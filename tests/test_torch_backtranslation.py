"""Online backtranslation and the dataset wrappers against the JAX package
(s2t_tpu/data/wrappers.py, backtranslation_dataset.py, tasks/translation.py:170-240).

* ``WordNoiser`` (shuffle, word dropout, blanking, the UnsupervisedMT order; with a
  BPE continuation marker, an end marker and none) and every wrapper's items, order,
  sizes and batches equal JAX's array for array;
* ``BacktranslationDataset`` batches over an injected reverse function (the width
  snapped to the token buckets) and ``ConcatHomogeneous`` (contiguous origins; a mixed
  batch keeps only its majority origin, as JAX drops the rest) equal JAX's;
* a 2-layer, 64-wide reverse ``transformer``'s synthetic sources (flax-initialised and
  perturbed, the same weights on both sides) equal JAX's beam at beam 1 and beam 3;
* ``semisupervised_translation``: the reverse model from a port checkpoint written
  from JAX's parameters, bitext, backtranslation and denoising batches equal JAX's
  (each origin present), and the first training batch's loss at rtol 1e-5 and its
  gradients within 1e-5 of each leaf's largest entry (at least 1: the key biases'
  exact gradient is 0, float32 noise in both packages).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.data import backtranslation_dataset as jbt
from s2t_tpu.data import wrappers as jw
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import transformer as jt
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu.utils.checkpoint import save_pytree
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data import backtranslation_dataset as tbt
from s2t_tpu_torch.data import wrappers as tw
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from s2t_tpu_torch.models import transformer as tt
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.utils.checkpoint import save_tree
from tests.test_torch_train_trainer import flat
from tests.test_torch_translation import TGT_WORDS, cfg_dict, write_corpus
from tests.test_torch_wav2vec2 import perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

BPE_WORDS = ["he@@", "llo", "wor@@", "ld", "a", "b@@", "c", "d</w>", "e"]


def dictionaries(words=BPE_WORDS):
    out = []
    for cls in (Dictionary, JaxDictionary):
        d = cls()
        for w in words:
            d.add_symbol(w)
        out.append(d)
    return out


def equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("markers", [("@@", None), (None, "</w>"), (None, None)],
                         ids=["cont", "end", "none"])
def test_word_noiser_matches_jax(markers):
    td, jd = dictionaries()
    tn, jn = tw.WordNoiser(td, *markers), jw.WordNoiser(jd, *markers)
    rng = np.random.default_rng(0)
    for i in range(20):
        toks = np.concatenate([rng.integers(4, len(td), size=int(rng.integers(1, 9))),
                               [td.eos()]]).astype(np.int32)
        equal(tn.word_ids(toks[:-1]), jn.word_ids(toks[:-1]))
        for name, kw in (("shuffle", dict(max_distance=3)), ("dropout", dict(prob=0.4)),
                         ("dropout", dict(prob=0.4, blank_idx=3)),
                         ("unsupervised_mt", dict(word_dropout_prob=0.3))):
            a, b = np.random.default_rng(i), np.random.default_rng(i)
            args = (toks,) + tuple(v for k, v in kw.items() if k in ("max_distance", "prob"))
            rest = {k: v for k, v in kw.items() if k not in ("max_distance", "prob")}
            equal(getattr(tn, name)(*args, rng=a, **rest), getattr(jn, name)(*args, rng=b, **rest))


class Items:
    """A plain list dataset (no package code): items with "source", "target", "tokens"."""

    def __init__(self, n=9, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{"id": i, "source": rng.integers(4, 12, size=3 + i % 4).astype(np.int32),
                       "target": rng.integers(4, 12, size=2 + i % 3).astype(np.int32),
                       "tokens": rng.integers(4, 12, size=5).astype(np.int32)}
                      for i in range(n)]
        for it in self.items:
            it["source"][-1] = 2
        self.n_frames = np.asarray([len(it["source"]) for it in self.items], np.int64)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])

    def ordered_indices(self, shuffle=True, seed=1, epoch=1):
        return np.argsort(self.n_frames, kind="stable")[::-1]

    def collater(self, samples, **kw):
        return {"ids": np.asarray([s["id"] for s in samples])}


WRAPPERS = {
    "noising": lambda m, d, base: m.NoisingDataset(base, d, seed=3, word_dropout_prob=0.3),
    "truncate": lambda m, d, base: m.TruncateDataset(base, 3),
    "random_crop": lambda m, d, base: m.RandomCropDataset(base, 3, seed=5),
    "append": lambda m, d, base: m.AppendTokenDataset(base, 7, field="target"),
    "prepend": lambda m, d, base: m.PrependTokenDataset(base, 7),
    "strip": lambda m, d, base: m.StripTokenDataset(base, 2),
    "offset": lambda m, d, base: m.OffsetTokensDataset(base, 4),
    "replace": lambda m, d, base: m.ReplaceDataset(base, {5: 6, 6: 9}),
    "roll": lambda m, d, base: m.RollDataset(base, 2),
    "eos_lang_pair": lambda m, d, base: m.TransformEosLangPairDataset(base, 2, new_src_eos=11,
                                                                     new_tgt_bos=10),
    "lm_context_window": lambda m, d, base: m.LMContextWindowDataset(base, 3),
    "subsample": lambda m, d, base: m.SubsampleDataset(base, 0.6, seed=4),
    "resampling": lambda m, d, base: m.ResamplingDataset(base, weights=np.arange(1, 10),
                                                         size_ratio=1.5, seed=2),
    "multi_corpus": lambda m, d, base: m.MultiCorpusSampledDataset(
        {"a": base, "b": Items(5, seed=1)}, seed=6),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_matches_jax(name):
    td, jd = dictionaries()
    t, j = WRAPPERS[name](tw, td, Items()), WRAPPERS[name](jw, jd, Items())
    for epoch in (1, 2):
        if epoch == 2:
            t.set_epoch(2)
            j.set_epoch(2)
        assert len(t) == len(j)
        for i in range(len(j)):
            equal(t[i], j[i])
        equal(t.ordered_indices(seed=3, epoch=epoch), j.ordered_indices(seed=3, epoch=epoch))
        equal(t.n_frames, j.n_frames)
        equal(t.collater([t[0], t[1]]), j.collater([j[0], j[1]]))


def toy_reverse(target, lengths):
    """Each row's tokens reversed before its EOS (an injected backtranslator)."""
    out = np.full_like(target, 1)
    for b, n in enumerate(lengths):
        out[b, :n - 1] = target[b, :n - 1][::-1]
        out[b, n - 1] = 2
    return out


def test_backtranslation_and_concat_batches_match_jax():
    td, jd = dictionaries(TGT_WORDS)
    lines = [" ".join(TGT_WORDS[i:i + k]) for i, k in ((0, 3), (4, 5), (9, 2), (2, 4))]
    t = tbt.BacktranslationDataset(lines, td, toy_reverse)
    j = jbt.BacktranslationDataset(lines, jd, toy_reverse)
    buckets = np.asarray([8, 16])
    for kw in ({}, {"token_buckets": buckets, "batch_multiple": 4}):
        equal(t.collater([t[0], t[1], t[2]], **kw), j.collater([j[0], j[1], j[2]], **kw))
    assert t.collater([t[1]], token_buckets=buckets)["target"].shape == (1, 8)
    equal(t.ordered_indices(seed=2), j.ordered_indices(seed=2))
    # bitext-like items beside BT items: contiguous runs, one origin a batch
    tc = tbt.ConcatHomogeneous([t, tw.TruncateDataset(t, 2, field="target")])
    jc = jbt.ConcatHomogeneous([j, jw.TruncateDataset(j, 2, field="target")])
    equal(tc.ordered_indices(seed=1), jc.ordered_indices(seed=1))
    equal(tc.n_frames, jc.n_frames)
    for idx in ([0, 1], [4, 5, 6], [3, 4, 5], [2, 3, 4]):
        got = tc.collater([tc[i] for i in idx])
        assert got.pop("origin") == (0 if sum(i < 4 for i in idx) * 2 > len(idx) else 1)
        equal(got, jc.collater([jc[i] for i in idx]))
    # the quirk: a mixed batch keeps its majority origin only (ROADMAP.md section 3)
    mixed = tc.collater([tc[i] for i in (2, 3, 4)])
    assert mixed["origin"] == 0 and mixed["nsentences"] == 2


def reverse_pair(beam, tdict_len, sdict_len, seed=0):
    kw = dict(encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
              encoder_attention_heads=4, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
              decoder_layers=2, decoder_attention_heads=4, dropout=0.0,
              encoder_normalize_before=True, decoder_normalize_before=True,
              vocab_size=sdict_len, src_vocab_size=tdict_len)
    jm = jt.TransformerModel(jt.TransformerMTConfig(**kw))
    x = np.full((1, 4), 5, np.int32)
    params = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), x,
                                                      np.asarray([4]), x)["params"]), seed=3)
    tm = load_flax_params(tt.TransformerModel(tt.TransformerMTConfig(**kw), device="cpu"),
                          params)
    gen_kw = dict(beam_size=beam, max_len_b=12, max_target_positions=32,
                  input_keys=("src_tokens", "src_lengths"))
    return (jm, params, JaxGenerator(jm, **gen_kw)), (tm, SequenceGenerator(tm, **gen_kw))


@pytest.mark.parametrize("beam", [1, 3])
def test_bt_sources_match_jax_beam(beam):
    td, jd = dictionaries(TGT_WORDS)
    (jm, params, jgen), (tm, tgen) = reverse_pair(beam, len(td), 24)
    lines = [" ".join(TGT_WORDS[i:i + k]) for i, k in ((0, 3), (4, 5), (9, 2), (2, 6))]
    t = tbt.BacktranslationDataset(lines, td, tbt.make_backtranslator(tm, tgen))
    j = jbt.BacktranslationDataset(lines, jd, jbt.make_backtranslator(jm, params, jgen))
    got = t.collater([t[i] for i in range(4)], token_buckets=np.asarray([8, 16]))
    want = j.collater([j[i] for i in range(4)], token_buckets=np.asarray([8, 16]))
    equal(got, want)
    assert got["src_tokens"].shape[0] == 4 and (got["src_lengths"] >= 1).all()


MONO = ["t1 t2 t3", "t4 t5", "t6 t7 t8 t9", "t10 t11", "t12 t13 t14", "t3 t2"]


def test_semisupervised_batches_and_first_step_match_jax(tmp_path):
    data = write_corpus(tmp_path / "data", n_train=8)
    (data / "mono.de").write_text("\n".join(MONO) + "\n")
    rev_kw = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=1,
                  encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
                  decoder_layers=1, decoder_attention_heads=2, dropout=0.0)
    d = cfg_dict(data, task="semisupervised_translation",
                 task_cfg={"bt_checkpoint": "", "bt_arch": "transformer", "bt_model": rev_kw,
                           "bt_beam": 2, "lambda_denoising": 1.0, "word_dropout_prob": 0.2},
                 criterion_cfg={"label_smoothing": 0.1},
                 dataset={"max_source_positions": 16, "max_target_positions": 16})
    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, copy.deepcopy(d)))
    rev = jt.TransformerModel(jt.TransformerMTConfig(
        **rev_kw, vocab_size=len(jtask.src_dict), src_vocab_size=len(jtask.tgt_dict)))
    x = np.full((1, 4), 5, np.int32)
    rparams = perturb(jax.tree.map(np.asarray, rev.init(jax.random.PRNGKey(1), x,
                                                        np.asarray([4]), x)["params"]))
    save_pytree(tmp_path / "rev.msgpack", {"params": rparams})
    save_tree(tmp_path / "rev.pt", {"params": flax_to_state_dict(rparams)})
    jtask.cfg.task_cfg["bt_checkpoint"] = str(tmp_path / "rev.msgpack")
    d["task_cfg"]["bt_checkpoint"] = str(tmp_path / "rev.pt")
    task = setup_task(from_dict(TrainConfig, d))
    task.device = "cpu"

    ds, jds = task.load_dataset("train", True), jtask.load_dataset("train", True)
    assert isinstance(ds, tbt.ConcatHomogeneous) and len(ds.datasets) == 3
    its = [t.get_batch_iterator(s, seed=3, shuffle=False,
                                **({} if t is task else {"batch_size_multiple": 1}))
           for t, s in ((task, ds), (jtask, jds))]
    got, want = (list(it.next_epoch_itr()) for it in its)
    assert len(got) == len(want)
    assert {b["origin"] for b in got} == {0, 1, 2}
    for g, w in zip(got, want):
        g = {k: v for k, v in g.items() if k != "origin"}
        equal(g, w)

    # the first step's loss and gradients (dropout 0) from one flax init
    batch = got[0]
    jm = jtask.build_model()
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), batch["src_tokens"], batch["src_lengths"],
        batch["prev_tokens"])["params"])
    jcrit, jfwd = jax_build_criterion(d["criterion"], d["criterion_cfg"]), jtask.forward_fn()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k not in ("ids", "origin")}

    def jax_loss(p):
        return jcrit(jfwd(jm, p, jbatch, True), jbatch)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    tm = load_flax_params(task.build_model(device="cpu", for_training=True), params)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    loss = task.build_criterion()(task.forward_fn()(tm, tb, train=False), tb)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = dict(flat(state_dict_to_flax({k: p.grad for k, p in tm.named_parameters()})))
    for key, g in flat(jgrads):
        np.testing.assert_allclose(grads[key], g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=key)
