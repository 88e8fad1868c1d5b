"""The multilingual Transformer, its round-robin zip and criterion, and the
multilingual translation task against the JAX package.

A corpus of two pairs (de-en 7 lines, fr-en 4: the shorter wraps) over one dictionary
of 20 words and ``<lang:en>``; tiny models (16 wide, FFN 32, 2 heads, one layer a side)
over ``lang_pairs`` de-en and fr-en:

* the zip's per-epoch orders, its summed row costs and every collated batch of the
  task's iterator equal JAX's, key for key; the Trainer takes a zip batch (the sample
  size summed over the pairs, each pair's logs);
* the separate, ``share_decoders`` and ``share_all_embeddings`` models: the port's
  seeded weights as a flax tree with JAX's paths and shapes (one table a shared one),
  perturbed, carried back by ``from_flax`` (and back again unchanged); every pair's
  encoder output and logits within 1e-5 of each tensor's largest magnitude, and the
  all-pairs forward equal to ``pair_view``'s, bit for bit;
* ``MultilingualCriterion`` over the label-smoothed CE: loss and sample size at rtol
  1e-4, every gradient within 1e-4 of its largest entry, each pair's and the summed logs;
* beam-5 tokens of ``pair_view`` identical to JAX's;
* the shared-model regime (``translation_multi_simple_epoch`` over ``transformer``):
  each target tagged ``<lang:en>`` as in JAX, and a dictionary without the tag raising
  ``ValueError`` in both packages;
* an encoder table sized by the target ``vocab_size`` (no shared encoder table, no
  ``lang_vocab_sizes``) below the source dictionary: a source id past it is a NaN row
  in JAX and a ``ValueError`` here.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.criterions.multilingual import MultilingualCriterion as JaxMultilingualCriterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import multilingual_transformer as jm_mod
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.cli.train import step_batch
from s2t_tpu_torch.config import OptimizationConfig, TrainConfig, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.criterions.multilingual import MultilingualCriterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import multilingual_transformer as tm_mod
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_lstm_lightconv import shapes
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(20)]
PAIRS = ("de-en", "fr-en")
V = len(WORDS) + 4
TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=1,
            encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
            decoder_layers=1, decoder_attention_heads=2, dropout=0.0, vocab_size=V,
            max_source_positions=32, max_target_positions=32, lang_pairs=PAIRS)
SHARING = {"separate": {}, "share_decoders": {"share_decoders": True},
           "share_all_embeddings": {"share_all_embeddings": True}}
CRIT = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})
LENGTHS = np.array([6, 4, 2], np.int32)


def pair_batches(seed=0):
    """pair -> a batch of 3 ragged sources (EOS-terminated, padded) and 5-token targets."""
    rng = np.random.default_rng(seed)
    out = {}
    for pair in PAIRS:
        src = rng.integers(4, V, size=(3, 6)).astype(np.int32)
        for b, n in enumerate(LENGTHS):
            src[b, n - 1], src[b, n:] = 2, 1
        tgt = rng.integers(4, V, size=(3, 5)).astype(np.int32)
        tgt[:, -1] = 2
        prev = np.concatenate([np.full((3, 1), 2, np.int32), tgt[:, :-1]], axis=1)
        out[pair] = {"src_tokens": src, "src_lengths": LENGTHS, "prev_tokens": prev,
                     "target": tgt}
    return out


def to_torch(pairs):
    return {p: {k: torch.from_numpy(v).long() for k, v in b.items()} for p, b in pairs.items()}


@pytest.fixture(scope="module")
def models():
    """sharing -> (JAX model, perturbed flax params, port model)."""
    batch = pair_batches()
    jax_in = {p: {k: b[k] for k in ("src_tokens", "src_lengths", "prev_tokens")}
              for p, b in batch.items()}
    out = {}
    for name, flags in SHARING.items():
        jm = jm_mod.MultilingualTransformerModel(jm_mod.multilingual_transformer(**TINY, **flags))
        port = tm_mod.MultilingualTransformerModel(tm_mod.multilingual_transformer(**TINY, **flags),
                                                   device="cpu", for_training=True)
        want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jax_in)["params"]
        params = perturb(state_dict_to_flax(port.state_dict()))
        assert shapes(params) == shapes(want), name
        out[name] = (jm, params, load_flax_params(port, params))
    return out


@pytest.mark.parametrize("name", list(SHARING))
def test_forward_matches_jax_and_the_pair_view(models, name):
    jm, params, tm = models[name]
    batch = pair_batches()
    want = jm.apply({"params": params}, {p: {k: b[k] for k in ("src_tokens", "src_lengths",
                                                                 "prev_tokens")}
                                         for p, b in batch.items()})["pairs"]
    with torch.no_grad():
        got = tm(to_torch(batch))["pairs"]
        for pair in PAIRS:
            for key in ("encoder_out", "decoder_logits"):
                assert_close(got[pair][key].numpy(), want[pair][key], f"{name} {pair} {key}")
            b = to_torch(batch)[pair]
            view = tm.pair_view(pair).forward_pair(b["src_tokens"], b["src_lengths"],
                                                   b["prev_tokens"])
            torch.testing.assert_close(view["decoder_logits"], got[pair]["decoder_logits"],
                                       rtol=0, atol=0)
    tree = dict(flat(params))
    back = dict(flat(state_dict_to_flax(tm.state_dict())))
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)
    # a shared module or table is one parameter
    keys = set(tm.state_dict())
    tables = {k for k in keys if k.endswith("embed_tokens.weight") or k.startswith("shared")}
    expect = {"separate": {"encoder_de.embed_tokens.weight", "encoder_fr.embed_tokens.weight",
                           "decoder_en.embed_tokens.weight"},
              "share_decoders": {"encoder_de.embed_tokens.weight",
                                 "encoder_fr.embed_tokens.weight",
                                 "shared_decoder_embed.weight"},
              "share_all_embeddings": {"shared_embed.weight"}}[name]
    assert tables == expect
    assert len(list(tm.parameters())) == len(keys)


def test_criterion_loss_gradients_and_logs_match_jax(models):
    jm, params, tm = models["share_decoders"]
    batch = pair_batches(1)
    jcrit = JaxMultilingualCriterion(jax_build_criterion(*CRIT))

    def jax_loss(p):
        out = jm.apply({"params": p}, {q: {k: b[k] for k in ("src_tokens", "src_lengths",
                                                              "prev_tokens")}
                                       for q, b in batch.items()})
        loss, size, logs = jcrit(out, {"pairs": batch})
        return loss, (size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)
    crit = MultilingualCriterion(build_criterion(*CRIT))
    assert crit.cfg.label_smoothing == 0.1  # attributes pass through to the base
    tm.zero_grad()
    b = to_torch(batch)
    loss, size, logs = crit(tm(b, train=True, generator=torch.Generator().manual_seed(0)),
                            {"pairs": b})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(size), float(jsize), rtol=1e-4)
    assert set(logs) == set(jlogs) and "de-en:nll_loss" in logs and "nll_loss" in logs
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]), rtol=1e-4,
                                   err_msg=k)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)


@pytest.mark.parametrize("pair", PAIRS)
def test_pair_view_beam5_tokens_match_jax(models, pair):
    jm, params, tm = models["share_decoders"]
    b = pair_batches(2)[pair]
    kw = dict(beam_size=5, max_len_b=8, input_keys=("src_tokens", "src_lengths"))
    tm.eval()
    with torch.no_grad():
        got, _, _ = SequenceGenerator(tm.pair_view(pair), **kw).generate(b)
    want = JaxGenerator(jm.pair_view(pair), **kw).generate(
        params, {k: jnp.asarray(b[k]) for k in ("src_tokens", "src_lengths")})[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# the task: the zip, the shared regime's tags
def write_corpus(root: Path, tag=True) -> Path:
    rng = np.random.default_rng(5)
    root.mkdir(parents=True, exist_ok=True)
    words = WORDS + (["<lang:en>"] if tag else [])
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    for split in ("train", "dev", "test"):
        for pair, n in (("de-en", 7), ("fr-en", 4)):
            for lang in pair.split("-"):
                lines = [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 7))))
                         for _ in range(n)]
                (root / f"{split}.{pair}.{lang}").write_text("\n".join(lines) + "\n")
    return root


def task_cfg(root, arch, task="multilingual_translation"):
    model = {k: v for k, v in TINY.items() if k not in ("vocab_size", "lang_pairs")}
    return {"task": task, "arch": arch, "criterion": "label_smoothed_cross_entropy",
            "task_cfg": {"lang_pairs": list(PAIRS)}, "model": model,
            "dataset": {"data": str(root), "max_tokens": 24, "num_buckets": 2,
                        "max_source_positions": 64, "max_target_positions": 64},
            "common": {"seed": 3}}


def both_tasks(d):
    return jax_setup_task(jax_from_dict(JaxTrainConfig, d)), setup_task(from_dict(TrainConfig, d))


def test_zip_orders_and_batches_match_jax(tmp_path):
    jt, tt = both_tasks(task_cfg(write_corpus(tmp_path), "multilingual_transformer_iwslt_de_en"))
    assert tt.per_pair_models and tt.eval_lang_pair == "de-en"
    jz, tz = jt.load_dataset("train", is_train=True), tt.load_dataset("train", is_train=True)
    assert len(tz) == len(jz) == 7
    for epoch in (1, 2):
        np.testing.assert_array_equal(tz.ordered_indices(True, 3, epoch),
                                      jz.ordered_indices(True, 3, epoch))
        np.testing.assert_array_equal(tz.n_frames, jz.n_frames)
    jb = list(jt.get_batch_iterator(jz, seed=3).next_epoch_itr())
    tb = list(tt.get_batch_iterator(tz, seed=3).next_epoch_itr())
    assert len(tb) == len(jb) > 1
    for a, b in zip(tb, jb):
        assert set(a) == set(b) == {"pairs", "ntokens"} and a["ntokens"] == b["ntokens"]
        for pair in PAIRS:
            assert set(a["pairs"][pair]) == set(b["pairs"][pair])
            for k, v in b["pairs"][pair].items():
                np.testing.assert_array_equal(np.asarray(a["pairs"][pair][k]), np.asarray(v),
                                              err_msg=f"{pair} {k}")
    # cli.generate decodes one pair's own split
    assert len(tt.load_pair_dataset("test", "fr-en")) == 4
    crit = tt.build_criterion()
    assert isinstance(crit, MultilingualCriterion)
    # the Trainer moves the nested batch, normalises by the pairs' summed sample size and
    # logs each pair
    trainer = Trainer(tt.build_model(device="cpu", for_training=True), crit,
                      OptimizationConfig(lr=1e-3, warmup_updates=2), device="cpu",
                      forward_fn=tt.forward_fn())
    m = trainer.train_step(step_batch(tb[0]))
    assert float(m["sample_size"]) == sum(float((b["target"] != 1).sum())
                                          for b in tb[0]["pairs"].values())
    assert np.isfinite(float(m["loss"])) and {f"{p}:nll_loss" for p in PAIRS} <= set(m)


def test_shared_regime_tags_targets_and_needs_the_tag(tmp_path):
    jt, tt = both_tasks(task_cfg(write_corpus(tmp_path / "a"), "transformer",
                                 "translation_multi_simple_epoch"))
    assert not tt.per_pair_models and tt.eval_lang_pair is None
    jd, td = jt.load_dataset("train", is_train=True), tt.load_dataset("train", is_train=True)
    tag = tt.tgt_dict.index("<lang:en>")
    assert len(td) == len(jd) == 11
    for i in range(len(td)):
        assert td[i]["target"][0] == tag
        np.testing.assert_array_equal(td[i]["target"], jd[i]["target"])
        np.testing.assert_array_equal(td[i]["source"], jd[i]["source"])
    jt, tt = both_tasks(task_cfg(write_corpus(tmp_path / "b", tag=False), "transformer",
                                 "translation_multi_simple_epoch"))
    for task in (jt, tt):
        with pytest.raises(ValueError, match="<lang:en>"):
            task.load_dataset("train", is_train=True)


def test_encoder_table_below_the_source_dictionary(models):
    """The table of a per-language encoder is the target vocab_size's (V rows); the
    task's src_vocab_size (V + 4) only sizes a shared one."""
    cfg = dict(TINY, src_vocab_size=V + 4)
    jm = jm_mod.MultilingualTransformerModel(jm_mod.multilingual_transformer(**cfg))
    tm = tm_mod.MultilingualTransformerModel(tm_mod.multilingual_transformer(**cfg),
                                             device="cpu")
    assert tm.encoders["de"].embed_tokens.num_embeddings == V
    batch = pair_batches()
    jax_in = {p: {k: b[k].copy() for k in ("src_tokens", "src_lengths", "prev_tokens")}
              for p, b in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jax_in)["params"]
    assert params["encoder_de"]["embed_tokens"]["embedding"].shape[0] == V
    jax_in["de-en"]["src_tokens"][0, 0] = V + 2  # an id of the source dictionary only
    out = jm.apply({"params": params}, jax_in)["pairs"]["de-en"]
    assert np.isnan(np.asarray(out["encoder_out"])).any()
    b = to_torch(batch)
    with torch.no_grad():
        tm(b)  # ids inside the table run
        b["de-en"]["src_tokens"][0, 0] = V + 2
        with pytest.raises(ValueError, match="past encoder 'de'"):
            tm(b)
