"""RoBERTa / BERT, the masked-LM and sentence tasks and their criteria against the JAX
package.

Tiny encoders (16 wide, FFN 32, 2 heads, 2 post-norm layers) with ``bert_base``'s
segments and 2-way head: the port's seeded weights as a flax tree with JAX's paths
and shapes, perturbed, carried back by ``from_flax``.

* ``apply_bert_masking`` on JAX's own draws (its three keys' uniforms and random ids
  handed over as ``batch["draws"]``) equals JAX's masked tokens and selection; on the
  port's generator pads and protected markers are never selected, about 15 % of the
  rest are, 80 / 10 / 10 of those masked / random (from id 4) / kept;
* the encoder output, the LM logits and the head's logits within 1e-5 of each tensor's
  largest magnitude, with segments; pads inside a row (the kernel reads each row's
  count of valid tokens: the fused attention is made to read only that here) give
  JAX's dense result;
* ``masked_lm`` and ``legacy_masked_lm`` (NSP weighted 0.5, a dummy row) through each
  task's forward adapter on JAX's draws: loss at rtol 1e-4, the logs, every gradient
  within 1e-4 of its largest entry;
* ``SentencePairDataset`` items (numpy draws, seed and epoch), ``cross_lingual_lm``'s
  tagged blocks, ``SentenceDataset`` / ``RankingDataset`` batches equal JAX's;
  ``sentence_prediction`` and ``sentence_ranking``: loss, logs and gradients as above.
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
from s2t_tpu.models import roberta as jr
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu.tasks.masked_lm import apply_bert_masking as jax_masking
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import roberta as tr
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.tasks.masked_lm import apply_bert_masking
from tests.test_torch_lstm_lightconv import shapes
from tests.test_torch_nat import lengths_only
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(20)]
V = len(WORDS) + 4 + 1  # the specials, the words and <mask>
MASK = V - 1
TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=2,
            encoder_attention_heads=2, dropout=0.0, attention_dropout=0.0, vocab_size=V,
            max_positions=16)


def tokens(seed=0, B=3, L=10, lengths=(10, 7, 3)):
    rng = np.random.default_rng(seed)
    t = rng.integers(4, V - 1, size=(B, L)).astype(np.int32)
    for b, n in enumerate(lengths):
        t[b, n:] = 1
    return t


def jax_draws(key, shape):
    """JAX's apply_bert_masking draws, as the port takes them handed over."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {"mask_uniforms": np.asarray(jax.random.uniform(k1, shape)),
            "kind_uniforms": np.asarray(jax.random.uniform(k2, shape)),
            "random_tokens": np.asarray(jax.random.randint(k3, shape, 4, V))}


@pytest.fixture(scope="module")
def bert():
    """(JAX bert_base, perturbed flax params, the port's)."""
    jm = jr.RobertaModel(jr.bert_base(**TINY))
    port = tr.RobertaModel(tr.bert_base(**TINY), device="cpu", for_training=True)
    t = tokens()
    want = jax.eval_shape(lambda k: jm.init(k, t, classification=True,
                                            segments=np.zeros_like(t)), jax.random.PRNGKey(0))
    params = perturb(state_dict_to_flax(port.state_dict()))
    assert shapes(params) == shapes(want["params"])
    return jm, params, load_flax_params(port, params)


def test_masking_on_jax_draws_and_its_rates():
    t = tokens(1, B=4, L=64, lengths=(64, 50, 20, 0))
    protect = np.zeros_like(t, bool)
    protect[:, 0] = True
    key = jax.random.PRNGKey(5)
    want_tok, want_sel = jax_masking(key, jnp.asarray(t), MASK, V, protect=jnp.asarray(protect))
    got_tok, got_sel = apply_bert_masking(torch.from_numpy(t).long(), MASK, V,
                                          protect=torch.from_numpy(protect),
                                          draws=jax_draws(key, t.shape))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    # the port's own draws: 200,000 maskable tokens
    big = torch.randint(4, V - 1, (400, 1000))
    big[:, 500:] = 1
    prot = torch.zeros_like(big, dtype=torch.bool)
    prot[:, 0] = True
    out, sel = apply_bert_masking(big, MASK, V, protect=prot,
                                  generator=torch.Generator().manual_seed(0))
    assert not sel[:, 500:].any() and not sel[:, 0].any()
    n = int(sel.sum())
    assert abs(n / (400 * 499) - 0.15) < 0.005
    masked, kept = int((out[sel] == MASK).sum()), int((out[sel] == big[sel]).sum())
    # a random replacement draws the token it replaces 1 time in V - 4
    assert abs(masked / n - 0.8) < 0.01 and abs(kept / n - 0.1 - 0.1 / (V - 4)) < 0.01
    assert int(out[sel].min()) >= 4 and torch.equal(out[~sel], big[~sel])


def test_forward_with_segments_and_inner_pads_match_jax(bert, monkeypatch):
    jm, params, tm = bert
    t = tokens(2)
    seg = np.zeros_like(t)
    seg[:, 4:] = 1
    want = jm.apply({"params": params}, t, classification=True, segments=seg)
    with torch.no_grad():
        got = tm(torch.from_numpy(t).long(), classification=True,
                 segments=torch.from_numpy(seg))
    for key in ("encoder_out", "lm_logits", "cls_logits"):
        assert_close(got[key].numpy(), want[key], key)
    assert got["lm_logits"].shape == (3, 10, V) and got["cls_logits"].shape == (3, 2)
    # pads inside rows: JAX attends densely under the padding bias; the port takes the
    # tokens valid-first so the kernel's prefix of each row's count is the mask
    calls = lengths_only(monkeypatch)
    t[0, 2], t[1, 0] = 1, 1
    want = jm.apply({"params": params}, t, classification=True, segments=seg)
    with torch.no_grad():
        got = tm(torch.from_numpy(t).long(), classification=True,
                 segments=torch.from_numpy(seg))
    assert len(calls) == 2
    for key in ("encoder_out", "lm_logits", "cls_logits"):
        assert_close(got[key].numpy(), want[key], f"inner pads {key}")


def loss_and_grads_match(jtask, ttask, jm, params, tm, batch, seed=0):
    """The task's forward adapter and criterion, JAX's under dropout key ``seed`` (no
    dropout: its masks are drawn from fold_in(key, 11)) and the port's on those draws:
    loss, logs and gradients."""
    key = jax.random.PRNGKey(seed)
    jcrit, jfwd = jtask.build_criterion(), jtask.forward_fn()

    def jax_loss(p):
        out = jfwd(jm, p, batch, True, rngs={"dropout": key})
        loss, size, logs = jcrit(out, batch)
        return loss, (size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    if "target" in batch:  # the masked-LM tasks
        tb["draws"] = jax_draws(jax.random.fold_in(key, 11), batch["target"].shape)
    tm.zero_grad()
    out = ttask.forward_fn()(tm, tb, train=False)
    loss, size, logs = ttask.build_criterion()(out, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(size), float(jsize), rtol=1e-6)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k].detach()), float(jlogs[k]), rtol=1e-4,
                                   err_msg=k)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()
                                        if p.grad is not None})))
    want = {k: v for k, v in flat(jax.tree.map(np.asarray, jgrads))}
    assert set(got) <= set(want)
    for k, v in want.items():
        assert_close(got.get(k, np.zeros_like(v)), v, f"{k}, 1e-4", tol=1e-4)


def write_lines(path: Path, n, rng, lo=3, hi=9):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))
                              for _ in range(n)) + "\n")


def both_tasks(root: Path, task: str, **extra):
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    crit = {"masked_lm": "masked_lm", "cross_lingual_lm": "masked_lm"}.get(task, task)
    d = {"task": task, "criterion": crit, "common": {"seed": 7},
         "dataset": {"data": str(root), "max_target_positions": 16}, **extra}
    return jax_setup_task(jax_from_dict(JaxTrainConfig, d)), setup_task(from_dict(TrainConfig, d))


@pytest.mark.parametrize("task", ["masked_lm", "legacy_masked_lm"])
def test_mlm_losses_and_gradients_match_jax(bert, tmp_path, task):
    jm, params, tm = bert
    rng = np.random.default_rng(3)
    write_lines(tmp_path / "train.txt", 12, rng)
    extra = {"criterion_cfg": {"nsp_loss_weight": 0.5}} if task == "legacy_masked_lm" else {}
    jt, tt = both_tasks(tmp_path, task, **extra)
    assert len(tt.dictionary) == V and tt.mask_id == MASK
    jd, td = jt.load_dataset("train"), tt.load_dataset("train")
    samples = [td[i] for i in range(3)]
    for i, s in enumerate(samples):
        for k, v in jd[i].items():
            np.testing.assert_array_equal(np.asarray(s[k]), np.asarray(v), err_msg=k)
    batch = td.collater(samples, batch_multiple=4)  # a dummy row of pads
    batch = {k: v for k, v in batch.items() if k not in ("ids", "nsentences")}
    loss_and_grads_match(jt, tt, jm, params, tm, batch)


def test_sentence_pair_dataset_epochs_and_cross_lingual_blocks(tmp_path):
    rng = np.random.default_rng(4)
    write_lines(tmp_path / "pairs" / "train.txt", 9, rng)
    jt, tt = both_tasks(tmp_path / "pairs", "legacy_masked_lm")
    jd, td = jt.load_dataset("train"), tt.load_dataset("train")
    for epoch in (1, 2):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(td)):
            for k, v in jd[i].items():
                np.testing.assert_array_equal(np.asarray(td[i][k]), np.asarray(v))
    for lang, n in (("de", 40), ("fr", 25)):
        write_lines(tmp_path / "xlm" / lang / "train.txt", n, rng)
    jt, tt = both_tasks(tmp_path / "xlm", "cross_lingual_lm", task_cfg={"langs": "de,fr"})
    assert tt.lang_tags == jt.lang_tags and len(tt.dictionary) == V + 2
    jd, td = jt.load_dataset("train", is_train=True), tt.load_dataset("train", is_train=True)
    assert len(td) == len(jd)
    for i in range(len(td)):
        np.testing.assert_array_equal(td[i]["tokens"], jd[i]["tokens"])
    np.testing.assert_array_equal(td.ordered_indices(True, 7, 1), jd.ordered_indices(True, 7, 1))
    assert {int(td[i]["tokens"][0]) for i in range(len(td))} == set(tt.lang_tags.values())


@pytest.mark.parametrize("task", ["sentence_prediction", "sentence_ranking"])
def test_sentence_tasks_match_jax(tmp_path, task):
    rng = np.random.default_rng(6)
    sents = lambda: " ".join(rng.choice(WORDS, size=int(rng.integers(2, 8))))  # noqa: E731
    if task == "sentence_prediction":
        (tmp_path / "labels.txt").write_text("pos neg neutral\n")
        rows = [f"{sents()}\t{rng.choice(['pos', 'neg', 'neutral'])}" for _ in range(5)]
    else:
        rows = ["\t".join([sents() for _ in range(3)] + [str(rng.integers(0, 3))])
                for _ in range(5)]
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    jt, tt = both_tasks(tmp_path, task, model={k: v for k, v in TINY.items()
                                                if k != "vocab_size"})
    jd, td = jt.load_dataset("train"), tt.load_dataset("train")
    np.testing.assert_array_equal(td.n_frames, jd.n_frames)
    idx = td.ordered_indices(True, 7, 1)
    np.testing.assert_array_equal(idx, jd.ordered_indices(True, 7, 1))
    jb = jd.collater([jd[int(i)] for i in idx[:4]], batch_multiple=5)
    tb = td.collater([td[int(i)] for i in idx[:4]], batch_multiple=5)
    assert set(tb) == set(jb)
    for k, v in jb.items():
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(v), err_msg=k)
    tm = tt.build_model(device="cpu", for_training=True)
    assert tm.cfg.num_classes == (3 if task == "sentence_prediction" else 1)
    jm = jr.RobertaModel(jr.roberta_base(**{**TINY, "vocab_size": tm.cfg.vocab_size,
                                            "num_classes": tm.cfg.num_classes}))
    params = perturb(state_dict_to_flax(tm.state_dict()))
    load_flax_params(tm, params)
    batch = {k: v for k, v in tb.items() if k not in ("ids", "nsentences")}
    loss_and_grads_match(jt, tt, jm, params, tm, batch)
