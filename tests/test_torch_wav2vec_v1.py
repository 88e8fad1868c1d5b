"""wav2vec (v1), its k-means quantizer and the CPC loss against the JAX package.

A tiny model (a 3-layer extractor of 16 channels, 40 samples a frame, an
aggregator of 16 and 12 channels with a 1x1 projection on its skip, 3 prediction
steps, 4 negatives) on 3 ragged waveforms, flax weights carried across by
``from_flax`` and perturbed; JAX's random draws (the negatives' uniforms, the
cross-utterance draws, the Gumbel uniforms) recorded and handed over:

* ``effective_offset`` of every preset and of the tiny stack;
* ``cpc_logits`` within 1e-5 of their largest magnitude and ``cpc_valid`` equal,
  with GELU, edge padding, strided feature skips and cross-utterance negatives
  (ReLU and zero-padded aggregation through the InfoNCE gradients);
* the loss x sample size at rtol 1e-4 and every gradient within 1e-4 of its
  largest entry, for InfoNCE, binary cross entropy with ``balanced_classes``,
  the k-means quantizer (its loss term) and the Gumbel quantizer in training
  (its diversity term);
* the k-means quantizer alone: codes, perplexity, loss and the straight-through
  output;
* a negative is never drawn from a padded frame;
* ``audio_pretraining`` routes ``arch: wav2vec``: its forward anneals ``vq_temp``,
  and ``cli.train`` runs 2 updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import wav2vec as jv
from s2t_tpu.modules.vq import KmeansVectorQuantizer as JaxKmeans
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from s2t_tpu_torch.models import wav2vec as tv
from s2t_tpu_torch.modules.vq import KmeansVectorQuantizer
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(conv_feature_layers=((16, 10, 5), (16, 8, 4), (16, 4, 2)),
            conv_aggregator_layers=((16, 2, 1), (12, 3, 1)), prediction_steps=3,
            num_negatives=4, vq_vars=6, vq_groups=2)
LENGTHS = np.array([2000, 1500, 900], np.int32)  # 48, 36 and 21 frames
CASES = {
    "infonce": dict(infonce=True, agg_zero_pad=True),
    "bce_balanced": dict(balanced_classes=True, activation="gelu", skip_connections_feat=True,
                         cross_sample_negatives=2),
    "kmeans": dict(infonce=True, vq_type="kmeans"),
    "gumbel": dict(infonce=True, vq_type="gumbel"),
}


def waves(seed=0):
    x = np.random.default_rng(seed).normal(size=(3, 2000)).astype(np.float32)
    for b, n in enumerate(LENGTHS):
        x[b, n:] = 0.0
    return x


def recorded(fn):
    """Run ``fn`` under ``jax.jit`` with its draws recorded, in the port's names."""
    rec, uniform, randint = [], jax.random.uniform, jax.random.randint

    def u(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = uniform(key, shape, dtype, minval, maxval)
        plain = sum(1 for k, _ in rec if k in ("negatives", "cross_uniform"))
        name = "gumbel_uniform" if minval else ("negatives", "cross_uniform")[plain]
        rec.append((name, out))
        return out

    def r(key, shape, minval, maxval, dtype=jnp.int32):
        out = randint(key, shape, minval, maxval, dtype)
        rec.append(("cross_utterance", out))
        return out

    jax.random.uniform, jax.random.randint = u, r
    try:
        out, arrays = jax.jit(lambda: (fn(), [x for _, x in rec]))()
    finally:
        jax.random.uniform, jax.random.randint = uniform, randint
    return out, {k: torch.from_numpy(np.array(a)) for (k, _), a in zip(rec, arrays)}


def make_pair(case):
    cfg = {**TINY, **CASES[case]}
    jm = jv.Wav2VecModel(jv.Wav2VecConfig(**cfg))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, waves(), LENGTHS)["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    tm = load_flax_params(tv.Wav2VecModel(tv.Wav2VecConfig(**cfg), device="cpu",
                                          for_training=True), params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {}


def get_pair(pairs, case):
    if case not in pairs:
        pairs[case] = make_pair(case)
    return pairs[case]


def test_effective_offset_matches_jax():
    for arch in ("wav2vec_base", "wav2vec_large"):
        assert getattr(tv, arch)().effective_offset == getattr(jv, arch)().effective_offset
    assert tv.Wav2VecConfig(**TINY).effective_offset == \
        jv.Wav2VecConfig(**TINY).effective_offset == 3
    assert tv.Wav2VecConfig(offset=5).effective_offset == 5


@pytest.mark.parametrize("case", ["bce_balanced"])
def test_cpc_scores_match_jax(pairs, case):
    jm, params, tm = get_pair(pairs, case)
    want, draws = recorded(lambda: jm.apply({"params": params}, waves(), jnp.asarray(LENGTHS),
                                            deterministic=False,
                                            rngs={"dropout": jax.random.PRNGKey(3)}))
    assert "negatives" in draws and ("cross_utterance" in draws) == (case == "bce_balanced")
    with torch.no_grad():
        got = tm(torch.from_numpy(waves()), torch.from_numpy(LENGTHS), train=True,
                 generator=torch.Generator().manual_seed(0), draws=draws)
    assert got["cpc_logits"].shape == (3, 48, 3, 1 + 4 + CASES[case].get(
        "cross_sample_negatives", 0))
    np.testing.assert_array_equal(got["cpc_valid"].numpy(), np.asarray(want["cpc_valid"]))
    assert_close(got["cpc_logits"].numpy(), want["cpc_logits"], "cpc_logits, 1e-5")
    assert got["num_negatives"] == want["num_negatives"]


@pytest.mark.parametrize("case", list(CASES))
def test_cpc_loss_and_gradients_match_jax(pairs, case):
    jm, params, tm = get_pair(pairs, case)
    kw = dict(deterministic=False, temp=jnp.float32(1.5), rngs={"dropout": jax.random.PRNGKey(4)})
    _, draws = recorded(lambda: jm.apply({"params": params}, waves(1), jnp.asarray(LENGTHS),
                                         **kw))
    assert ("gumbel_uniform" in draws) == (case == "gumbel")
    jcrit = jax_build_criterion("wav2vec", {})

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, waves(1), jnp.asarray(LENGTHS), **kw), {})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(waves(1)), torch.from_numpy(LENGTHS), train=True,
             generator=torch.Generator().manual_seed(0), temp=1.5, draws=draws)
    loss, size, logs = build_criterion("wav2vec", {})(out, {})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)
    assert ("kmeans_loss" in logs) == (case == "kmeans")
    assert ("diversity_loss" in logs) == (case == "gumbel")


def test_kmeans_quantizer_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 7, 12)).astype(np.float32)
    jq = JaxKmeans(12, num_vars=5, groups=2, vq_dim=12)
    params = perturb(jax.tree.map(np.asarray, jq.init(jax.random.PRNGKey(2), x)["params"]))
    want = jq.apply({"params": params}, x)
    tq = KmeansVectorQuantizer(12, num_vars=5, groups=2, vq_dim=12)
    tq.load_state_dict(flax_to_state_dict(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tq(xt)
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    for key in ("x", "code_perplexity", "kmeans_loss"):
        assert_close(got[key].detach().numpy(), want[key], f"{key}, 1e-5")
    # straight-through: the output's gradient reaches the input through the norm
    got["x"].sum().backward()
    assert xt.grad.abs().max() > 0


def test_negatives_never_come_from_padding():
    cfg = tv.Wav2VecConfig(**{**TINY, "cross_sample_negatives": 3})
    tm = tv.Wav2VecModel(cfg, device="cpu")
    B, T = 3, 48
    frames = torch.tensor([48, 36, 21])
    y = torch.arange(T, dtype=torch.float32)[None, :, None].expand(B, T, 2).contiguous()
    y = y + 1000.0 * torch.arange(B, dtype=torch.float32)[:, None, None]  # row, frame
    draws = {"negatives": torch.full((B, T, 4), 0.999999),
             "cross_utterance": torch.randint(0, B, (B, T, 3)),
             "cross_uniform": torch.full((B, T, 3), 0.999999)}
    negs = tm._negatives(y, frames, None, draws)[..., 0]
    row, frame = negs // 1000, negs % 1000
    assert torch.all(frame < frames[row.long()])
    negs = tm._negatives(y, frames, torch.Generator().manual_seed(1), {})[..., 0]
    row, frame = negs // 1000, negs % 1000
    assert torch.all(frame < frames[row.long()])
    own = negs[..., :4] // 1000 == torch.arange(B)[:, None, None]
    assert torch.all(own)


def test_audio_pretraining_trains_wav2vec_v1_with_its_vq_temp(tmp_path, monkeypatch):
    """``audio_pretraining`` routes ``arch: wav2vec``: the forward anneals the Gumbel
    temperature by ``vq_temp`` (JAX's float32 schedule), and cli.train runs 2 updates."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.tasks.audio_pretraining import gumbel_temperature
    from tests.test_torch_item9_recipes import _manifest

    (tmp_path / "data").mkdir()
    root = _manifest(tmp_path / "data")
    model = {**TINY, "vq_type": "gumbel", "vq_temp": [2.0, 0.5, 0.9]}
    cfg = from_dict(TrainConfig, {
        "task": "audio_pretraining", "arch": "wav2vec", "criterion": "wav2vec", "model": model,
        "task_cfg": {"max_sample_size": 6000},
        "dataset": {"data": str(root), "max_tokens": 14000, "valid_subset": "valid"},
        "optimization": {"lr": 1e-3, "warmup_updates": 2, "max_update": 2},
        "checkpoint": {"save_dir": str(tmp_path / "ckpt"), "no_save": True}})
    temps = []
    plain = tv.Wav2VecModel.forward

    def spy(self, *args, temp=None, **kw):
        temps.append(float(temp))
        return plain(self, *args, temp=temp, **kw)

    monkeypatch.setattr(tv.Wav2VecModel, "forward", spy)
    out = cli_train.main(cfg, device="cpu")
    assert out["trainer"].step == 2 and np.isfinite(out["history"][-1]["loss"])
    assert "diversity_loss" in out["history"][-1]
    # the steps' temperatures: max(2 * 0.9^step, 0.5) in float32, from step 0
    assert temps[:2] == [gumbel_temperature((2.0, 0.5, 0.9), s).item() for s in (0, 1)]
