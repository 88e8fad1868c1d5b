"""wav2vec 2.0 pretraining and CTC fine-tuning against the JAX package.

A tiny model (a 7-layer conv stack of 16 channels, 320 samples a frame, one
layer of 32) on 3 seeded waveforms, flax weights carried across by ``from_flax``
(the losses and ``wav2vec_ctc`` are in tests/test_torch_wav2vec2_train.py):

* ``conv_out_lengths``, ``grad_multiply`` and ``sample_mask_spans`` on handed-over uniforms;
* ``extract_features`` in both extractor modes, within 1e-5 of the largest magnitude;
* the pretraining forward in training on JAX's draws (span uniforms, Gumbel
  uniforms, negatives, recorded from ``jax.random``): logits, perplexities,
  feature penalty, positions; a negative JAX masks is masked in the port, and
  one the port alone masks (the same codes, JAX's projected rows rounded apart)
  is a tie of JAX's own logits;
* ``from_flax`` both ways, and ``transplant_component`` of a pretraining tree into
  the fine-tuning model (``strict=False``) against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.models import wav2vec2 as jw
from s2t_tpu.utils.checkpoint import transplant_component as jax_transplant
from s2t_tpu_torch.interop.from_flax import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from s2t_tpu_torch.models import wav2vec2 as tw
from s2t_tpu_torch.utils.checkpoint import transplant_component
from tests.test_torch_train_trainer import flat
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

CONV = ((16, 10, 5), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 3, 2), (16, 2, 2), (16, 2, 2))
W2V = dict(conv_feature_layers=CONV, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
           encoder_layers=1, encoder_attention_heads=2, final_dim=16, latent_vars=8,
           latent_groups=2, num_negatives=5, mask_length=2, mask_prob=0.5, conv_pos=16,
           conv_pos_groups=4, dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
           dropout_features=0.0)
LENGTHS = np.array([4000, 3100, 2000], np.int32)  # 12, 9 and 6 frames
CRIT = ("wav2vec", {})


def waves(seed=0):
    return np.random.default_rng(seed).normal(size=(3, 4000)).astype(np.float32)


def perturb(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype), params)


def assert_close(got, want, key="", tol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol * max(1.0, np.abs(want).max()), err_msg=key)


def jax_pair(cls=jw.Wav2Vec2Model, cfg_cls=jw.Wav2Vec2Config, **kw):
    jm = cls(cfg_cls(**{**W2V, **kw}))
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, waves(), LENGTHS)["params"]
    return jm, perturb(jax.tree.map(np.asarray, params))


def port_model(params, cls=tw.Wav2Vec2Model, cfg_cls=tw.Wav2Vec2Config, **kw):
    return load_flax_params(cls(cfg_cls(**{**W2V, **kw}), device="cpu", for_training=True),
                            params)


def recorded_draws(fn):
    """Run ``fn`` (jitted) with ``jax.random.uniform`` / ``randint`` recorded: the
    span uniforms, the Gumbel uniforms (minval 1e-6) and the negatives, returned
    beside its output."""
    rec, uniform, randint = [], jax.random.uniform, jax.random.randint

    def u(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = uniform(key, shape, dtype, minval, maxval)
        rec.append(("gumbel_uniform" if minval else "mask_uniform", out))
        return out

    def r(key, shape, minval, maxval, dtype=jnp.int32):
        out = randint(key, shape, minval, maxval, dtype)
        rec.append(("negatives", out))
        return out

    def run():
        return fn(), [x for _, x in rec]

    jax.random.uniform, jax.random.randint = u, r
    try:
        out, arrays = jax.jit(run)()
    finally:
        jax.random.uniform, jax.random.randint = uniform, randint
    return out, {k: torch.from_numpy(np.array(a)) for (k, _), a in zip(rec, arrays)}


def test_lengths_grad_multiply_and_spans_match_jax():
    lens = np.array([100, 55, 400, 10], np.int32)
    got = tw.conv_out_lengths(torch.from_numpy(lens).long(), CONV)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw.conv_out_lengths(lens, CONV)))
    x = torch.ones(3, requires_grad=True)
    tw.grad_multiply(x * 2.0, 0.1).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 0.2)
    key = jax.random.PRNGKey(4)
    T, flens = 30, np.array([30, 17, 3], np.int32)
    n = tw.mask_span_count(T, 0.65, 4, 2)
    want_pos, want_mask = jw.sample_mask_spans(key, 3, T, flens, 0.65, 4, 2)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (3, n))))
    pos, mask = tw.sample_mask_spans(u, T, torch.from_numpy(flens).long(), 4)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_extract_features_matches_jax(mode):
    jm, params = jax_pair(extractor_mode=mode)
    tm = port_model(params, extractor_mode=mode)
    x, lens = jax.jit(lambda p: jm.apply({"params": p}, waves(), LENGTHS,
                                         method=jw.Wav2Vec2Model.extract_features))(params)
    with torch.no_grad():
        tx, tlens = tm.extract_features(torch.from_numpy(waves()), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(lens))
    assert_close(tx.numpy(), x, "x")
    with pytest.raises(ValueError, match=r"\(B, N\) waveforms"):
        tm.extract_features(torch.zeros(3, 98, 80), torch.from_numpy(LENGTHS))


@pytest.fixture(scope="module")
def pretraining_pair():
    return jax_pair()


def test_pretraining_forward_matches_jax_on_handed_draws(pretraining_pair):
    jm, params = pretraining_pair
    tm = port_model(params)
    ref, draws = recorded_draws(lambda: jm.apply(
        {"params": params}, waves(), LENGTHS, deterministic=False, temp=2.0,
        rngs={"dropout": jax.random.PRNGKey(3)}))
    assert set(draws) == {"mask_uniform", "gumbel_uniform", "negatives"}
    with torch.no_grad():
        out = tm(torch.from_numpy(waves()), torch.from_numpy(LENGTHS), train=True,
                 generator=torch.Generator().manual_seed(0), temp=2.0, draws=draws)
    for key in ("mask_positions", "mask_valid"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("features_pen", "prob_perplexity", "code_perplexity"):
        assert_close(out[key].item(), float(ref[key]), key)
    want, got = np.asarray(ref["logits"]), out["logits"].numpy()
    both = np.isfinite(want) & np.isfinite(got)
    assert_close(got[both], want[both], "logits")
    assert not (np.isinf(want) & np.isfinite(got)).any()
    only_port = np.argwhere(np.isinf(got) & np.isfinite(want))
    for n, b, m in only_port:  # JAX's own logit ties the positive's: the same target
        assert abs(want[n, b, m] - want[0, b, m]) <= 1e-5 * max(1.0, abs(want[0, b, m]))
    assert np.isinf(got).any()


def test_from_flax_both_ways_and_transplant_match_jax(pretraining_pair):
    jm, pre = pretraining_pair
    tm = port_model(pre)
    want = dict(flat(pre))
    got = dict(flat(state_dict_to_flax(tm.state_dict())))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert tuple(tm.pos_conv.conv.weight.shape) == (32, 32 // 4, 16)  # (out, in / groups, k)
    _, ft = jax_pair(jw.Wav2VecCtc, jw.Wav2VecCtcConfig, vocab_size=9)
    want = jax_transplant(ft, {"w2v": pre}, "w2v", strict=False)
    ft_sd = flax_to_state_dict(ft)
    got = transplant_component(ft_sd, {f"w2v.{k}": v for k, v in
                                       flax_to_state_dict(pre).items()}, "w2v", strict=False)
    assert dict(flat(state_dict_to_flax(got))).keys() == dict(flat(want)).keys()
    for k, v in flat(want):
        np.testing.assert_array_equal(dict(flat(state_dict_to_flax(got)))[k], v, err_msg=k)
    with pytest.raises(KeyError, match="structure"):  # the quantizer has no place to go
        transplant_component(ft_sd, {f"w2v.{k}": v for k, v in flax_to_state_dict(pre).items()},
                             "w2v")
