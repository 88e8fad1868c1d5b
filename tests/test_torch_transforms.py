"""The port's feature transforms against the JAX package's, on the CPU.

Where no randomness enters, the port is held to JAX at atol 1e-5 (float32
reductions in another order): utterance CMVN, global CMVN, the eval-time
composite, and SpecAugment without a generator (the identity).  Random draws
come from a ``torch.Generator`` in the port and from ``jax.random`` keys in
JAX, so the masks differ by design; there the port is held to properties
(masks inside the valid frames, widths within F and T, fill equal to the
utterance mean, the padded tail untouched, one seed one output), to JAX
exactly when both are fed the same uniform draws, and to the masked share of
the JAX transform over 2,000 utterances within 0.015 (five standard errors
of the difference of two means of ~0.1-sd per-utterance shares).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.data.audio import transforms as jt
from s2t_tpu_torch.data.audio import transforms as pt
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
LENGTHS = np.array([50, 37, 12, 0], np.int32)


def _feats(B=4, T=50, D=20, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(loc=3.0, size=(B, T, D)).astype(np.float32)
    return feats


def _port(fn, feats, lengths=LENGTHS, generator=None):
    return fn(torch.from_numpy(feats), torch.from_numpy(lengths), generator).numpy()


@pytest.mark.parametrize("norm_vars", [True, False])
def test_utterance_cmvn_matches_jax(norm_vars):
    feats = _feats()
    got = _port(pt.UtteranceCMVN(norm_vars=norm_vars), feats)
    want = jt.UtteranceCMVN(norm_vars=norm_vars)(jnp.asarray(feats), jnp.asarray(LENGTHS))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_global_cmvn_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "stats.npz", mean=rng.normal(size=20), std=rng.uniform(0.5, 2, size=20))
    cfg = {"stats_npz_path": str(tmp_path / "stats.npz")}
    feats = _feats()
    got = _port(pt.GlobalCMVN.from_config_dict(cfg), feats)
    want = jt.GlobalCMVN.from_config_dict(cfg)(jnp.asarray(feats), jnp.asarray(LENGTHS))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_eval_composite_matches_jax():
    cfg = {"transforms": ["utterance_cmvn", "specaugment"],
           "specaugment": {"freq_mask_F": 5, "time_mask_T": 10}}
    feats = _feats()
    got = _port(pt.CompositeTransform.from_config_dict(cfg), feats)  # no generator: eval
    want = jt.CompositeTransform.from_config_dict(cfg)(jnp.asarray(feats), jnp.asarray(LENGTHS))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_specaugment_without_generator_is_identity():
    feats = _feats()
    aug = pt.SpecAugment(time_warp_w=5, freq_mask_f=5, time_mask_t=10)
    assert np.array_equal(_port(aug, feats), feats)


@pytest.mark.parametrize("warp", [0, 4])
def test_specaugment_masks_stay_in_bounds(warp):
    F, Tm = 6, 9
    aug = pt.SpecAugment(time_warp_w=warp, freq_mask_n=2, freq_mask_f=F, time_mask_n=2,
                         time_mask_t=Tm, time_mask_p=1.0)
    feats = _feats(B=16, seed=2)
    lengths = np.array([50, 37, 12, 0, 1, 20, 50, 44] * 2, np.int32)
    for seed in range(5):
        out = _port(aug, feats, lengths, torch.Generator().manual_seed(seed))
        again = _port(aug, feats, lengths, torch.Generator().manual_seed(seed))
        assert np.array_equal(out, again)  # one seed, one output
        src = feats if warp == 0 else _port(
            lambda f, l, g: aug._time_warp(f, l, lambda: torch.rand((16, 1), generator=g)),
            feats, lengths, torch.Generator().manual_seed(seed))
        for b, n in enumerate(lengths):
            np.testing.assert_array_equal(out[b, n:], feats[b, n:])  # padded tail untouched
            if n == 0:
                continue
            fill = src[b, :n].mean()
            masked = np.isclose(out[b, :n], fill, rtol=0, atol=1e-5) & ~np.isclose(
                src[b, :n], fill, rtol=0, atol=1e-5)
            rows = masked.all(axis=1)  # time masks span every channel
            cols = masked[~rows].all(axis=0) if not rows.all() else np.zeros(20, bool)
            # the masked set is whole frames and whole channels, of the allowed widths
            assert np.array_equal(masked, rows[:, None] | cols[None, :])
            assert cols.sum() <= 2 * F and rows.sum() <= 2 * min(Tm, n)
            if warp == 0:
                unmasked = ~masked
                np.testing.assert_array_equal(out[b, :n][unmasked], feats[b, :n][unmasked])


class _Draws:
    """Hands the same uniform draws to both frameworks, in their draw order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def take(self):
        return self.draws.pop(0)


@pytest.mark.parametrize("warp", [0, 3])
def test_specaugment_matches_jax_on_shared_draws(monkeypatch, warp):
    B = 4
    feats = _feats(B=B, seed=3)
    rng = np.random.default_rng(4)
    F, Tm = 6, 9
    n_uniform = 2 if warp else 0  # the warp draws its center and its shift
    uniforms = [rng.uniform(size=(B, 1)).astype(np.float32) for _ in range(n_uniform + 6)]
    ints = [rng.integers(0, F + 1, size=(B, 1)) for _ in range(2)]
    kw = dict(time_warp_w=warp, freq_mask_n=2, freq_mask_f=F, time_mask_n=2, time_mask_t=Tm)

    # the port's draw order: warp (c, w), then per frequency mask (randint f, uniform f0),
    # then per time mask (uniform t, uniform t0)
    order = uniforms[:n_uniform] + [ints[0], uniforms[n_uniform], ints[1],
                                    uniforms[n_uniform + 1]] + uniforms[n_uniform + 2:n_uniform + 6]
    port_draws = _Draws(order)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(port_draws.take()))
    monkeypatch.setattr(torch, "randint", lambda *a, **k: torch.from_numpy(port_draws.take()))
    got = _port(pt.SpecAugment(**kw), feats, generator=torch.Generator())
    monkeypatch.undo()

    jax_draws = _Draws(order)

    def uniform(key, shape, minval=0.0, maxval=1.0, **_):
        return minval + jnp.asarray(jax_draws.take()) * (maxval - minval)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(jax_draws.take()))
    want = jt.SpecAugment(**kw)(jnp.asarray(feats), jnp.asarray(LENGTHS), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_specaugment_masked_share_matches_jax():
    B, T, D = 2000, 120, 40
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = rng.integers(20, T + 1, size=B).astype(np.int32)
    kw = dict(freq_mask_n=2, freq_mask_f=10, time_mask_n=2, time_mask_t=20, time_mask_p=1.0)
    got = _port(pt.SpecAugment(**kw), feats, lengths, torch.Generator().manual_seed(0))
    want = np.asarray(jt.SpecAugment(**kw)(jnp.asarray(feats), jnp.asarray(lengths),
                                           jax.random.PRNGKey(0)))
    valid = np.arange(T)[None, :] < lengths[:, None]

    def share(out):
        fill = (feats * valid[..., None]).sum(axis=(1, 2)) / (lengths * D)
        masked = np.isclose(out, fill[:, None, None], rtol=0, atol=1e-6) & valid[..., None]
        return (masked.sum(axis=(1, 2)) / (lengths * D)).mean()

    assert abs(share(got) - share(want)) < 0.015
    assert 0.1 < share(got) < 0.6
