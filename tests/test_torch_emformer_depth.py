"""The Emformer at emformer_s's width, 3 and 12 layers: float32 chaos with depth.

With random weights the Emformer's keys include the un-normed memory bank and
left context, whose norms grow layer by layer, so its attention saturates and a
float32 difference grows with depth.  Here flax initialises ``emformer_s``
(256 wide, segments of 16, V = 10000, dropout 0) at 3 and at 12 layers, the
port takes the same weights through ``from_flax``, and both encode 2 seeded rows
of 600 frames on the CPU, once as they are and once with a seeded 1e-6 relative
perturbation (the readings of ``chip_smoke.emformer_sensitivity``):

* JAX's own valid CTC logits move at least 1000 times more at 12 layers than at
  3 (the chaos is the reference's);
* at each depth the port differs from JAX by at most 4 times what that 1e-6
  perturbation moves JAX's logits (the port tracks JAX as closely as float32
  lets JAX track itself).

This is why chip_smoke.py holds the Emformer card vs CPU at 3 layers.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.models import streaming as js
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.models import streaming as ts
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

B, T = 2, 600
CHAOS_RATIO = 1e3  # JAX's sensitivity at 12 layers over its sensitivity at 3, at least
TRACK_FACTOR = 4.0  # |port - JAX| over JAX's sensitivity, at most


def inputs():
    rng = np.random.default_rng(40)
    x = rng.normal(size=(B, T, 80)).astype(np.float32)
    lengths = np.array([T, int(rng.integers(T * 2 // 5, T + 1))], np.int32)
    noise = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    return x, x * (1 + 1e-6 * noise), lengths


def readings(layers):
    """(JAX's sensitivity, the port's sensitivity, |port - JAX|) over the valid CTC logits."""
    x, xp, lengths = inputs()
    cfg = dict(vocab_size=10000, encoder_layers=layers, dropout=0.0, attention_dropout=0.0,
               activation_dropout=0.0)
    jm = js.EmformerModel(js.emformer_s(**cfg))
    params = jm.init(jax.random.PRNGKey(0), x[:, :64], np.minimum(lengths, 64))["params"]
    apply = jax.jit(lambda p, a, n: jm.apply({"params": p}, a, n))
    want, want_p = apply(params, x, lengths), apply(params, xp, lengths)
    tm = load_flax_params(ts.EmformerModel(ts.emformer_s(**cfg), device="cpu"),
                          jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths).long())["ctc_logits"].numpy()
        got_p = tm(torch.from_numpy(xp), torch.from_numpy(lengths).long())["ctc_logits"].numpy()
    enc_lengths = np.asarray(want["encoder_lengths"])
    valid = np.arange(got.shape[1])[None, :] < enc_lengths[:, None]
    w, wp = np.asarray(want["ctc_logits"]), np.asarray(want_p["ctc_logits"])
    return (np.abs(w - wp)[valid].max(), np.abs(got - got_p)[valid].max(),
            np.abs(got - w)[valid].max())


@pytest.fixture(scope="module")
def by_depth():
    return {layers: readings(layers) for layers in (3, 12)}


def test_jax_emformer_s_sensitivity_grows_with_depth(by_depth):
    shallow, deep = by_depth[3][0], by_depth[12][0]
    assert deep >= CHAOS_RATIO * shallow, (
        f"JAX's logits move {deep:.3e} at 12 layers and {shallow:.3e} at 3 under a 1e-6 "
        f"input perturbation: expected a ratio of at least {CHAOS_RATIO:g}")


@pytest.mark.parametrize("layers", [3, 12])
def test_port_tracks_jax_within_its_own_input_sensitivity(by_depth, layers):
    jax_sens, port_sens, diff = by_depth[layers]
    assert diff <= TRACK_FACTOR * jax_sens, (
        f"{layers} layers: |port - JAX| = {diff:.3e}, over {TRACK_FACTOR:g} x JAX's "
        f"sensitivity to a 1e-6 input perturbation ({jax_sens:.3e}; the port's "
        f"{port_sens:.3e})")
