"""Gradients of the port's fused attention against the JAX package, and its dropout.

On CPU tensors ``fused_attention`` runs ``fused_attention_plain`` and autograd
differentiates it.  At dropout 0 its gradients are held to ``jax.grad``
through the Pallas kernel in interpret mode (lengths >= 1, as
tests/test_attention_pallas.py runs it) and through the JAX dense path, which
also defines the 0-length row; fp32, atol 1e-5 (sums in another order).
Dropout bits cannot match JAX's (the TPU PRNG), so dropout > 0 is held within
the port: a float64 gradcheck shows forward and backward use one mask, and
``keep_mask`` is pinned to an independent numpy evaluation of the documented
hash, which the CUDA kernels compute too (chip_smoke.py holds them to it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.modules.attention import dot_attention_weights, padding_bias
from s2t_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from s2t_tpu_torch.ops.attention_cuda import fused_attention, fused_attention_plain, keep_mask

ATOL = 1e-5


def make_case(B, T, H, D, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, g, valid


def port_grads(q, k, v, g, valid, rate=0.0, seed=None):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fused_attention(tq, tk, tv, torch.from_numpy(valid), rate, seed)
    (out * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def jax_grads(attend, q, k, v, g, valid):
    with jax.default_matmul_precision("highest"):
        grads = jax.grad(lambda *a: jnp.vdot(attend(*a), jnp.asarray(g)), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in grads]


def jax_dense(valid):
    def attend(q, k, v):
        w = dot_attention_weights(q, k, padding_bias(jnp.asarray(valid), jnp.float32), jnp.float32)
        return jnp.einsum("bhqk,bkhd->bqhd", w, v)

    return attend


def test_grads_match_pallas_kernel_interpret():
    q, k, v, g, valid = make_case(2, 100, 4, 64, [100, 57])
    ref = jax_grads(lambda *a: jax_fused_attention(*a, jnp.asarray(valid), interpret=True),
                    q, k, v, g, valid)
    for name, got, want in zip("qkv", port_grads(q, k, v, g, valid), ref):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [32, 64, 128])
def test_grads_match_dense_path_with_zero_length_row(D):
    q, k, v, g, valid = make_case(3, 37, 2, D, [37, 0, 11], seed=D)
    got = port_grads(q, k, v, g, valid)
    for name, a, b in zip("qkv", got, jax_grads(jax_dense(valid), q, k, v, g, valid)):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"d{name}")
    # the 0-length row attends uniformly, and its dS still reaches dQ and dK
    assert np.abs(got[0][1]).max() > 1e-3 and np.abs(got[1][1]).max() > 1e-3


def test_dropout_gradcheck_float64():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 6, 2, 4))).requires_grad_() for _ in range(3))
    valid = torch.tensor([[True] * 6, [True] * 4 + [False] * 2])
    seed = torch.tensor([20240611], dtype=torch.int64)
    assert not keep_mask(seed, 2, 2, 6, 64).all()  # the mask drops something here
    assert torch.autograd.gradcheck(
        lambda a, b, c: fused_attention_plain(a, b, c, valid, 0.25, seed), (q, k, v))
    # the same seed gives the same output; another seed another one
    out = fused_attention_plain(q, k, v, valid, 0.25, seed)
    torch.testing.assert_close(out, fused_attention_plain(q, k, v, valid, 0.25, seed.clone()),
                               rtol=0, atol=0)
    assert not torch.equal(out, fused_attention_plain(q, k, v, valid, 0.25, seed + 1))


def _np_keep_mask(seed, B, H, T, rate_u8):
    def mix(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))

    lo, hi = np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32)
    bh = (np.arange(B)[:, None] * H + np.arange(H)[None, :]).astype(np.uint32)
    stream = mix(mix(lo ^ mix(bh)) ^ hi)
    t = np.arange(T, dtype=np.uint32)
    word = mix((t[:, None] << np.uint32(16)) | t[None, :])
    bits = mix(stream[:, :, None, None] ^ word[None, None])
    return (bits >> np.uint32(24)) >= rate_u8


def test_keep_mask_is_the_documented_hash():
    seed = (0x1234ABCD << 32) | 0x9E3779B9
    with np.errstate(over="ignore"):
        want = _np_keep_mask(seed, 3, 2, 40, 38)
    got = keep_mask(torch.tensor([seed], dtype=torch.int64), 3, 2, 40, 38)
    np.testing.assert_array_equal(got.numpy(), want)
    # about 1 - 38/256 of the entries are kept
    assert abs(got.float().mean().item() - (1 - 38 / 256)) < 0.02
