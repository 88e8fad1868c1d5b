"""s2t_tpu_torch fused attention (CPU: its plain version) against the JAX package.

The port's ``fused_attention`` on CPU tensors runs ``fused_attention_plain``;
it is held to the Pallas kernel in interpret mode (dropout 0, lengths >= 1,
as tests/test_attention_pallas.py runs it) and to the JAX dense path
(``dot_attention_weights`` + ``padding_bias`` + PV), which also defines the
0-length row.  fp32 throughout, atol 1e-5 (sums in another order).
The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.modules.attention import dot_attention_weights, padding_bias
from s2t_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from s2t_tpu_torch.ops.attention_cuda import fused_attention, fused_attention_plain
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5


def make_case(B, T, H, D, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, valid


def port(q, k, v, valid):
    return fused_attention(*(torch.from_numpy(a) for a in (q, k, v, valid))).numpy()


def jax_dense(q, k, v, valid):
    w = dot_attention_weights(jnp.asarray(q), jnp.asarray(k),
                              padding_bias(jnp.asarray(valid), jnp.float32), jnp.float32)
    return np.asarray(jnp.einsum("bhqk,bkhd->bqhd", w, jnp.asarray(v)))


def test_matches_pallas_kernel_interpret():
    q, k, v, valid = make_case(2, 100, 4, 64, [100, 57])
    ref = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), interpret=True
    ))
    np.testing.assert_allclose(port(q, k, v, valid), ref, atol=ATOL)


@pytest.mark.parametrize("D", [32, 44, 64, 90, 128])
def test_matches_dense_path_with_zero_length_row(D):
    q, k, v, valid = make_case(3, 37, 2, D, [37, 0, 11], seed=D)
    out = port(q, k, v, valid)
    np.testing.assert_allclose(out, jax_dense(q, k, v, valid), atol=ATOL)
    # the 0-length row is the uniform average of V over all T keys
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), out[1].shape), atol=ATOL)


def test_head_major_strided_layout():
    # a (B, H, T, D) buffer viewed as (B, T, H, D): the layout the kernel reads in place
    q, k, v, valid = make_case(2, 29, 4, 32, [29, 13], seed=3)
    hm = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
          for a in (q, k, v)]
    out = fused_attention(*hm, torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), port(q, k, v, valid), atol=ATOL)


def test_cpu_tensor_runs_plain_version():
    q, k, v, valid = (torch.from_numpy(a) for a in make_case(1, 8, 2, 32, [5]))
    before = fused_attention.launches
    torch.testing.assert_close(fused_attention(q, k, v, valid),
                               fused_attention_plain(q, k, v, valid), rtol=0, atol=0)
    assert fused_attention.launches == before
