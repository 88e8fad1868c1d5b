"""s2t_tpu_torch leaf modules against the JAX package on CPU.

Each module is initialised by flax, carried across with
``interop.from_flax.load_flax_params`` and fed the same numpy inputs.
fp32, atol 1e-5: the same math, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.modules import attention as jattn
from s2t_tpu.modules import layers as jlayers
from s2t_tpu.modules.positional import fairseq_sinusoidal_encoding as jax_sinusoidal
from s2t_tpu.modules.subsampling import Conv1dSubsampling as JaxConv1dSubsampling
from s2t_tpu.utils.masking import lengths_to_mask as jax_lengths_to_mask
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.modules import attention as tattn
from s2t_tpu_torch.modules import layers as tlayers
from s2t_tpu_torch.modules.positional import fairseq_sinusoidal_encoding
from s2t_tpu_torch.modules.subsampling import Conv1dSubsampling
from s2t_tpu_torch.utils.masking import lengths_to_mask, mask_to_lengths
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
D, H, FFN = 64, 4, 128


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol)


def flax_init(module, *args, **kw):
    params = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw))(*args)
    return jax.tree.map(np.asarray, params["params"])


def carried(port_module, params):
    return load_flax_params(port_module, params).eval().requires_grad_(False)


def inputs(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_masking():
    lengths = np.array([5, 0, 3], np.int64)
    mask = lengths_to_mask(t(lengths), 6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_lengths_to_mask(jnp.asarray(lengths), 6)))
    np.testing.assert_array_equal(mask_to_lengths(mask).numpy(), lengths)


@pytest.mark.parametrize("dim", [64, 7])
def test_sinusoidal_positions(dim):
    pe = fairseq_sinusoidal_encoding(50, dim, padding_idx=1)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jax_sinusoidal(50, dim, 1)))


def test_conv1d_subsampling():
    x = inputs((3, 41, 80))
    lengths = np.array([41, 30, 9], np.int32)
    jm = JaxConv1dSubsampling(2, 32, D, 5, 2)
    params = flax_init(jm, x, lengths)
    tm = carried(Conv1dSubsampling(80, 2, 32, D, 5, 2), params)
    jy, jl = jm.apply({"params": params}, x, lengths)
    ty, tl = tm(t(x), t(lengths).long())
    close(ty, jy)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_mha_full_vs_incremental_cache():
    B, U = 2, 6
    x = inputs((B, U, D))
    jm = jattn.MultiHeadAttention(D, H)
    bias = np.asarray(jattn.causal_bias(U))
    params = flax_init(jm, x, x, x, bias)
    tm = carried(tattn.MultiHeadAttention(D, H), params)
    full, _ = tm(t(x), t(x), t(x), tattn.causal_bias(U))
    close(full, jm.apply({"params": params}, x, x, x, bias)[0])

    jcache = {"k": jnp.zeros((B, U, H, D // H)), "v": jnp.zeros((B, U, H, D // H))}
    tcache = {"k": torch.zeros(B, U, H, D // H), "v": torch.zeros(B, U, H, D // H)}
    for i in range(U):
        xi = x[:, i:i + 1]
        jo, jcache = jm.apply({"params": params}, xi, xi, xi, cache=jcache, cache_index=i)
        to, tcache = tm(t(xi), t(xi), t(xi), cache=tcache, cache_index=i)
        close(to, jo)
        close(to[:, 0], full[:, i].numpy())
    close(tcache["k"], jcache["k"])


def test_mha_grouped_cross_attention():
    B, G, Tk = 2, 3, 9
    q_in, enc = inputs((B * G, 1, D), 1), inputs((B, Tk, D), 2)
    valid = np.arange(Tk)[None, :] < np.array([9, 4])[:, None]
    bias = np.repeat(np.asarray(jattn.padding_bias(jnp.asarray(valid))), G, axis=0)
    jm = jattn.MultiHeadAttention(D, H)
    params = flax_init(jm, q_in, q_in, q_in)
    tm = carried(tattn.MultiHeadAttention(D, H), params)
    jkv = jm.apply({"params": params}, enc, method=jm.project_kv)
    tkv = tm.project_kv(t(enc))
    jo, _ = jm.apply({"params": params}, q_in, None, None, bias, kv_override=jkv)
    to, _ = tm(t(q_in), None, None, t(bias), kv_override=tkv)
    close(to, jo)
    # equal to per-beam cross-attention over repeated K/V
    rep = tuple(a.repeat_interleave(G, dim=0) for a in tkv)
    per_beam, _ = tm(t(q_in), None, None, t(bias), kv_override=rep)
    close(to, per_beam.numpy())


@pytest.mark.parametrize("normalize_before", [True, False])
def test_encoder_layer(normalize_before):
    x = inputs((3, 23, D))
    valid = np.arange(23)[None, :] < np.array([23, 17, 0])[:, None]
    jm = jlayers.S2TEncoderLayer(D, FFN, H, normalize_before=normalize_before)
    params = flax_init(jm, x, valid)
    tm = carried(tlayers.S2TEncoderLayer(D, FFN, H, "relu", normalize_before), params)
    close(tm(t(x), t(valid)), jm.apply({"params": params}, x, valid))


@pytest.mark.parametrize("normalize_before", [True, False])
def test_decoder_layer_teacher_forced_and_incremental(normalize_before):
    B, U, Tk = 2, 5, 11
    x, enc = inputs((B, U, D), 3), inputs((B, Tk, D), 4)
    enc_valid = np.arange(Tk)[None, :] < np.array([11, 6])[:, None]
    cross_bias = np.asarray(jattn.padding_bias(jnp.asarray(enc_valid)))
    self_bias = np.asarray(jattn.causal_bias(U))
    jm = jlayers.TransformerDecoderLayer(D, FFN, H, normalize_before=normalize_before)
    params = flax_init(jm, x, enc, self_bias, cross_bias)
    tm = carried(tlayers.TransformerDecoderLayer(D, FFN, H, "relu", normalize_before), params)
    full, _ = tm(t(x), t(enc), t(self_bias), t(cross_bias))
    close(full, jm.apply({"params": params}, x, enc, self_bias, cross_bias)[0])

    enc_kv = tm.cross_kv(t(enc))
    cache = {"k": torch.zeros(B, U, H, D // H), "v": torch.zeros(B, U, H, D // H)}
    for i in range(U):
        step, cache = tm(t(x[:, i:i + 1]), t(enc), None, t(cross_bias), cache=cache,
                         cache_index=i, enc_kv=enc_kv)
        close(step[:, 0], full[:, i].numpy())
