"""The legacy modules of the port (``modules/legacy.py``) against the JAX package's
(s2t_tpu/modules/legacy.py): ``VGGBlock`` (with and without LayerNorm, ceil-mode
pooling over odd (time, freq) sizes), ``LocationAttention`` (first step and a later
one, a cached encoder projection, padded frames), ``Highway`` and
``CharacterTokenEmbedder`` (with eos / unk symbol rows), each flax-initialised,
perturbed and carried across by ``from_flax``: outputs within 1e-5 of each tensor's
largest magnitude, and the port's parameters mapped back to JAX's tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.modules import legacy as jl
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from s2t_tpu_torch.modules import legacy as tl
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)


def carry(jmod, port, *args):
    """flax init of ``jmod`` on ``args``, perturbed, loaded into ``port``; the params."""
    params = perturb(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), *args)["params"]))
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    back = dict(flat(state_dict_to_flax(port.state_dict())))
    assert set(back) == set(dict(flat(params)))
    return params


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "layer_norm"])
def test_vgg_block_matches_jax(norm):
    x = np.random.default_rng(0).normal(size=(2, 13, 9, 3)).astype(np.float32)
    jm = jl.VGGBlock(3, 8, num_conv_layers=2, input_dim=9, layer_norm=norm)
    tm = tl.VGGBlock(3, 8, num_conv_layers=2, input_dim=9, layer_norm=norm)
    params = carry(jm, tm, x)
    want = jm.apply({"params": params}, x)
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 7, 5, 8)
    assert_close(got.detach().numpy(), want)
    assert tm.output_freq_dim == jm.output_freq_dim == 5
    assert tm.total_output_dim == jm.total_output_dim == 40


def test_location_attention_matches_jax():
    rng = np.random.default_rng(1)
    B, T, De, Dd, K = 2, 11, 12, 10, 2
    enc = rng.normal(size=(B, T, De)).astype(np.float32)
    valid = np.arange(T)[None] < np.array([T, 7])[:, None]
    state = rng.random((B, K, T)).astype(np.float32)
    dec_h = rng.normal(size=(B, Dd)).astype(np.float32)
    kw = dict(attn_dim=8, encoder_dim=De, decoder_dim=Dd, attn_state_kernel_size=K,
              conv_dim=4, conv_kernel_size=3, scaling=2.0)
    jm, tm = jl.LocationAttention(**kw), tl.LocationAttention(**kw)
    params = carry(jm, tm, enc, valid, dec_h, state)
    t = [torch.from_numpy(a) for a in (enc, valid, dec_h, state)]
    for h, th in ((None, None), (dec_h, t[2])):
        cw, ww = jm.apply({"params": params}, enc, valid, h, state)
        c, w = tm(t[0], t[1], th, t[3])
        assert_close(c.detach().numpy(), cw)
        assert_close(w.detach().numpy(), ww)
        assert float(w[1, 7:].detach().abs().max()) == 0.0
    proj = tm.project_encoder(t[0])
    jproj = jm.apply({"params": params}, enc, method=jm.project_encoder)
    assert_close(proj.detach().numpy(), jproj)
    c2, _ = tm(t[0], t[1], t[2], t[3], proj_enc_out=proj)
    assert_close(c2.detach().numpy(), jm.apply({"params": params}, enc, valid, dec_h, state)[0])


def test_highway_matches_jax():
    x = np.random.default_rng(2).normal(size=(3, 5, 6)).astype(np.float32)
    jm, tm = jl.Highway(6, 3), tl.Highway(6, 3)
    params = carry(jm, tm, x)
    assert_close(tm(torch.from_numpy(x)).detach().numpy(), jm.apply({"params": params}, x))


@pytest.mark.parametrize("highway", [2, 0])
def test_character_token_embedder_matches_jax(highway):
    rng = np.random.default_rng(3)
    chars = rng.integers(3, 257, size=(2, 4, 6)).astype(np.int32)
    chars[0, 1, 3:] = 0  # a short word
    chars[0, 2] = 0
    chars[0, 2, 0] = 1  # eos
    chars[1, 3] = 0
    chars[1, 3, 0] = 2  # unk
    filters = ((1, 4), (2, 6), (3, 5))
    jm = jl.CharacterTokenEmbedder(12, char_embed_dim=5, filters=filters, highway_layers=highway)
    tm = tl.CharacterTokenEmbedder(12, char_embed_dim=5, filters=filters, highway_layers=highway)
    params = carry(jm, tm, chars)
    want = jm.apply({"params": params}, chars)
    got = tm(torch.from_numpy(chars))
    assert_close(got.detach().numpy(), want)
    np.testing.assert_allclose(got[0, 2].detach().numpy(), params["symbol_embeddings"][0])
    np.testing.assert_allclose(got[1, 3].detach().numpy(), params["symbol_embeddings"][1])
    # gradients through the char CNN, highway and projection
    g = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, chars) ** 2)))(params)
    (got ** 2).sum().backward()
    grads = dict(flat(state_dict_to_flax({k: p.grad for k, p in tm.named_parameters()})))
    for name, want_g in flat(g):
        assert_close(grads[name], want_g, name)
