"""The port's encoder-variant modules against the JAX package on the CPU.

Module by module on the same weights (``from_flax``), inputs from a numpy seed,
fp32 within atol 1e-5 (tokens identical):

* ``rope_tables`` equal, ``apply_rope`` (interleaved pairs) within 1e-6;
* ``MultiHeadAttention``: rope (its fused-kernel case, the plain version here),
  Shaw relative (and at ``kv_stride`` 2), Gaussian local with and without a
  window bias, plain local, reduced keys (``kv_stride`` 2 and 3) over a padded
  batch; Shaw relative in incremental decoding, step by step against JAX's
  cache, and rope in incremental decoding;
* ``LightweightConv`` / ``DynamicConv``, centred and causal, and their
  ``cache=`` steps against the JAX steps and against the full causal pass, and
  both without the weight softmax; ``LightConvBlock`` over a padded batch, with
  and without the GLU;
* ``DLCL.combine`` at every index;
* ``ConformerConvModule`` strided and widening; the encoder layer with a
  strided, widening conv module (pre- and post-norm, macaron) and with each
  attention type;
* ``Conv1dSubsampling`` with ``norm: layer`` and without masking between layers;
* the loss and gradients of whole tiny models with Gaussian local attention under
  a hard window and with dynamic convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.modules import attention as jattn
from s2t_tpu.modules import dlcl as jdlcl
from s2t_tpu.modules import layers as jlayers
from s2t_tpu.modules import lightconv as jlc
from s2t_tpu.modules import positional as jpos
from s2t_tpu.modules import subsampling as jsub
from s2t_tpu_torch.modules import attention as tattn
from s2t_tpu_torch.modules import dlcl as tdlcl
from s2t_tpu_torch.modules import layers as tlayers
from s2t_tpu_torch.modules import lightconv as tlc
from s2t_tpu_torch.modules import positional as tpos
from s2t_tpu_torch.modules import subsampling as tsub
from tests.test_torch_conformer import flax_init, load_module, perturb, rng_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
D, H = 32, 4
LENGTHS = (23, 17, 9, 1)


def _valid(lens, T):
    return np.arange(T)[None] < np.asarray(lens)[:, None]


def test_rope_tables_and_rotation_match_jax():
    cos, sin = tpos.rope_tables(40, 8)
    jcos, jsin = jpos.rope_tables(40, 8)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    x = np.random.default_rng(0).normal(size=(2, 40, 3, 8)).astype(np.float32)
    want = np.asarray(jpos.apply_rope(jnp.asarray(x), jcos, jsin))
    np.testing.assert_allclose(tpos.apply_rope(torch.from_numpy(x), cos, sin).numpy(), want,
                               atol=1e-6)
    # pairs are (0, 1), (2, 3), ...: position 0 is the identity
    np.testing.assert_allclose(want[:, 0], x[:, 0], atol=1e-7)


ATTENTION_CASES = {
    "rope": dict(attention_type="rope"),
    "relative": dict(attention_type="relative", max_relative_length=4),
    "relative_stride2": dict(attention_type="relative", max_relative_length=4, kv_stride=2),
    "local_gauss": dict(attention_type="local", gauss_mask_sigma=3.0, init_mask_weight=0.0),
    "local_gauss_window": dict(attention_type="local", gauss_mask_sigma=2.0, window=5),
    "local": dict(attention_type="local"),
    "abs_window": dict(attention_type="abs", window=4),
    "abs_stride2": dict(attention_type="abs", kv_stride=2),
    "rope_stride3": dict(attention_type="rope", kv_stride=3),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_self_attention_variants_match_jax(case):
    kw = dict(ATTENTION_CASES[case])
    window = kw.pop("window", 0)
    T = 23
    x, lens = rng_batch(1, T=T, C=D, lengths=LENGTHS)
    valid = _valid(lens, T)
    bias = None
    if window:
        bias = np.asarray(jattn.padding_bias(jnp.asarray(valid)) +
                          jattn.local_window_bias(T, window))
    jm = jattn.MultiHeadAttention(D, H, **kw)
    params = perturb(flax_init(jm, x, x, x, bias, True, None, None, valid))
    want, _ = jm.apply({"params": params}, x, x, x, bias, True, valid_mask=valid)
    tm = load_module(tattn.MultiHeadAttention(D, H, **kw), params)
    with torch.no_grad():
        got, _ = tm(*(torch.from_numpy(x),) * 3,
                    None if bias is None else torch.from_numpy(bias),
                    valid_mask=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if case == "local_gauss":
        assert set(params) >= {"gauss_sigma", "gauss_mask_weight"}


@pytest.mark.parametrize("attention_type", ["relative", "rope"])
def test_incremental_self_attention_matches_jax_step_by_step(attention_type):
    """Decoder self-attention over a JAX cache of L slots (a -1e9 step mask) and the
    port's in-place cache read up to the step: the query position is the step's."""
    kw = {"attention_type": attention_type}
    if attention_type == "relative":
        kw["max_relative_length"] = 2  # clipping reached from step 3 on
    B, L = 3, 7
    xs = np.random.default_rng(2).normal(size=(B, L, D)).astype(np.float32)
    jm = jattn.MultiHeadAttention(D, H, **kw)
    params = perturb(flax_init(jm, xs, xs, xs))
    tm = load_module(tattn.MultiHeadAttention(D, H, **kw), params)
    jcache = {"k": jnp.zeros((B, L, H, D // H)), "v": jnp.zeros((B, L, H, D // H))}
    tcache = {"k": torch.zeros(B, L, H, D // H), "v": torch.zeros(B, L, H, D // H)}
    steps = []
    for i in range(L):
        xi = xs[:, i:i + 1]
        want, jcache = jm.apply({"params": params}, xi, xi, xi, None, True, cache=jcache,
                                cache_index=jnp.int32(i))
        with torch.no_grad():
            got, tcache = tm(*(torch.from_numpy(xi),) * 3, cache=tcache, cache_index=i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=str(i))
        steps.append(got)
    # the steps equal the teacher-forced causal pass
    causal = np.asarray(jattn.causal_bias(L))
    full, _ = jm.apply({"params": params}, xs, xs, xs, causal, True)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), np.asarray(full), atol=ATOL)


@pytest.mark.parametrize("conv", ["lightweight", "dynamic"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k", [3, 4])
def test_lightweight_and_dynamic_conv_match_jax(conv, causal, k):
    x = np.random.default_rng(k).normal(size=(2, 11, D)).astype(np.float32)
    jcls, tcls = ((jlc.LightweightConv, tlc.LightweightConv) if conv == "lightweight"
                  else (jlc.DynamicConv, tlc.DynamicConv))
    jm = jcls(D, k, H, causal=causal)
    params = perturb(flax_init(jm, x))
    want, _ = jm.apply({"params": params}, x)
    tm = load_module(tcls(D, k, H, causal=causal), params)
    with torch.no_grad():
        got, none = tm(torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if not causal:
        return
    # incremental: one step at a time over a rolling cache of the k - 1 last inputs
    jcache, tcache = jnp.zeros((2, k - 1, D)), torch.zeros(2, k - 1, D)
    for t in range(x.shape[1]):
        jstep, jcache = jm.apply({"params": params}, x[:, t:t + 1], cache=jcache)
        with torch.no_grad():
            tstep, tcache = tm(torch.from_numpy(x[:, t:t + 1]), cache=tcache)
        np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), atol=ATOL)
        np.testing.assert_allclose(tstep.numpy()[:, 0], got.numpy()[:, t], atol=ATOL)
        np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))


@pytest.mark.parametrize("conv", ["lightweight", "dynamic"])
def test_conv_without_weight_softmax_matches_jax(conv):
    """The raw kernel weights, not softmax-normalised per head."""
    x = np.random.default_rng(5).normal(size=(2, 11, D)).astype(np.float32)
    jcls, tcls = ((jlc.LightweightConv, tlc.LightweightConv) if conv == "lightweight"
                  else (jlc.DynamicConv, tlc.DynamicConv))
    jm = jcls(D, 3, H, weight_softmax=False)
    params = perturb(flax_init(jm, x))
    want, _ = jm.apply({"params": params}, x)
    tm = load_module(tcls(D, 3, H, weight_softmax=False), params)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("glu", [True, False])
@pytest.mark.parametrize("conv", ["lightweight", "dynamic"])
def test_lightconv_block_matches_jax(conv, glu):
    x, lens = rng_batch(3, T=19, C=D, lengths=(19, 12, 5, 1))
    valid = _valid(lens, 19)
    jm = jlc.LightConvBlock(D, D, 5, H, conv_type=conv, glu=glu)
    params = perturb(flax_init(jm, x, valid))
    want, _ = jm.apply({"params": params}, x, valid)
    tm = load_module(tlc.LightConvBlock(D, D, 5, H, conv, glu=glu), params)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dlcl_combine_matches_jax_at_every_index():
    L = 3
    hist = [np.random.default_rng(i).normal(size=(2, 5, D)).astype(np.float32)
            for i in range(L + 1)]
    jm = jdlcl.DLCL(L, D)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), hist, L,
                                            method=jdlcl.DLCL.combine)["params"])
    assert init["weights"].shape == (L + 1, L + 1) and "norm3" in init
    # the port's construction is JAX's init: the running average
    np.testing.assert_allclose(tdlcl.DLCL(L, D).weights.detach().numpy(), init["weights"])
    params = perturb(init)
    tm = load_module(tdlcl.DLCL(L, D), params)
    for idx in range(L + 1):
        want = jm.apply({"params": params}, hist[:idx + 1], idx, method=jdlcl.DLCL.combine)
        with torch.no_grad():
            got = tm.combine([torch.from_numpy(h) for h in hist[:idx + 1]], idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=str(idx))


@pytest.mark.parametrize("out_dim,stride", [(0, 2), (48, 1), (48, 2), (48, 3)])
def test_strided_expanding_conv_module_matches_jax(out_dim, stride):
    x, lens = rng_batch(4, T=23, C=D, lengths=LENGTHS)
    valid = _valid(lens, 23)
    jm = jlayers.ConformerConvModule(D, 5, out_dim=out_dim, stride=stride, use_bias=True)
    params = perturb(flax_init(jm, x, valid))
    want = np.asarray(jm.apply({"params": params}, x, valid))
    tm = load_module(tlayers.ConformerConvModule(D, 5, 0.0, "layer_norm", True, "swish",
                                                 out_dim, stride), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid))
    assert got.shape == want.shape == (4, (23 - 1) // stride + 1, out_dim or D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


LAYER_CASES = {
    # (attention_type, JAX layer keywords)
    "conv_stride_expand_pre": ("rel_pos", dict(conv_expand_dim=48, conv_stride=2,
                                               macaron_ffn_dim=64), True),
    "conv_stride_expand_post": ("abs", dict(conv_expand_dim=48, conv_stride=2,
                                            macaron_ffn_dim=64), False),
    "conv_stride_only": ("abs", dict(conv_stride=2), True),
    "rope": ("rope", {}, True),
    "relative": ("relative", dict(max_relative_length=3), True),
    "relative_stride": ("relative", dict(max_relative_length=3, attention_stride=2), True),
    "local": ("local", dict(gauss_mask_sigma=2.0, init_mask_weight=0.3), False),
    "light": ("light", dict(lconv_kernel=3), True),
    "dynamic": ("dynamic", dict(lconv_kernel=7), False),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_encoder_layer_variants_match_jax(case):
    attention, kw, pre = LAYER_CASES[case]
    conformer = "conv_expand_dim" in kw or "conv_stride" in kw
    x, lens = rng_batch(5, T=23, C=D, lengths=LENGTHS)
    valid = _valid(lens, 23)
    pos = jpos.relative_encoding(23, D) if attention == "rel_pos" else None
    jm = jlayers.S2TEncoderLayer(D, 96 if conformer else 64, H, 0.0, 0.0, 0.0, "swish", pre,
                                 attention, conformer, conformer, 5, conv_activation="swish",
                                 conv_bias=True, **kw)
    params = perturb(flax_init(jm, x, valid, None, pos))
    want = np.asarray(jm.apply({"params": params}, x, valid, None, pos))
    tm = load_module(tlayers.S2TEncoderLayer(
        D, 96 if conformer else 64, H, "swish", pre, attention_type=attention,
        macaron_style=conformer, use_cnn_module=conformer, cnn_kernel=5,
        conv_activation="swish", conv_bias=True, **kw), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid),
                 pos_emb=None if pos is None else tpos.relative_encoding(23, D))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if "conv_expand_dim" in kw:
        assert set(params) >= {"conv_res"} and want.shape == (4, 12, 48)


@pytest.mark.parametrize("norm,mask_between", [("layer", True), ("layer", False),
                                               ("none", False), ("batch1d", True)])
def test_conv1d_subsampling_norm_and_pad_semantics_match_jax(norm, mask_between):
    """``norm: layer`` normalises each conv's output before the gate (any other value is
    inert, as in JAX); without masking between layers the padded tail leaks into the
    valid frames at the boundary, as it does in JAX, on identical padding."""
    x, lens = rng_batch(6, T=37, C=80, lengths=(37, 30, 19, 7))
    jm = jsub.Conv1dSubsampling(2, 16, D, 5, 2, norm, "glu", mask_between)
    params = perturb(flax_init(jm, x, lens))
    want, want_lens = jm.apply({"params": params}, x, lens)
    tm = load_module(tsub.Conv1dSubsampling(80, 2, 16, D, 5, 2, "glu", norm, mask_between),
                     params)
    with torch.no_grad():
        got, got_lens = tm(torch.from_numpy(x), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert ("norm0" in params) == (norm == "layer")


@pytest.mark.parametrize("name", ["local_hard_window", "dynamic"])
def test_variant_loss_and_grads_match_jax(name):
    """Gaussian local attention under a fractional hard window, and dynamic
    convolutions with a kernel plan, trained as whole tiny models (the helper's
    docstring in tests/test_torch_variants_models.py)."""
    from tests.test_torch_variants_models import variant_loss_and_grads_match

    variant_loss_and_grads_match(name)
