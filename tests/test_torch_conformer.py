"""The port's Conformer block and Conv2d subsampler against the JAX package on the CPU.

Module by module on the same weights (``from_flax``), inputs from a numpy seed:

* ``relative_encoding`` equal (both float64 rounded to f32) at T = 1, 7, 40;
  ``rel_shift`` equal element for element at T = 1, 2, 7 and 16;
* ``RelPositionMultiHeadAttention`` over a padded batch (a length-1 row) and at
  T = 1: fp32 within atol 1e-5; bf16 (the JAX cast points) within 1.5e-2 of
  JAX's bf16 output in relative Frobenius norm, and no farther from the fp32
  output than 1.5x JAX's bf16 output is;
* ``ConformerConvModule`` with the layer norm and with the frozen batch-norm
  affine, with and without biases: atol 1e-5;
* the Conformer layer (macaron FFN, conv module, final norm) with rel_pos and
  with abs attention (the fused kernel's plain version), pre- and post-norm:
  atol 1e-5;
* ``Conv2dSubsampling`` with ``valid`` and ``same`` padding, with and without
  ``mask_between``, GLU and swish: lengths equal, outputs atol 1e-5;
* ``s2t_conformer`` (2 layers of 64, kernel 7, swish, one decoder layer): the
  forward (atol 1e-5), beam-5 tokens identical at ``max_len_a`` 0.5, the loss of
  label-smoothed CE + 0.3 CTC (rtol 1e-5) and every gradient (atol 1e-5 of each
  leaf's largest entry), ``from_flax`` both ways;
* a Conformer ``s2t_ctc`` (ConformerCTCSmall's shape cut to 2 x 64: Conv2d
  subsampler, swish, batch-norm conv module): greedy and prefix-beam tokens
  identical, the CTC loss and every gradient as above;
* a post-norm ``s2t_transformer`` behind a same-padded ReLU Conv2d front end
  without CTC: forward;
* ``cli.train`` (one epoch from raw audio, one flax init) and ``cli.generate``
  of a Conformer CTC config give the JAX CLIs' validation losses (rtol 1e-4)
  and T-/H-/D- lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.modules import attention as jattn
from s2t_tpu.modules import layers as jlayers
from s2t_tpu.modules import positional as jpos
from s2t_tpu.modules import subsampling as jsub
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.modules import attention as tattn
from s2t_tpu_torch.modules import layers as tlayers
from s2t_tpu_torch.modules import positional as tpos
from s2t_tpu_torch.modules import subsampling as tsub
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
BF16_RTOL = 1.5e-2  # relative Frobenius error, about two bf16 epsilons
D, H = 64, 4
LENGTHS = (40, 33, 21, 1)
CONFORMER = dict(encoder_embed_dim=D, encoder_ffn_embed_dim=128, encoder_layers=2,
                 encoder_attention_heads=H, cnn_module_kernel=7, decoder_embed_dim=D,
                 decoder_ffn_embed_dim=128, decoder_layers=1, decoder_attention_heads=H,
                 vocab_size=32, max_target_positions=64, dropout=0.0, attention_dropout=0.0,
                 activation_dropout=0.0, share_decoder_input_output_embed=False)
# egs/librispeech/asr/conf/ConformerCTCSmall.yaml at 2 layers of 64 and 16 conv2d filters
CONFORMER_CTC = dict(encoder_embed_dim=D, encoder_ffn_embed_dim=128, encoder_layers=2,
                     encoder_attention_heads=H, subsampling_type="conv2d", subsampling_layers=2,
                     subsampling_filter=16, subsampling_kernel=3, subsampling_stride=2,
                     subsampling_norm="batch2d", subsampling_activation="swish",
                     macaron_style=True, use_cnn_module=True, cnn_module_kernel=7,
                     cnn_module_norm="batch_norm", encoder_attention_type="rel_pos",
                     encoder_activation_fn="swish", vocab_size=32, dropout=0.0,
                     attention_dropout=0.0, activation_dropout=0.0)
CTC_LENGTHS = (40, 33, 21, 7)  # a valid 3x3 conv2d pair leaves 1 frame of 7


def rng_batch(seed, B=4, T=40, C=80, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, T, C)).astype(np.float32), np.array(lengths[:B], np.int32)


def flax_init(module, *args):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0), *args)["params"])


def load_module(module, params):
    """A flax module's own params tree into the port module (no model prefix)."""
    sd = {k[2:]: v for k, v in flax_to_state_dict({"m": params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


def perturb(params, seed=7):
    """Random values in place of flax's ones/zeros inits, so that every leaf counts."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype), params)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [1, 7, 40])
def test_relative_encoding_matches_jax(T):
    want = np.asarray(jpos.relative_encoding(T, D))
    assert want.shape == (2 * T - 1, D)
    np.testing.assert_array_equal(tpos.relative_encoding(T, D).numpy(), want)
    table = tpos.relative_table(T, D, torch.bfloat16, torch.device("cpu"))
    want16 = np.asarray(jpos.relative_encoding(T, D, jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(table.float().numpy(), want16)


@pytest.mark.parametrize("T", [1, 2, 7, 16])
def test_rel_shift_matches_jax_element_for_element(T):
    x = np.random.default_rng(T).normal(size=(2, 3, T, 2 * T - 1)).astype(np.float32)
    want = np.asarray(jattn.RelPositionMultiHeadAttention._rel_shift(jnp.asarray(x)))
    got = tattn.RelPositionMultiHeadAttention.rel_shift(torch.from_numpy(x))
    assert got.shape == (2, 3, T, T)
    np.testing.assert_array_equal(got.numpy(), want)
    # a strided (non-contiguous) input gives the same
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
    np.testing.assert_array_equal(tattn.RelPositionMultiHeadAttention.rel_shift(xt).numpy(), want)


def _rel_attention_case(T, lengths, dtype, jdtype):
    x, lens = rng_batch(3, B=len(lengths), T=T, C=D, lengths=lengths)
    valid = np.arange(T)[None] < lens[:, None]
    jm = jattn.RelPositionMultiHeadAttention(D, H, dtype=jdtype)
    pos = jpos.relative_encoding(T, D, jdtype)
    bias = jattn.padding_bias(jnp.asarray(valid), jdtype)
    xj = jnp.asarray(x, jdtype)
    params = perturb(flax_init(jm, xj, xj, xj, pos, bias))
    want = np.asarray(jm.apply({"params": params}, xj, xj, xj, pos, bias), np.float32)
    tm = load_module(tattn.RelPositionMultiHeadAttention(D, H), params).to(dtype)
    with torch.no_grad():
        pos = tpos.relative_table(T, D, dtype, torch.device("cpu"))
        got = tm(torch.from_numpy(x).to(dtype), pos,
                 tattn.padding_bias(torch.from_numpy(valid), dtype))
    return got.float().numpy(), want


@pytest.mark.parametrize("T,lengths", [(23, (23, 17, 1)), (1, (1, 1))])
def test_rel_pos_attention_matches_jax(T, lengths):
    got, want = _rel_attention_case(T, lengths, torch.float32, jnp.float32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rel_pos_attention_bf16_matches_jax():
    """bf16 (each op rounds, as a bf16 ulp of these O(4) outputs is 0.016): the port's
    output lies within BF16_RTOL of JAX's in relative Frobenius norm, and no farther
    from the fp32 output than 1.5x JAX's own bf16 output is."""
    got, want = _rel_attention_case(23, (23, 17, 1), torch.bfloat16, jnp.bfloat16)
    _, want32 = _rel_attention_case(23, (23, 17, 1), torch.float32, jnp.float32)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(got, want) < BF16_RTOL
    assert rel(got, want32) <= 1.5 * rel(want, want32)


@pytest.mark.parametrize("norm_type,bias", [("layer_norm", True), ("layer_norm", False),
                                             ("batch_norm", False)])
def test_conv_module_matches_jax(norm_type, bias):
    x, lens = rng_batch(4, T=23, C=D, lengths=(23, 17, 9, 1))
    valid = np.arange(23)[None] < lens[:, None]
    jm = jlayers.ConformerConvModule(D, 7, norm_type=norm_type, use_bias=bias)
    params = perturb(flax_init(jm, x, valid))
    want = np.asarray(jm.apply({"params": params}, x, valid))
    tm = load_module(tlayers.ConformerConvModule(D, 7, 0.0, norm_type, bias), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("attention", ["rel_pos", "abs"])
@pytest.mark.parametrize("normalize_before", [True, False])
def test_conformer_layer_matches_jax(attention, normalize_before):
    x, lens = rng_batch(5, T=23, C=D, lengths=(23, 17, 9, 1))
    valid = np.arange(23)[None] < lens[:, None]
    jm = jlayers.S2TEncoderLayer(D, 128, H, 0.0, 0.0, 0.0, "swish", normalize_before, attention,
                                 True, True, 7, conv_activation="swish",
                                 conv_norm_type="layer_norm", conv_bias=False)
    pos = jpos.relative_encoding(23, D) if attention == "rel_pos" else None
    params = perturb(flax_init(jm, x, valid, None, pos))
    assert {"macaron_norm", "macaron_ffn", "conv_norm", "conv_module", "final_norm"} <= set(params)
    want = np.asarray(jm.apply({"params": params}, x, valid, None, pos))
    tm = load_module(tlayers.S2TEncoderLayer(
        D, 128, H, "swish", normalize_before, attention_type=attention, macaron_style=True,
        use_cnn_module=True, cnn_kernel=7, conv_activation="swish", conv_bias=False), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid),
                 pos_emb=None if pos is None else tpos.relative_encoding(23, D))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("padding", ["valid", "same"])
@pytest.mark.parametrize("mask_between", [True, False])
@pytest.mark.parametrize("activation", ["glu", "swish"])
def test_conv2d_subsampling_matches_jax(padding, mask_between, activation):
    x, lens = rng_batch(6, T=37, C=80, lengths=(37, 30, 19, 7))
    jm = jsub.Conv2dSubsampling(2, 8, 48, 80, 3, 2, activation, padding=padding,
                                mask_between=mask_between)
    params = perturb(flax_init(jm, x, lens))
    want, want_lens = jm.apply({"params": params}, x, lens)
    tm = load_module(tsub.Conv2dSubsampling(80, 2, 8, 48, 3, 2, activation, padding,
                                            mask_between), params)
    with torch.no_grad():
        got, got_lens = tm(torch.from_numpy(x), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --------------------------------------------------------------------------- #
# whole models
@pytest.fixture(scope="module")
def conformer_pair():
    jm = jst.S2TTransformerModel(jst.s2t_conformer(**CONFORMER))
    feats, lens = rng_batch(0)
    prev = np.random.default_rng(0).integers(3, 32, size=(4, 7)).astype(np.int32)
    params = perturb(flax_init(jm, feats, lens, prev))
    tm = tst.S2TTransformerModel(tst.s2t_conformer(**CONFORMER), device="cpu", seed=1)
    load_flax_params(tm, params)
    return jm, params, tm


def test_s2t_conformer_forward_matches_jax(conformer_pair):
    jm, params, tm = conformer_pair
    feats, lens = rng_batch(1)
    prev = np.random.default_rng(1).integers(3, 32, size=(4, 7)).astype(np.int32)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


def test_s2t_conformer_beam_tokens_identical(conformer_pair):
    jm, params, tm = conformer_pair
    feats, lens = rng_batch(2)
    batch = {"features": feats, "feat_lengths": lens}
    opts = dict(beam_size=5, max_len_a=0.5, max_len_b=2)
    jt, js, _ = JaxGenerator(jm, **opts).generate(params, batch)
    tt, ts, _ = SequenceGenerator(tm, **opts).generate(batch)
    assert tt.shape == np.asarray(jt).shape == (4, 5, 7)  # 0.5 * 10 encoder frames + 2
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


def _paths(tree):
    return {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_s2t_conformer_from_flax_maps_every_leaf(conformer_pair):
    _, params, tm = conformer_pair
    back = state_dict_to_flax(tm.state_dict())
    assert _paths(back) == _paths(params)
    layer = params["encoder"]["layer0"]
    assert {"pos_bias_u", "pos_bias_v", "pos_proj"} <= set(layer["self_attn"])
    depthwise = back["encoder"]["layer0"]["conv_module"]["depthwise_conv"]["kernel"]
    np.testing.assert_array_equal(depthwise, layer["conv_module"]["depthwise_conv"]["kernel"])
    assert tm.state_dict()["encoder.layers.0.conv_module.depthwise_conv.weight"].shape == (D, 1, 7)


def _train_batch(seed, lengths):
    rng = np.random.default_rng(seed)
    feats, lens = rng_batch(seed, lengths=lengths)
    target = rng.integers(4, 32, size=(4, 5)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]
    return {"features": feats, "feat_lengths": lens, "prev_tokens": np.roll(target, 1, 1),
            "target": target, "ntokens": np.float32((target != 1).sum())}


def loss_and_grads_match(jm, params, tm, criterion, batch, args):
    jcrit = jax_build_criterion(*criterion)

    def jax_loss(p):
        loss, sample_size, logs = jcrit(jm.apply({"params": p}, *args), batch)
        return loss, (sample_size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)
    load_flax_params(tm, params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    targs = [tb["features"], tb["feat_lengths"].long()]
    if len(args) == 3:
        targs.append(tb["prev_tokens"].long())
    loss, size, logs = build_criterion(*criterion)(tm(*targs), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logs["ctc_loss"].item(), float(jlogs["ctc_loss"]), rtol=1e-5)
    assert size.item() == float(jsize)
    got = state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})
    assert _paths(got) == _paths(jgrads)
    for (path, g), (_, want) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                    jax.tree_util.tree_flatten_with_path(jgrads)[0]):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))
    return got


def test_s2t_conformer_loss_and_grads_match_jax(conformer_pair):
    jm, params, _ = conformer_pair
    batch = _train_batch(4, LENGTHS)
    tm = tst.S2TTransformerModel(tst.s2t_conformer(**CONFORMER), device="cpu", for_training=True)
    got = loss_and_grads_match(
        jm, params, tm, ("label_smoothed_cross_entropy_with_ctc",
                         {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}}),
        batch, (batch["features"], batch["feat_lengths"], batch["prev_tokens"]))
    assert np.abs(got["encoder"]["layer0"]["self_attn"]["pos_bias_u"]).max() > 0


@pytest.fixture(scope="module")
def conformer_ctc_pair():
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_base(**CONFORMER_CTC))
    feats, lens = rng_batch(0, lengths=CTC_LENGTHS)
    params = perturb(flax_init(jm, feats, lens))
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_base(**CONFORMER_CTC), device="cpu", seed=1)
    load_flax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("beam", [1, 5])
def test_conformer_ctc_tokens_identical(conformer_ctc_pair, beam):
    jm, params, tm = conformer_ctc_pair
    feats, lens = rng_batch(3, lengths=CTC_LENGTHS)
    batch = {"features": feats, "feat_lengths": lens}
    jt, js, jenc = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam)).generate(params, batch)
    tt, ts, enc = CTCGenerator(tm, CTCDecoder(beam_size=beam)).generate(batch)
    np.testing.assert_array_equal(enc["encoder_lengths"].numpy(), [9, 7, 4, 1])
    np.testing.assert_allclose(enc["ctc_logits"].numpy(), np.asarray(jenc["ctc_logits"]),
                               atol=ATOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


def test_conformer_ctc_loss_and_grads_match_jax(conformer_ctc_pair):
    jm, params, _ = conformer_ctc_pair
    batch = _train_batch(5, CTC_LENGTHS)
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_base(**CONFORMER_CTC), device="cpu", for_training=True)
    got = loss_and_grads_match(jm, params, tm, ("ctc", {"ctc_weight": 1.0, "zero_infinity": True}),
                               batch, (batch["features"], batch["feat_lengths"]))
    conv = got["encoder"]["layer1"]["conv_module"]
    assert np.abs(conv["norm_scale"]).max() > 0 and np.abs(got["encoder"]["subsample"]["conv0"][
        "kernel"]).max() > 0


def test_conv2d_front_end_post_norm_forward_matches_jax():
    kw = dict(encoder_embed_dim=D, decoder_embed_dim=D, encoder_ffn_embed_dim=128,
              decoder_ffn_embed_dim=128, encoder_layers=1, decoder_layers=1,
              encoder_attention_heads=H, decoder_attention_heads=H, vocab_size=32, dropout=0.0,
              subsampling_type="conv2d", subsampling_kernel=3, subsampling_padding="same",
              subsampling_activation="relu", subsampling_filter=D,
              encoder_normalize_before=False, decoder_normalize_before=False, use_ctc=False)
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**kw))
    feats, lens = rng_batch(8, lengths=CTC_LENGTHS)
    prev = np.random.default_rng(8).integers(3, 32, size=(4, 5)).astype(np.int32)
    params = perturb(flax_init(jm, feats, lens, prev))
    tm = load_flax_params(tst.S2TTransformerModel(tst.s2t_transformer_s(**kw), device="cpu"),
                          params)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    assert out["ctc_logits"] is None and ref["ctc_logits"] is None
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "decoder_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


@pytest.mark.parametrize("field,value,item", [
    ("pipeline_parallel", 2, "item 12"),
])
def test_unported_conformer_branches_raise_by_name(field, value, item):
    # ``item``: the ROADMAP.md item that ported the branch, which raised naming it before;
    # the Conformer's pipelined stack builds, and an uneven split raises JAX's error
    m = tst.S2TTransformerModel(tst.s2t_conformer(**{**CONFORMER, field: value}), device="cpu")
    assert len(m.encoder.pipe_stages) == value and len(m.encoder.layers) == 0
    with pytest.raises(ValueError, match="divide evenly") as e:
        tst.S2TTransformerModel(tst.s2t_conformer(**{**CONFORMER, field: value + 1}),
                                device="cpu")
    assert f"pipeline_parallel={value + 1} stages" in str(e.value)
    # subsampling_norm is inert under conv2d and, but for "layer", under conv1d (as in JAX)
    m = tst.S2TTransformerModel(tst.s2t_conformer(**CONFORMER, subsampling_norm="batch2d"),
                                device="cpu")
    assert m.encoder.subsample.norms is None


@pytest.mark.parametrize("field,value", [
    ("encoder_attention_type", "relative"),
    ("encoder_attention_type", "rope"),
    ("subsampling_ref_pad_semantics", True),
    ("use_enc_dlcl", True),
])
def test_conformer_variant_branches_match_jax(field, value):
    """The encoder variants inside a Conformer block (macaron FFN, conv module): the
    forward agrees with JAX within 1e-5 of each tensor's largest magnitude."""
    kw = {**CONFORMER, field: value}
    if value == "relative":
        kw["max_encoder_relative_length"] = 4
    jm = jst.S2TTransformerModel(jst.s2t_conformer(**kw))
    feats, lens = rng_batch(9)
    prev = np.random.default_rng(9).integers(3, 32, size=(4, 5)).astype(np.int32)
    params = perturb(flax_init(jm, feats, lens, prev))
    tm = load_flax_params(tst.S2TTransformerModel(tst.s2t_conformer(**kw), device="cpu"), params)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), want, err_msg=key,
                                   atol=ATOL * max(1.0, np.abs(want).max()))


# --------------------------------------------------------------------------- #
# the CLIs: a Conformer CTC model section from raw audio
from tests.test_torch_pds_cli import corpus  # noqa: E402,F401  (the shared wav corpus fixture)

CLI_MODEL = {**{k: v for k, v in CONFORMER_CTC.items() if k != "vocab_size"},
             "encoder_embed_dim": 32, "encoder_ffn_embed_dim": 64, "encoder_layers": 1,
             "encoder_attention_heads": 2, "subsampling_filter": 8}


def _cli_cfg(root, save_dir, results):
    return {
        "arch": "s2t_ctc", "criterion": "ctc",
        "criterion_cfg": {"ctc_weight": 1.0, "zero_infinity": True},
        "model": dict(CLI_MODEL),
        "dataset": {"data": str(root), "max_tokens": 80000, "max_source_positions": 9000,
                    "max_target_positions": 16, "num_buckets": 2,
                    "required_batch_size_multiple": 2, "gen_subset": "test"},
        "optimization": {"lr": 1e-3, "warmup_updates": 2, "max_epoch": 1},
        "checkpoint": {"save_dir": str(save_dir), "async_save": False, "reset_optimizer": True,
                       "no_save": True},
        "common": {"log_interval": 1},
        "generation": {"beam": 2, "max_len_b": 8, "scoring": "wer", "post_process": None,
                       "results_path": str(results)},
    }


def cli_round_trip(corpus, tmp_path, cfg_fn, loss_keys, init_args):
    """Both CLIs train an epoch (one update) from one flax init and validate, then decode
    the feature split with the trained weights.  (One epoch: JAX's CLI compiles its train
    step again for its second, the state's placement having changed.)"""
    from s2t_tpu.cli import generate as jax_generate
    from s2t_tpu.cli import train as jax_train
    from s2t_tpu.config import TrainConfig as JaxTrainConfig
    from s2t_tpu.config import from_dict as jax_from_dict
    from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
    from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
    from s2t_tpu.tasks import setup_task as jax_setup_task
    from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
    from s2t_tpu.utils.checkpoint import save_pytree
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
    from s2t_tpu_torch.utils.checkpoint import save_tree

    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, cfg_fn(corpus, corpus, corpus)))
    params = jax.tree.map(np.asarray, jax.jit(jtask.build_model().init)(
        jax.random.PRNGKey(0), *init_args)["params"])
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
    save_pytree(tmp_path / "jax" / "checkpoint_last.pt", {"params": params})
    save_tree(tmp_path / "port" / "checkpoint_last.pt", {"params": flax_to_state_dict(params)})
    want = jax_train.main(jax_from_dict(JaxTrainConfig, cfg_fn(corpus, tmp_path / "jax",
                                                               tmp_path)))
    got = cli_train.main(from_dict(TrainConfig, cfg_fn(corpus, tmp_path / "port", tmp_path)),
                         device="cpu")
    assert got["trainer"].step == int(want["state"].step) == 1
    for mine, theirs in zip(got["history"], want["history"], strict=True):
        for key in loss_keys:
            np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-4, err_msg=key)

    trained = jax.tree.map(np.asarray, want["state"].params)
    jcfg = jax_from_dict(JaxTrainConfig, cfg_fn(corpus, tmp_path, tmp_path / "jgen"))
    jax_generate.main(jcfg, trained, task=JaxTask(jcfg, JaxDataConfig(),
                                                  JaxDictionary.load(corpus / "dict.txt"), None))
    cfg = from_dict(TrainConfig, cfg_fn(corpus, tmp_path, tmp_path / "pgen"))
    task = SpeechToTextTask(cfg, S2TDataConfig(), Dictionary.load(corpus / "dict.txt"))
    out = cli_generate.main(cfg, flax_to_state_dict(trained), task=task, device="cpu")
    assert out["n_utts"] == 4

    def lines(tag, who):
        text = (tmp_path / who / "generate-test.txt").read_text().splitlines()
        return [line for line in text if line.startswith(tag)]

    assert len(lines("H-", "pgen")) == 4
    for tag in ("T-", "H-", "D-"):
        assert lines(tag, "pgen") == lines(tag, "jgen"), tag


def test_conformer_ctc_cli_train_and_generate_match_jax(corpus, tmp_path):
    cli_round_trip(corpus, tmp_path, _cli_cfg, ("loss", "ctc_loss"),
                   (np.zeros((2, 64, 80), np.float32), np.array([64, 40], np.int32)))
