"""The encoder variants under PDS against the JAX package.

* A tiny EffecientConformer (egs/librispeech/asr/conf/EffecientConformerCTCSmall.yaml
  cut to 3 stages of 1 layer, widths 16 / 24 / 32): the Conv2d subsampler at a
  ratio of -1, a strided, widening conv module in the last layer of stages 0 and
  1.  The forward (within 1e-5 of each tensor's largest magnitude, lengths equal),
  greedy and beam-3 CTC tokens identical, the CTC loss (rtol 1e-5) and every
  gradient (atol 1e-5 of each leaf's largest entry), ``from_flax`` both ways;
* a PDS encoder-decoder with conv strides, widths growing by stage, per-stage CTC
  taps and fusion (the fusion ratio counts the strides): forward;
* PDS ``encoder_attention_type`` rope, local, light and dynamic, and the Conv1d
  subsampler at a ratio of -1 under PDS's default reference pad semantics with
  ``subsampling_norm: layer``: forward.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.models import pds as jpds
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models.build import build_model
from tests.test_torch_conformer import _paths, flax_init, loss_and_grads_match, perturb, rng_batch
from tests.test_torch_variants_models import assert_close
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

# EffecientConformerCTCSmall.yaml's model section at 3 stages of 1 layer and small widths
EFFICIENT = dict(pds_stages=3, pds_ratios=(-1, 0, 0), pds_layers=(1, 1, 1),
                 pds_kernel_sizes=(3, 3, 3), pds_embed_dims=(16, 24, 32),
                 pds_attn_heads=(2, 2, 2), pds_ffn_ratios=(2, 2, 2), pds_position_embed=(1, 1, 1),
                 pds_conv_strides=(2, 2, 1), encoder_embed_dim=32, subsampling_type="conv2d",
                 subsampling_layers=1, subsampling_filter=8, subsampling_kernel=3,
                 subsampling_stride=2, subsampling_norm="batch2d",
                 subsampling_activation="swish", macaron_style=True, use_cnn_module=True,
                 cnn_module_kernel=5, encoder_attention_type="rel_pos",
                 encoder_activation_fn="swish", vocab_size=24, dropout=0.0,
                 attention_dropout=0.0, activation_dropout=0.0)
PDS = dict(pds_stages=3, pds_ratios=(2, 1, 2), pds_layers=(1, 1, 1), pds_kernel_sizes=(3, 3, 3),
           pds_embed_dims=(32, 32, 32), pds_attn_heads=(2, 2, 2), pds_ffn_ratios=(2, 2, 2),
           pds_position_embed=(1, 1, 1), encoder_embed_dim=32, decoder_embed_dim=32,
           decoder_ffn_embed_dim=64, decoder_layers=1, decoder_attention_heads=2, vocab_size=24,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
           share_decoder_input_output_embed=False)
PDS_VARIANTS = {
    "rope": dict(encoder_attention_type="rope"),
    "local": dict(encoder_attention_type="local"),
    "light": dict(encoder_attention_type="light"),
    "dynamic": dict(encoder_attention_type="dynamic"),
    "conv1d_ref_pad": dict(pds_ratios=(-1, 1, 2), subsampling_filter=16,
                           subsampling_norm="layer"),
    # strided, widening stages with per-stage taps and fusion
    "strides_fusion": dict(pds_embed_dims=(16, 24, 32), pds_conv_strides=(2, 1, 2),
                           pds_ratios=(2, 1, 1), use_cnn_module=True, cnn_module_kernel=3,
                           pds_ctc=(1, 1, 1), pds_fusion=True),
}


@pytest.fixture(scope="module")
def efficient():
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_pds(**EFFICIENT))
    feats, lens = rng_batch(0)
    params = perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), feats,
                                                               lens)["params"]))
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_pds(**EFFICIENT), device="cpu")
    return jm, params, load_flax_params(tm, params)


def test_efficient_conformer_forward_matches_jax(efficient):
    jm, params, tm = efficient
    feats, lens = rng_batch(1)
    ref = jax.jit(lambda p: jm.apply({"params": p}, feats, lens))(params)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long())
    # T 40 -> 19 (a valid 3x3 conv at stride 2) -> 10 -> 5: each stride shrinks the lengths
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(), np.asarray(ref["encoder_lengths"]))
    assert out["encoder_out"].shape == (4, 5, 32)
    for key in ("encoder_out", "ctc_logits"):
        assert_close(out[key], ref[key], key)
    enc = params["encoder"]
    assert {"conv_res"} <= set(enc["stage0_layer0"]) and "conv_res" not in enc["stage2_layer0"]
    assert enc["stage0_layer0"]["conv_module"]["depthwise_conv"]["kernel"].shape == (5, 1, 24)
    assert _paths(state_dict_to_flax(tm.state_dict())) == _paths(params)


@pytest.mark.parametrize("beam", [1, 3])
def test_efficient_conformer_ctc_tokens_identical(efficient, beam):
    jm, params, tm = efficient
    feats, lens = rng_batch(2)
    b = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam)).generate(params, b)
    tt, ts, _ = CTCGenerator(tm, CTCDecoder(beam_size=beam)).generate(b)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def test_efficient_conformer_loss_and_grads_match_jax(efficient):
    jm, params, _ = efficient
    feats, lens = rng_batch(3)
    rng = np.random.default_rng(3)
    target = rng.integers(4, 24, size=(4, 4)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]
    batch = {"features": feats, "feat_lengths": lens, "prev_tokens": np.roll(target, 1, 1),
             "target": target, "ntokens": np.float32((target != 1).sum())}
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_pds(**EFFICIENT), device="cpu", for_training=True)
    got = loss_and_grads_match(jm, params, tm, ("ctc", {"ctc_weight": 1.0, "zero_infinity": True}),
                               batch, (batch["features"], batch["feat_lengths"]))
    assert np.abs(got["encoder"]["stage1_layer0"]["conv_res"]["kernel"]).max() > 0


@pytest.mark.parametrize("name", list(PDS_VARIANTS))
def test_pds_variant_forward_matches_jax(name):
    kw = {**PDS, **PDS_VARIANTS[name]}
    jm = jpds.PDSS2TTransformerModel(jpds.pdss2t_transformer_s_8(**kw))
    feats, lens = rng_batch(4)
    prev = np.random.default_rng(4).integers(3, 24, size=(4, 5)).astype(np.int32)
    params = perturb(flax_init(jm, feats, lens, prev))
    tm = load_flax_params(build_model("pdss2t_transformer_s_8", kw, device="cpu"), params)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(), np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        assert_close(out[key], ref[key], key)
    assert len(out["inter_ctc_logits"]) == len(ref["inter_ctc_logits"])
    for (l, got, glen), (jl, want, wlen) in zip(out["inter_ctc_logits"], ref["inter_ctc_logits"]):
        assert l == jl
        np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
        assert_close(got, want, f"inter_ctc_logits @ {l}")
    if name == "strides_fusion":  # stage widths 24, 24, 32 after the widening layers
        assert set(params["encoder"]) >= {"fusion0", "fusion1", "ctc0", "ctc1", "ctc2"}
        # stage 0 reaches the last length through stage 2's stride: a fusion ratio of 2
        assert tm.encoder.fusion_blocks["0"].conv.kernel_size == (2,)
