"""The encoder variants as whole ``s2t_transformer`` models against the JAX package.

Tiny models (2 encoder layers of 32, 2 heads, one decoder layer, vocab 24,
dropout 0) initialised by flax, perturbed so every leaf counts, carried across
by ``from_flax``; inputs from a numpy seed:

* forward tensors (encoder output, CTC logits, decoder logits) within 1e-5 of each
  tensor's largest magnitude and ``from_flax`` both ways, for DLCL, Shaw relative (encoder 3, decoder 2),
  Gaussian local with and without a fractional hard window,
  ``encoder_attention_window``, rope, reduced attention, ``encoder_embed_linear``,
  lightweight and dynamic convolutions with a kernel plan,
  ``subsampling_ref_pad_semantics`` under Conv1d (with ``subsampling_norm: layer``),
  and ``convtransformer`` (with the reference pad semantics under Conv2d);
* beam-5 tokens identical for the relative model (its decoder's relative
  self-attention in incremental decoding) and for DLCL;
* (``variant_loss_and_grads_match``, run by tests/test_torch_variants_train.py and
  tests/test_torch_variants.py) the loss of label-smoothed CE + 0.3 CTC (rtol 1e-5)
  and every gradient (atol 1e-5 of each leaf's largest entry);
* a window beside an inter-mixup inside the stack, with JAX's draws handed over
  (JAX drops the window after the mixup; the port does the same).
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_transformer as tst
from tests.test_torch_conformer import _paths, loss_and_grads_match, perturb
from tests.test_torch_ctc_stack import LOGIT_KEYS, TAP_KEYS, TINY, model_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
BASE = {**TINY, "encoder_layers": 2}
VARIANTS = {
    "dlcl": dict(use_enc_dlcl=True),
    "relative": dict(encoder_attention_type="relative", max_encoder_relative_length=3,
                     max_decoder_relative_length=2),
    "local": dict(encoder_attention_type="local", gauss_mask_sigma=3.0, init_mask_weight=0.0),
    "local_hard_window": dict(encoder_attention_type="local", gauss_mask_sigma=2.0,
                              hard_mask_window=0.3),
    "window": dict(encoder_attention_window=3),
    "rope": dict(encoder_attention_type="rope"),
    "reduced": dict(encoder_attention_stride=2),
    "embed_linear": dict(encoder_embed_linear=True, encoder_embed_norm=True),
    "light": dict(encoder_attention_type="light", encoder_lconv_kernels=(3,)),
    "dynamic": dict(encoder_attention_type="dynamic", encoder_lconv_kernels=(3, 7, 15)),
    "conv1d_ref_pad": dict(subsampling_ref_pad_semantics=True, subsampling_norm="layer"),
}
CONVTRANSFORMER = dict(encoder_embed_dim=32, decoder_embed_dim=32, encoder_ffn_embed_dim=64,
                       decoder_ffn_embed_dim=64, encoder_layers=2, decoder_layers=1,
                       encoder_attention_heads=2, decoder_attention_heads=2, vocab_size=24,
                       dropout=0.0, share_decoder_input_output_embed=False,
                       subsampling_ref_pad_semantics=True)


def assert_close(got, want, key=""):
    """Within 1e-5 of the reference's largest magnitude (at least 1e-5)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=key)


def assert_encoder_matches(out, ref):
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    assert_close(out["encoder_out"], ref["encoder_out"], "encoder_out")
    for key in LOGIT_KEYS:
        assert (out[key] is None) == (ref[key] is None), key
        if ref[key] is not None:
            assert_close(out[key], ref[key], key)
    for key in TAP_KEYS:
        assert [l for l, _ in out[key]] == [l for l, _ in ref[key]], key
        for (l, got), (_, want) in zip(out[key], ref[key]):
            assert_close(got, want, f"{key} @ {l}")


def make_pair(kw, preset="s2t_transformer_s", base=BASE):
    batch = model_batch(0)
    jcfg = getattr(jst, preset)(**base, **kw)
    jm = jst.S2TTransformerModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0), batch["features"], batch["feat_lengths"],
                     batch["prev_tokens"])["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    tm = tst.S2TTransformerModel(getattr(tst, preset)(**base, **kw), device="cpu", seed=1)
    return jm, params, load_flax_params(tm, params)


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair(pairs, name):
    if name not in pairs:
        pairs[name] = (make_pair(CONVTRANSFORMER, "convtransformer", {})
                       if name == "convtransformer" else make_pair(VARIANTS[name]))
    return pairs[name]


@pytest.mark.parametrize("name", list(VARIANTS) + ["convtransformer"])
def test_variant_forward_matches_jax(pairs, name):
    jm, params, tm = pair(pairs, name)
    batch = model_batch(1)
    ref = jm.apply({"params": params}, batch["features"], batch["feat_lengths"],
                   batch["prev_tokens"])
    with torch.no_grad():
        out = tm(torch.from_numpy(batch["features"]), torch.from_numpy(batch["feat_lengths"]).long(),
                 torch.from_numpy(batch["prev_tokens"]))
    assert_encoder_matches(out, ref)
    assert_close(out["decoder_logits"], ref["decoder_logits"], "decoder_logits")
    back = state_dict_to_flax(tm.state_dict())
    assert _paths(back) == _paths(params)
    enc = params["encoder"]
    expect = {"dlcl": ("dlcl", "weights"), "embed_linear": ("embed_linear", "kernel"),
              "conv1d_ref_pad": ("subsample", "norm1")}
    if name in expect:
        a, b = expect[name]
        assert b in enc[a]
    if name == "relative":
        assert enc["layer0"]["self_attn"]["relative_position_keys"].shape == (7, 16)
        assert params["decoder"]["layer0"]["self_attn"]["relative_position_keys"].shape == (5, 16)
    if name == "dynamic":  # the kernel plan: 3 then 7
        assert enc["layer1"]["self_attn"]["conv"]["weight_linear"]["kernel"].shape == (32, 14)
    if name == "convtransformer":
        assert out["ctc_logits"] is None and tm.cfg.subsampling_padding == "same"


@pytest.mark.parametrize("name", ["relative", "dlcl"])
def test_variant_beam_tokens_identical(pairs, name):
    jm, params, tm = pair(pairs, name)
    batch = model_batch(2)
    batch = {"features": batch["features"], "feat_lengths": batch["feat_lengths"]}
    opts = dict(beam_size=5, max_len_a=0.0, max_len_b=6)
    jt, js, _ = JaxGenerator(jm, **opts).generate(params, batch)
    tt, ts, _ = SequenceGenerator(tm, **opts).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


def variant_loss_and_grads_match(name):
    jm, params, _ = make_pair(VARIANTS[name])
    b = model_batch(3)
    batch = {"features": b["features"], "feat_lengths": b["feat_lengths"],
             "prev_tokens": b["prev_tokens"], "target": b["target"],
             "ntokens": np.float32((b["target"] != 1).sum())}
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**BASE, **VARIANTS[name]), device="cpu",
                                 for_training=True)
    got = loss_and_grads_match(
        jm, params, tm, ("label_smoothed_cross_entropy_with_ctc",
                         {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}}),
        batch, (batch["features"], batch["feat_lengths"], batch["prev_tokens"]))
    # the variant's own parameters take a gradient
    node = got["encoder"]["dlcl"] if name == "dlcl" else got["encoder"]["layer0"]["self_attn"]
    assert max(np.abs(v).max() for v in jax.tree.leaves(node)) > 0


def test_window_after_an_inter_mixup_in_the_stack_matches_jax(monkeypatch):
    """JAX rebuilds only the padding bias after a mixup inside the stack
    (s2t_tpu/models/s2t_transformer.py:781): the layers after it attend unwindowed."""
    kw = dict(encoder_attention_window=2, inter_mixup=True, inter_mixup_layer=2,
              inter_mixup_ratio=0.5)
    jm, params, tm = make_pair(kw)
    batch = model_batch(4)
    for key in range(16):
        ref = jm.apply({"params": params}, batch["features"], batch["feat_lengths"],
                       batch["prev_tokens"], deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(key)})
        if bool(np.asarray(ref["mixup"]["flag"]).any()):
            break
    draws = {k: (v if k == "keep_boundary" else np.asarray(v)) for k, v in ref["mixup"].items()}
    monkeypatch.setattr(tst, "draw_mixup", lambda B, cfg, seed, step=None: draws)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = tm(t["features"], t["feat_lengths"].long(), t["prev_tokens"], train=True,
                 generator=torch.Generator().manual_seed(0))
    assert_encoder_matches(out, ref)
