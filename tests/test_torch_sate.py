"""The port's SATE (s2t_sate, s2t_ctc_sate) and the model registry against the JAX
package on the CPU.

Tiny configs: an acoustic encoder of one layer of 64 (s2t_transformer) or a
3-stage PDS encoder (dims 32/48/64, ratios 2/2/2), one textual layer, one
decoder layer, 4 heads, vocab 32, dropout 0; weights are flax's (perturbed
so that every leaf counts), carried across with ``from_flax``; B = 4 at
T = 40 with lengths (40, 33, 21, 1).

* every ``Adapter`` type (and ``embed_norm`` / ``out_norm``): atol 1e-5;
* ``ctc_shrink_matrix``: the lengths and the avg matrix equal, the weighted and
  softmax ones within 1e-6, with repeats, blanks and an all-blank row;
* ``TextualEncoder`` on the fused-attention path against the JAX dense path,
  with a 0-length row (uniform attention over all T keys): atol 1e-5;
* the SATE model over the transformer and the PDS acoustic encoder, with the
  shrink bridge (and an all-blank CTC head: every textual row 0 long), with
  rel_pos textual attention: ``encoder_out``, ``ctc_logits``,
  ``decoder_logits`` within atol 1e-5 of each tensor's largest magnitude,
  lengths equal; beam-5 tokens identical
  at ``max_len_a`` 0.5, where the bound is the acoustic subsampler's T/4 even
  over a PDS encoder that shrinks by 8 (mirrored); the loss of label-smoothed
  CE + CTC (rtol 1e-5) and every gradient (atol 1e-5 of each leaf's largest
  entry), with ``freeze_acoustic_encoder`` too, the CTC under shrink over
  the shrunk lengths (mirrored);
* the textual encoder takes the fused-attention path: one call per acoustic and
  textual layer an encode;
* ``s2t_ctc_sate``: greedy and prefix-beam tokens identical;
* ``from_flax`` both ways; the unported SATE fields raise by name, and the
  textual CTC research stack's fields build and run a forward;
* the registry: every JAX architecture is registered in the port, and each
  unported one raises ``NotImplementedError`` naming its ROADMAP.md item;
* the recipe census: every ``egs/**/*.yaml`` that names a SATE or Conformer
  arch or sets rel_pos / macaron_style / use_cnn_module resolves to the JAX
  preset's fields and builds at a tiny depth (36, the CTC-Aug and BiL-CTC
  progressive recipes among them), or raises naming an item-7 field (the two
  EffecientConformer recipes);
* ``cli.train`` (one epoch from raw audio, one flax init) and ``cli.generate`` of
  a SATE config give the JAX CLIs' validation losses (rtol 1e-4) and
  T-/H-/D- lines.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu.models import sate as jsate
from s2t_tpu.modules import adapter as jadapter
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models import sate as tsate
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.modules import adapter as tadapter
from tests.test_torch_conformer import (
    ATOL, _paths, _train_batch, cli_round_trip, flax_init, load_module, loss_and_grads_match,
    perturb, rng_batch)
from tests.test_torch_pds_cli import corpus  # noqa: F401  (the shared wav corpus fixture)
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
D = 64
SATE = dict(acoustic_encoder_embed_dim=D, acoustic_encoder_ffn_embed_dim=128,
            acoustic_encoder_layers=1, acoustic_encoder_attention_heads=4,
            acoustic_decoder_embed_dim=D, acoustic_decoder_ffn_embed_dim=128,
            acoustic_decoder_layers=1, acoustic_decoder_attention_heads=4,
            acoustic_dropout=0.0, acoustic_attention_dropout=0.0,
            acoustic_activation_dropout=0.0, acoustic_share_decoder_input_output_embed=False,
            adapter_type="league", text_encoder_layers=1, text_attention_heads=4,
            text_ffn_embed_dim=128, vocab_size=32, max_target_positions=64)
PDS = dict(acoustic_encoder="pds", pds_stages=3, pds_ratios=(2, 2, 2), pds_layers=(1, 1, 1),
           pds_kernel_sizes=(5, 5, 5), pds_embed_dims=(32, 48, 64), pds_attn_heads=(4, 4, 4),
           pds_ffn_ratios=(2, 2, 2), pds_position_embed=(1, 1, 1))
VARIANTS = {
    "league": {},
    "pds_inter_league": {**PDS, "adapter_type": "inter_league"},
    "shrink": {"adapter_type": "shrink", "adapter_shrink_strategy": "weighted"},
    "text_rel_pos": {"text_attention_type": "rel_pos", "textual_encoder_embed_norm": True,
                     "textual_encoder_no_scale_embedding": False, "adapter_type": "gated_league"},
    "postnorm_no_pos": {"acoustic_encoder_normalize_before": False,
                        "acoustic_decoder_normalize_before": False, "text_no_pos_emb": True,
                        "adapter_type": "context"},
    # the acoustic encoder learns from its CTC loss alone
    "freeze_acoustic": {"freeze_acoustic_encoder": True},
}


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(variant):
        if variant not in cache:
            kw = {**SATE, **VARIANTS[variant]}
            jm = jsate.S2TSATEModel(jsate.s2t_sate_s(**kw))
            feats, lens = rng_batch(0)
            prev = np.full((4, 7), 2, np.int32)
            params = perturb(flax_init(jm, feats, lens, prev))
            tm = tsate.S2TSATEModel(tsate.s2t_sate_s(**kw), device="cpu", seed=1)
            load_flax_params(tm, params)
            cache[variant] = (jm, params, tm)
        return cache[variant]

    return get


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("adapter_type,norms", [
    ("none", False), ("linear", False), ("context", False), ("league", False),
    ("inter_league", False), ("gated_league", False), ("league", True), ("context", True)])
def test_adapter_matches_jax(adapter_type, norms):
    x, _ = rng_batch(1, T=17, C=D)
    logits = np.random.default_rng(2).normal(size=(4, 17, 32)).astype(np.float32) * 3
    jm = jadapter.Adapter(D, 32, adapter_type, 0.7, embed_norm=norms, out_norm=norms)
    variables = jm.init(jax.random.PRNGKey(0), x, logits)
    params = perturb(jax.tree.map(np.asarray, variables.get("params", {})))
    want = np.asarray(jm.apply({"params": params}, x, logits))
    tm = load_module(tadapter.Adapter(D, 32, adapter_type, 0.7, norms, norms), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _shrink_logits():
    """Argmax paths with repeats, blanks between equal labels, a blank tail, and an
    all-blank row."""
    paths = [[0, 5, 5, 0, 5, 7, 7, 7, 0, 0, 3, 9],
             [4, 4, 4, 4, 0, 0, 6, 2, 2, 0, 1, 1],
             [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
             [8, 0, 8, 8, 0, 0, 0, 0, 9, 9, 9, 9]]
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 12, 10)).astype(np.float32)
    for b, path in enumerate(paths):
        logits[b, np.arange(12), path] += 4.0 + rng.random(12).astype(np.float32)
    return logits, np.array([12, 10, 12, 6], np.int32)


@pytest.mark.parametrize("strategy", ["avg", "weighted", "softmax"])
def test_ctc_shrink_matrix_matches_jax(strategy):
    logits, lens = _shrink_logits()
    W, new = jadapter.ctc_shrink_matrix(jnp.asarray(logits), jnp.asarray(lens), 0, strategy)
    tW, tnew = tadapter.ctc_shrink_matrix(torch.from_numpy(logits), torch.from_numpy(lens).long(),
                                          0, strategy)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(new))
    assert tnew.tolist() == [5, 3, 0, 2]  # the all-blank row keeps no segment
    if strategy == "avg":
        np.testing.assert_array_equal(tW.numpy(), np.asarray(W))
    else:
        np.testing.assert_allclose(tW.numpy(), np.asarray(W), atol=1e-6)
    assert not tW[2].any()


def test_textual_encoder_zero_length_row_matches_jax_dense():
    """The port's textual layers run the fused-attention path (its plain version on
    the CPU); JAX attends densely under an explicit padding bias.  A 0-length row
    (an all-blank shrink) attends uniformly over all T keys in both."""
    kw = {**SATE, "text_encoder_layers": 2}
    cfg = jsate.s2t_sate_s(**kw)
    x, _ = rng_batch(4, T=9, C=D)
    lens = np.array([9, 4, 0, 1], np.int32)
    jm = jsate.TextualEncoder(cfg)
    params = perturb(flax_init(jm, x, lens))
    want, _, _ = jm.apply({"params": params}, x, lens)
    tm = load_module(tsate.TextualEncoder(tsate.s2t_sate_s(**kw)), params)
    with torch.no_grad():  # (x, XCTC logits, inter-XCTC taps), as JAX's
        got, xctc, taps = tm(torch.from_numpy(x), torch.from_numpy(lens).long())
    assert xctc is None and taps == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sate_forward_matches_jax(pairs, variant):
    jm, params, tm = pairs(variant)
    feats, lens = rng_batch(1)
    prev = np.random.default_rng(1).integers(3, 32, size=(4, 7)).astype(np.int32)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        assert out[key].shape == ref[key].shape, key
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), want, atol=ATOL * max(1.0, np.abs(want).max()),
                                   err_msg=key)
    if variant == "shrink":
        assert (out["encoder_lengths"] < torch.tensor([10, 9, 6, 1])).any()


def test_sate_all_blank_shrink_matches_jax(pairs):
    """An untrained CTC head that calls every frame blank: every textual row is 0
    frames long, and the decoder attends over an all-masked encoder output."""
    jm, params, _ = pairs("shrink")
    head = params["encoder"]["acoustic"]["ctc_head"]
    bias = head["proj"]["bias"] if "proj" in head else head["bias"]
    bias[0] += 1e3
    tm = tsate.S2TSATEModel(tsate.s2t_sate_s(**{**SATE, **VARIANTS["shrink"]}), device="cpu")
    load_flax_params(tm, params)
    feats, lens = rng_batch(2)
    prev = np.random.default_rng(2).integers(3, 32, size=(4, 7)).astype(np.int32)
    try:
        ref = jm.apply({"params": params}, feats, lens, prev)
        with torch.no_grad():
            out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    finally:
        bias[0] -= 1e3
    assert out["encoder_lengths"].tolist() == [0, 0, 0, 0] == np.asarray(
        ref["encoder_lengths"]).tolist()
    for key in ("encoder_out", "decoder_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


@pytest.mark.parametrize("variant", ["league", "pds_inter_league"])
def test_sate_beam_tokens_identical(pairs, variant):
    jm, params, tm = pairs(variant)
    feats, lens = rng_batch(3)
    batch = {"features": feats, "feat_lengths": lens}
    opts = dict(beam_size=5, max_len_a=0.5, max_len_b=2)
    jt, js, jenc = JaxGenerator(jm, **opts).generate(params, batch)
    gen = SequenceGenerator(tm, **opts)
    tt, ts, enc = gen.generate(batch)
    # the bound is the acoustic subsampler's T/4 = 10 frames, also over the PDS encoder
    # whose output is 40 / 8 = 5 frames long (s2t_tpu/inference/generator.py:397-405)
    assert gen._enc_len_bound(40) == 10 and tt.shape == np.asarray(jt).shape == (4, 5, 7)
    assert enc["encoder_out"].shape[1] == (5 if variant.startswith("pds") else 10)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["league", "pds_inter_league", "shrink", "freeze_acoustic"])
def test_sate_loss_and_grads_match_jax(pairs, variant):
    jm, params, _ = pairs(variant)
    batch = _train_batch(6, (40, 33, 21, 1))
    tm = tsate.S2TSATEModel(tsate.s2t_sate_s(**{**SATE, **VARIANTS[variant]}), device="cpu",
                            for_training=True)
    got = loss_and_grads_match(
        jm, params, tm, ("label_smoothed_cross_entropy_with_ctc",
                         {"label_smoothing": 0.1, "ctc": {"ctc_weight": 1.0}}),
        batch, (batch["features"], batch["feat_lengths"], batch["prev_tokens"]))
    assert np.abs(got["encoder"]["textual"]["layer0"]["self_attn"]["q_proj"]["kernel"]).max() > 0


def test_textual_layers_take_the_fused_attention_path(pairs, monkeypatch):
    from s2t_tpu_torch.modules import attention

    calls = []
    plain = attention.fused_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(attention, "fused_attention", counted)
    for variant, layers in (("league", 2), ("pds_inter_league", 4)):
        _, _, tm = pairs(variant)
        calls.clear()
        feats, lens = rng_batch(1)
        with torch.no_grad():
            tm.encode(torch.from_numpy(feats), torch.from_numpy(lens).long())
        assert len(calls) == layers, variant


def test_sate_from_flax_maps_every_leaf(pairs):
    for variant in ("league", "pds_inter_league", "text_rel_pos"):
        _, params, tm = pairs(variant)
        assert set(flax_to_state_dict(params)) == set(tm.state_dict())
        assert _paths(state_dict_to_flax(tm.state_dict())) == _paths(params)
        enc = params["encoder"]
        assert {"acoustic", "adapter", "textual"} <= set(enc)
        assert "layer0" in enc["textual"]
    _, params, tm = pairs("league")
    np.testing.assert_array_equal(
        state_dict_to_flax(tm.state_dict())["encoder"]["adapter"]["embed_adapter"],
        params["encoder"]["adapter"]["embed_adapter"])
    assert "stage2_layer0" in pairs("pds_inter_league")[1]["encoder"]["acoustic"]


@pytest.mark.parametrize("beam", [1, 5])
def test_s2t_ctc_sate_tokens_identical(beam):
    kw = {**{k: v for k, v in SATE.items() if not k.startswith("acoustic_decoder")},
          "adapter_type": "inter_league"}
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_sate(**kw))
    feats, lens = rng_batch(0)
    params = perturb(flax_init(jm, feats, lens))
    tm = load_flax_params(tctc.S2TCTCModel(tctc.s2t_ctc_sate(**kw), device="cpu"), params)
    assert tm.cfg.decoder_layers == 0 and isinstance(tm.encoder, tsate.S2TSATEEncoder)
    feats, lens = rng_batch(5)
    batch = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam)).generate(params, batch)
    tt, ts, _ = CTCGenerator(tm, CTCDecoder(beam_size=beam)).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("field,value", [
    ("text_attention_type", "rope"), ("acoustic_use_enc_dlcl", True),
])
def test_item7_sate_fields_build_and_run(field, value):
    """Rope textual attention and an acoustic DLCL build and run a forward (their parity
    with JAX is tests/test_torch_variants_recipes.py's)."""
    m = build_model("s2t_sate_s", {**SATE, field: value}, device="cpu")
    feats, lens = rng_batch(0)
    with torch.no_grad():
        out = m(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.full((4, 3), 2))
    assert torch.isfinite(out["encoder_out"]).all()
    if field == "acoustic_use_enc_dlcl":
        assert m.encoder.acoustic.dlcl is not None


@pytest.mark.parametrize("field,value", [
    ("text_use_xctc", True), ("inter_xctc_layers", (1,)), ("xctc_pae", "inter_league"),
    ("xctc_cross_attn", True), ("xctc_pae_ground_truth_ratio", 0.1)])
def test_ctc_stack_sate_fields_build_and_run(field, value):
    """The textual CTC research stack's fields build and run a forward (their parity with
    JAX is tests/test_torch_ctc_aug.py's); with one textual layer a tap there is skipped,
    a PAE with no tap, a cross-attention with no cross layer and an oracle ratio with no
    PAE are inert, as in JAX."""
    m = build_model("s2t_sate_s", {**SATE, field: value}, device="cpu")
    feats, lens = rng_batch(0)
    with torch.no_grad():
        out = m(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.full((4, 3), 2))
    assert torch.isfinite(out["encoder_out"]).all() and out["inter_xctc_logits"] == ()
    xctc = field in ("text_use_xctc", "inter_xctc_layers")
    assert (out["xctc_logits"] is not None) == xctc
    if xctc:
        assert out["xctc_logits"].shape[-1] == 32


# --------------------------------------------------------------------------- #
def _jax_archs():
    import importlib
    import pkgutil

    import s2t_tpu.models
    from s2t_tpu.registry import ARCHS as JAX_ARCHS

    for mod in pkgutil.iter_modules(s2t_tpu.models.__path__):
        importlib.import_module(f"s2t_tpu.models.{mod.name}")
    return {a: JAX_ARCHS.get(a)[0] for a in JAX_ARCHS.keys()}


def test_every_jax_arch_is_registered_and_builds_in_the_port():
    from s2t_tpu_torch.models import build
    from s2t_tpu_torch.registry import ARCHS, MODELS

    jax_archs = _jax_archs()
    assert set(ARCHS.keys()) == set(jax_archs)
    assert {a: ARCHS.get(a)[0] for a in jax_archs} == jax_archs
    assert not hasattr(build, "UNPORTED_ARCHS")
    # every preset gives its config and every model class is the port's; the last slice's
    # archs (the multilingual Transformer, RoBERTa / BERT, GPT-2) build here at one layer,
    # the others in their own tests
    for arch, (model_name, preset) in ((a, ARCHS.get(a)) for a in jax_archs):
        assert preset() is not None and MODELS.get(model_name) is not None, arch
    tiny = {"encoder_layers": 1, "decoder_layers": 1}
    for arch in ("multilingual_transformer", "multilingual_transformer_iwslt_de_en",
                 "roberta_base", "roberta_large", "bert_base", "camembert", "gottbert",
                 "xlmr_base", "xlmr_large", "hf_gpt2", "hf_gpt2_medium", "hf_gpt2_large"):
        fields = ARCHS.get(arch)[1]().__dataclass_fields__
        ctx = {k: v for k, v in {**tiny, "vocab_size": 40,
                                 "lang_pairs": ("de-en",)}.items() if k in fields}
        m = build_model(arch, device="cpu", **ctx)
        assert sum(p.numel() for p in m.parameters()) > 0, arch


# --------------------------------------------------------------------------- #
# the recipe census
SATE_BUILDS = {f"egs/mustc/st/conf/{n}.yaml" for n in (
    "sate", "sate_deep", "sate_big", "reproduction_sate", "sate_pds_8", "sate_pds_8_444",
    "sate_pds_16", "sate_pds_base_8", "sate_pds_deep_8", "sate_big_pds",
    # the textual CTC research stack and CTC-Aug
    "ctc_aug_base", "ctc_aug_big", "ctc_aug_pds_big", "nast_pds_big",
    "reproduction_bil_ctc_progressive", "reproduction_bil_ctc_progressive2",
    "reproduction_ctc_aug")}
REFUSED = {}  # recipe -> what its first unported field names
TINY_DEPTH = {"encoder_layers": 1, "decoder_layers": 1, "text_encoder_layers": 1,
              "acoustic_encoder_layers": 1, "acoustic_decoder_layers": 1}


def _is_census_recipe(arch, model):
    return (arch.startswith("s2t_sate") or arch in ("s2t_ctc_sate", "s2t_conformer")
            or any(str(model.get(f"{p}{k}")) == v for p in ("", "acoustic_")
                   for k, v in (("encoder_attention_type", "rel_pos"), ("macaron_style", "True"),
                                ("use_cnn_module", "True"))))


def census_recipes():
    yaml = pytest.importorskip("yaml")
    out = {}
    for path in sorted((ROOT / "egs").glob("**/*.yaml")):
        conf = yaml.safe_load(path.read_text()) or {}
        # an overlay with no arch runs on its basis.yaml's (s2t_transformer_s) arch
        arch = conf.get("arch") or "s2t_transformer_s"
        model = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in (conf.get("model") or {}).items()}
        if _is_census_recipe(arch, model):
            out[str(path.relative_to(ROOT))] = (arch, model)
    return out


def _shallow(arch, model):
    """The recipe's model at one layer a stack (PDS stages keep their plan)."""
    if arch.startswith("s2t_sate") or arch == "s2t_ctc_sate":
        keys = ("acoustic_encoder_layers", "text_encoder_layers") + (
            ("acoustic_decoder_layers",) if arch != "s2t_ctc_sate" else ())
    elif "pds" in arch:
        keys = ("decoder_layers",) if arch.startswith("pdss2t") else ()
    else:
        keys = ("encoder_layers",) + (("decoder_layers",) if arch != "s2t_ctc" else ())
    return {**model, **{k: TINY_DEPTH[k] for k in keys}}


def test_every_sate_and_conformer_recipe_builds_or_raises_by_name():
    from s2t_tpu.registry import ARCHS as JAX_ARCHS

    _jax_archs()
    recipes = census_recipes()
    built, refused = [], {}
    for path, (arch, model) in recipes.items():
        want = JAX_ARCHS.get(arch)[1](**model)
        from s2t_tpu_torch.registry import ARCHS

        got = ARCHS.get(arch)[1](**model)
        for f in dataclasses.fields(want):  # the same fields with the same values
            w, g = getattr(want, f.name), getattr(got, f.name)
            if dataclasses.is_dataclass(w):
                for sub in dataclasses.fields(w):
                    assert getattr(g, sub.name) == getattr(w, sub.name), (path, f.name, sub.name)
            else:
                assert g == w, (path, f.name)
        try:
            m = build_model(arch, _shallow(arch, model), device="cpu", vocab_size=32)
        except NotImplementedError as e:
            refused[path] = str(e)
            continue
        feats = torch.randn(2, 48, 80)
        with torch.no_grad():
            out = m(feats, torch.tensor([48, 30]), torch.full((2, 3), 2))
        assert torch.isfinite(out["encoder_out"]).all(), path
        built.append(path)
    assert SATE_BUILDS <= set(built), sorted(SATE_BUILDS - set(built))
    assert set(refused) == set(REFUSED), refused
    for path, msg in refused.items():
        assert REFUSED[path] in msg and "Config." in msg, (path, msg)
    assert len(recipes) == len(built) + len(refused) == 38 and len(built) == 38


# --------------------------------------------------------------------------- #
# the CLIs: sate.yaml's model section at a tiny size, from raw audio
CLI_MODEL = {"adapter_type": "league", "text_encoder_layers": 1, "text_attention_heads": 2,
             "text_ffn_embed_dim": 64, "acoustic_encoder_embed_dim": 32,
             "acoustic_encoder_ffn_embed_dim": 64, "acoustic_encoder_layers": 1,
             "acoustic_encoder_attention_heads": 2, "acoustic_subsampling_filter": 16,
             "acoustic_decoder_embed_dim": 32, "acoustic_decoder_ffn_embed_dim": 64,
             "acoustic_decoder_layers": 1, "acoustic_decoder_attention_heads": 2,
             "acoustic_dropout": 0.0, "acoustic_attention_dropout": 0.0,
             "acoustic_activation_dropout": 0.0}


def _cli_cfg(root, save_dir, results):
    return {
        "arch": "s2t_sate_s", "criterion": "label_smoothed_cross_entropy_with_ctc",
        "criterion_cfg": {"label_smoothing": 0.1, "ctc": {"ctc_weight": 1.0}},  # sate.yaml's
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


def test_sate_cli_train_and_generate_match_jax(corpus, tmp_path):
    cli_round_trip(corpus, tmp_path, _cli_cfg, ("loss", "nll_loss", "ctc_loss"),
                   (np.zeros((2, 64, 80), np.float32), np.array([64, 40], np.int32),
                    np.full((2, 3), 2, np.int32)))


def test_chip_smoke_carries_the_sate_and_conformer_recipes():
    """chip_smoke.py phases 19-21 run these recipes' sections (the card has no yaml
    package, so the script carries copies)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    def conf(name):
        return yaml.safe_load((ROOT / "egs" / name).read_text())

    sate = conf("mustc/st/conf/sate.yaml")
    assert sate["arch"] == "s2t_sate_s" and chip_smoke.SATE_MODEL == sate["model"]
    assert chip_smoke.SATE_CRITERION[1] == sate["criterion_cfg"]
    assert chip_smoke.SATE_CRITERION[0] == conf("mustc/st/conf/basis.yaml")["criterion"]
    pds8 = conf("mustc/st/conf/sate_pds_8.yaml")
    assert pds8["arch"] == "s2t_sate_s" and chip_smoke.SATE_PDS_8_MODEL == pds8["model"]
    small = conf("librispeech/asr/conf/ConformerCTCSmall.yaml")
    assert chip_smoke.CONFORMER_CTC_SMALL == {k: small[k] for k in (
        "arch", "model", "criterion", "criterion_cfg", "optimization")}
    # K1f launches an encode: 12 acoustic + 6 textual layers; none under rel_pos attention
    for model in (chip_smoke.SATE_MODEL, chip_smoke.SATE_PDS_8_MODEL):
        cfg = chip_smoke.sate_cfg(model)
        assert chip_smoke.encoder_layers(cfg) == 18
        assert chip_smoke.step_launches(cfg) == {"attention_fwd": 18, "attention_bwd": 18,
                                                 "ctc_alpha": 1, "ctc_beta_grad": 1}
    assert chip_smoke.sate_cfg(chip_smoke.SATE_PDS_8_MODEL).pds.pds_layers == (3, 3, 3, 3)
    assert chip_smoke.encoder_layers(chip_smoke.s2t_conformer()) == 0
    from s2t_tpu_torch.models.s2t_ctc import s2t_ctc_base

    small_cfg = s2t_ctc_base(**chip_smoke.fields(chip_smoke.CONFORMER_CTC_SMALL["model"]))
    assert chip_smoke.encoder_layers(small_cfg) == 0
    assert small_cfg.encoder_embed_dim // small_cfg.encoder_attention_heads == 44
