"""The port's PDS encoder (pdss2t_transformer, s2t_ctc_pds) against the JAX package on the CPU.

Tiny configs: 3 stages at ratios (2, 1, 2), dims (32, 48, 64), 4 heads, FFN
ratio 2, one layer a stage, vocab 32, a one-layer decoder; variants plain,
fusion, ``pds_position_embed`` (1, 0, 1), one ``pds_final_layers`` layer,
post-norm, and Conformer stages (macaron FFN, conv module, rel_pos).  Weights are flax's, carried across with ``from_flax``; the batch
is B = 4 at T = 61 (not a multiple of 4) with lengths (61, 45, 31, 1).

* ``encoder_out``, ``ctc_logits`` and ``decoder_logits`` within atol 1e-5
  (fp32), ``encoder_lengths`` equal;
* beam-5 tokens of ``SequenceGenerator`` identical to the JAX generator's at
  ``max_len_a`` 0.5, on the ratio-4 plan and on an ``_8`` plan (2, 2, 2),
  whose output length the staged encoder's exact ratio bounds;
* ``s2t_ctc_pds``: greedy and beam-5 tokens of ``CTCGenerator`` identical;
* label-smoothed CE + CTC and ``ctc``: the loss and every gradient,
  ``fusion_weight`` and the fusion's affine included, against
  ``jax.value_and_grad`` (loss rtol 1e-5, gradients atol 1e-5 of each
  leaf's largest entry);
* ``from_flax`` maps every leaf both ways; each unported branch raises
  ``NotImplementedError`` by name;
* every ``egs/**/*.yaml`` of arch ``pdss2t_transformer_*`` or ``s2t_ctc_pds``
  resolves to the JAX preset's field values and passes the port's checks
  (73), or raises naming its module (2, the EffecientConformer pair).

tests/test_torch_pds_cli.py drives a PDS model through both packages' CLIs.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import pds as jpds
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import pds as tpds
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models.build import build_model
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
TINY = dict(pds_stages=3, pds_ratios=(2, 1, 2), pds_layers=(1, 1, 1), pds_kernel_sizes=(5, 5, 5),
            pds_embed_dims=(32, 48, 64), pds_attn_heads=(4, 4, 4), pds_ffn_ratios=(2, 2, 2),
            pds_position_embed=(1, 1, 1), pds_ctc=(0, 0, 0), vocab_size=32, decoder_layers=1,
            decoder_ffn_embed_dim=128, max_target_positions=64, dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0,
            # an untied output projection keeps random-weight beams from copying their
            # input token, so the searches branch
            share_decoder_input_output_embed=False)
VARIANTS = {"plain": {}, "fusion": dict(pds_fusion=True),
            "position_101": dict(pds_position_embed=(1, 0, 1)),
            "final_layers": dict(pds_final_layers=1),
            "postnorm": dict(encoder_normalize_before=False, decoder_normalize_before=False),
            # an _8 plan: the generator bounds its output by ceil(T / 8), not T / 4
            "ratio8": dict(pds_ratios=(2, 2, 2)),
            # Conformer stages: macaron FFN, conv module (a kernel per stage), rel_pos
            "conformer": dict(macaron_style=True, use_cnn_module=True,
                              encoder_attention_type="rel_pos", pds_cnn_kernel_sizes=(5, 3, 7),
                              encoder_activation_fn="swish", pds_final_layers=1)}
# the encoder-only model: s2t_ctc_pds sets decoder_layers 0 unless told otherwise
CTC_TINY = {k: v for k, v in TINY.items() if k != "decoder_layers"}
LENGTHS = (61, 45, 31, 1)


def make_batch(seed=0, B=4, T=61):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 80)).astype(np.float32)
    prev = rng.integers(3, 32, size=(B, 7)).astype(np.int32)
    return feats, np.array(LENGTHS[:B], np.int32), prev


def jax_params(jm, *args):
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"])


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(variant):
        if variant not in cache:
            kw = {**TINY, **VARIANTS[variant]}
            jm = jpds.PDSS2TTransformerModel(jpds.pdss2t_transformer_s_8(**kw))
            params = jax_params(jm, *make_batch())
            tm = tpds.PDSS2TTransformerModel(tpds.pdss2t_transformer_s_8(**kw), device="cpu",
                                             seed=1)
            load_flax_params(tm, params)
            cache[variant] = (jm, params, tm)
        return cache[variant]

    return get


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_parity(pairs, variant):
    jm, params, tm = pairs(variant)
    feats, lens, prev = make_batch(seed=1)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)
    assert out["inter_ctc_logits"] == () == ref["inter_ctc_logits"]
    assert out["inter_xctc_logits"] == () == ref["inter_xctc_logits"]


def _paths(tree):
    return {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("variant", ["fusion", "final_layers"])
def test_from_flax_maps_every_leaf(pairs, variant):
    _, params, tm = pairs(variant)
    assert set(flax_to_state_dict(params)) == set(tm.state_dict())
    back = state_dict_to_flax(tm.state_dict())
    assert _paths(back) == _paths(params)
    names = set(params["encoder"])
    assert {"ds0", "ds2", "stage0_layer0", "stage2_layer0"} <= names
    if variant == "fusion":
        assert {"fusion0", "fusion1", "fusion2", "fusion_weight"} <= names
        np.testing.assert_array_equal(back["encoder"]["fusion_weight"],
                                      params["encoder"]["fusion_weight"])
        np.testing.assert_array_equal(back["encoder"]["fusion1"]["norm_scale"],
                                      params["encoder"]["fusion1"]["norm_scale"])
    else:
        assert "final_layer0" in names
    with pytest.raises(KeyError, match="stray"):
        flax_to_state_dict({**params, "encoder": {**params["encoder"], "stray": np.zeros(2)}})


def test_seeded_init_matches_flax_init_of_the_fusion(pairs):
    _, params, _ = pairs("fusion")
    tm = tpds.PDSS2TTransformerModel(tpds.pdss2t_transformer_s_8(**TINY, pds_fusion=True),
                                     device="cpu", seed=3)
    sd = state_dict_to_flax(tm.state_dict())["encoder"]
    np.testing.assert_allclose(sd["fusion_weight"], params["encoder"]["fusion_weight"])
    for i in range(3):
        for leaf in ("norm_scale", "norm_bias"):
            np.testing.assert_array_equal(sd[f"fusion{i}"][leaf], params["encoder"][f"fusion{i}"][leaf])


@pytest.mark.parametrize("variant", ["plain", "ratio8"])
def test_beam_tokens_identical(pairs, variant):
    jm, params, tm = pairs(variant)
    feats, lens, _ = make_batch(seed=2)
    batch = {"features": feats, "feat_lengths": lens}
    opts = dict(beam_size=5, max_len_a=0.5, max_len_b=2)
    jt, js, _ = JaxGenerator(jm, **opts).generate(params, batch)
    gen = SequenceGenerator(tm, **opts)
    tt, ts, _ = gen.generate(batch)
    # ceil(ceil(61 / 4) * 4 / ratio) encoder frames bound the output: 0.5 * 16 + 2 or 0.5 * 8 + 2
    want_len = {"plain": 10, "ratio8": 6}[variant]
    assert gen._max_len_for(gen._enc_len_bound(61)) == want_len
    assert tt.shape == np.asarray(jt).shape == (4, 5, want_len)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def ctc_pair():
    kw = {**CTC_TINY, "pds_fusion": True}
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_pds(**kw))
    feats, lens, _ = make_batch()
    params = jax_params(jm, feats, lens)
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_pds(**kw), device="cpu", seed=1)
    load_flax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("beam", [1, 5])
def test_ctc_generator_tokens_identical(ctc_pair, beam):
    jm, params, tm = ctc_pair
    assert tm.cfg.decoder_layers == 0 and isinstance(tm.encoder, tpds.PDSEncoder)
    feats, lens, _ = make_batch(seed=3)
    batch = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam)).generate(params, batch)
    tt, ts, enc = CTCGenerator(tm, CTCDecoder(beam_size=beam)).generate(batch)
    assert tt.shape == np.asarray(jt).shape == (4, beam, enc["ctc_logits"].shape[1])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


def _train_batch(seed=4):
    rng = np.random.default_rng(seed)
    feats, lens, _ = make_batch(seed=seed)
    target = rng.integers(4, 32, size=(4, 6)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]  # a shorter sentence: EOS, then pad
    return {"features": feats, "feat_lengths": lens, "prev_tokens": np.roll(target, 1, 1),
            "target": target, "ntokens": np.float32((target != 1).sum())}


@pytest.mark.parametrize("arch,criterion", [
    ("pdss2t_transformer", ("label_smoothed_cross_entropy_with_ctc",
                            {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}})),
    ("s2t_ctc_pds", ("ctc", {"ctc_weight": 1.0, "zero_infinity": True})),
])
def test_loss_and_grads_match_jax(arch, criterion):
    kw = {**(CTC_TINY if arch == "s2t_ctc_pds" else TINY), "pds_fusion": True,
          "pds_final_layers": 1}
    batch = _train_batch()
    if arch == "s2t_ctc_pds":
        jm, tcls = jctc.S2TCTCModel(jctc.s2t_ctc_pds(**kw)), tctc.S2TCTCModel
        cfg, args = tctc.s2t_ctc_pds(**kw), (batch["features"], batch["feat_lengths"])
    else:
        jm, tcls = jpds.PDSS2TTransformerModel(jpds.pdss2t_transformer_s_8(**kw)), \
            tpds.PDSS2TTransformerModel
        cfg = tpds.pdss2t_transformer_s_8(**kw)
        args = (batch["features"], batch["feat_lengths"], batch["prev_tokens"])
    params = jax_params(jm, *args)
    jcrit = jax_build_criterion(*criterion)

    def jax_loss(p):
        loss, sample_size, logs = jcrit(jm.apply({"params": p}, *args), batch)
        return loss, (sample_size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)
    tm = tcls(cfg, device="cpu", for_training=True)
    load_flax_params(tm, params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out = tm(tb["features"], tb["feat_lengths"].long(), tb["prev_tokens"].long())
    loss, size, logs = build_criterion(*criterion)(out, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logs["ctc_loss"].item(), float(jlogs["ctc_loss"]), rtol=1e-5)
    assert size.item() == float(jsize)
    got = state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})
    assert _paths(got) == _paths(jgrads)
    assert np.abs(got["encoder"]["fusion_weight"]).max() > 0
    for (path, g), (_, want) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                    jax.tree_util.tree_flatten_with_path(jgrads)[0]):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("field,value,names", [
    ("pds_fusion_method", "all_pool", "only 'conv'"),
])
def test_unported_branches_raise_by_name(field, value, names):
    kw = {**TINY, field: value, "pds_fusion": True}
    with pytest.raises(NotImplementedError) as e:
        build_model("pdss2t_transformer_s_8", kw, device="cpu")
    assert names in str(e.value)


@pytest.mark.parametrize("field,value", [
    ("encoder_attention_type", "rope"),
    ("encoder_attention_type", "relative"),
    ("encoder_attention_type", "local"),
    ("pds_conv_strides", (1, 2, 1)),
    ("pds_ratios", (-1, 1, 2)),
    ("subsampling_type", "conv2d"),
])
def test_item7_branches_match_jax(field, value):
    """The encoder-variant branches of PDS: the forward agrees with JAX (lengths equal,
    tensors within 1e-5 of their largest magnitude); relative attention, which gets no
    clip length here, fails in both."""
    kw = {**TINY, field: value}
    if field == "subsampling_type":
        kw["pds_ratios"] = (-1, 1, 2)
    if field == "pds_conv_strides":
        kw.update(use_cnn_module=True, cnn_module_kernel=3)
    if "pds_ratios" in kw and kw["pds_ratios"][0] == -1:
        kw["subsampling_filter"] = 16
    jm = jpds.PDSS2TTransformerModel(jpds.pdss2t_transformer_s_8(**kw))
    feats, lens, prev = make_batch()
    if value == "relative":
        with pytest.raises(AssertionError):
            jax_params(jm, feats, lens, prev)
        with pytest.raises(ValueError, match="relative"):
            build_model("pdss2t_transformer_s_8", kw, device="cpu")
        return
    params = jax_params(jm, feats, lens, prev)
    tm = load_flax_params(build_model("pdss2t_transformer_s_8", kw, device="cpu"), params)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "decoder_logits"):
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), want, err_msg=key,
                                   atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("field,value", [
    ("pds_ctc", (1, 0, 0)), ("pds_xctc", (0, 1, 0)), ("use_xctc", True),
    ("ctc_pae", "inter_league"), ("xctc_pae", "inter_league"), ("ctc_layer", 2),
    ("xctc_layer", 2)])
def test_stage_tap_fields_build_and_run(field, value):
    """The CTC research stack's PDS fields build and run a forward (their parity with
    JAX is tests/test_torch_pds_taps.py's); a PAE with no tap and an XCTC layer with no
    XCTC head are inert, as in JAX."""
    m = build_model("pdss2t_transformer_s_8", {**TINY, field: value}, device="cpu")
    with torch.no_grad():
        out = m(torch.randn(2, 61, 80), torch.tensor([61, 40]), torch.full((2, 3), 2))
    assert torch.isfinite(out["encoder_out"]).all()
    # T = 61 pads to 64; stages 0 and 1 (ratios 2, 1) run at 32 frames, lengths 31 and 20
    taps = {"pds_ctc": ("inter_ctc_logits", 1), "pds_xctc": ("inter_xctc_logits", 2)}
    if field in taps:  # (layer, logits at the stage's length, the stage's lengths)
        key, layer = taps[field]
        ((got_layer, logits, lengths),) = out[key]
        assert got_layer == layer and logits.shape[1] == 32 and lengths.tolist() == [31, 20]
    else:
        assert out["inter_ctc_logits"] == () and out["inter_xctc_logits"] == ()
    assert (out["xctc_logits"] is not None) == (field == "use_xctc")
    if field == "ctc_layer":  # the normed head reads stage 1's output
        assert out["ctc_logits"].shape[1] == 32 and m.encoder.ctc_head.norm is not None


def test_ratio_minus_one_takes_the_conv1d_subsampler():
    """A ratio of -1 with the port's subsampler semantics (masked between layers)
    builds the shared Conv1d subsampler, and agrees with JAX."""
    kw = {**TINY, "pds_ratios": (-1, 1, 2), "subsampling_ref_pad_semantics": False,
          "subsampling_filter": 16}
    jm = jpds.PDSS2TTransformerModel(jpds.pdss2t_transformer_s_8(**kw))
    feats, lens, prev = make_batch()
    params = jax_params(jm, feats, lens, prev)
    tm = build_model("pdss2t_transformer_s_8", kw, device="cpu")
    load_flax_params(tm, params)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(), np.asarray(ref["encoder_lengths"]))
    np.testing.assert_allclose(out["encoder_out"].numpy(), np.asarray(ref["encoder_out"]), atol=ATOL)


# --------------------------------------------------------------------------- #
# the recipes
# --------------------------------------------------------------------------- #
UNPORTED_RECIPES = {}  # recipe -> what its refusal names


def pds_recipes():
    yaml = pytest.importorskip("yaml")
    out = {}
    for path in sorted((ROOT / "egs").glob("**/*.yaml")):
        conf = yaml.safe_load(path.read_text()) or {}
        arch = conf.get("arch") or ""
        if arch.startswith("pdss2t_transformer") or arch == "s2t_ctc_pds":
            model = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in (conf.get("model") or {}).items()}
            out[str(path.relative_to(ROOT))] = (arch, model)
    return out


def test_every_pds_recipe_resolves_as_jax_or_raises_by_name():
    from s2t_tpu.registry import ARCHS as JAX_ARCHS
    from s2t_tpu_torch.registry import ARCHS

    recipes = pds_recipes()
    built, refused = [], {}
    for path, (arch, model) in recipes.items():
        want = JAX_ARCHS.get(arch)[1](**model)
        got = ARCHS.get(arch)[1](**model)
        assert isinstance(got, tpds.PDSConfig), path
        for f in dataclasses.fields(want):  # the same fields with the same values
            assert getattr(got, f.name) == getattr(want, f.name), (path, f.name)
        try:
            tpds.check_supported(got)
        except NotImplementedError as e:
            refused[path] = str(e)
            continue
        built.append(path)
    assert len(recipes) == 75 and len(built) == 75 and len(refused) == 0, refused
    assert set(refused) == set(UNPORTED_RECIPES)
    for path, msg in refused.items():
        assert UNPORTED_RECIPES[path] in msg and "PDSConfig." in msg, (path, msg)
    # the fusion recipes build: pds_big (m_8) and pds_deep (sd_8); so do the Conformer-stage ones
    assert {"egs/librispeech/asr/conf/pds_big.yaml",
            "egs/librispeech/asr/conf/pds_deep.yaml",
            "egs/mustc/asr/conf/purectc_pds_base_8_grow512.yaml",
            "egs/librispeech/asr/conf/compare_purectc_pds_base_8.yaml",
            "egs/librispeech/asr/conf/compare_my_purectc_pds_base_8.yaml"} <= set(built)
    arch, model = recipes["egs/librispeech/asr/conf/purectc_pds_base_8_growth360.yaml"]
    m = build_model(arch, model, device="cpu", vocab_size=32)
    assert isinstance(m, tctc.S2TCTCModel) and m.cfg.downsample_ratio == 8
    assert [s[0].self_attn.num_heads for s in m.encoder.stages] == [4, 4, 4, 4]
    assert [s[0].attn_norm.normalized_shape[0] for s in m.encoder.stages] == [200, 256, 256, 360]
    # EffecientConformer: a Conv2d subsampler, then two strided, widening stages
    m = build_model(*recipes["egs/librispeech/asr/conf/EffecientConformerCTCSmall.yaml"],
                    device="cpu", vocab_size=32)
    assert m.cfg.downsample_ratio == 8 and m.cfg.out_dim == 240
    assert [s[-1].conv_stride for s in m.encoder.stages] == [2, 2, 1]


def test_chip_smoke_carries_the_pds_recipes():
    """chip_smoke.py phases 17-18 run these recipes' sections (the card has no yaml
    package, so the script carries copies)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    def conf(name):
        return yaml.safe_load((ROOT / "egs" / name).read_text())

    growth = conf("librispeech/asr/conf/purectc_pds_base_8_growth360.yaml")
    assert growth["arch"] == "s2t_ctc_pds" and chip_smoke.GROWTH360_MODEL == growth["model"]
    big = conf("librispeech/asr/conf/pds_big.yaml")
    assert big["arch"] == chip_smoke.PDS_BIG_ARCH and chip_smoke.PDS_BIG_MODEL == big["model"]
    base = conf("mustc/asr/conf/pds_base_8.yaml")
    assert {k: base[k] for k in ("arch", "criterion_cfg")} == chip_smoke.PDS_BASE_8
    basis = conf("mustc/asr/conf/basis.yaml")
    assert chip_smoke.PDS_BASIS == {"criterion": basis["criterion"], "eval": basis["eval"],
                                    **{k: basis["dataset"][k] for k in (
                                        "max_tokens", "max_source_positions",
                                        "max_target_positions", "num_buckets")}}
    cfg = chip_smoke.pds_cfg(Path("data"))
    assert (cfg.arch, cfg.criterion) == ("pdss2t_transformer_s_8", basis["criterion"])
    # 12 K1f launches an encode of s_8 and m_8, 16 of growth360
    assert chip_smoke.encoder_layers(tpds.pdss2t_transformer_s_8()) == 12
    assert chip_smoke.encoder_layers(tpds.pdss2t_transformer_m_8()) == 12
    assert chip_smoke.encoder_layers(
        tctc.s2t_ctc_pds(**chip_smoke.fields(chip_smoke.GROWTH360_MODEL))) == 16
