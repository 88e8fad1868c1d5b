"""The encoder variants under SATE against the JAX package, and the item-7 recipes.

* SATE ``text_attention_type`` rope, local, light and dynamic, and
  ``acoustic_use_enc_dlcl``: forward within 1e-5 of each tensor's largest
  magnitude (tiny models of tests/test_torch_sate.py, ``from_flax``);
* relative attention raises ValueError where no clip length reaches it (PDS's stage
  layers, SATE's textual layers), as JAX's layer fails there;
* the ten item-7 recipes build through ``build_config`` -> ``check_train_supported``
  -> ``build_criterion`` -> ``build_model`` (one layer a stack) and run a forward,
  and no port module names item 7 any more.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from s2t_tpu.models import sate as jsate
from s2t_tpu_torch.config import build_config, check_train_supported
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.models import sate as tsate
from s2t_tpu_torch.models.build import build_model
from tests.test_torch_conformer import flax_init, perturb, rng_batch
from tests.test_torch_sate import SATE
from tests.test_torch_variants_models import assert_close
from tests.test_torch_variants_pds import PDS
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("field,model", [("encoder_attention_type", "pds"),
                                         ("text_attention_type", "sate")])
def test_relative_attention_without_a_clip_length_raises(field, model):
    """PDS's stage layers and SATE's textual layers take no relative length, and JAX's
    relative attention asserts one."""
    with pytest.raises(ValueError, match="relative"):
        if model == "pds":
            build_model("pdss2t_transformer_s_8", {**PDS, field: "relative"}, device="cpu")
        else:
            build_model("s2t_sate_s", {**SATE, field: "relative"}, device="cpu")


@pytest.mark.parametrize("kw", [dict(text_attention_type="rope"),
                                dict(text_attention_type="local"),
                                dict(text_attention_type="light"),
                                dict(text_attention_type="dynamic"),
                                dict(acoustic_use_enc_dlcl=True, acoustic_encoder_layers=2)],
                         ids=["rope", "local", "light", "dynamic", "acoustic_dlcl"])
def test_sate_variant_forward_matches_jax(kw):
    kw = {**SATE, **kw}
    jm = jsate.S2TSATEModel(jsate.s2t_sate_s(**kw))
    feats, lens = rng_batch(5)
    prev = np.random.default_rng(5).integers(3, 32, size=(4, 5)).astype(np.int32)
    params = perturb(flax_init(jm, feats, lens, prev))
    tm = load_flax_params(tsate.S2TSATEModel(tsate.s2t_sate_s(**kw), device="cpu"), params)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        assert_close(out[key], ref[key], key)
    if "acoustic_use_enc_dlcl" in kw:
        assert "dlcl" in params["encoder"]["acoustic"]


ITEM7_RECIPES = ["egs/aishell/asr/conf/dlcl.yaml", "egs/librispeech/asr/conf/dlcl.yaml",
                 "egs/mustc/asr/conf/dlcl.yaml", "egs/mustc/st/conf/dlcl.yaml",
                 "egs/mustc/st/conf/relative.yaml", "egs/mustc/st/conf/rpr.yaml",
                 "egs/librispeech/asr/conf/EffecientConformerCTCSmall.yaml",
                 "egs/librispeech/asr/conf/EffecientConformerCTCMedium.yaml",
                 "egs/librispeech/asr/conf/local_attn.yaml", "egs/mustc/st/conf/dynamic.yaml"]


@pytest.mark.parametrize("recipe", ITEM7_RECIPES)
def test_item7_recipe_builds_and_runs(recipe):
    path = ROOT / recipe
    basis = path.parent / "basis.yaml"
    cfg = build_config([basis, path] if basis.exists() else [path])
    check_train_supported(cfg)
    build_criterion(cfg.criterion, cfg.criterion_cfg)
    arch = cfg.arch or "s2t_transformer_s"
    model = dict(cfg.model)
    if "pds" not in arch:  # one layer a stack (PDS stages keep their plan)
        model.update(encoder_layers=1, decoder_layers=1)
    m = build_model(arch, model, device="cpu", for_training=True, vocab_size=32)
    feats = torch.randn(2, 48, 80)
    out = m(feats, torch.tensor([48, 30]), torch.full((2, 3), 2))
    assert torch.isfinite(out["encoder_out"]).all()
    if "EffecientConformer" in recipe:
        assert m.cfg.total_ratio == 8 and out["encoder_out"].shape[1] == 6


def test_no_port_module_names_item_7():
    hits = [str(p) for p in (ROOT / "s2t_tpu_torch").glob("**/*.py")
            if "item 7" in p.read_text()]
    assert hits == []


def test_chip_smoke_carries_the_item7_recipes():
    """chip_smoke.py phases 28-29 run these recipes' sections (the card has no yaml
    package, so the script carries copies) and count their fused attention calls."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke
    from s2t_tpu_torch.registry import ARCHS

    def conf(path):
        return yaml.safe_load((ROOT / path).read_text())

    files = {"dlcl": "egs/librispeech/asr/conf/dlcl.yaml",
             "relative": "egs/mustc/st/conf/relative.yaml",
             "local_attn": "egs/librispeech/asr/conf/local_attn.yaml",
             "dynamic": "egs/mustc/st/conf/dynamic.yaml"}
    assert set(files) == set(chip_smoke.VARIANT_RECIPES)
    for name, path in files.items():
        c = conf(path)
        arch, model = chip_smoke.VARIANT_RECIPES[name]
        assert (c.get("arch") or "s2t_transformer_s") == arch and (c.get("model") or {}) == model
    for path in ("egs/aishell/asr/conf/dlcl.yaml", "egs/mustc/asr/conf/dlcl.yaml",
                 "egs/mustc/st/conf/dlcl.yaml"):
        assert conf(path)["model"] == chip_smoke.VARIANT_RECIPES["dlcl"][1]
    eff = conf("egs/librispeech/asr/conf/EffecientConformerCTCSmall.yaml")
    assert {k: eff[k] for k in ("arch", "criterion", "criterion_cfg", "model")} == \
        chip_smoke.EFFICIENT_CONFORMER_SMALL
    launches = {name: chip_smoke.encoder_layers(
        ARCHS.get(arch)[1](**chip_smoke.fields(model)))
        for name, (arch, model) in {**chip_smoke.VARIANT_RECIPES,
                                    **chip_smoke.VARIANT_OVERLAYS}.items()}
    assert launches == chip_smoke.VARIANT_K1F == {
        "dlcl": 12, "relative": 0, "local_attn": 0, "dynamic": 0, "rope": 12}
    # the script's fused types are its own, and agree with the port's routing
    from s2t_tpu_torch.modules.attention import FUSED_ATTENTION_TYPES

    assert chip_smoke.KERNEL_ATTENTION_TYPES == FUSED_ATTENTION_TYPES
    from s2t_tpu_torch.models.s2t_ctc import s2t_ctc_pds
    from s2t_tpu_torch.models.s2t_transformer import s2t_transformer_s

    assert chip_smoke.encoder_layers(
        s2t_ctc_pds(**chip_smoke.fields(eff["model"]))) == 0
    # a rope layer takes the kernel; a window or reduced keys keep it dense
    assert chip_smoke.encoder_layers(s2t_transformer_s(encoder_attention_type="rope")) == 12
    assert chip_smoke.encoder_layers(s2t_transformer_s(encoder_attention_window=8)) == 0
