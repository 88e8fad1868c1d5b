"""The 16 MT recipes in the port.

* the census: ``egs/mustc/mt/conf/*`` (6, over that directory's ``basis.yaml``)
  and ``egs/wmt16/mt/conf/*`` (10 with ``fconv.yaml``, each alone, as
  tests/test_egs_confs.py loads them) resolve through ``build_config`` ->
  ``check_train_supported`` -> ``build_criterion`` -> a one-layer ``build_model``
  of the recipe's arch (``transformer`` where it names none) at its widths
  (fconv's one layer: its first convolution on each side);
* ``cli.train`` runs ``egs/mustc/mt/conf/base.yaml`` and ``ctc.yaml`` over
  ``basis.yaml`` at one layer for 2 updates on a tiny whitespace corpus, with
  the recipes' ``eval_bleu`` validation and ``best_checkpoint_metric: bleu``;
* chip_smoke.py carries these two recipes' sections as they are.
"""

from pathlib import Path

import numpy as np
import pytest

from s2t_tpu_torch.cli import train as cli_train
from s2t_tpu_torch.config import build_config, check_train_supported
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.models.build import build_model
from tests.test_torch_translation import write_corpus
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
MUSTC_MT = sorted(f"egs/mustc/mt/conf/{p.name}" for p in (ROOT / "egs/mustc/mt/conf").glob(
    "*.yaml"))
WMT16_MT = sorted(f"egs/wmt16/mt/conf/{p.name}" for p in (ROOT / "egs/wmt16/mt/conf").glob(
    "*.yaml"))
ONE_LAYER = {"encoder_layers": 1, "decoder_layers": 1}
FCONV_ONE_LAYER = {"encoder_convs": ((512, 3),), "decoder_convs": ((512, 3),)}


def recipe_config(recipe, overrides=()):
    path = ROOT / recipe
    basis = path.parent / "basis.yaml"
    stack = [basis, path] if basis.exists() and path != basis else [path]
    return build_config(stack, list(overrides))


def test_the_census_counts_15_recipes():
    # 15 Transformer recipes and, since fconv is ported, fconv.yaml
    assert len(MUSTC_MT) == 6 and len(WMT16_MT) == 10
    assert "egs/wmt16/mt/conf/fconv.yaml" in WMT16_MT


@pytest.mark.parametrize("recipe", MUSTC_MT + WMT16_MT)
def test_recipe_resolves_and_builds_with_one_layer(recipe):
    pytest.importorskip("yaml")
    cfg = recipe_config(recipe)
    check_train_supported(cfg)
    build_criterion(cfg.criterion, cfg.criterion_cfg)
    fconv = (cfg.arch or "").startswith("fconv")
    m = build_model(cfg.arch or "transformer",
                    {**cfg.model, **(FCONV_ONE_LAYER if fconv else ONE_LAYER)}, device="cpu",
                    for_training=True, vocab_size=32, src_vocab_size=28)
    assert (len(m.cfg.encoder_convs) if fconv else m.cfg.encoder_layers) == 1
    assert sum(p.numel() for p in m.parameters()) > 0
    if fconv:
        assert cfg.optimization.lr_scheduler == "fixed" and m.cfg.encoder_embed_dim == 768
    if recipe.endswith("ctc.yaml"):
        assert m.cfg.use_ctc and m.cfg.ctc_upsampling_ratio == 3


@pytest.mark.parametrize("recipe", ["egs/mustc/mt/conf/base.yaml", "egs/mustc/mt/conf/ctc.yaml"])
def test_cli_trains_recipe_at_one_layer(tmp_path, recipe):
    pytest.importorskip("yaml")
    root = write_corpus(tmp_path / "data")
    cfg = recipe_config(recipe, [
        "model.encoder_layers=1", "model.decoder_layers=1", "optimization.max_update=2",
        "dataset.max_tokens=40", "dataset.num_buckets=2", "generation.max_len_b=6",
        "eval.eval_gen_beam=2", f"dataset.data={root}",
        f"checkpoint.save_dir={tmp_path / 'ckpt'}", "checkpoint.async_save=false"])
    assert cfg.eval.eval_bleu and cfg.checkpoint.best_checkpoint_metric == "bleu"
    out = cli_train.main(cfg, device="cpu")
    assert out["trainer"].step == 2
    assert all(np.isfinite(r["loss"]) for r in out["train_log"])
    last = out["history"][-1]
    assert "bleu" in last and np.isfinite(last["loss"])
    if recipe.endswith("ctc.yaml"):
        assert "ctc_loss" in last
    assert (tmp_path / "ckpt" / "checkpoint_best.pt").exists()


def test_chip_smoke_carries_the_mt_recipes():
    """chip_smoke.py phases 37-38 run these recipes' sections (the card has no yaml
    package, so the script carries copies)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    def conf(path):
        return yaml.safe_load((ROOT / path).read_text())

    assert conf("egs/mustc/mt/conf/basis.yaml") == chip_smoke.MUSTC_MT_BASIS
    assert conf("egs/mustc/mt/conf/base.yaml") == chip_smoke.MUSTC_MT_BASE
    assert conf("egs/mustc/mt/conf/ctc.yaml") == chip_smoke.MUSTC_MT_CTC
