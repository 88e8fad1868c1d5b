"""The seven recipes of the text zoo's first steps in the port: ``egs/wmt16/mt/conf/fconv.yaml``,
``egs/wikitext103/lm/adaptive_lm.yaml``, ``egs/wmt16/align/transformer_align.yaml`` and
``egs/wmt16/nat/{cmlm,levenshtein,insertion,nacrf}.yaml``.

* the census: each resolves through ``build_config`` -> ``check_train_supported`` ->
  ``build_criterion`` -> a one-layer ``build_model`` at its widths (fconv's first
  convolution on each side; the LM over wikitext-103's 267,744 words; the alignment
  layer 0 of a one-layer decoder);
* ``cli.train`` runs each at one layer for 2 updates on a tiny corpus (the LM's
  adaptive cutoffs at 10 / 20 for its 30-word dictionary), validation included;
  then ``cli.generate`` decodes the test split with the generator the task builds,
  and for ``cmlm.yaml`` and ``insertion.yaml`` writes JAX's lines from the same
  weights, and ``hub.from_pretrained`` answers JAX's for ``cmlm.yaml``;
* chip_smoke.py carries these recipes' sections as they are.
"""

from pathlib import Path

import numpy as np
import pytest

from s2t_tpu_torch.cli import generate as cli_generate
from s2t_tpu_torch.cli import train as cli_train
from s2t_tpu_torch.config import build_config, check_train_supported
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.utils.checkpoint import save_tree
from tests.test_torch_align import write_aligned
from tests.test_torch_language_modeling import write_corpus as write_lm_corpus
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
FCONV = "egs/wmt16/mt/conf/fconv.yaml"
LM = "egs/wikitext103/lm/adaptive_lm.yaml"
ALIGN = "egs/wmt16/align/transformer_align.yaml"
NAT = [f"egs/wmt16/nat/{n}.yaml" for n in ("cmlm", "levenshtein", "insertion", "nacrf")]
RECIPES = [FCONV, LM, ALIGN, *NAT]
WIKI103_VOCAB = 267744
ONE_LAYER = {  # the model overrides of a one-layer build
    FCONV: {"encoder_convs": ((512, 3),), "decoder_convs": ((512, 3),)},
    LM: {"decoder_layers": 1},
    ALIGN: {"encoder_layers": 1, "decoder_layers": 1, "alignment_layer": 0},
}


def one_layer(recipe):
    return ONE_LAYER.get(recipe, {"encoder_layers": 1, "decoder_layers": 1})


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_resolves_and_builds_with_one_layer(recipe):
    pytest.importorskip("yaml")
    cfg = build_config([ROOT / recipe])
    check_train_supported(cfg)
    build_criterion(cfg.criterion, cfg.criterion_cfg)
    ctx = ({"vocab_size": WIKI103_VOCAB} if recipe == LM
           else {"vocab_size": 32, "src_vocab_size": 28})
    m = build_model(cfg.arch, {**cfg.model, **one_layer(recipe)}, device="cpu", **ctx)
    assert sum(p.numel() for p in m.parameters()) > 0
    if recipe == LM:
        assert m.cfg.adaptive_softmax_cutoff == (20000, 60000) and m.cfg.decoder_embed_dim == 1024
        assert cfg.optimization.lr_scheduler == "cosine"
    if recipe.endswith("nacrf.yaml"):
        assert m.crf.beam == 64 and cfg.task_cfg["noise"] == "full_mask"


def overrides(recipe, data, tmp):
    model = {**one_layer(recipe)}
    if recipe == LM:
        model.update(adaptive_softmax_cutoff=[10, 20], adaptive_input_cutoff=[10, 20])
    out = [f"model.{k}={list(map(list, v)) if isinstance(v, tuple) else v}"
           for k, v in model.items()]
    if recipe != LM:  # the LM's 512-token blocks need its position caps
        out += ["dataset.max_target_positions=64", "dataset.max_source_positions=64"]
    return out + ["optimization.max_update=2", "optimization.max_epoch=3",
                  "dataset.max_tokens=1100", "dataset.num_buckets=2",
                  "generation.max_len_b=6", "generation.beam=2", "common.log_interval=1",
                  f"dataset.data={data}", f"checkpoint.save_dir={tmp / 'ckpt'}",
                  "checkpoint.no_save=true", "checkpoint.async_save=false", f"generation.results_path={tmp / 'gen'}"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    pytest.importorskip("yaml")
    tmp = tmp_path_factory.mktemp("item11")
    lm = write_lm_corpus(tmp / "lm", n_lines=300)
    (lm / "dev.txt").write_text((lm / "valid.txt").read_text())
    return {"text": write_aligned(tmp / "text"), "lm": lm}


@pytest.mark.parametrize("recipe", RECIPES)
def test_cli_trains_the_recipe_at_one_layer_and_decodes(corpora, tmp_path, recipe):
    data = corpora["lm" if recipe == LM else "text"]
    cfg = build_config([ROOT / recipe], overrides(recipe, data, tmp_path))
    out = cli_train.main(cfg, device="cpu")
    assert out["trainer"].step == 2
    assert all(np.isfinite(r["loss"]) for r in out["train_log"])
    last = out["history"][-1]
    assert np.isfinite(last["loss"])
    if recipe == ALIGN:
        assert "alignment_loss" in last
    if recipe in NAT:  # per-head means: the reported loss is the criterion's own
        assert "word_ins_loss" in last or "nll_loss" in last
    if recipe == LM:
        return  # a language model has no generator
    gen = cli_generate.main(cfg, out["model"].state_dict(), device="cpu")
    hyps = [x for x in (gen["out_dir"] / "generate-test.txt").read_text().splitlines()
            if x.startswith("H-")]
    assert gen["n_utts"] == len(hyps) == 4


@pytest.mark.parametrize("recipe", [NAT[0], NAT[2]])
def test_cli_generate_and_hub_write_jax_lines(corpora, tmp_path, recipe):
    import jax

    from s2t_tpu.cli import generate as jax_generate
    from s2t_tpu.config import build_config as jax_build_config
    from s2t_tpu.hub import GeneratorHub as JaxHub
    from s2t_tpu.tasks import setup_task as jax_setup_task
    from s2t_tpu_torch.hub import from_pretrained
    from s2t_tpu_torch.interop.from_flax import state_dict_to_flax
    from s2t_tpu_torch.tasks import setup_task

    data = corpora["text"]
    ov = overrides(recipe, data, tmp_path) + ["generation.iter_decode_max_iter=3"]
    cfg, jcfg = build_config([ROOT / recipe], ov), jax_build_config([ROOT / recipe], ov)
    model = setup_task(cfg).build_model(device="cpu", seed=3)
    params = state_dict_to_flax(model.state_dict())
    got = cli_generate.main(cfg, model.state_dict(), device="cpu")
    jcfg.generation.results_path = str(tmp_path / "jgen")
    jax_generate.main(jcfg, jax.tree.map(np.asarray, params))
    for name in ("generate-test.txt", "translation-test.txt"):
        assert (got["out_dir"] / name).read_text() == (tmp_path / "jgen" / name).read_text(), name
    if recipe != NAT[0]:
        return
    ckpt = tmp_path / "model.pt"
    save_tree(ckpt, {"params": model.state_dict()})
    jtask = jax_setup_task(jcfg)
    jmodel = jtask.build_model()
    jhub = JaxHub(jcfg, jtask, jmodel, params, jtask.build_generator(jmodel))
    hub = from_pretrained(ckpt, task=setup_task(cfg), device="cpu")
    requests = (data / "test.en").read_text().splitlines()
    assert hub.generate(requests) == jhub.generate(requests)


def test_chip_smoke_carries_the_recipes():
    """chip_smoke.py phases 42-45 run these recipes' sections (the card has no yaml
    package, so the script carries copies)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    for recipe, copy in zip(RECIPES, (chip_smoke.FCONV_RECIPE, chip_smoke.ADAPTIVE_LM_RECIPE,
                                      chip_smoke.ALIGN_RECIPE, *chip_smoke.NAT_RECIPES.values())):
        assert yaml.safe_load((ROOT / recipe).read_text()) == copy, recipe
    assert list(chip_smoke.NAT_RECIPES) == ["cmlm", "levenshtein", "insertion", "nacrf"]


def test_chip_smoke_defines_each_top_level_name_once():
    """A phase helper that reuses an earlier one's name replaces it for every phase."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name)]
    assert sorted({n for n in names if names.count(n) > 1}) == []
