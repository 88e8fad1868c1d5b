"""The item-9 and item-15 recipes in the port.

* the census: ``dual.yaml``, ``multibranch.yaml``, ``w2v2.yaml``,
  ``wav2vec2_base.yaml``, ``wav2vec_ctc_finetune.yaml`` (item 9),
  ``quant_noise.yaml`` and ``multilingual.yaml`` (item 15), each over its
  directory's ``basis.yaml``, resolve through ``build_config`` ->
  ``check_train_supported`` -> ``build_criterion`` -> ``build_model`` with one
  layer a stack, and no port module names item 9 any more;
* ``audio_pretraining``: its manifest batches equal JAX's, the Gumbel
  temperature is JAX's float32 schedule, and ``cli.train`` runs
  ``wav2vec2_base.yaml`` (``polynomial_decay`` held at lr) for 2 updates;
* ``cli.train`` runs ``quant_noise.yaml``, ``multilingual.yaml`` (its
  comma-separated splits), ``dual.yaml`` and ``multibranch.yaml`` for 2 updates
  on tiny corpora;
* chip_smoke.py carries these recipes' sections as they are.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.cli import train as cli_train
from s2t_tpu_torch.config import TrainConfig, build_config, check_train_supported, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.tasks.audio_pretraining import gumbel_temperature
from tests.test_torch_train_settings import LANGS, _multilingual_corpus
from tests.test_torch_wav2vec2 import CONV
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
W2V_TINY = {"conv_feature_layers": [list(c) for c in CONV], "encoder_embed_dim": 32,
            "encoder_ffn_embed_dim": 64, "encoder_layers": 1, "encoder_attention_heads": 2,
            "conv_pos": 16, "conv_pos_groups": 4, "final_dim": 16, "latent_vars": 8,
            "num_negatives": 4, "mask_length": 2}
ONE_LAYER = {
    "s2t_dual_s": {"speech_encoder_layers": 1, "speech_decoder_layers": 1,
                   "text_encoder_layers": 1},
    "s2t_multibranch_s": {"junior_layers": 1, "senior_layers": 1, "textual_layers": 1,
                          "decoder_layers": 1},
    "s2t_w2v2_transformer_base": {"w2v_encoder_layers": 1, "encoder_layers": 1,
                                  "decoder_layers": 1},
    "wav2vec2_base": {"encoder_layers": 1},
    "wav2vec_ctc": {"encoder_layers": 1},
    "s2t_transformer_s": {"encoder_layers": 1, "decoder_layers": 1},
    "s2t_transformer_m": {"encoder_layers": 1, "decoder_layers": 1},
}
RECIPES = ["egs/mustc/st/conf/dual.yaml", "egs/mustc/st/conf/multibranch.yaml",
           "egs/mustc/st/conf/w2v2.yaml", "egs/librispeech/pretraining/wav2vec2_base.yaml",
           "egs/librispeech/pretraining/wav2vec_ctc_finetune.yaml",
           "egs/mustc/st/conf/quant_noise.yaml", "egs/mustc/st_multilingual/multilingual.yaml"]


def recipe_config(recipe, overrides=()):
    path = ROOT / recipe
    basis = path.parent / "basis.yaml"
    return build_config([basis, path] if basis.exists() else [path], list(overrides))


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_resolves_and_builds_with_one_layer(recipe):
    pytest.importorskip("yaml")
    cfg = recipe_config(recipe)
    check_train_supported(cfg)
    build_criterion(cfg.criterion, cfg.criterion_cfg)
    arch = cfg.arch or "s2t_transformer_s"
    model = {**cfg.model, **ONE_LAYER[arch]}
    ctx = {} if cfg.task == "audio_pretraining" or arch == "wav2vec_ctc" else {"vocab_size": 32}
    m = build_model(arch, model, device="cpu", for_training=True, **ctx)
    assert sum(p.numel() for p in m.parameters()) > 0
    if "quant_noise" in recipe:
        assert cfg.optimization.quant_noise_p == 0.1
    if "multilingual" in recipe:
        assert "," in cfg.dataset.train_subset


def test_no_port_module_names_item_9_for_this_slice():
    from s2t_tpu_torch.models import build
    from s2t_tpu_torch.registry import ARCHS, MODELS

    # item 9's tail (berard, wav2vec v1, the Emformer) is ported, as is every arch since:
    # the registry keeps no unported preset
    assert not hasattr(build, "UNPORTED_ARCHS")
    for model in ("berard", "wav2vec", "emformer"):
        assert MODELS.get(model) is not None
        assert any(ARCHS.get(a)[0] == model for a in ARCHS.keys())


def _manifest(root: Path, n=6) -> Path:
    rng = np.random.default_rng(3)
    lines = [str(root)]
    for i in range(n):
        k = int(rng.integers(3000, 9000))
        np.save(root / f"a{i}.npy", rng.normal(size=k).astype(np.float32))
        lines.append(f"a{i}.npy\t{k}")
    for split in ("train", "valid"):
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")
    return root


def test_audio_pretraining_batches_and_temperature_match_jax(tmp_path):
    root = _manifest(tmp_path)
    d = {"task": "audio_pretraining", "arch": "wav2vec2_base", "criterion": "wav2vec",
         "task_cfg": {"max_sample_size": 7000}, "model": {"normalize": True},
         "dataset": {"data": str(root), "max_tokens": 16000, "num_buckets": 2}}
    task = setup_task(from_dict(TrainConfig, d))
    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, d))
    its = [t.get_batch_iterator(t.load_dataset("train", True), seed=2,
                                **({} if t is task else {"batch_size_multiple": 1}))
           for t in (task, jtask)]
    got, want = (list(it.next_epoch_itr()) for it in its)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
    for step in (0, 1, 1000, 10 ** 6):
        t0, t1, decay = 2.0, 0.5, 0.999995
        want_t = jnp.maximum(t0 * decay ** jnp.asarray(step, jnp.int32).astype(jnp.float32), t1)
        assert gumbel_temperature((t0, t1, decay), step).item() == float(want_t)


def test_cli_trains_wav2vec2_base(tmp_path):
    pytest.importorskip("yaml")
    (tmp_path / "data").mkdir()
    root = _manifest(tmp_path / "data")
    model = ",".join(f"{k}: {v}" for k, v in W2V_TINY.items())
    cfg = recipe_config("egs/librispeech/pretraining/wav2vec2_base.yaml", [
        f"model={{{model}, dtype_str: float32}}", "optimization.max_update=2",
        "task_cfg.max_sample_size=6000", "dataset.max_tokens=14000",
        f"dataset.data={root}", "dataset.valid_subset=valid",
        f"checkpoint.save_dir={tmp_path / 'ckpt'}", "checkpoint.async_save=false"])
    out = cli_train.main(cfg, device="cpu")
    assert [r["step"] for r in out["train_log"]] == [1, 2]
    assert all(r["lr"] == pytest.approx(5e-4) for r in out["train_log"])  # held: no ramp
    assert np.isfinite(out["history"][-1]["loss"]) and "prob_perplexity" in out["history"][-1]
    assert (tmp_path / "ckpt" / "checkpoint_last.pt").exists()


def _feature_corpus(root: Path, splits, words=("aa", "bb", "cc")) -> Path:
    rng = np.random.default_rng(6)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    for split in splits:
        lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
        for i in range(4):
            t = int(rng.integers(20, 50))
            np.save(root / f"{split}{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            text = " ".join(rng.choice(words, size=3))
            lines.append(f"{split}{i}\t{split}{i}.npy\t{t}\t{text}\t{text}")
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")
    return root


TINY_S2T = ("model={encoder_layers: 1, decoder_layers: 1, encoder_embed_dim: 32, "
            "decoder_embed_dim: 32, encoder_ffn_embed_dim: 64, decoder_ffn_embed_dim: 64, "
            "encoder_attention_heads: 2, decoder_attention_heads: 2, subsampling_filter: 32}")


TINY_DUAL = ("model={speech_encoder_layers: 1, speech_decoder_layers: 1, text_encoder_layers: 1, "
             "speech_encoder_embed_dim: 32, speech_decoder_embed_dim: 32, "
             "speech_encoder_ffn_embed_dim: 64, speech_decoder_ffn_embed_dim: 64, "
             "text_encoder_ffn_embed_dim: 64, speech_encoder_attention_heads: 2, "
             "speech_decoder_attention_heads: 2, speech_subsampling_filter: 32}")
TINY_MB = ("model={junior_layers: 1, senior_layers: 1, textual_layers: 1, decoder_layers: 1, "
           "encoder_embed_dim: 32, decoder_embed_dim: 32, encoder_ffn_embed_dim: 64, "
           "decoder_ffn_embed_dim: 64, encoder_attention_heads: 2, decoder_attention_heads: 2, "
           "subsampling_filter: 32}")


@pytest.mark.parametrize("recipe,model", [
    ("egs/mustc/st/conf/quant_noise.yaml", TINY_S2T),
    ("egs/mustc/st_multilingual/multilingual.yaml", TINY_S2T),
    ("egs/mustc/st/conf/dual.yaml", TINY_DUAL),
    ("egs/mustc/st/conf/multibranch.yaml", TINY_MB),
], ids=["quant_noise", "multilingual", "dual", "multibranch"])
def test_cli_trains_recipe(tmp_path, recipe, model):
    """2 updates and a validation; the dual / multibranch models validate without
    eval_bleu, as their missing incremental decoder fails JAX's generator too."""
    pytest.importorskip("yaml")
    if "multilingual" in recipe:
        root = _multilingual_corpus(tmp_path)
        (root / "config.yaml").write_text("vocab_filename: dict.txt\nprepend_tgt_lang_tag: true\n"
                                          "sampling_alpha: 0.5\n")
        for lang in LANGS:  # the recipe's split names
            (root / f"train_{lang}_st.tsv").write_text((root / f"train_{lang}.tsv").read_text())
        (root / "dev_de_st.tsv").write_text((root / "train_de.tsv").read_text())
    else:
        root = _feature_corpus(tmp_path, ("train", "dev"))
    cfg = recipe_config(recipe, [
        model, "optimization.max_update=2", "dataset.max_tokens=400",
        "dataset.max_source_positions=100", "dataset.num_buckets=2", "eval.eval_bleu=false",
        f"dataset.data={root}", f"checkpoint.save_dir={tmp_path / 'ckpt'}",
        "checkpoint.async_save=false"])
    out = cli_train.main(cfg, device="cpu")
    assert out["trainer"].step == 2
    assert all(np.isfinite(r["loss"]) for r in out["train_log"])
    if "multilingual" in recipe:
        assert len(out["task"].datasets[cfg.dataset.train_subset].datasets) == 3


def test_chip_smoke_carries_the_recipes():
    """chip_smoke.py phases 31-35 run these recipes' sections (the card has no yaml
    package, so the script carries copies)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    def conf(path):
        return {k: v for k, v in yaml.safe_load((ROOT / path).read_text()).items()}

    assert conf("egs/librispeech/pretraining/wav2vec2_base.yaml") == chip_smoke.W2V2_BASE_RECIPE
    assert conf("egs/mustc/st/conf/w2v2.yaml") == chip_smoke.W2V2_ST_RECIPE
    assert conf("egs/librispeech/pretraining/wav2vec_ctc_finetune.yaml") == \
        chip_smoke.W2V_CTC_RECIPE
    assert conf("egs/mustc/st/conf/dual.yaml") == chip_smoke.DUAL_RECIPE
    assert conf("egs/mustc/st/conf/multibranch.yaml") == chip_smoke.MULTIBRANCH_RECIPE
    assert conf("egs/mustc/st/conf/quant_noise.yaml") == chip_smoke.QUANT_NOISE_RECIPE
    assert conf("egs/mustc/st_multilingual/multilingual.yaml") == chip_smoke.MULTILINGUAL_RECIPE
    basis = conf("egs/mustc/st/conf/basis.yaml")
    assert basis["criterion"] == chip_smoke.MUSTC_ST_BASIS["criterion"]
    for section in ("dataset", "optimization"):
        assert {k: basis[section][k] for k in chip_smoke.MUSTC_ST_BASIS[section]} == \
            chip_smoke.MUSTC_ST_BASIS[section]
    # the K1f layers the phases count: 12 a wav2vec2_base encode, 18 for w2v2.yaml's model
    # (12 w2v + 6) and the dual model (12 speech + 6 text), 24 for multibranch (12 + 6 + 6)
    from s2t_tpu_torch.models.s2t_dual import s2t_dual_s
    from s2t_tpu_torch.models.s2t_multibranch import s2t_multibranch_s
    from s2t_tpu_torch.models.s2t_w2v2_transformer import s2t_w2v2_transformer_base
    from s2t_tpu_torch.models.wav2vec2 import wav2vec2_base, wav2vec_ctc_arch

    assert [chip_smoke.encoder_layers(c) for c in (
        wav2vec2_base(), wav2vec_ctc_arch(), s2t_w2v2_transformer_base(), s2t_dual_s(),
        s2t_multibranch_s())] == [12, 12, 18, 18, 24]
