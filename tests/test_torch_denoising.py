"""BART's denoising data and tasks, mBART's fine-tuning task and the BART recipes
against the JAX package.

* ``bart_noise`` returns JAX's ids over 5 seeds for every noise knob (sentence
  permutation, Poisson span infilling with random tokens, a zero ``poisson_lambda``'s
  pure insertions, deletion, insertion, no masking) and a one-token line;
* ``denoising``: the batches of two epochs through ``get_batch_iterator`` equal JAX's
  key for key (fresh noise each epoch, the noise knobs from ``task_cfg``);
* ``multilingual_denoising``: ``<mask>`` and the ``<lang:xx>`` tags join the
  dictionary as in JAX, each language's items carry its tag (appended to the source,
  prepended to the target), the temperature sampling's order and the batches equal
  JAX's;
* ``translation_from_pretrained_bart``: the tags join a shared dictionary once and
  separate ones each, the sources end with the source tag and the targets start with
  the target tag, the batches equal JAX's;
* the recipes: ``egs/cnn_dm/bart/mbart_ft_mt.yaml`` resolves, passes the training
  checks and builds ``mbart_large`` at one layer; ``denoising_pretrain.yaml`` builds
  ``bart_base`` and then fails at its ``polynomial`` scheduler, in JAX with a
  ``KeyError`` and in the port with ``NotImplementedError``;
* chip_smoke.py phases 46-47 carry both recipes' sections as they are.
"""

from pathlib import Path

import numpy as np
import pytest

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import build_config as jax_build_config
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data.denoising_dataset import bart_noise as jax_bart_noise
from s2t_tpu.optim.builders import build_lr_schedule as jax_build_lr_schedule
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.config import TrainConfig, build_config, check_train_supported, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.data.denoising_dataset import bart_noise
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.optim.builders import build_lr_schedule
from s2t_tpu_torch.tasks import setup_task
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
BART = "egs/cnn_dm/bart/denoising_pretrain.yaml"
MBART = "egs/cnn_dm/bart/mbart_ft_mt.yaml"
WORDS = [f"w{i}" for i in range(30)] + ["."]
KNOBS = {
    "recipe": dict(mask_ratio=0.3, poisson_lambda=3.5, permute_sentence_ratio=1.0),
    "random": dict(mask_ratio=0.5, poisson_lambda=2.0, random_ratio=0.5,
                   permute_sentence_ratio=0.5),
    "pure_insertions": dict(mask_ratio=0.4, poisson_lambda=0.0),
    "delete_insert": dict(mask_ratio=0.2, delete_ratio=0.3, insert_ratio=0.25),
    "no_mask": dict(mask_ratio=0.0, insert_ratio=0.1, permute_sentence_ratio=0.0),
}


def line(rng, n):
    toks = list(rng.choice(WORDS[:-1], size=n))
    for i in sorted(rng.choice(n, size=max(n // 5, 1), replace=False)):
        toks[i] = "."
    return " ".join(toks)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_bart_noise_matches_jax(knobs):
    rng = np.random.default_rng(0)
    stop = 4 + WORDS.index(".")
    for n in (1, 2, 9, 25, 40):
        tokens = np.concatenate([rng.integers(4, 4 + len(WORDS), size=n), [2]]).astype(np.int32)
        tokens[rng.choice(n, size=max(n // 4, 1), replace=False)] = stop
        for seed in range(5):
            kw = dict(mask_id=40, vocab_size=41, full_stop_id=stop, **KNOBS[knobs])
            got = bart_noise(tokens, np.random.default_rng(seed), **kw)
            want = jax_bart_noise(tokens, np.random.default_rng(seed), **kw)
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} seed={seed}")
            assert got.dtype == want.dtype and got[-1] == 2


def write_text(root: Path, splits, langs=(None,), seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    for lang in langs:
        d = root if lang is None else root / lang
        d.mkdir(exist_ok=True)
        for split, n in splits.items():
            (d / f"{split}.txt").write_text(
                "\n".join(line(rng, int(rng.integers(3, 18))) for _ in range(n)) + "\n")
    return root


def tasks(d):
    return setup_task(from_dict(TrainConfig, d)), jax_setup_task(jax_from_dict(JaxTrainConfig, d))


def assert_batches_equal(task, jtask, split, epochs=(1, 2)):
    its = [t.get_batch_iterator(t.load_dataset(split, True), seed=3,
                                **({} if t is task else {"batch_size_multiple": 1}))
           for t in (task, jtask)]
    for epoch in epochs:
        got, want = (list(it.next_epoch_itr()) for it in its)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]),
                                              err_msg=f"epoch {epoch} {key}")
        for it in its:
            it.next_epoch()


def denoising_cfg(root, task="denoising", **task_cfg):
    return {"task": task, "arch": "bart_base", "criterion": "label_smoothed_cross_entropy",
            "task_cfg": task_cfg, "common": {"seed": 5},
            "dataset": {"data": str(root), "max_tokens": 400, "num_buckets": 2,
                        "max_source_positions": 64, "max_target_positions": 64}}


def test_denoising_batches_match_jax(tmp_path):
    root = write_text(tmp_path, {"train": 30})
    task, jtask = tasks(denoising_cfg(root, mask_ratio=0.4, poisson_lambda=2.5,
                                      random_ratio=0.3, delete_ratio=0.1))
    assert task.mask_id == jtask.mask_id == len(WORDS) + 4
    assert task.dictionary.indices == jtask.dictionary.indices
    assert_batches_equal(task, jtask, "train")
    ds = task.datasets["train"]
    ds.set_epoch(1)
    first = ds[0]["source"]
    ds.set_epoch(2)
    assert not np.array_equal(first, ds[0]["source"])  # fresh noise each epoch
    np.testing.assert_array_equal(ds[0]["target"], ds.items[0])


def test_multilingual_denoising_tags_and_sampling_match_jax(tmp_path):
    root = write_text(tmp_path, {"train": 24, "dev": 4}, langs=("de", "en"))
    for lang, n in (("fr", 6),):  # a small third language: upsampled at alpha 0.7
        (root / lang).mkdir()
        rng = np.random.default_rng(9)
        (root / lang / "train.txt").write_text(
            "\n".join(line(rng, int(rng.integers(3, 12))) for _ in range(n)) + "\n")
    task, jtask = tasks(denoising_cfg(root, "multilingual_denoising"))
    assert task.langs == jtask.langs == ["de", "en", "fr"]
    assert task.lang_tags == jtask.lang_tags
    assert task.dictionary.indices == jtask.dictionary.indices
    assert task.lang_tags["de"] == task.mask_id + 1
    ds, jds = task.load_dataset("train", True), jtask.load_dataset("train", True)
    order = ds.ordered_indices(seed=3, epoch=1)
    np.testing.assert_array_equal(order, jds.ordered_indices(seed=3, epoch=1))
    assert (order >= 48).sum() > 6  # the small language is upsampled
    for i in (0, 24, 47, 50):
        item, jitem = ds[i], jds[i]
        tag = task.lang_tags[["de", "en", "fr"][min(i // 24, 2)]]
        assert item["source"][-1] == tag and item["target"][0] == tag
        for key in ("source", "target"):
            np.testing.assert_array_equal(item[key], jitem[key])
    assert_batches_equal(task, jtask, "train", epochs=(1,))
    # task_cfg.langs picks and orders the languages
    picked, _ = tasks(denoising_cfg(root, "multilingual_denoising", langs="fr,de"))
    assert picked.langs == ["fr", "de"]


def write_pair(root: Path, shared: bool, seed=1):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "dict.de.txt").write_text("".join(f"t{i} 1\n" for i in range(20)))
    if not shared:
        (root / "dict.en.txt").write_text("".join(f"s{i} 1\n" for i in range(15)))
    (root / "config.yaml").write_text(
        "vocab_filename: dict.de.txt\n" + ("" if shared else "src_vocab_filename: dict.en.txt\n"))
    src_words = [f"t{i}" for i in range(20)] if shared else [f"s{i}" for i in range(15)]
    for split, n in (("train", 20), ("dev", 4)):
        (root / f"{split}.en").write_text("\n".join(
            " ".join(rng.choice(src_words, size=int(rng.integers(2, 7)))) for _ in range(n)) + "\n")
        (root / f"{split}.de").write_text("\n".join(
            " ".join(f"t{j}" for j in rng.integers(0, 20, size=int(rng.integers(2, 6))))
            for _ in range(n)) + "\n")
    return root


@pytest.mark.parametrize("shared", [True, False])
def test_translation_from_pretrained_bart_tags_match_jax(tmp_path, shared):
    pytest.importorskip("yaml")
    root = write_pair(tmp_path, shared)
    d = {"task": "translation_from_pretrained_bart", "task_cfg": {"langs": "en,de,fr"},
         "criterion": "label_smoothed_cross_entropy",
         "dataset": {"data": str(root), "max_tokens": 60, "num_buckets": 2,
                     "max_source_positions": 64, "max_target_positions": 64}}
    task, jtask = tasks(d)
    n_src = 20 if shared else 15
    for got, want, n in ((task.src_dict, jtask.src_dict, n_src),
                         (task.tgt_dict, jtask.tgt_dict, 20)):
        assert got.indices == want.indices
        assert [got.index(s) for s in ("<mask>", "<lang:en>", "<lang:de>", "<lang:fr>")] == \
            [n + 4 + i for i in range(4)]  # once each, after the 4 specials and the words
    assert (task.src_dict is task.tgt_dict) == shared
    ds = task.load_dataset("train", True)
    item = ds[0]
    assert item["source"][-2:].tolist() == [2, task.src_dict.index("<lang:en>")]
    assert item["target"][0] == task.tgt_dict.index("<lang:de>") and item["target"][-1] == 2
    assert_batches_equal(task, jtask, "train", epochs=(1,))
    assert not task.cfg.arch and task.default_arch == "mbart_large"


def one_layer_model(cfg, vocab):
    return build_model(cfg.arch, {**cfg.model, "encoder_layers": 1, "decoder_layers": 1},
                       device="cpu", vocab_size=vocab, max_source_positions=64,
                       max_target_positions=64)


def test_mbart_ft_mt_recipe_builds():
    pytest.importorskip("yaml")
    cfg = build_config([ROOT / MBART])
    check_train_supported(cfg)
    build_criterion(cfg.criterion, cfg.criterion_cfg)
    m = one_layer_model(cfg, 40)
    assert (cfg.task, cfg.arch, m.cfg.encoder_embed_dim) == (
        "translation_from_pretrained_bart", "mbart_large", 1024)
    assert m.cfg.encoder_normalize_before and cfg.checkpoint.finetune_from_model == "mbart/model.pt"
    assert build_lr_schedule(cfg.optimization) is not None


def test_denoising_pretrain_recipe_fails_at_its_scheduler_in_both_packages():
    pytest.importorskip("yaml")
    cfg, jcfg = build_config([ROOT / BART]), jax_build_config([ROOT / BART])
    assert cfg.optimization.lr_scheduler == jcfg.optimization.lr_scheduler == "polynomial"
    build_criterion(cfg.criterion, cfg.criterion_cfg)
    m = one_layer_model(cfg, 40)
    assert m.cfg.encoder_embed_dim == 768 and not m.cfg.encoder_normalize_before
    with pytest.raises(KeyError, match="polynomial"):
        jax_build_lr_schedule(jcfg.optimization)
    with pytest.raises(NotImplementedError, match="polynomial"):
        build_lr_schedule(cfg.optimization)
    with pytest.raises(NotImplementedError, match="polynomial"):
        check_train_supported(cfg)


def test_chip_smoke_carries_the_bart_recipes():
    """chip_smoke.py phases 46-47 run these recipes' sections (the card has no yaml
    package, so the script carries copies)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    assert yaml.safe_load((ROOT / BART).read_text()) == chip_smoke.BART_RECIPE
    assert yaml.safe_load((ROOT / MBART).read_text()) == chip_smoke.MBART_RECIPE
