"""The translation tasks against the JAX package.

A whitespace-token corpus (source and target dictionaries of 20 words each,
``config.yaml`` naming them), raw text and fairseq-binarised pairs:

* raw and binarised batches equal JAX's, key for key (bucketing, order,
  collation); the ``.idx`` / ``.bin`` files each package writes read back in the
  other; Pharaoh word alignments collate as JAX's;
* both CLIs train ``transformer`` one update from one flax init with ``eval_bleu``
  validation (``best_checkpoint_metric: bleu``): validation losses at rtol 1e-4
  and BLEU equal; then ``cli.generate`` decodes the test split beam 2 and writes
  ``generate-test.txt`` (its T-/H-/D- lines) and ``translation-test.txt`` as
  JAX's;
* ``hub.from_pretrained`` answers raw text requests with JAX's detokenised top
  hypotheses;
* SATE's MT leg: an MT checkpoint's decoder transplants into ``s2t_sate_s``
  through the CLI hook as in JAX, and its encoder raises ``KeyError`` at JAX's
  point ("encoder", and "encoder/textual" from "encoder").
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data.indexed_dataset import MMapIndexedDataset as JaxMMap
from s2t_tpu.data.indexed_dataset import MMapIndexedDatasetBuilder as JaxBuilder
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu.utils.checkpoint import transplant_component as jax_transplant
from s2t_tpu_torch.config import CheckpointConfig, TrainConfig, from_dict
from s2t_tpu_torch.data.indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.utils.checkpoint import save_tree, transplant_component
from tests.test_torch_train_trainer import flat
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

SRC_WORDS = [f"s{i}" for i in range(20)]
TGT_WORDS = [f"t{i}" for i in range(20)]
MODEL = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=1,
             encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
             decoder_layers=1, decoder_attention_heads=2, encoder_normalize_before=True,
             decoder_normalize_before=True, dropout=0.0)


def write_corpus(root: Path, n_train=12, seed=0) -> Path:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "dict.en.txt").write_text("".join(f"{w} 1\n" for w in SRC_WORDS))
    (root / "dict.de.txt").write_text("".join(f"{w} 1\n" for w in TGT_WORDS))
    (root / "config.yaml").write_text("vocab_filename: dict.de.txt\n"
                                      "src_vocab_filename: dict.en.txt\n")
    for split, n in (("train", n_train), ("dev", 4), ("test", 4)):
        src, tgt = [], []
        for _ in range(n):
            k = int(rng.integers(2, 7))
            src.append(" ".join(rng.choice(SRC_WORDS, size=k)))
            tgt.append(" ".join(rng.choice(TGT_WORDS, size=int(rng.integers(2, 6)))))
        (root / f"{split}.en").write_text("\n".join(src) + "\n")
        (root / f"{split}.de").write_text("\n".join(tgt) + "\n")
    return root


def cfg_dict(root, save_dir=None, results=None, **sections):
    d = {"task": "translation_with_tokenizer", "arch": "transformer", "model": dict(MODEL),
         "criterion": "label_smoothed_cross_entropy",
         "dataset": {"data": str(root), "max_tokens": 40, "num_buckets": 2,
                     "max_source_positions": 64, "max_target_positions": 64,
                     "gen_subset": "test"},
         "optimization": {"lr": 1e-3, "warmup_updates": 2, "max_update": 1},
         "checkpoint": {"save_dir": str(save_dir or root), "async_save": False,
                        "reset_optimizer": True, "no_save": True,
                        "best_checkpoint_metric": "bleu",
                        "maximize_best_checkpoint_metric": True},
         "eval": {"eval_bleu": True, "eval_gen_beam": 2},
         "common": {"log_interval": 1},
         "generation": {"beam": 2, "max_len_b": 8, "scoring": "sacrebleu",
                        "post_process": None, "results_path": str(results or root)}}
    for k, v in sections.items():
        d[k] = {**d.get(k, {}), **v} if isinstance(v, dict) else v
    return d


def assert_batches_equal(task, jtask, split):
    its = [t.get_batch_iterator(t.load_dataset(split, True), seed=3,
                                **({} if t is task else {"batch_size_multiple": 1}))
           for t in (task, jtask)]
    got, want = (list(it.next_epoch_itr()) for it in its)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)


def test_raw_and_binarized_batches_match_jax(tmp_path):
    pytest.importorskip("yaml")
    root = write_corpus(tmp_path / "raw", n_train=40)
    d = cfg_dict(root)
    task, jtask = setup_task(from_dict(TrainConfig, d)), jax_setup_task(
        jax_from_dict(JaxTrainConfig, d))
    assert_batches_equal(task, jtask, "train")
    # binarised: the port writes train, JAX writes dev; each reads the other's
    bin_root = write_corpus(tmp_path / "bin", n_train=40)
    for split, builder_cls in (("train", MMapIndexedDatasetBuilder), ("dev", JaxBuilder)):
        for lang, dic in (("en", task.src_dict), ("de", task.tgt_dict)):
            b = builder_cls(bin_root / f"{split}.en-de.{lang}")
            for line in (root / f"{split}.{lang}").read_text().splitlines():
                b.add_item(dic.encode_line(line, append_eos=True))
            b.finalize()
    for lang in ("en", "de"):
        for split in ("train", "dev"):
            mine, theirs = (cls(bin_root / f"{split}.en-de.{lang}")
                            for cls in (MMapIndexedDataset, JaxMMap))
            assert len(mine) == len(theirs)
            for i in range(len(mine)):
                np.testing.assert_array_equal(mine[i], theirs[i])
    d = cfg_dict(bin_root)
    task, jtask = setup_task(from_dict(TrainConfig, d)), jax_setup_task(
        jax_from_dict(JaxTrainConfig, d))
    assert type(task.load_dataset("train")).__name__ == "BinarizedTranslationDataset"
    assert_batches_equal(task, jtask, "train")
    # Pharaoh alignments (transformer_align's), an empty line among them, collate as JAX's
    rng = np.random.default_rng(5)
    (root / "train.align").write_text("".join(
        " ".join(f"{rng.integers(0, 6)}-{rng.integers(0, 5)}"
                 for _ in range(int(rng.integers(0, 4)))) + "\n" for _ in range(40)))
    d = cfg_dict(root, task_cfg={"load_alignments": True})
    task, jtask = setup_task(from_dict(TrainConfig, d)), jax_setup_task(
        jax_from_dict(JaxTrainConfig, d))
    assert_batches_equal(task, jtask, "train")
    assert "alignments" in next(iter(task.get_batch_iterator(
        task.load_dataset("train"), seed=3).next_epoch_itr()))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both CLIs train one update from one flax init (JAX's CLI compiles its step again for
    a second, the state's placement having changed); the port's checkpoint is saved."""
    pytest.importorskip("yaml")
    from s2t_tpu.cli import train as jax_train
    from s2t_tpu.utils.checkpoint import save_pytree
    from s2t_tpu_torch.cli import train as cli_train

    tmp = tmp_path_factory.mktemp("mt")
    root = write_corpus(tmp / "data")
    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, cfg_dict(root)))
    src = np.full((2, 5), 4, np.int32)
    params = jax.tree.map(np.asarray, jax.jit(jtask.build_model().init)(
        jax.random.PRNGKey(0), src, np.array([5, 5], np.int32), src)["params"])
    for who in ("jax", "port"):
        (tmp / who).mkdir()
    save_pytree(tmp / "jax" / "checkpoint_last.pt", {"params": params})
    save_tree(tmp / "port" / "checkpoint_last.pt", {"params": flax_to_state_dict(params)})
    want = jax_train.main(jax_from_dict(JaxTrainConfig, cfg_dict(root, tmp / "jax")))
    got = cli_train.main(from_dict(TrainConfig, cfg_dict(root, tmp / "port")), device="cpu")
    return tmp, root, want, got


def test_cli_train_with_bleu_validation_and_generate_match_jax(trained):
    from s2t_tpu.cli import generate as jax_generate
    from s2t_tpu_torch.cli import generate as cli_generate

    tmp, root, want, got = trained
    assert got["trainer"].step == int(want["state"].step) == 1
    for mine, theirs in zip(got["history"], want["history"], strict=True):
        for key in ("loss", "nll_loss"):
            np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-4,
                                       err_msg=f"{key}, rtol 1e-4")
        assert mine["bleu"] == pytest.approx(theirs["bleu"], abs=1e-9)
    params = jax.tree.map(np.asarray, want["state"].params)
    jax_generate.main(jax_from_dict(JaxTrainConfig, cfg_dict(root, tmp, tmp / "jgen")), params)
    out = cli_generate.main(from_dict(TrainConfig, cfg_dict(root, tmp, tmp / "pgen")),
                            flax_to_state_dict(params), device="cpu")
    assert out["n_utts"] == 4

    def lines(name, who):
        return (tmp / who / name).read_text().splitlines()

    assert len([x for x in lines("generate-test.txt", "pgen") if x.startswith("H-")]) == 4
    for name in ("generate-test.txt", "translation-test.txt"):
        assert lines(name, "pgen") == lines(name, "jgen"), name


def test_hub_answers_text_requests_as_jax(trained):
    from s2t_tpu.hub import GeneratorHub as JaxHub
    from s2t_tpu_torch.hub import from_pretrained

    tmp, root, want, got = trained
    requests = ["s1 s2 s3", "s4 s5", "s19 s0 s7 s7"]
    jcfg = jax_from_dict(JaxTrainConfig, cfg_dict(root))
    jtask = jax_setup_task(jcfg)
    jmodel = jtask.build_model()
    jhub = JaxHub(jcfg, jtask, jmodel, state_dict_to_flax(got["model"].state_dict()),
                  jtask.build_generator(jmodel))
    ckpt = tmp / "port_model.pt"
    save_tree(ckpt, {"params": got["model"].state_dict()})
    hub = from_pretrained(ckpt, data_dir=str(root), config=cfg_dict(root), device="cpu")
    assert hub.generate(requests) == jhub.generate(requests)
    assert hub.translate(requests[0]) == jhub.translate(requests[0])


def test_sate_mt_leg_decoder_transplants_and_encoder_raises_as_jax(trained, tmp_path):
    from s2t_tpu_torch.cli.train import transplant_pretrained
    from s2t_tpu_torch.models import sate as tsate

    tmp, root, want, got = trained
    mt = got["model"].state_dict()
    sate = tsate.S2TSATEModel(tsate.s2t_sate_s(
        acoustic_encoder_embed_dim=16, acoustic_encoder_ffn_embed_dim=32,
        acoustic_encoder_layers=1, acoustic_encoder_attention_heads=2,
        acoustic_decoder_embed_dim=16, acoustic_decoder_ffn_embed_dim=32,
        acoustic_decoder_layers=1, acoustic_decoder_attention_heads=2,
        acoustic_subsampling_filter=32, text_encoder_layers=1, text_attention_heads=2,
        text_ffn_embed_dim=32, vocab_size=len(TGT_WORDS) + 4), device="cpu")
    tgt = sate.state_dict()
    jtgt, jsrc = state_dict_to_flax(tgt), state_dict_to_flax(mt)
    jax_got = jax_transplant(jtgt, jsrc, "decoder")
    save_tree(tmp_path / "mt.pt", {"params": mt})
    transplant_pretrained(CheckpointConfig(load_pretrained_decoder_from=str(tmp_path / "mt.pt")),
                          sate)
    got_tree = dict(flat(state_dict_to_flax(sate.state_dict())))
    for k, v in flat(jax_got):
        np.testing.assert_array_equal(got_tree[k], v, err_msg=k)
    assert torch.equal(sate.state_dict()["decoder.layers.0.ffn.fc1.weight"],
                       mt["decoder.layers.0.ffn.fc1.weight"])
    for comp, src_comp in (("encoder", None), ("encoder/textual", "encoder")):
        with pytest.raises(KeyError, match="structure mismatch"):
            jax_transplant(jtgt, jsrc, comp, source_component=src_comp)
        with pytest.raises(KeyError, match="structure mismatch"):
            transplant_component(tgt, mt, comp, source_component=src_comp)
