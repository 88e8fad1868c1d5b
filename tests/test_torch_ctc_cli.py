"""Encoder-only CTC decoding through the port's task, CLIs and hub against the JAX package.

On a tiny corpus of fbank feature files (4 dev and 4 test utterances, 20
words) and one set of flax-initialised ``s2t_ctc`` weights (2 layers, d=32,
``encoder_embed_norm``, no embedding scale) carried across with ``from_flax``:

* ``cli.generate`` with ``generation.ctc_infer`` writes the JAX CLI's
  T-/H-/D- lines, score line, ``translation-test.txt`` and
  ``translation-test.txt.ctc``, greedy (beam 1, score 0.0) and prefix beam 5;
* ``cli.train.validate`` with ``eval_ctc_wer`` and ``eval_wer`` gives the JAX
  ``validate``'s loss, ``wer``, ``ctc_wer`` and ``ctc_cer``;
* ``hub.from_pretrained(...).transcribe`` on a port checkpoint gives the
  strings of the JAX ``from_pretrained`` on a JAX checkpoint of the same weights;
* ``tools/wer_sanity`` (bench.py section C) reads 0.0, as the JAX package does.
"""

import jax
import numpy as np
import pytest

from s2t_tpu.cli import generate as jax_generate
from s2t_tpu.cli import train as jax_train
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.hub import from_pretrained as jax_from_pretrained
from s2t_tpu.parallel.mesh import make_mesh
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu.utils.checkpoint import save_pytree
from s2t_tpu_torch.cli import generate as cli_generate
from s2t_tpu_torch.cli import train as cli_train
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.hub import from_pretrained
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.tools.wer_sanity import wer_sanity
from s2t_tpu_torch.trainer import Trainer
from s2t_tpu_torch.utils.checkpoint import save_tree
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(20)]
MODEL = {"encoder_embed_dim": 32, "encoder_ffn_embed_dim": 64, "encoder_layers": 2,
         "encoder_attention_heads": 2, "subsampling_filter": 32, "encoder_embed_norm": True,
         "encoder_no_scale_embedding": True, "dropout": 0.0, "attention_dropout": 0.0,
         "activation_dropout": 0.0}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ctc_corpus")
    rng = np.random.default_rng(0)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    for split in ("dev", "test"):
        lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
        for i in range(4):
            feats = rng.normal(size=(int(rng.integers(40, 90)), 80)).astype(np.float32)
            np.save(root / f"{split}{i}.npy", feats)
            text = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 5))))
            lines.append(f"{split}{i}\t{split}{i}.npy\t{feats.shape[0]}\t{text}\t{text}")
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")
    return root


def cfg_dict(root, beam=5, results=None):
    return {
        "arch": "s2t_ctc", "criterion": "ctc",
        "criterion_cfg": {"ctc_weight": 1.0, "zero_infinity": True},
        "model": dict(MODEL),
        "dataset": {"data": str(root), "max_tokens": 9000, "max_source_positions": 9000,
                    "max_target_positions": 16, "num_buckets": 2, "valid_subset": "dev",
                    "gen_subset": "test"},
        "optimization": {"lr": 1e-3, "warmup_updates": 5},
        "checkpoint": {"save_dir": str(root / "ck")},
        "eval": {"eval_ctc_wer": True, "eval_wer": True, "eval_gen_beam": 1},
        "generation": {"beam": beam, "scoring": "wer", "post_process": None, "ctc_infer": True,
                       "results_path": results},
    }


@pytest.fixture(scope="module")
def weights(corpus):
    """One flax init of the JAX task's model, and the same weights as a port state dict."""
    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, cfg_dict(corpus)))
    params = jax.jit(jtask.build_model().init)(
        jax.random.PRNGKey(1), np.zeros((2, 64, 80), np.float32), np.array([64, 40], np.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    return params, flax_to_state_dict(params)


@pytest.mark.parametrize("beam", [1, 5])
def test_generate_with_ctc_infer_matches_jax(corpus, weights, tmp_path, beam):
    params, state_dict = weights
    jcfg = jax_from_dict(JaxTrainConfig, cfg_dict(corpus, beam, str(tmp_path / "jax")))
    jax_generate.main(jcfg, params)
    cfg = from_dict(TrainConfig, cfg_dict(corpus, beam, str(tmp_path / "port")))
    out = cli_generate.main(cfg, state_dict, device="cpu")
    assert out["n_utts"] == 4
    for name in ("generate-test.txt", "translation-test.txt", "translation-test.txt.ctc"):
        got = (tmp_path / "port" / name).read_text()
        assert got == (tmp_path / "jax" / name).read_text(), name
        assert got.strip(), name
    text = (tmp_path / "port" / "generate-test.txt").read_text()
    assert sum(line.startswith("H-") for line in text.splitlines()) == 4
    if beam == 1:  # greedy scores 0.0, as the JAX CLI writes them
        assert all(line.split("\t")[1] == "0.0000" for line in text.splitlines()
                   if line.startswith(("H-", "D-")))


def test_validate_decodes_as_jax(corpus, weights):
    params, state_dict = weights
    jcfg = jax_from_dict(JaxTrainConfig, cfg_dict(corpus))
    jtask = jax_setup_task(jcfg)
    jds = jtask.load_dataset("dev")
    jmodel = jtask.build_model()
    jtrainer = JaxTrainer(jmodel, jtask.build_criterion(), jcfg.optimization,
                          mesh=make_mesh(devices=jax.devices()[:1]), forward_fn=jtask.forward_fn())
    batch = next(iter(jtask.get_batch_iterator(jds, max_tokens=9000, shuffle=False)
                      .next_epoch_itr()))
    state = jtrainer.init_state(jax_train.to_device_batch(batch))
    state = state.replace(params=jax.tree.map(np.asarray, params))
    jgen = jtask.build_generator(jmodel)
    jgen.beam_size = jcfg.eval.eval_gen_beam  # what the JAX main does
    want = jax_train.validate(jcfg, jtask, jtrainer, state, jds, jgen)

    cfg = from_dict(TrainConfig, cfg_dict(corpus))
    task = setup_task(cfg)
    ds = task.load_dataset("dev")
    model = task.build_model(device="cpu", for_training=True)
    model.load_state_dict(state_dict)
    trainer = Trainer(model, task.build_criterion(), cfg.optimization, device="cpu",
                      forward_fn=task.forward_fn())
    gen = task.build_generator(model)
    gen.beam_size = cfg.eval.eval_gen_beam
    got = cli_train.validate(cfg, task, trainer, ds, gen)
    for key in ("wer", "ctc_wer", "ctc_cer"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert gen.decoder.beam_size == 5  # generation.beam: a CTCGenerator ignores beam_size


def test_from_pretrained_transcribes_as_jax(corpus, weights, tmp_path):
    params, state_dict = weights
    save_pytree(tmp_path / "jax.ckpt", {"params": params})
    save_tree(tmp_path / "port.pt", {"params": state_dict})
    conf = cfg_dict(corpus)
    paths = [str(corpus / f"test{i}.npy") for i in range(4)]
    want = jax_from_pretrained(tmp_path / "jax.ckpt", corpus, conf).generate(paths)
    hub = from_pretrained(tmp_path / "port.pt", corpus, conf, device="cpu")
    assert hub.generate(paths) == want
    assert hub.transcribe(paths[0]) == want[0]
    assert any(want)  # some hypothesis is not empty
    greedy = from_pretrained(tmp_path / "port.pt", corpus, conf, device="cpu", beam=1)
    assert greedy.generator.decoder.beam_size == 1


def test_wer_sanity_reads_zero():
    assert wer_sanity(device="cpu")["wer_sanity"] == 0.0


def test_chip_smoke_trains_the_purectc_recipe():
    """chip_smoke.py phase 14 trains egs/mustc/asr/conf/purectc.yaml's model
    section (the card has no yaml package, so the script carries a copy)."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke
    from pathlib import Path

    conf = yaml.safe_load((Path(chip_smoke.ROOT) / "egs/mustc/asr/conf/purectc.yaml").read_text())
    assert conf["arch"] == "s2t_ctc" and conf["criterion"] == "ctc"
    assert chip_smoke.PURECTC_MODEL == conf["model"]
    assert chip_smoke.ctc_cfg(Path("data")).criterion_cfg == conf["criterion_cfg"]
