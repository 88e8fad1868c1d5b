"""The port's training and generation CLIs on the CPU.

* ``cli.train.main`` trains a tiny s2t_transformer from raw 16-bit wavs (the
  fbank's plain version, CMVN + SpecAugment, label-smoothed CE + CTC) for two
  epochs: epoch, last and best checkpoints with their metadata, a validation
  loss per epoch;
* four uninterrupted steps equal, bit for bit, two steps, a save, a resume
  from ``checkpoint_last.pt`` and two more (parameters, Adam moments, step);
* the command line (``--config`` YAML, ``key=value`` overrides, ``--device``);
* ``cli.generate.main`` writes the same H- and D- lines as the JAX
  ``cli.generate.main`` on the same weights (``from_flax``), beam 2,
  ``max_len_b`` 8, on a split of fbank features: the same integers, and
  scores printed to 4 decimals from float32 sums in another order.
"""

import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.cli import generate as jax_generate
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu_torch.cli import generate as cli_generate
from s2t_tpu_torch.cli import train as cli_train
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data.audio.fbank import fbank_numpy
from s2t_tpu_torch.data.dataset import S2TDataConfig, load_waveform
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
from s2t_tpu_torch.utils.checkpoint import load_checkpoint
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(20)]
TRANSFORMS = {"_train": {"transforms": ["utterance_cmvn", "specaugment"],
                         "specaugment": {"freq_mask_F": 5, "time_mask_T": 10}},
              "_eval": {"transforms": ["utterance_cmvn"]}}
MODEL = {"encoder_embed_dim": 32, "encoder_ffn_embed_dim": 64, "encoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_embed_dim": 32, "decoder_ffn_embed_dim": 64,
         "decoder_layers": 1, "decoder_attention_heads": 2, "subsampling_filter": 32}


def _wav(path: Path, samples: np.ndarray):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.rint(samples), -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    for split, n in (("train", 8), ("dev", 4)):
        lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
        for i in range(n):
            samples = int(rng.integers(4000, 9000))
            _wav(root / f"{split}{i}.wav", rng.normal(scale=2000.0, size=samples))
            text = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 5))))
            lines.append(f"{split}{i}\t{split}{i}.wav\t{samples}\t{text}\t{text}")
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")
    # the dev utterances again, as fbank features, for decoding
    lines = ["id\taudio\tn_frames\ttgt_text"]
    for row in (root / "dev.tsv").read_text().splitlines()[1:]:
        uid, audio, _, text, _ = row.split("\t")
        feats = fbank_numpy(load_waveform(audio, str(root)))
        np.save(root / f"{uid}.npy", feats)
        lines.append(f"{uid}\t{uid}.npy\t{feats.shape[0]}\t{text}")
    (root / "test.tsv").write_text("\n".join(lines) + "\n")
    return root


def _cfg_dict(root: Path, save_dir: Path, **optimization):
    return {
        "arch": "s2t_transformer_xs",
        "criterion": "label_smoothed_cross_entropy_with_ctc",
        "criterion_cfg": {"ctc": {"ctc_weight": 0.3}},
        "model": dict(MODEL),
        "dataset": {"data": str(root), "max_tokens": 9000, "max_source_positions": 9000,
                    "max_target_positions": 16, "num_buckets": 2,
                    "required_batch_size_multiple": 2, "gen_subset": "test"},
        "optimization": {"lr": 1e-3, "warmup_updates": 5, **optimization},
        "checkpoint": {"save_dir": str(save_dir), "async_save": False},
        "common": {"log_interval": 1},
        "generation": {"beam": 2, "max_len_b": 8, "scoring": "wer", "post_process": None},
    }


def _train(root, save_dir, **optimization):
    cfg = from_dict(TrainConfig, _cfg_dict(root, save_dir, **optimization))
    task = SpeechToTextTask(cfg, S2TDataConfig(use_audio_input=True, transforms=TRANSFORMS),
                            Dictionary.load(root / "dict.txt"))
    return cli_train.main(cfg, task=task, device="cpu")


def test_train_two_epochs_from_raw_audio(corpus, tmp_path):
    out = _train(corpus, tmp_path / "ck", max_epoch=2)
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["ctc_loss"]) for h in out["history"])
    names = {p.name for p in (tmp_path / "ck").iterdir()}
    for name in ("checkpoint1.pt", "checkpoint2.pt", "checkpoint_last.pt", "checkpoint_best.pt"):
        assert name in names and name + ".json" in names
    tree, meta = load_checkpoint(tmp_path / "ck" / "checkpoint_last.pt")
    assert meta["epoch"] == 2 and meta["step"] == out["trainer"].step == len(out["train_log"])
    assert meta["val_metric"] == out["history"][-1]["loss"]
    assert set(tree) == {"step", "params", "opt_state"}


def test_resume_is_bit_equal(corpus, tmp_path):
    whole = _train(corpus, tmp_path / "a", max_update=4)
    _train(corpus, tmp_path / "b", max_update=2)
    resumed = _train(corpus, tmp_path / "b", max_update=4)
    assert whole["trainer"].step == resumed["trainer"].step == 4
    assert [r["step"] for r in resumed["train_log"]] == [3, 4]
    assert [r["loss"] for r in resumed["train_log"]] == [r["loss"] for r in whole["train_log"][2:]]
    a, b = whole["trainer"].state_dict(), resumed["trainer"].state_dict()
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert torch.equal(a["opt_state"]["mu"], b["opt_state"]["mu"])
    assert torch.equal(a["opt_state"]["nu"], b["opt_state"]["nu"])


def test_command_line(corpus, tmp_path):
    pytest.importorskip("yaml")
    import yaml

    data = tmp_path / "data"
    data.mkdir()
    for p in corpus.iterdir():
        (data / p.name).symlink_to(p)
    (data / "config.yaml").write_text(yaml.safe_dump(
        {"vocab_filename": "dict.txt", "use_audio_input": True, "transforms": TRANSFORMS}))
    conf = _cfg_dict(data, tmp_path / "ck", max_epoch=1)
    conf.pop("dataset")
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(conf))
    args = [str(data), "--config", str(tmp_path / "conf.yaml"), "--device", "cpu",
            "dataset.max_tokens=9000", "dataset.max_source_positions=9000",
            "dataset.max_target_positions=16"]
    cli_train.cli_main(args)
    assert (tmp_path / "ck" / "checkpoint1.pt").exists()
    cfg = cli_train.build_cfg(cli_train.parse_args(args))
    assert cfg.dataset.data == str(data) and cfg.optimization.max_epoch == 1
    assert cli_train.parse_args([str(data)]).device == "cuda"  # the card unless asked
    assert cli_generate.parse_args([str(data)]).device == "cuda"


def test_generate_matches_jax(corpus, tmp_path):
    d = _cfg_dict(corpus, tmp_path / "ck")
    d["generation"]["results_path"] = str(tmp_path / "jax")
    jcfg = jax_from_dict(JaxTrainConfig, d)
    jtask = JaxTask(jcfg, JaxDataConfig(), JaxDictionary.load(corpus / "dict.txt"), None)
    jm = jtask.build_model()
    feats = np.zeros((2, 64, 80), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), feats, np.array([64, 40], np.int32),
                              np.full((2, 3), 2, np.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    jax_generate.main(jcfg, params, task=jtask)

    d["generation"]["results_path"] = str(tmp_path / "port")
    cfg = from_dict(TrainConfig, d)
    task = SpeechToTextTask(cfg, S2TDataConfig(), Dictionary.load(corpus / "dict.txt"))
    out = cli_generate.main(cfg, flax_to_state_dict(params), task=task, device="cpu")
    assert out["n_utts"] == 4

    def lines(tag, who):
        text = (tmp_path / who / "generate-test.txt").read_text().splitlines()
        return [line for line in text if line.startswith(tag)]

    assert len(lines("H-", "port")) == 4
    for tag in ("T-", "H-", "D-", "Generate test with beam=2: WER: "):
        assert lines(tag, "port") == lines(tag, "jax")
    assert ((tmp_path / "port" / "translation-test.txt").read_text()
            == (tmp_path / "jax" / "translation-test.txt").read_text())


def _fields(cls):
    import dataclasses

    out = {}
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING \
            else f.default
        out[f.name] = _fields(type(default)) if dataclasses.is_dataclass(default) else default
    return out


def test_train_config_tree_matches_jax():
    from s2t_tpu.config import apply_overrides as jax_apply
    from s2t_tpu.config import deep_merge as jax_merge
    from s2t_tpu.config import to_dict as jax_to_dict
    from s2t_tpu_torch.config import apply_overrides, deep_merge, to_dict

    assert _fields(TrainConfig) == _fields(JaxTrainConfig)
    base, over = {"a": {"b": 1, "c": [1, 2]}, "d": 2}, {"a": {"b": 3}, "e": None}
    assert deep_merge(base, over) == jax_merge(base, over)
    overrides = ["optimization.lr=5e-3", "dataset.max_tokens=100", "common.log_format=json",
                 "checkpoint.no_save=true", "model.dropout=0.2"]
    assert apply_overrides({}, overrides) == jax_apply({}, overrides)
    d = _cfg_dict(Path("data"), Path("ck"), max_epoch=3)
    assert to_dict(from_dict(TrainConfig, d)) == jax_to_dict(jax_from_dict(JaxTrainConfig, d))
    with pytest.raises(ValueError, match="unknown config key"):
        from_dict(TrainConfig, {"optimization": {"no_such_knob": 1}})


def test_scorers_match_jax():
    from s2t_tpu.utils.scoring import build_scorer as jax_build_scorer
    from s2t_tpu.utils.scoring import edit_distance as jax_edit_distance
    from s2t_tpu_torch.utils.scoring import build_scorer, edit_distance

    pairs = [("the cat sat on the mat", "the cat sat on mat"), ("a b c", "x y"),
             ("", "extra words"), ("same words here", "same words here"), ("abc", "")]
    for ref, hyp in pairs:
        assert edit_distance(ref.split(), hyp.split()) == jax_edit_distance(ref.split(), hyp.split())
    for name in ("wer", "cer"):
        port, jax_scorer = build_scorer(name), jax_build_scorer(name)
        for ref, hyp in pairs:
            port.add(ref, hyp)
            jax_scorer.add(ref, hyp)
        assert port.result_string() == jax_scorer.result_string()
    pytest.importorskip("sacrebleu")
    port, jax_scorer = build_scorer("sacrebleu"), jax_build_scorer("sacrebleu")
    for ref, hyp in pairs[:2]:
        port.add(ref, hyp)
        jax_scorer.add(ref, hyp)
    assert port.result_string() == jax_scorer.result_string()


def test_checkpoint_manager_matches_jax(tmp_path):
    from s2t_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from s2t_tpu_torch.utils.checkpoint import CheckpointManager, average_checkpoints

    kw = dict(keep_last_epochs=2, keep_interval_updates=1, keep_best_checkpoints=2)
    port, jax_mgr = CheckpointManager(tmp_path / "port", **kw), JaxManager(tmp_path / "jax", **kw)
    saves = [dict(step=2, epoch=1, end_of_epoch=False), dict(step=3, epoch=1, val_metric=4.0),
             dict(step=5, epoch=2, end_of_epoch=False), dict(step=6, epoch=2, val_metric=3.0),
             dict(step=9, epoch=3, val_metric=3.5)]
    for i, save in enumerate(saves):
        port.save({"params": {"w": torch.full((2,), float(i))}}, **save)
        jax_mgr.save({"params": {"w": np.full((2,), float(i), np.float32)}}, **save)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    best = port.best_checkpoints(2)
    assert [p.name for p in best] == [p.name for p in jax_mgr.best_checkpoints(2)]
    tree, meta = load_checkpoint(tmp_path / "port" / "checkpoint_best.pt")
    assert meta["step"] == 6 and torch.equal(tree["params"]["w"], torch.full((2,), 3.0))
    avg = average_checkpoints(best)
    assert torch.equal(avg["w"], torch.full((2,), 3.5))  # the steps 6 and 9 saves: (3 + 4) / 2
