"""A tiny PDS model section through the port's ``cli.train`` and ``cli.generate``
against the JAX CLIs on the CPU.

On tests/test_torch_cli.py's corpus (the same seed: 8 train and 4 dev 16-bit
wavs, the dev utterances again as fbank features), a 2-stage PDS encoder with
fusion under a one-layer decoder, dropout 0, starts in both CLIs from one flax
init (``checkpoint_last.pt`` with ``reset_optimizer``): two epochs of
training from raw audio give the JAX CLI's validation losses (rtol 1e-4), and
``cli.generate`` on the feature split writes its T-/H-/D- lines.
"""

import wave
from pathlib import Path

import jax
import numpy as np
import pytest

from s2t_tpu_torch.interop.from_flax import flax_to_state_dict
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(20)]
CLI_MODEL = {"pds_stages": 2, "pds_ratios": [2, 2], "pds_layers": [1, 1],
             "pds_kernel_sizes": [5, 5], "pds_embed_dims": [24, 32], "pds_attn_heads": [2, 2],
             "pds_ffn_ratios": [2, 2], "pds_position_embed": [1, 1], "pds_fusion": True,
             "decoder_layers": 1, "decoder_ffn_embed_dim": 64, "decoder_attention_heads": 2,
             "dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0}


def _wav(path: Path, samples: np.ndarray):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.rint(samples), -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_torch_cli.py's corpus (the same seed and layout): 8 train and
    4 dev wavs, the dev utterances as fbank features for decoding; with a
    config.yaml (raw audio, no transforms) for both CLIs."""
    from s2t_tpu_torch.data.audio.fbank import fbank_numpy
    from s2t_tpu_torch.data.dataset import load_waveform

    yaml = pytest.importorskip("yaml")
    root = tmp_path_factory.mktemp("pds_corpus")
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
    lines = ["id\taudio\tn_frames\ttgt_text"]
    for row in (root / "dev.tsv").read_text().splitlines()[1:]:
        uid, audio, _, text, _ = row.split("\t")
        feats = fbank_numpy(load_waveform(audio, str(root)))
        np.save(root / f"{uid}.npy", feats)
        lines.append(f"{uid}\t{uid}.npy\t{feats.shape[0]}\t{text}")
    (root / "test.tsv").write_text("\n".join(lines) + "\n")
    (root / "config.yaml").write_text(yaml.safe_dump(
        {"vocab_filename": "dict.txt", "use_audio_input": True}))
    return root


def _cli_cfg(root: Path, save_dir: Path, results: Path):
    return {
        "arch": "pdss2t_transformer_s_8",
        "criterion": "label_smoothed_cross_entropy_with_ctc",
        "criterion_cfg": {"ctc": {"ctc_weight": 0.3}},
        "model": dict(CLI_MODEL),
        # one batch a split (the size columns count samples): one shape each to compile
        "dataset": {"data": str(root), "max_tokens": 80000, "max_source_positions": 9000,
                    "max_target_positions": 16, "num_buckets": 2,
                    "required_batch_size_multiple": 2, "gen_subset": "test"},
        "optimization": {"lr": 1e-3, "warmup_updates": 2, "max_epoch": 2},
        "checkpoint": {"save_dir": str(save_dir), "async_save": False, "reset_optimizer": True,
                       "no_save": True},
        "common": {"log_interval": 1},
        "generation": {"beam": 2, "max_len_b": 8, "scoring": "wer", "post_process": None,
                       "results_path": str(results)},
    }


@pytest.fixture(scope="module")
def weights(corpus):
    """One flax init of the JAX task's model, and the same weights as a port state dict."""
    from s2t_tpu.config import TrainConfig as JaxTrainConfig
    from s2t_tpu.config import from_dict as jax_from_dict
    from s2t_tpu.tasks import setup_task as jax_setup_task

    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, _cli_cfg(corpus, corpus, corpus)))
    params = jax.jit(jtask.build_model().init)(
        jax.random.PRNGKey(0), np.zeros((2, 64, 80), np.float32), np.array([64, 40], np.int32),
        np.full((2, 3), 2, np.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    return params, flax_to_state_dict(params)


def test_cli_train_matches_jax(corpus, weights, tmp_path):
    """Both CLIs resume from checkpoint_last.pt with reset_optimizer (the weights only)
    and train two epochs from raw audio: the same steps and validation losses."""
    from s2t_tpu.cli import train as jax_train
    from s2t_tpu.config import TrainConfig as JaxTrainConfig
    from s2t_tpu.config import from_dict as jax_from_dict
    from s2t_tpu.utils.checkpoint import save_pytree
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.utils.checkpoint import save_tree

    params, state_dict = weights
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
    save_pytree(tmp_path / "jax" / "checkpoint_last.pt", {"params": params})
    save_tree(tmp_path / "port" / "checkpoint_last.pt", {"params": state_dict})
    want = jax_train.main(jax_from_dict(JaxTrainConfig, _cli_cfg(corpus, tmp_path / "jax",
                                                                 tmp_path)))
    got = cli_train.main(from_dict(TrainConfig, _cli_cfg(corpus, tmp_path / "port", tmp_path)),
                         device="cpu")
    assert got["trainer"].step == int(want["state"].step) == 2
    assert [h["epoch"] for h in got["history"]] == [1, 2]
    for mine, theirs in zip(got["history"], want["history"], strict=True):
        for key in ("loss", "nll_loss", "ctc_loss"):
            np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-4, err_msg=key)
    assert got["history"][1]["loss"] < got["history"][0]["loss"]


def test_cli_generate_matches_jax(corpus, weights, tmp_path):
    """Beam 2 on the feature split: the JAX CLI's T-, H- and D- lines."""
    from s2t_tpu.cli import generate as jax_generate
    from s2t_tpu.config import TrainConfig as JaxTrainConfig
    from s2t_tpu.config import from_dict as jax_from_dict
    from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
    from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
    from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask

    params, state_dict = weights
    jcfg = jax_from_dict(JaxTrainConfig, _cli_cfg(corpus, tmp_path, tmp_path / "jax"))
    jtask = JaxTask(jcfg, JaxDataConfig(), JaxDictionary.load(corpus / "dict.txt"), None)
    jax_generate.main(jcfg, params, task=jtask)
    cfg = from_dict(TrainConfig, _cli_cfg(corpus, tmp_path, tmp_path / "port"))
    task = SpeechToTextTask(cfg, S2TDataConfig(), Dictionary.load(corpus / "dict.txt"))
    out = cli_generate.main(cfg, state_dict, task=task, device="cpu")
    assert out["n_utts"] == 4

    def lines(tag, who):
        text = (tmp_path / who / "generate-test.txt").read_text().splitlines()
        return [line for line in text if line.startswith(tag)]

    assert len(lines("H-", "port")) == 4
    for tag in ("T-", "H-", "D-"):
        assert lines(tag, "port") == lines(tag, "jax"), tag
