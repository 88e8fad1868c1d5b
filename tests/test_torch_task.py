"""``SpeechToTextTask.forward_fn`` from raw audio: the port against the JAX task.

A tiny s2t_transformer (dropout 0) is initialised by flax through the JAX
task's own forward adapter and carried across with ``from_flax``.  One batch
of a raw-audio corpus (identical in both frameworks, tests/test_torch_data.py)
goes through each task's ``forward_fn`` in eval mode: the fbank (the port's
K5 wrapper, on a CPU tensor its plain version; ``fbank_jax`` in JAX), the
eval transforms (utterance CMVN), the model.  The encoder output (valid
frames) is held to JAX at atol 1e-4 and the label-smoothed CE + CTC loss at
rtol 1e-4: float32 sums in another order through two encoder layers, from
features that differ by ~1e-6 (a float64 DFT in the port, float32 in JAX).
The task's other entry points raise by name where the port has no branch.
"""

import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.ops import fbank_cuda
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(24)]
TRANSFORMS = {"_train": {"transforms": ["utterance_cmvn", "specaugment"]},
              "_eval": {"transforms": ["utterance_cmvn"]}}
CFG = {
    "arch": "s2t_transformer_s",
    "criterion": "label_smoothed_cross_entropy_with_ctc",
    "criterion_cfg": {"ctc": {"ctc_weight": 0.3}},
    "model": {"encoder_layers": 2, "decoder_layers": 1, "encoder_embed_dim": 32,
              "decoder_embed_dim": 32, "encoder_ffn_embed_dim": 64, "decoder_ffn_embed_dim": 64,
              "encoder_attention_heads": 2, "decoder_attention_heads": 2,
              "subsampling_filter": 32, "dropout": 0.0, "attention_dropout": 0.0,
              "activation_dropout": 0.0},
    "dataset": {"max_tokens": 40000, "max_source_positions": 9000, "max_target_positions": 16,
                "num_buckets": 2, "required_batch_size_multiple": 2},
}


def _write_corpus(root: Path) -> Path:
    rng = np.random.default_rng(0)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i in range(5):
        n = int(rng.integers(3000, 8000))
        with wave.open(str(root / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.clip(rng.normal(scale=2000.0, size=n), -32768, 32767)
                          .astype("<i2").tobytes())
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 6))))
        lines.append(f"u{i}\tu{i}.wav\t{n}\t{text}\t{text}")
    (root / "train.tsv").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    root = _write_corpus(tmp_path_factory.mktemp("audio"))
    d = {**CFG, "dataset": {**CFG["dataset"], "data": str(root)}}
    task = SpeechToTextTask(from_dict(TrainConfig, d),
                            S2TDataConfig(use_audio_input=True, transforms=TRANSFORMS),
                            Dictionary.load(root / "dict.txt"))
    jtask = JaxTask(jax_from_dict(JaxTrainConfig, d),
                    JaxDataConfig(use_audio_input=True, transforms=TRANSFORMS),
                    JaxDictionary.load(root / "dict.txt"), None)
    batch = next(iter(task.get_batch_iterator(task.load_dataset("train"), shuffle=False)
                      .next_epoch_itr()))
    return task, jtask, {k: v for k, v in batch.items() if k not in ("ids", "nsentences")}


def test_forward_fn_from_raw_audio_matches_jax(tasks):
    task, jtask, batch = tasks
    assert batch["features"].ndim == 2  # (B, samples)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jtask.build_model()
    jfwd = jtask.forward_fn()
    jcrit = jtask.build_criterion()

    def forward_and_loss(p, b):
        out = jfwd(jm, p, b, deterministic=True)
        return out, jcrit(out, b)

    # each compiled whole: op by op, every op of the fbank and the model compiles alone
    with jax.default_matmul_precision("highest"):
        params = jax.jit(lambda b: jfwd(jm, None, b, True, rngs={"params": jax.random.PRNGKey(0)})
                         )(jbatch)["params"]
        jout, (jloss, _, jlogs) = jax.jit(forward_and_loss)(params, jbatch)
    model = load_flax_params(task.build_model(device="cpu"), jax.tree.map(np.asarray, params))
    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    before = fbank_cuda.fbank.launches
    with torch.no_grad():
        out = task.forward_fn()(model, tbatch, train=False)
        loss, _, logs = task.build_criterion()(out, tbatch)
    assert fbank_cuda.fbank.launches == before  # CPU tensors: the plain version
    lengths = np.asarray(jout["encoder_lengths"])
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(), lengths)
    assert lengths.max() > 0
    valid = np.arange(out["encoder_out"].shape[1])[None, :] < lengths[:, None]
    np.testing.assert_allclose(out["encoder_out"].numpy()[valid],
                               np.asarray(jout["encoder_out"])[valid], atol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(logs["ctc_loss"]), float(jlogs["ctc_loss"]), rtol=1e-4)


def test_train_forward_draws_transforms_from_the_step_generator(tasks):
    task, _, batch = tasks
    model = task.build_model(device="cpu", seed=3, for_training=True)
    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    fwd = task.forward_fn()
    runs = [fwd(model, tbatch, train=True, generator=torch.Generator().manual_seed(s))
            ["encoder_out"] for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_setup_reads_the_data_directory(tmp_path):
    pytest.importorskip("yaml")
    _write_corpus(tmp_path)
    (tmp_path / "config.yaml").write_text("vocab_filename: dict.txt\nuse_audio_input: true\n")
    task = setup_task(from_dict(TrainConfig, {"dataset": {"data": str(tmp_path)}}))
    assert isinstance(task, SpeechToTextTask) and task.data_cfg.use_audio_input
    assert len(task.tgt_dict) == len(WORDS) + 4


def test_unported_branches_raise_by_name(tasks, tmp_path_factory):
    task, _, batch = tasks
    # a use_audio_input split decodes its waveforms as collated, as JAX's generator
    # does: an encoder that wants (B, T, C) features raises naming them
    gen = task.build_generator(task.build_model(device="cpu"))
    with pytest.raises(ValueError, match=r"\(B, T, C\) features"):
        gen.generate(batch)
    # comma-separated splits are the multilingual dataset
    assert len(task.load_dataset("train,train")) == 2 * len(task.load_dataset("train"))
    # the item-7 presets build (tests/test_torch_variants_models.py); a text model raises
    for arch in ("s2t_dynamic_transformer_s", "convtransformer", "s2t_transformer_s_relative"):
        assert build_model(arch, {"encoder_layers": 1, "decoder_layers": 1},
                           device="cpu").cfg.encoder_layers == 1
    # semisupervised_translation is ported (tests/test_torch_backtranslation.py): it sets
    # up as a translation task and reads its bitext alone without a mono.<tgt> file
    from s2t_tpu_torch.tasks.translation import SemisupervisedTranslationTask
    mt = tmp_path_factory.mktemp("mt")
    (mt / "dict.txt").write_text("a 1\nb 1\n")
    (mt / "train.en").write_text("a b\n")
    (mt / "train.de").write_text("b a\n")
    st = setup_task(from_dict(TrainConfig, {"task": "semisupervised_translation",
                                            "dataset": {"data": str(mt)},
                                            "task_cfg": {"bt_checkpoint": "none.pt"}}))
    assert isinstance(st, SemisupervisedTranslationTask)
    assert len(st.load_dataset("train", is_train=True)) == 1
    with pytest.raises(KeyError, match="unknown task"):
        setup_task(from_dict(TrainConfig, {"task": "no_such_task"}))
