"""``s2t_w2v2_transformer`` and the repaired ``use_audio_input`` decode against JAX.

A tiny model (the 7-layer 16-channel conv stack of tests/test_torch_wav2vec2.py,
one w2v layer, one post-w2v layer, one decoder layer, a CTC head) on a tiny
wav corpus whose data config sets ``use_audio_input``:

* ``cli.generate`` beam-decodes the split from the collated (B, N) waveforms,
  as JAX's generator does: the H- tokens equal JAX's beam on the same batches,
  and ``hub.from_pretrained`` returns ``cli.generate``'s D- strings;
* validation's ``eval_ctc_wer`` counts on a waveform batch equal JAX's;
* the forward (decoder logits within 1e-5 of their largest magnitude) and
  ``extract_w2v_features``; ``from_flax`` both ways;
* training is in tests/test_torch_w2v2_train.py.
"""

import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.cli.train import _accumulate_ctc_wer as jax_ctc_wer
from s2t_tpu.cli.train import _make_ctc_decode_fn
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.models import s2t_w2v2_transformer as jw2
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.cli import generate as cli_generate
from s2t_tpu_torch.cli.train import _accumulate_ctc_wer
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.hub import from_pretrained
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.utils.checkpoint import save_tree
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import CONV, assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(12)]
MODEL = {"w2v_conv_feature_layers": [list(c) for c in CONV], "w2v_encoder_embed_dim": 32,
         "w2v_encoder_ffn_embed_dim": 64, "w2v_encoder_layers": 1,
         "w2v_encoder_attention_heads": 2, "w2v_conv_pos": 16, "w2v_conv_pos_groups": 4,
         "w2v_mask_length": 2, "w2v_mask_prob": 0.3, "w2v_dropout": 0.0,
         "w2v_attention_dropout": 0.0, "w2v_dropout_input": 0.0, "w2v_dropout_features": 0.0,
         "encoder_layers": 1, "encoder_embed_dim": 48, "encoder_ffn_embed_dim": 64,
         "encoder_attention_heads": 2, "decoder_layers": 1, "decoder_embed_dim": 48,
         "decoder_ffn_embed_dim": 64, "decoder_attention_heads": 2, "use_ctc": True,
         "dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0}
CRIT = {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}}


def write_corpus(root: Path) -> Path:
    rng = np.random.default_rng(0)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    (root / "config.yaml").write_text("vocab_filename: dict.txt\nuse_audio_input: true\n")
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i in range(6):
        n = int(rng.integers(3000, 7000))
        with wave.open(str(root / f"u{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.clip(rng.normal(scale=3000.0, size=n), -32768, 32767)
                          .astype("<i2").tobytes())
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 5))))
        lines.append(f"u{i}\tu{i}.wav\t{n}\t{text}\t{text}")
    (root / "test.tsv").write_text("\n".join(lines) + "\n")
    return root


def cfg_dict(root, save_dir):
    return {"arch": "s2t_w2v2_transformer_base", "model": MODEL, "criterion_cfg": CRIT,
            "dataset": {"data": str(root), "max_tokens": 12000, "max_source_positions": 9000,
                        "max_target_positions": 16, "num_buckets": 2, "gen_subset": "test"},
            "generation": {"beam": 3, "max_len_b": 6, "post_process": None},
            "checkpoint": {"save_dir": str(save_dir)}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = write_corpus(tmp_path_factory.mktemp("wavs"))
    d = cfg_dict(root, tmp_path_factory.mktemp("out"))
    jtask = jax_setup_task(jax_from_dict(JaxTrainConfig, d))
    jtask.load_dataset("test")
    jm = jtask.build_model()
    src = np.random.default_rng(1).normal(scale=3000.0, size=(2, 4000)).astype(np.float32)
    lens, prev = np.array([4000, 2500], np.int32), np.full((2, 3), 2, np.int32)
    params = jax.jit(lambda k: jm.init({"params": k, "dropout": k}, src, lens, prev))(
        jax.random.PRNGKey(0))["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    return root, d, jtask, jm, params


def test_use_audio_input_decode_through_cli_generate_and_hub(setup, tmp_path):
    root, d, jtask, jm, params = setup
    task = setup_task(from_dict(TrainConfig, d))
    model = load_flax_params(task.build_model(device="cpu"), params)
    ckpt = tmp_path / "ckpt.pt"
    save_tree(ckpt, {"params": model.state_dict()})
    cfg = from_dict(TrainConfig, {**d, "generation": {**d["generation"],
                                                      "results_path": str(tmp_path)}})
    out = cli_generate.main(cfg, model.state_dict(), device="cpu")
    assert out["n_utts"] == 6 and out["rtf"] > 0
    jgen = jtask.build_generator(jm)
    itr = jtask.get_batch_iterator(jtask.datasets["test"], max_tokens=12000, shuffle=False,
                                   batch_size_multiple=1).next_epoch_itr()
    n = 0
    for batch in itr:
        assert batch["features"].ndim == 2  # (B, N) waveforms
        tokens, _, _ = jgen.generate(params, {k: batch[k] for k in ("features", "feat_lengths")})
        for b in range(batch["nsentences"]):
            want = jtask.tgt_dict.string(np.asarray(tokens)[b, 0])
            assert out["results"][int(batch["ids"][b])]["hyp_tokens"] == want
            n += 1
    assert n == 6
    hub = from_pretrained(ckpt, data_dir=root, config=d, device="cpu")
    paths = [str(root / f"u{i}.wav") for i in range(3)]
    assert hub.generate(paths) == [out["results"][i]["hyp"] for i in range(3)]


def test_eval_ctc_wer_on_waveforms_matches_jax(setup):
    root, d, jtask, jm, params = setup
    task = setup_task(from_dict(TrainConfig, d))
    model = load_flax_params(task.build_model(device="cpu"), params)
    ds = task.load_dataset("test")
    batch = next(iter(task.get_batch_iterator(ds, shuffle=False).next_epoch_itr()))
    counts = {"w_err": 0, "w_len": 0, "c_err": 0, "c_len": 0}
    _accumulate_ctc_wer(task, model, batch, counts)

    class JaxTrainerView:
        pass

    view = JaxTrainerView()
    view.model = jm
    want = {"w_err": 0, "w_len": 0, "c_err": 0, "c_len": 0}
    dev = {k: jax.numpy.asarray(batch[k]) for k in ("features", "feat_lengths")}
    jax_ctc_wer(jtask, _make_ctc_decode_fn(jtask, view), params, dev, batch, want)
    assert counts == want and counts["w_len"] > 0


def test_forward_features_and_from_flax_match_jax(setup):
    root, d, jtask, jm, params = setup
    task = setup_task(from_dict(TrainConfig, d))
    tm = load_flax_params(task.build_model(device="cpu"), params)
    src = np.random.default_rng(2).normal(scale=3000.0, size=(2, 5000)).astype(np.float32)
    lens = np.array([5000, 3300], np.int32)
    prev = np.array([[2, 4, 5, 6], [2, 7, 8, 1]], np.int32)
    ref = jax.jit(lambda p: jm.apply({"params": p}, src, lens, prev))(params)
    with torch.no_grad():
        out = tm(torch.from_numpy(src), torch.from_numpy(lens), torch.from_numpy(prev).long())
        feats, flens = tm.extract_w2v_features(torch.from_numpy(src), torch.from_numpy(lens))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        assert_close(out[key].numpy(), ref[key], key)
    want, wlens = jax.jit(lambda p: jm.apply({"params": p}, src, lens,
                                             method=jw2.S2TW2V2TransformerModel
                                             .extract_w2v_features))(params)
    assert_close(feats.numpy(), want, "w2v features")
    np.testing.assert_array_equal(flens.numpy(), np.asarray(wlens))
    got = dict(flat(state_dict_to_flax(tm.state_dict())))
    assert got.keys() == dict(flat(params)).keys()
    assert all(np.array_equal(got[k], v) for k, v in flat(params))
