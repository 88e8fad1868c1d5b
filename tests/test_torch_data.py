"""The port's data layer against the JAX package's, on the CPU.

Equality (no tolerance: the same integers and the same float32 arrays) of
the dictionary, the char and SPM tokenizers, the bucketing and batching
functions (against JAX's native ``clib`` path and its pure-Python loop), the
epoch iterator with a mid-epoch resume, and whole batches of
``Task.get_batch_iterator`` for a feature corpus and a raw-audio corpus.
"""

import wave
from pathlib import Path

import numpy as np
import pytest

from s2t_tpu import clib as jax_clib
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data import batching as jax_batching
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.data.iterators import EpochBatchIterator as JaxEpochBatchIterator
from s2t_tpu.data.tokenizer import CharTokenizer as JaxChar
from s2t_tpu.data.tokenizer import SPMTokenizer as JaxSPM
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data import batching
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.iterators import EpochBatchIterator
from s2t_tpu_torch.data.tokenizer import CharTokenizer, SPMTokenizer, build_tokenizer
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TEXTS = ["the cat sat on the mat", "a dog ran far away", "the dog sat", "cats and dogs",
         "on the far side of the moon", "ünïcödé wörds too"]
BATCH_KEYS = ("ids", "features", "feat_lengths", "target", "prev_tokens", "target_lengths",
              "transcript", "transcript_lengths", "nsentences", "ntokens")


def _write_dict(path: Path):
    words = sorted({w for t in TEXTS for w in t.split()})
    path.write_text("".join(f"{w} {i + 1}\n" for i, w in enumerate(words)))
    return path


def test_dictionary_matches_jax(tmp_path):
    path = _write_dict(tmp_path / "dict.txt")
    d, j = Dictionary.load(path), JaxDictionary.load(path)
    assert len(d) == len(j) and [d[i] for i in range(len(d))] == [j[i] for i in range(len(j))]
    assert (d.bos(), d.pad(), d.eos(), d.unk()) == (j.bos(), j.pad(), j.eos(), j.unk())
    for text in TEXTS + ["unseen words here"]:
        ids = d.encode_line(text, append_eos=True)
        np.testing.assert_array_equal(ids, j.encode_line(text, append_eos=True))
        assert d.string(ids) == j.string(ids)
        assert d.string(ids, bpe_symbol="sentencepiece") == j.string(
            ids, bpe_symbol="sentencepiece")
    d.save(tmp_path / "saved.txt")
    j.save(tmp_path / "saved_jax.txt")
    assert (tmp_path / "saved.txt").read_text() == (tmp_path / "saved_jax.txt").read_text()


def test_tokenizers_match_jax(tmp_path):
    char, jchar = CharTokenizer(), JaxChar()
    for text in TEXTS:
        assert char.encode_line(text) == jchar.encode_line(text)
        assert char.decode(char.encode(text)) == jchar.decode(jchar.encode(text))
    pytest.importorskip("tokenizers")
    spm = SPMTokenizer.train(TEXTS * 4, vocab_size=40, model_path=tmp_path / "spm.json")
    jspm = JaxSPM(model_path=tmp_path / "spm.json")  # the same model file
    for text in TEXTS + ["zebra on the moon"]:
        assert spm.encode_line(text) == jspm.encode_line(text)
        assert spm.decode(spm.encode(text)) == jspm.decode(jspm.encode(text))
    built = build_tokenizer({"bpe": "spm", "sentencepiece_model": str(tmp_path / "spm.json")})
    assert built.encode_line(TEXTS[0]) == spm.encode_line(TEXTS[0])


@pytest.fixture(params=["native", "python"])
def jax_batching_path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(jax_clib, "batch_by_size_native", lambda *a, **k: None)
    elif jax_clib.get_lib() is None:
        pytest.skip("the JAX package's native clib is not built here")
    return request.param


def test_batching_matches_jax(jax_batching_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(1, 3000, size=300)
    tokens = rng.integers(1, 60, size=300)
    for nb, sizes in ((12, frames), (5, None), (1, frames)):
        np.testing.assert_array_equal(batching.make_buckets(3000, nb, sizes=sizes),
                                      jax_batching.make_buckets(3000, nb, sizes=sizes))
    buckets = batching.make_buckets(3000, 12, sizes=frames)
    np.testing.assert_array_equal(batching.bucketize(frames, buckets),
                                  jax_batching.bucketize(frames, buckets))
    assert batching.round_up(13, 8) == jax_batching.round_up(13, 8) == 16
    keep = batching.filter_by_size(frames, tokens, max_frames=2500, max_tokens=50)
    np.testing.assert_array_equal(
        keep, jax_batching.filter_by_size(frames, tokens, max_frames=2500, max_tokens=50))
    order = keep[np.argsort(frames[keep], kind="stable")[::-1]]
    for kw in (dict(max_tokens=20000, frame_buckets=buckets, required_batch_size_multiple=8),
               dict(max_tokens=9000, max_sentences=5, required_batch_size_multiple=1),
               dict(max_tokens=None, max_sentences=7, frame_buckets=buckets)):
        got = batching.batch_by_size(order, frames, **kw)
        want = jax_batching.batch_by_size(order, frames, **kw)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    seqs = [np.asarray(rng.integers(4, 20, size=n).tolist() + [2]) for n in (3, 7, 12)]
    for got, want in zip(batching.collate_targets(seqs, 4, 8, 1, 2),
                         jax_batching.collate_targets(seqs, 4, 8, 1, 2)):
        np.testing.assert_array_equal(got, want)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"id": i}


def _iterators():
    rng = np.random.default_rng(1)
    sizes = rng.integers(1, 50, size=40)

    def batches_fn(epoch):
        order = np.random.default_rng(epoch).permutation(40)
        return batching.batch_by_size(order, sizes, max_tokens=100)

    def collate(samples):
        return [s["id"] for s in samples]

    return (EpochBatchIterator(_Items(40), batches_fn, collate, seed=3),
            JaxEpochBatchIterator(_Items(40), batches_fn, collate, seed=3))


def test_epoch_iterator_order_and_resume_match_jax():
    port, jax_it = _iterators()
    for _ in range(2):  # two epochs, in the same order
        assert list(port.next_epoch_itr()) == list(jax_it.next_epoch_itr())
        port.next_epoch()
        jax_it.next_epoch()
    # mid-epoch: consume 3 batches, save, resume in a fresh iterator
    itr, jitr = port.next_epoch_itr(), jax_it.next_epoch_itr()
    head = [next(itr) for _ in range(3)]
    assert head == [next(jitr) for _ in range(3)]
    state = port.state_dict()
    assert state == jax_it.state_dict()
    rest = list(jitr)
    resumed, jax_resumed = _iterators()
    resumed.load_state_dict(state)
    jax_resumed.load_state_dict(state)
    assert list(resumed.next_epoch_itr()) == rest == list(jax_resumed.next_epoch_itr())
    resumed.rewind()
    assert list(resumed.next_epoch_itr())[:3] == head


def _write_wav(path: Path, samples: np.ndarray):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.rint(samples), -32768, 32767).astype("<i2").tobytes())


def _corpus(root: Path, audio: bool) -> Path:
    rng = np.random.default_rng(2)
    _write_dict(root / "dict.txt")
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i in range(14):
        text = TEXTS[i % len(TEXTS)]
        if audio:
            n = int(rng.integers(300, 4000))  # some rows shorter than one 400-sample window
            _write_wav(root / f"u{i}.wav", rng.normal(scale=2000.0, size=n))
            lines.append(f"u{i}\tu{i}.wav\t{n}\t{text}\t{text}")
        else:
            n = int(rng.integers(5, 60))
            np.save(root / f"u{i}.npy", rng.normal(size=(n, 80)).astype(np.float32))
            lines.append(f"u{i}\tu{i}.npy\t{n}\t{text}\t{text}")
    (root / "train.tsv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("audio", [False, True], ids=["features", "raw_audio"])
def test_task_batches_match_jax(tmp_path, audio):
    root = _corpus(tmp_path, audio)
    cfg = {"dataset": {"data": str(root), "max_tokens": 9000 if audio else 200,
                       "max_source_positions": 4000 if audio else 100,
                       "max_target_positions": 16, "num_buckets": 4,
                       "required_batch_size_multiple": 4}}
    task = SpeechToTextTask(from_dict(TrainConfig, cfg), S2TDataConfig(use_audio_input=audio),
                            Dictionary.load(root / "dict.txt"))
    jtask = JaxTask(jax_from_dict(JaxTrainConfig, cfg), JaxDataConfig(use_audio_input=audio),
                    JaxDictionary.load(root / "dict.txt"), None)
    its = [t.get_batch_iterator(t.load_dataset("train", is_train=True), seed=5,
                                **({} if t is task else {"batch_size_multiple": 1}))
           for t in (task, jtask)]
    for epoch in (1, 2):
        got, want = (list(it.next_epoch_itr()) for it in its)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert set(g) == set(w) >= set(BATCH_KEYS)
            for key in g:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
            assert g["features"].shape[0] % 4 == 0 and g["features"].dtype == np.float32
        for it in its:
            it.next_epoch()
