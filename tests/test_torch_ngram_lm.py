"""The port's n-gram LM and CTCGenerator's n-gram re-ranking against the JAX package on the CPU.

``train_ngram_lm`` builds the same n-gram table as JAX's; an ARPA file the
port writes loads in both packages and scores every sentence as JAX's own
model does, to 1e-9 (float64 sums of the same table; the file keeps 6
decimals).  ``rescore_nbest`` re-ranks as JAX's does.  A tiny ``s2t_ctc``
(carried across with ``from_flax``) decodes a beam through each task's
``build_generator`` with ``generation.lm_path`` set to an ``.arpa`` file this
test writes: tokens must equal JAX's and scores agree at 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data import ngram_lm as jngram
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data import ngram_lm
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.inference.ctc_decoder import CTCGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(20)]
RNG = np.random.default_rng(0)
CORPUS = [" ".join(RNG.choice(WORDS[:12], size=int(RNG.integers(2, 7)))) for _ in range(40)]
SENTENCES = ["w0 w1 w2", "w3 w3 w3 w3", "w19 w0", "w5", "w11 w7 w2 w9 w1"]
MODEL = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
             encoder_attention_heads=2, subsampling_filter=32, dropout=0.0,
             attention_dropout=0.0, activation_dropout=0.0)


@pytest.mark.parametrize("order", [2, 3])
def test_trained_table_and_arpa_round_trip_match_jax(order, tmp_path):
    lm = ngram_lm.train_ngram_lm(CORPUS, order=order)
    jlm = jngram.train_ngram_lm(CORPUS, order=order)
    assert lm.ngrams == jlm.ngrams
    lm.save(tmp_path / "lm.arpa")
    jlm.save(tmp_path / "jax.arpa")
    assert (tmp_path / "lm.arpa").read_text() == (tmp_path / "jax.arpa").read_text()
    back = ngram_lm.ArpaLM.load(tmp_path / "lm.arpa")
    jback = jngram.ArpaLM.load(tmp_path / "lm.arpa")
    assert back.order == jback.order == order
    for s in SENTENCES:
        assert back.score(s.split()) == pytest.approx(jback.score(s.split()), abs=1e-9)
        assert back.score(s.split()) == pytest.approx(jlm.score(s.split()), abs=1e-4)


def test_rescore_nbest_matches_jax():
    d = Dictionary()
    for w in WORDS:
        d.add_symbol(w)
    lm = ngram_lm.train_ngram_lm(CORPUS, order=2)
    tokens = RNG.integers(4, 4 + len(WORDS), size=(3, 4, 6)).astype(np.int32)
    tokens[:, :, 4:] = d.pad()
    scores = RNG.normal(size=(3, 4)).astype(np.float32)
    got = ngram_lm.rescore_nbest(tokens, scores, d, lm, lm_weight=0.7, word_bonus=0.2)
    want = jngram.rescore_nbest(tokens, scores, d, lm, lm_weight=0.7, word_bonus=0.2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_ctc_generator_with_an_arpa_lm_matches_jax(tmp_path):
    (tmp_path / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    ngram_lm.train_ngram_lm(CORPUS, order=3).save(tmp_path / "lm.arpa")
    cfg = {"arch": "s2t_ctc", "model": MODEL, "dataset": {"data": str(tmp_path)},
           "generation": {"beam": 4, "lm_path": str(tmp_path / "lm.arpa"), "lm_weight": 2.0}}
    task = SpeechToTextTask(from_dict(TrainConfig, cfg), S2TDataConfig(),
                            Dictionary.load(tmp_path / "dict.txt"))
    jtask = JaxTask(jax_from_dict(JaxTrainConfig, cfg), JaxDataConfig(),
                    JaxDictionary.load(tmp_path / "dict.txt"), None)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(3, 48, 80)).astype(np.float32)
    lens = np.array([48, 40, 29], np.int32)
    jm = jtask.build_model()
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(0), feats, lens)["params"])
    tm = load_flax_params(task.build_model(device="cpu"), params)
    batch = {"features": feats, "feat_lengths": lens}
    gen = task.build_generator(tm)
    assert isinstance(gen, CTCGenerator) and gen.ngram_lm.order == 3
    jt, js, _ = jtask.build_generator(jm).generate(params, batch)
    tt, ts, _ = gen.generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    # the LM re-ranks: without it the n-best keeps the CTC order
    plain, _, _ = CTCGenerator(tm, gen.decoder).generate(batch)
    assert not torch.equal(plain, tt)
