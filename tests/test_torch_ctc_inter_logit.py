"""``generation.ctc_inter_logit``: decoding the k-th inter-CTC tap against the JAX package.

Two tiny encoder-only models initialised by flax (perturbed) and carried across by
``from_flax``: an ``s2t_ctc`` Transformer with inter-CTC taps after layers 1, 2 and
3 of 4, and an ``s2t_ctc_pds`` with a tap after each of its 3 stages (the shared
head and PAE of tests/test_torch_pds_taps.py).  At k = 1, 2, 3 and beam 1 and 3 the
port's ``CTCGenerator`` tokens are identical to the JAX generator's.  The JAX
decoder reads the k-th tap with the FINAL encoder lengths
(s2t_tpu/inference/ctc_decoder.py:45-46), so a PDS stage tap, at a finer time scale
than the output, is read over its first final-length frames: the port does the
same.  The task maps ``generation.ctc_inter_logit`` onto the decoder.
"""

import numpy as np
import pytest
import torch

from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
from tests.test_torch_conformer import flax_init, perturb, rng_batch
from tests.test_torch_pds_taps import PDS, TAPS
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TRANSFORMER = dict(vocab_size=40, encoder_layers=4, encoder_embed_dim=32,
                   encoder_ffn_embed_dim=64, encoder_attention_heads=2, subsampling_filter=32,
                   inter_ctc_layers=(1, 2, 3), dropout=0.0, attention_dropout=0.0,
                   activation_dropout=0.0)
MODELS = {
    "transformer": ("s2t_ctc_base", TRANSFORMER),
    "pds": ("s2t_ctc_pds", {k: v for k, v in {**PDS, **TAPS["shared"]}.items()
                            if not k.startswith("decoder")}),
}


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, (preset, kw) in MODELS.items():
        jm = jctc.S2TCTCModel(getattr(jctc, preset)(**kw))
        feats, lens = rng_batch(0)
        params = perturb(flax_init(jm, feats, lens))
        tm = tctc.S2TCTCModel(getattr(tctc, preset)(**kw), device="cpu")
        out[name] = (jm, params, load_flax_params(tm, params))
    return out


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("beam", [1, 3])
def test_inter_logit_tokens_identical_to_jax(pairs, name, k, beam):
    jm, params, tm = pairs[name]
    feats, lens = rng_batch(4)
    b = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam, intermediate_logit=k)
                                   ).generate(params, b)
    tt, ts, enc = CTCGenerator(tm, CTCDecoder(beam_size=beam, intermediate_logit=k)).generate(b)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    tap = enc["inter_ctc_logits"][k - 1][1]
    # the tap, read with the final lengths: a PDS stage tap over its first frames only
    want, _ = CTCDecoder(beam_size=beam).decode({"ctc_logits": tap,
                                                 "encoder_lengths": enc["encoder_lengths"]})
    assert torch.equal(tt, want if beam > 1 else want[:, None])
    if name == "pds" and k == 1:
        assert tap.shape[1] > enc["ctc_logits"].shape[1]


def test_generation_ctc_inter_logit_reaches_the_decoder(pairs, tmp_path):
    _, _, tm = pairs["transformer"]
    (tmp_path / "dict.txt").write_text("".join(f"w{i} 1\n" for i in range(36)))
    d = {"arch": "s2t_ctc", "model": TRANSFORMER, "dataset": {"data": str(tmp_path)},
         "generation": {"ctc_inter_logit": 2, "beam": 3}}
    task = SpeechToTextTask(from_dict(TrainConfig, d), S2TDataConfig(),
                            Dictionary.load(tmp_path / "dict.txt"))
    gen = task.build_generator(tm)
    assert isinstance(gen, CTCGenerator)
    assert gen.decoder.intermediate_logit == 2 and gen.decoder.beam_size == 3
    feats, lens = rng_batch(5)
    b = {"features": feats, "feat_lengths": lens}
    got, _, _ = gen.generate(b)
    want, _, _ = CTCGenerator(tm, CTCDecoder(beam_size=3, intermediate_logit=2)).generate(b)
    assert torch.equal(got, want)
