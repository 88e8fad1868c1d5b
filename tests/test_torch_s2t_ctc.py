"""The port's encoder-only CTC model and CTCGenerator against the JAX package on the CPU.

A tiny ``s2t_ctc`` (2 encoder layers, d=64, 4 heads, FFN 128, vocab 32) is
initialised by flax and carried across with ``from_flax``, plain and with
``encoder_embed_norm`` and no embedding scale (egs/mustc/asr/conf/purectc.yaml).
``encoder_out`` and ``ctc_logits`` agree at atol 1e-5 (fp32, two layers
summed in another order); greedy and beam-5 tokens of ``CTCGenerator`` are
identical to the JAX ``CTCGenerator``'s and the beam scores agree at 1e-5.
The ``ctc`` criterion's loss and every parameter's gradient match
``jax.value_and_grad`` at the tolerances of tests/test_torch_train_criterion.py
(loss rtol 1e-5, gradients atol 1e-5 of each leaf's largest entry).
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.ngram_lm import train_ngram_lm
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models.build import build_model
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
TINY = dict(vocab_size=32, encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
            encoder_attention_heads=4, subsampling_filter=64, dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0)
VARIANTS = {"plain": {}, "embed_norm": dict(encoder_embed_norm=True,
                                            encoder_no_scale_embedding=True)}


def make_batch(B=4, T=60, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 80)).astype(np.float32)
    return feats, np.array([60, 45, 31, 1][:B], np.int32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    kw = {**TINY, **VARIANTS[request.param]}
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_base(**kw))
    feats, lens = make_batch()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, lens)["params"]
    params = jax.tree.map(np.asarray, params)
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_base(**kw), device="cpu", seed=1)
    load_flax_params(tm, params)
    return jm, params, tm


def test_forward_parity(pair):
    jm, params, tm = pair
    feats, lens = make_batch(seed=1)
    ref = jm.apply({"params": params}, feats, lens)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long())
    assert out["decoder_logits"] is None and ref["decoder_logits"] is None
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


def test_from_flax_maps_every_leaf(pair):
    _, params, tm = pair
    assert set(flax_to_state_dict(params)) == set(tm.state_dict())
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(state_dict_to_flax(tm.state_dict()))[0]]
    assert set(paths) == {jax.tree_util.keystr(p) for p, _ in
                          jax.tree_util.tree_flatten_with_path(params)[0]}
    assert ("embed_norm" in params["encoder"]) == tm.cfg.encoder_embed_norm


@pytest.mark.parametrize("beam", [1, 5])
def test_generator_tokens_identical(pair, beam):
    jm, params, tm = pair
    feats, lens = make_batch(seed=2)
    batch = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam)).generate(params, batch)
    tt, ts, enc = CTCGenerator(tm, CTCDecoder(beam_size=beam)).generate(batch)
    assert tt.shape == np.asarray(jt).shape == (4, beam, enc["ctc_logits"].shape[1])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ctc_criterion_loss_and_grads_match_jax(variant):
    kw = {**TINY, **VARIANTS[variant]}
    rng = np.random.default_rng(3)
    feats, lens = make_batch(seed=3)
    target = rng.integers(4, 32, size=(4, 6)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]  # a shorter sentence: EOS, then pad
    batch = {"features": feats, "feat_lengths": lens, "prev_tokens": np.roll(target, 1, 1),
             "target": target, "ntokens": np.float32((target != 1).sum())}
    criterion = ("ctc", {"ctc_weight": 1.0, "zero_infinity": True})
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_base(**kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, lens)["params"]
    params = jax.tree.map(np.asarray, params)
    jcrit = jax_build_criterion(*criterion)

    def jax_loss(p):
        loss, sample_size, logs = jcrit(jm.apply({"params": p}, feats, lens), batch)
        return loss, (sample_size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_base(**kw), device="cpu", for_training=True)
    load_flax_params(tm, params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, size, logs = build_criterion(*criterion)(tm(tb["features"], tb["feat_lengths"]), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logs["ctc_loss"].item(), float(jlogs["ctc_loss"]), rtol=1e-5)
    assert size.item() == float(jsize)
    got = state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})
    for (path, g), (_, want) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                    jax.tree_util.tree_flatten_with_path(jgrads)[0]):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_unported_presets_and_encoders_raise():
    # in-layer conv strides are ported (tests/test_torch_variants_pds.py); they need the
    # conv module, as in JAX
    with pytest.raises(ValueError, match="pds_conv_strides"):
        build_model("s2t_ctc_pds", dict(vocab_size=32, pds_conv_strides=(1, 2, 1, 1)),
                    device="cpu")
    # the PDS stage taps are ported (tests/test_torch_pds_taps.py)
    taps = build_model("s2t_ctc_pds", dict(vocab_size=32, pds_layers=(1, 1, 1, 1),
                                           pds_xctc=(0, 1, 0, 0)), device="cpu")
    assert set(taps.encoder.xctc_norms) == {"1"}
    with pytest.raises(TypeError, match="SATEConfig"):
        tctc.S2TCTCModel(object(), device="cpu")
    # the SATE encoder is ported (tests/test_torch_sate.py): its preset builds an encoder-only model
    sate = build_model("s2t_ctc_sate", dict(vocab_size=32, acoustic_encoder_layers=1,
                                            text_encoder_layers=1), device="cpu")
    assert isinstance(sate, tctc.S2TCTCModel) and sate.cfg.decoder_layers == 0
    # the PDS encoder is ported (tests/test_torch_pds.py): its preset builds an encoder-only model
    pds = build_model("s2t_ctc_pds", dict(vocab_size=32, pds_layers=(1, 1, 1, 1)), device="cpu")
    assert isinstance(pds, tctc.S2TCTCModel) and pds.cfg.decoder_layers == 0
    model = build_model("s2t_ctc", dict(TINY), device="cpu")
    assert isinstance(model, tctc.S2TCTCModel) and model.cfg.decoder_layers == 0
    # the n-gram LM re-ranking is ported (tests/test_torch_ngram_lm.py): it re-ranks a beam
    d = Dictionary()
    for i in range(28):
        d.add_symbol(f"w{i}")
    lm = train_ngram_lm(["w0 w1", "w1 w2 w3"], order=2)
    feats, lens = make_batch()
    tokens, scores, _ = CTCGenerator(model, CTCDecoder(beam_size=3), ngram_lm=lm, lm_weight=1.0,
                                     dictionary=d).generate({"features": feats,
                                                             "feat_lengths": lens})
    assert tokens.shape[:2] == (4, 3) and (scores[:, :-1] >= scores[:, 1:]).all()
