"""The s2t_tpu_torch serving slice against the JAX package on CPU.

A tiny s2t_transformer (2 encoder / 2 decoder layers, d=64, 4 heads, FFN 128,
vocab 32) is initialised by flax and carried across with ``from_flax``.
Forward tensors agree at atol 1e-4 (fp32, two stacks summed in another
order); beam-search tokens must be identical; the end-to-end path (fixture
wavs -> fbank -> hub -> tokens) must give the JAX tokens.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.data.audio.fbank import fbank_numpy as jax_fbank_numpy
from s2t_tpu.data.dataset import load_waveform as jax_load_waveform
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu_torch.data.audio.fbank import fbank_numpy
from s2t_tpu_torch.data.dataset import load_waveform
from s2t_tpu_torch.hub import GeneratorHub
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_params
from s2t_tpu_torch.models import s2t_transformer as tst
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-4
WAVS = sorted(str(p) for p in (Path(__file__).parent / "fixtures" / "audio").glob("utt*.wav"))
TINY = dict(
    vocab_size=32, encoder_layers=2, decoder_layers=2, encoder_embed_dim=64,
    decoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128,
    encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=64,
    max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
)
VARIANTS = {
    "prenorm_tied": {},
    "postnorm_untied_ctc_tied": dict(
        encoder_normalize_before=False, decoder_normalize_before=False,
        share_decoder_input_output_embed=False, share_ctc_and_embed=True,
    ),
    # an untied output projection keeps random-weight beams from copying
    # their input token, so the searches below branch and finish early
    "decode": dict(share_decoder_input_output_embed=False),
}


def make_batch(B=4, T=60, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 80)).astype(np.float32)
    lens = np.array([60, 45, 31, 1][:B], np.int32)
    prev = rng.integers(3, 32, size=(B, 7)).astype(np.int32)
    return feats, lens, prev


def build_pair(variant):
    kw = {**TINY, **VARIANTS[variant]}
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**kw))
    feats, lens, prev = make_batch()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, lens, prev)["params"]
    params = jax.tree.map(np.asarray, params)
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**kw), device="cpu", seed=1)
    load_flax_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair(pairs, variant):
    if variant not in pairs:
        pairs[variant] = build_pair(variant)
    return pairs[variant]


@pytest.mark.parametrize("variant", ["prenorm_tied", "postnorm_untied_ctc_tied"])
def test_forward_parity(pairs, variant):
    jm, params, tm = pair(pairs, variant)
    feats, lens, prev = make_batch(seed=1)
    ref = jm.apply({"params": params}, feats, lens, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(feats), torch.from_numpy(lens).long(), torch.from_numpy(prev).long())
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(), np.asarray(ref["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_from_flax_maps_every_leaf(pairs, variant):
    _, params, tm = pair(pairs, variant)
    assert set(flax_to_state_dict(params)) == set(tm.state_dict())


def test_from_flax_raises_on_unmapped_leaves(pairs):
    _, params, tm = pair(pairs, "prenorm_tied")
    extra = {**params, "encoder": {**params["encoder"], "mystery": {"gamma": np.zeros(3)}}}
    with pytest.raises(KeyError, match="mystery"):
        load_flax_params(tm, extra)
    missing = {**params, "encoder": {k: v for k, v in params["encoder"].items() if k != "final_norm"}}
    with pytest.raises(KeyError, match="final_norm"):
        load_flax_params(tm, missing)


@pytest.mark.parametrize("opts", [
    {}, dict(min_len=10), dict(lenpen=0.6), dict(no_repeat_ngram_size=2),
], ids=["plain", "min_len", "lenpen", "ngram"])
def test_beam_search_tokens_identical(pairs, opts):
    jm, params, tm = pair(pairs, "decode")
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxGenerator(jm, beam_size=3, max_len_b=12, **opts).generate(params, batch)
    tt, ts, _ = SequenceGenerator(tm, beam_size=3, max_len_b=12, **opts).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_end_to_end_wavs_through_hub(pairs):
    jm, params, tm = pair(pairs, "decode")
    feats = []
    for p in WAVS:
        f = fbank_numpy(load_waveform(p))
        np.testing.assert_allclose(f, jax_fbank_numpy(jax_load_waveform(p)), atol=1e-6)
        feats.append(f)
    hub = GeneratorHub(tm, SequenceGenerator(tm, beam_size=5, max_len_b=20))
    batch = hub._speech_batch(WAVS)
    jt, _, _ = JaxGenerator(jm, beam_size=5, max_len_b=20).generate(params, batch)
    want = []
    for row in np.asarray(jt)[:, 0]:
        stop = np.flatnonzero(row == 2)
        want.append(row[: stop[0] if stop.size else len(row)])
    got = hub.generate(WAVS)
    assert len(got) == len(WAVS) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_unported_branches_raise():
    # rel_pos and the conv module are ported (tests/test_torch_conformer.py), and so are
    # Shaw's relative attention and DLCL (tests/test_torch_variants_models.py); relative
    # attention without a clip length fails, as it does in JAX
    with pytest.raises(ValueError, match="max_relative_length"):
        tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY, encoder_attention_type="relative"),
                                device="cpu")
    dlcl = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY, use_enc_dlcl=True), device="cpu")
    assert dlcl.encoder.dlcl.weights.shape == (3, 3)
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu")
    # sampling is ported (tests/test_torch_search.py): it draws K samples a sentence
    feats, lens, _ = make_batch()
    tokens, scores, _ = SequenceGenerator(tm, beam_size=2, max_len_b=6, sampling=True).generate(
        {"features": feats, "feat_lengths": lens})
    assert tokens.shape[:2] == (4, 2) and torch.isfinite(scores).all()
    # an option the port refuses as JAX does: groups that do not divide the beam
    with pytest.raises(ValueError, match="divisible"):
        SequenceGenerator(tm, beam_size=5, diverse_beam_groups=3)
