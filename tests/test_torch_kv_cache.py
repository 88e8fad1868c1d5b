"""The port's int8 KV cache and lazy beam reorder against the JAX package on the CPU.

On tiny s2t_transformer pairs (tests/test_torch_search.py's, carried across
with ``from_flax``) the int8 cache's decode steps give JAX's logits within
1e-5, with abs and with Shaw relative decoder self-attention; its int8 values
are JAX's to one step of rounding on at most 1 % of the entries (a half-way
point may land either side in another float order) and its bf16 scales are
JAX's exactly.  The lazy reorder decodes the eager reorder's tokens, with
scores within 1e-6, at beams 2 and 5 and under joint CTC with a length
penalty, and JAX's lazy tokens.  A model without the int8 mode (PDS, as in
JAX) warns and decodes at full precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.utils.masking import lengths_to_mask as jax_lengths_to_mask
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.models import pds as tpds
from s2t_tpu_torch.utils.masking import lengths_to_mask

from tests.test_torch_search import MAX_LEN, VARIANTS, build_pair, make_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

STEP_ATOL = 1e-5


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair(pairs, variant="abs"):
    if variant not in pairs:
        pairs[variant] = build_pair(variant)
    return pairs[variant]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_int8_cache_steps_match_jax(pairs, variant):
    jm, params, tm = pair(pairs, variant)
    feats, lens, prev = make_batch()
    B, L = feats.shape[0], 8
    enc = jm.apply({"params": params}, feats, lens, method=jm.encode)
    mask = jax_lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
    jcache = jm.apply({"params": params}, B, L, method=jm.init_cache, kv_int8=True)
    jstep = jax.jit(lambda p, tok, c, i, e, m: jm.apply({"params": p}, tok, c, i, e, m,
                                                        method=jm.decode_step))
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens).long())
        tmask = lengths_to_mask(tenc["encoder_lengths"], tenc["encoder_out"].shape[1])
        tcache = tm.init_cache(B, L, kv_int8=True)
        for i in range(L - 1):
            tok = prev[:, i:i + 1]
            jl, jcache = jstep(params, jnp.asarray(tok), jcache, jnp.int32(i),
                               enc["encoder_out"], mask)
            tl, tcache = tm.decode_step(torch.from_numpy(tok).long(), tcache, i,
                                        tenc["encoder_out"], tmask)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STEP_ATOL,
                                       err_msg=f"step {i}")
    for name in ("k", "v", "k_scale", "v_scale"):
        got = tcache["layer1"][name][:, :L - 1].float().numpy()
        want = np.asarray(jcache["layer1"][name][:, :L - 1].astype(jnp.float32))
        assert (np.abs(got - want) <= (1 if name in ("k", "v") else 0)).all(), name
        assert np.mean(got != want) <= (0.01 if name in ("k", "v") else 0), name


@pytest.mark.parametrize("case", ["beam2", "beam5", "beam5_ctc_lenpen"])
def test_lazy_reorder_equals_eager(pairs, case):
    jm, params, tm = pair(pairs)
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}
    kw = dict(beam_size=int(case[4]), max_len_b=MAX_LEN)
    if case.endswith("lenpen"):
        kw.update(infer_ctc_weight=0.3, lenpen=0.7)
    eager_t, eager_s, _ = SequenceGenerator(tm, **kw).generate(batch)
    lazy_t, lazy_s, _ = SequenceGenerator(tm, lazy_beam_reorder=True, **kw).generate(batch)
    np.testing.assert_array_equal(lazy_t.numpy(), eager_t.numpy())
    np.testing.assert_allclose(lazy_s.numpy(), eager_s.numpy(), rtol=1e-6, atol=1e-6)
    if case == "beam5":
        jt, _, _ = JaxGenerator(jm, lazy_beam_reorder=True, **kw).generate(params, batch)
        np.testing.assert_array_equal(lazy_t.numpy(), np.asarray(jt))




def test_option_refusals_and_fallbacks(pairs, caplog):
    _, _, tm = pair(pairs)
    with pytest.raises(ValueError, match="divisible by diverse_beam_groups"):
        SequenceGenerator(tm, beam_size=5, diverse_beam_groups=2)
    # the JAX PDS model has no int8 cache: a warning, and the full-precision decode
    kw = dict(vocab_size=32, pds_embed_dims=(32, 32, 32, 32), pds_layers=(1, 1, 1, 1),
              decoder_layers=1, decoder_ffn_embed_dim=64, dropout=0.0, attention_dropout=0.0,
              activation_dropout=0.0)
    pds = tpds.PDSS2TTransformerModel(tpds.pdss2t_transformer_s_8(**kw), device="cpu")
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}
    want, _, _ = SequenceGenerator(pds, beam_size=2, max_len_b=6).generate(batch)
    got, _, _ = SequenceGenerator(pds, beam_size=2, max_len_b=6,
                                  kv_cache_dtype="int8").generate(batch)
    assert "no int8 cache mode" in caplog.text
    assert torch.equal(got, want)
