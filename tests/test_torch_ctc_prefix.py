"""The port's CTC prefix scorer and joint CTC/attention beam against the JAX package on the CPU.

``CTCPrefixScorer`` scans the r_nb / r_b recurrence in the combine tree of
``jax.lax.associative_scan``; the log-sums round differently from XLA's, so
delta, psi and the lattices are held to JAX at rtol 1e-4 and atol 1e-4 (the
impossible paths sit near -1e9, where a float32 ulp is 64: rtol covers them)
and must be finite where JAX's are.  The scan is also held
to a plain frame-by-frame loop at rtol 1e-6.  Joint beam tokens (weights 0.2
and 0.5, over the CTC head and over an XCTC head) must equal JAX's; scores
agree at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.inference.ctc_prefix import CTCPrefixScorer as JaxScorer
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu_torch.inference.ctc_prefix import CTCPrefixScorer, log_matmul, prefix_products
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.models import s2t_transformer as tst
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

RTOL = ATOL = 1e-4
SCORE_ATOL = 1e-5
TINY = dict(
    vocab_size=32, encoder_layers=2, decoder_layers=2, encoder_embed_dim=64,
    decoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128,
    encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=64,
    max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    share_decoder_input_output_embed=False,
)
HEADS = {"ctc": {}, "xctc": dict(use_xctc=True, src_vocab_size=24)}


def make_batch(B=4, T=60, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 80)).astype(np.float32)
    lens = np.array([60, 45, 31, 1][:B], np.int32)
    prev = rng.integers(3, 32, size=(B, 7)).astype(np.int32)
    return feats, lens, prev


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair(pairs, head):
    if head not in pairs:
        kw = {**TINY, **HEADS[head]}
        jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**kw))
        feats, lens, prev = make_batch()
        params = jax.tree.map(np.asarray,
                              jax.jit(jm.init)(jax.random.PRNGKey(0), feats, lens, prev)["params"])
        tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**kw), device="cpu", seed=1)
        pairs[head] = (jm, params, load_flax_params(tm, params))
    return pairs[head]


@pytest.mark.parametrize("T", [1, 2, 5, 8, 13])
def test_prefix_products_match_a_frame_loop(T):
    g = torch.Generator().manual_seed(T)
    m = torch.randn((T, 2, 3, 3), generator=g) * 3.0
    want = [m[0]]
    for t in range(1, T):
        want.append(log_matmul(m[t], want[-1]))
    np.testing.assert_allclose(prefix_products(m).numpy(), torch.stack(want).numpy(), rtol=1e-6,
                               atol=1e-5)


def close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    assert np.isfinite(want).all(), what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_score_candidates_and_select_match_jax():
    B, K, T, V, kc = 2, 3, 23, 12, 5
    rng = np.random.default_rng(3)
    lp = jax.nn.log_softmax(rng.normal(size=(B, T, V)).astype(np.float32) * 2.0, -1)
    lp = np.array(lp)
    lengths = np.array([23, 15], np.int32)
    js = JaxScorer(jnp.asarray(lp), jnp.asarray(lengths), beam_size=K, blank_id=0, eos_id=2)
    ts = CTCPrefixScorer(torch.from_numpy(lp), torch.from_numpy(lengths).long(), beam_size=K,
                         blank_id=0, eos_id=2)
    jstate, tstate = js.init_state(), ts.init_state()
    close(tstate.r, jstate.r, "initial r")
    for step in range(4):
        # EOS, the blank, repeats of the last token and fresh tokens
        cand = rng.integers(0, V, size=(B * K, kc)).astype(np.int32)
        cand[:, 0], cand[0, 1] = 2, 0
        if step:
            cand[:, 2] = np.asarray(jstate.last)
        jd, jr, jp = js.score_candidates(jstate, jnp.asarray(cand))
        td, tr, tp = ts.score_candidates(tstate, torch.from_numpy(cand).long())
        close(td, jd, f"delta, step {step}")
        close(tp, jp, f"psi, step {step}")
        close(tr, jr, f"lattices, step {step}")
        parent = rng.integers(0, K, size=(B, K)).astype(np.int32)
        slot = rng.integers(1, kc, size=(B, K)).astype(np.int32)
        tok = np.take_along_axis(cand.reshape(B, K, kc)[np.arange(B)[:, None], parent],
                                 slot[..., None], 2)[..., 0]
        jstate = js.select(jstate, jnp.asarray(cand), jr, jp, jnp.asarray(parent),
                           jnp.asarray(slot), jnp.asarray(tok))
        tstate = ts.select(tstate, torch.from_numpy(cand).long(), tr, tp,
                           torch.from_numpy(parent).long(), torch.from_numpy(slot).long(),
                           torch.from_numpy(tok).long())
        close(tstate.r, jstate.r, f"selected r, step {step}")
        close(tstate.psi, jstate.psi, f"selected psi, step {step}")
        np.testing.assert_array_equal(tstate.last.numpy(), np.asarray(jstate.last))


@pytest.mark.parametrize("weight", [0.2, 0.5])
@pytest.mark.parametrize("head", list(HEADS))
def test_joint_beam_tokens_identical(pairs, head, weight):
    jm, params, tm = pair(pairs, head)
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}
    kw = dict(beam_size=3, max_len_b=12, infer_ctc_weight=weight)
    jt, js, jenc = JaxGenerator(jm, **kw).generate(params, batch)
    tt, ts, tenc = SequenceGenerator(tm, **kw).generate(batch)
    assert ("xctc_logits" in tenc and tenc["xctc_logits"] is not None) == (head == "xctc")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCORE_ATOL, atol=SCORE_ATOL)
    # the CTC term moves the search: the plain beam decodes other tokens
    plain, _, _ = SequenceGenerator(tm, beam_size=3, max_len_b=12).generate(batch)
    assert not torch.equal(plain, tt)
