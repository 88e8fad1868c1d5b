"""The port's CTC decoders against the JAX package on the CPU.

``ctc_greedy_decode`` must give the JAX tokens and lengths exactly: ragged
lengths, repeated tokens, an all-blank row and a 0-length row.
``ctc_prefix_beam_decode`` must give the JAX prefixes exactly and the scores
within 1e-5 (float32 logaddexp chains summed in another order), also where
log-probs tie (the top-k breaks ties to the lower index in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.inference.ctc_decoder import ctc_prefix_beam_decode as jax_beam
from s2t_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from s2t_tpu_torch.inference.ctc_decoder import ctc_prefix_beam_decode
from s2t_tpu_torch.ops.ctc import ctc_greedy_decode
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

LENGTHS = np.array([30, 17, 9, 1, 0], np.int32)


def log_probs(case, B=5, T=30, V=8, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, V)) * 2).astype(np.float32)
    if case == "repeats":  # runs of one token, split by blanks now and then
        logits[:, :, 5] += np.where(np.arange(T) % 7 < 5, 6.0, -6.0)[None, :]
    elif case == "ties":  # tokens 3, 4, 5 share every frame's log-prob
        logits[:, :, 4] = logits[:, :, 3]
        logits[:, :, 5] = logits[:, :, 3]
    elif case == "uniform":
        logits[:] = 0.0
    if B > 2:
        logits[2, :, 0] += 20.0  # an all-blank row
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("case", ["random", "repeats", "ties"])
def test_greedy_matches_jax(case):
    lp = log_probs(case)
    want_tok, want_len = jax_greedy(jnp.asarray(lp), jnp.asarray(LENGTHS))
    tok, lens = ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_len))
    assert lens[2] == 0 and lens[4] == 0 and (tok[4] == 1).all()  # all-blank, 0-length rows
    assert tok.dtype == torch.int32 and lens.dtype == torch.int32


@pytest.mark.parametrize("case", ["random", "repeats", "ties", "uniform"])
@pytest.mark.parametrize("beam", [2, 5])
def test_prefix_beam_matches_jax(case, beam):
    lp = log_probs(case, seed=1)
    want_tok, want_scores = jax_beam(jnp.asarray(lp), jnp.asarray(LENGTHS), beam_size=beam)
    tok, scores = ctc_prefix_beam_decode(torch.from_numpy(lp), torch.from_numpy(LENGTHS),
                                         beam_size=beam)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-5, rtol=0)
    assert tok.shape == (5, beam, 30)


def test_prefix_beam_prunes_to_prune_k_with_a_wide_vocabulary():
    lp = log_probs("random", B=2, T=12, V=40, seed=2)
    lens = np.array([12, 7], np.int32)
    want_tok, want_scores = jax_beam(jnp.asarray(lp), jnp.asarray(lens), beam_size=3, prune_k=4)
    tok, scores = ctc_prefix_beam_decode(torch.from_numpy(lp), torch.from_numpy(lens),
                                         beam_size=3, prune_k=4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-5, rtol=0)
