"""The port's CTC loss (CPU: the plain lattice recurrences) against the JAX package.

Cases: repeated labels, a row with fewer frames than labels, a row whose
repeats need more frames than it has (nll 1e30, zeroed by zero_infinity), a
0-frame row, and the sum / mean / none reductions, on raw logits
(``normalized=False``, what the criterion passes) and on log-probabilities.
Values are held to the JAX ``ctc_loss`` (its scan path on CPU) at rtol 1e-5,
atol 1e-4, as tests/test_ctc_pallas.py holds its kernel; gradients w.r.t. the
logits at atol 1e-5 (achieved <= 2e-6; the JAX kernel test allows 1e-2).
``ctc_alpha_plain`` / ``ctc_beta_grad_plain`` are held to a direct float64
evaluation over every lattice path, and ``torch.nn.functional.ctc_loss`` is a
second anchor on the feasible rows (test only: the port never calls it).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from s2t_tpu_torch.ops.ctc import _extend_labels, _transition_mask, ctc_loss
from s2t_tpu_torch.ops.ctc_cuda import NEG_INF, ctc_alpha_plain, ctc_beta_grad_plain, ctc_nll
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

V = 12
LABELS = np.array([
    [3, 3, 4, 4, 5],   # repeated labels
    [6, 7, 8, 1, 1],   # 3 labels, padded
    [5, 5, 5, 5, 5],   # 5 repeats need 9 frames: infeasible in 7
    [9, 10, 1, 1, 1],  # fewer frames (1) than labels (2)
    [4, 6, 1, 1, 1],   # 0 frames
    [7, 7, 2, 3, 11],
], np.int32)
LABEL_LENGTHS = np.array([5, 3, 5, 2, 2, 5], np.int32)
INPUT_LENGTHS = np.array([20, 14, 7, 1, 0, 17], np.int32)
FEASIBLE = [0, 1, 5]


def make_logits(seed=0, T=20):
    return (np.random.default_rng(seed).normal(size=(len(LABELS), T, V)) * 2).astype(np.float32)


def port_loss(x, reduction, normalized):
    return ctc_loss(x, torch.from_numpy(LABELS).long(), torch.from_numpy(INPUT_LENGTHS),
                    torch.from_numpy(LABEL_LENGTHS), reduction=reduction, normalized=normalized)


def jax_loss(x, reduction, normalized):
    return jax_ctc_loss(x, jnp.asarray(LABELS), jnp.asarray(INPUT_LENGTHS),
                        jnp.asarray(LABEL_LENGTHS), reduction=reduction, normalized=normalized)


@pytest.mark.parametrize("normalized", [False, True], ids=["logits", "log_probs"])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_values_and_grads_match_jax(reduction, normalized):
    x = make_logits()
    if normalized:
        x = np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    tx = torch.from_numpy(x).requires_grad_()
    got = port_loss(tx, reduction, normalized)
    want = jax_loss(jnp.asarray(x), reduction, normalized)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    if reduction == "none":
        assert (got[[2, 3, 4]] == 0).all()  # infeasible and 0-frame rows
        assert (got[FEASIBLE] > 0).all()
    w = np.random.default_rng(1).normal(size=np.shape(want)).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    gx = jax.grad(lambda a: jnp.sum(jax_loss(a, reduction, normalized) * w))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-5)


def test_torch_ctc_loss_anchor_on_feasible_rows():
    x = make_logits(seed=3)
    lp = torch.log_softmax(torch.from_numpy(x), dim=-1)
    got = port_loss(lp, "none", True)[FEASIBLE]
    want = torch.nn.functional.ctc_loss(
        lp[FEASIBLE].transpose(0, 1), torch.from_numpy(LABELS[FEASIBLE]).long(),
        torch.from_numpy(INPUT_LENGTHS[FEASIBLE]).long(),
        torch.from_numpy(LABEL_LENGTHS[FEASIBLE]).long(), reduction="none")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _direct(emit, ext, length):
    """All lattice paths of one row over its first ``length`` frames, float64:
    (alpha at the last frame per state, log-likelihood over the two final states)."""
    S = emit.shape[1]
    skip = _transition_mask(ext[None], 0)[0].tolist()
    per_state = [[] for _ in range(S)]
    for path in itertools.product(range(S), repeat=length):
        if path[0] > 1:
            continue
        steps = zip(path, path[1:])
        if all(b in (a, a + 1) or (b == a + 2 and skip[b]) for a, b in steps):
            per_state[path[-1]].append(sum(emit[t, s] for t, s in enumerate(path)))
    alpha = torch.stack([torch.logsumexp(torch.stack(p), 0) if p else emit.new_tensor(-torch.inf)
                         for p in per_state])
    return alpha, torch.logsumexp(alpha[-2:], 0)


def test_plain_recurrences_match_direct_evaluation():
    rng = np.random.default_rng(5)
    labels = torch.tensor([[2, 2], [3, 4]])
    ext = _extend_labels(labels, 0)
    B, S, T = 2, ext.shape[1], 5
    lengths = torch.tensor([5, 3])
    emit = torch.from_numpy(rng.normal(size=(T, B, S)) - 1.0).requires_grad_()
    skip = torch.where(_transition_mask(ext, 0), 0.0, NEG_INF).double()
    alphas = ctc_alpha_plain(emit, skip, lengths)
    logz = torch.logaddexp(alphas[-1, :, -2], alphas[-1, :, -1])
    final = torch.full((B, S), NEG_INF, dtype=torch.float64)
    final[:, -2:] = 0.0
    demit = ctc_beta_grad_plain(emit.detach(), alphas.detach(), skip, final, lengths,
                                logz.detach())
    for b in range(B):
        n = int(lengths[b])
        want_alpha, want_logz = _direct(emit[:n, b], ext[b], n)
        reach = torch.isfinite(want_alpha)
        torch.testing.assert_close(alphas[n - 1, b][reach], want_alpha[reach], rtol=0, atol=1e-10)
        assert (alphas[n - 1, b][~reach] < -1e29).all()
        torch.testing.assert_close(alphas[n:, b], alphas[n - 1, b].expand(T - n, S),
                                   rtol=0, atol=0)  # frames past the length carry alpha
        torch.testing.assert_close(logz[b], want_logz, rtol=0, atol=1e-10)
        (grad,) = torch.autograd.grad(-want_logz, emit)
        torch.testing.assert_close(demit[:, b], grad[:, b], rtol=0, atol=1e-10)


def test_ctc_nll_is_differentiable_in_emit():
    emit = torch.randn(2, 6, 5, requires_grad=True)
    ext = _extend_labels(torch.tensor([[2, 3], [4, 4]]), 0)
    nll = ctc_nll(emit, _transition_mask(ext, 0), torch.tensor([6, 4]), torch.tensor([3, 3]),
                  torch.tensor([4, 4]))
    assert nll.grad_fn is not None
    nll.sum().backward()
    assert emit.grad[1, 4:].abs().sum() == 0  # frames past the length get no gradient
