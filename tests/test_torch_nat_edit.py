"""The edit-based NAT models, Levenshtein and insertion, against the JAX package.

* the oracles on ``tests/test_nat.py``'s cases, exactly: delete labels, the
  compact / insert round trip, the leftmost insertion oracle (repeats included);
  then on seeded random pairs: every LCS table, the delete labels, the greedy
  clamp of ``insert_placeholders`` and ``random_delete_with_mask`` on JAX's draws;
* ``make_slot_targets`` on ``tests/test_nat.py``'s cases and on random keeps, at 1e-6;
* tiny Levenshtein and insertion models (2 + 2 layers of 16) from one flax init
  (``tests/test_torch_nat.py``'s helpers) trained one forward on JAX's recorded
  draws: the oracles' targets equal, the loss and every head's log at rtol 1e-4,
  every gradient within 1e-4 of its largest entry;
* the Levenshtein refinement (3 rounds) and the insertion decode (pad penalty 0.5)
  give JAX's tokens; ``from_flax`` both ways keeps both trees;
* pad inside a canvas, the fused attention reading only each mask's row counts, as
  the kernel does: the training roll-in with the pad row of the tied embedding
  planted so that its argmax fill picks pad (loss and gradients), and a refinement
  round over a canvas with pads between its words (features and tokens) match JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.models import insertion_transformer as jins
from s2t_tpu.models import levenshtein_transformer as jlev
from s2t_tpu.ops import levenshtein as jops
from s2t_tpu_torch.interop.from_flax import state_dict_to_flax
from s2t_tpu_torch.models.insertion_transformer import make_slot_targets
from s2t_tpu_torch.ops import levenshtein as ops
from tests.test_torch_nat import (PAD, JaxDraws, is_prefix, lengths_only, loss_and_grads_match,
                                  most_filled, nat_setup, plant_pad, torch_batch)
from tests.test_torch_wav2vec2 import assert_close
from tests.test_torch_train_trainer import flat
from tests.test_torch_translation import write_corpus
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)


def t(x):
    return torch.tensor(x)


DEL_CASES = {  # tests/test_nat.py: (in, out, labels)
    "identity": ([[0, 5, 6, 7, 2, 1]], [[0, 5, 6, 7, 2, 1]], [[0, 0, 0, 0, 0, 0]]),
    "extra_tokens": ([[0, 5, 8, 6, 9, 2]], [[0, 5, 6, 2, 1, 1]], [[0, 0, 1, 0, 1, 0]]),
    "pads_unlabelled": ([[0, 8, 2, 1, 1, 1]], [[0, 2, 1, 1, 1, 1]], [[0, 1, 0, 0, 0, 0]]),
}
INS_CASES = {  # tests/test_nat.py: (y_del, tgt, the first counts)
    "gap": ([[0, 7, 2, 1, 1, 1]], [[0, 5, 6, 7, 2, 1]], [2, 0, 0]),
    "canonical_on_repeats": ([[0, 5, 5, 5, 2, 1]], [[0, 5, 5, 5, 5, 2]], [0, 0, 0, 1, 0]),
}


@pytest.mark.parametrize("case", list(DEL_CASES))
def test_delete_labels_on_the_jax_cases(case):
    a, b, want = DEL_CASES[case]
    np.testing.assert_array_equal(ops.del_targets(t(a), t(b)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jops.del_targets(jnp.asarray(a), jnp.asarray(b))),
                                  want)


@pytest.mark.parametrize("case", list(INS_CASES))
def test_insertion_oracle_on_the_jax_cases(case):
    y_del, tgt, want = INS_CASES[case]
    got = ops.ins_oracle_leftmost(t(y_del), t(tgt)).numpy()
    np.testing.assert_array_equal(got[0, :len(want)], want)
    np.testing.assert_array_equal(got, np.asarray(jlev.ins_oracle_leftmost(
        jnp.asarray(y_del, jnp.int32), jnp.asarray(tgt, jnp.int32))))


def test_compact_and_insert_round_trip_on_the_jax_case():
    packed, n = ops.compact_tokens(t([[0, 5, 6, 7, 2, 1, 1]]),
                                   t([[True, True, False, True, True, False, False]]), 1)
    np.testing.assert_array_equal(packed.numpy(), [[0, 5, 7, 2, 1, 1, 1]])
    assert int(n[0]) == 4
    out, new_len = ops.insert_placeholders(packed, t([[0, 1, 0, 0, 0, 0, 0]]), 1, 3)
    np.testing.assert_array_equal(out.numpy(), [[0, 5, 3, 7, 2, 1, 1]])
    assert int(new_len[0]) == 5


def random_rows(rng, B, N, lo=3, hi=7, pad=1):
    x = rng.integers(lo, hi, size=(B, N)).astype(np.int32)
    for r in range(B):
        x[r, rng.integers(0, N + 1):] = pad
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lcs_tables_and_delete_labels_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = random_rows(rng, 6, 9), random_rows(rng, 6, 11)
    L = ops.lcs_table(t(a), t(b), t(a != 1), t(b != 1)).numpy()
    for r in range(6):
        np.testing.assert_array_equal(L[r], np.asarray(jops._lcs_table(
            jnp.asarray(a[r]), jnp.asarray(b[r]), jnp.asarray(a[r] != 1), jnp.asarray(b[r] != 1))))
    np.testing.assert_array_equal(ops.del_targets(t(a), t(b)).numpy(),
                                  np.asarray(jops.del_targets(jnp.asarray(a), jnp.asarray(b))))


def test_insert_placeholders_clamps_as_jax():
    rng = np.random.default_rng(3)
    tokens = np.asarray(jlev.compact_tokens(jnp.asarray(random_rows(rng, 6, 8)),
                                            jnp.asarray(rng.random((6, 8)) < 0.8), 1)[0])
    counts = rng.integers(0, 6, size=(6, 8)).astype(np.int32)  # overflows the canvas
    got = ops.insert_placeholders(t(tokens), t(counts), 1, 3)
    want = jlev.insert_placeholders(jnp.asarray(tokens), jnp.asarray(counts), 1, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_delete_matches_jax_on_its_draws(monkeypatch):
    rng = np.random.default_rng(4)
    tgt = random_rows(rng, 5, 10, lo=4, hi=9)
    tgt[:, 0] = 0
    tgt[:, 4] = 2  # an eos inside: never deleted
    rec = JaxDraws(monkeypatch)
    want = jlev.random_delete_with_mask(jax.random.PRNGKey(5), jnp.asarray(tgt))
    scores, fractions = (torch.from_numpy(v.copy()) for v in rec.rec)
    got = ops.random_delete_with_mask(t(tgt), scores=scores, fractions=fractions)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SLOT_CASES = {  # tests/test_nat.py's two, then random keeps
    "one_kept": ([[4, 5, 6, 7]], [[False, True, False, False]]),
    "centre_weighting": ([[4, 5, 6, 1]], [[False, False, False, False]]),
}


@pytest.mark.parametrize("case", list(SLOT_CASES) + ["random"])
def test_slot_targets_match_jax(case):
    if case == "random":
        rng = np.random.default_rng(6)
        tgt = random_rows(rng, 5, 9, lo=4, hi=12)
        keep = rng.random((5, 9)) < 0.4
    else:
        tgt, keep = (np.asarray(x) for x in SLOT_CASES[case])
    got = make_slot_targets(t(tgt), t(keep), 1, 12, tau=0.7)
    want = jins.make_slot_targets(jnp.asarray(tgt, jnp.int32), jnp.asarray(keep), 1, 12, tau=0.7)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    root = write_corpus(tmp_path_factory.mktemp("edit"), n_train=16)
    return {"levenshtein": nat_setup(root, "levenshtein_transformer", {}, {"max_ins": 8}),
            "insertion": nat_setup(root, "insertion_transformer", {"insertion_tau": 0.8})}


def test_levenshtein_loss_and_gradients_match_jax(setups, monkeypatch):
    loss_and_grads_match(setups["levenshtein"], monkeypatch, "levenshtein",
                         ["word_ins_loss", "ins_loss", "del_loss", "nll_loss"])


def test_levenshtein_oracle_targets_match_jax(setups, monkeypatch):
    task, _, jm, jfwd, params, tm, jbatch = setups["levenshtein"]
    rec = JaxDraws(monkeypatch)
    want = jfwd(jm, params, jbatch, False, {"dropout": jax.random.PRNGKey(11)})
    with torch.no_grad():
        got = task.forward_fn()(tm, torch_batch(jbatch, rec.handed("levenshtein")), train=True,
                                generator=torch.Generator().manual_seed(0))
    for key in ("word_ins_tgt", "word_ins_mask", "ins_tgt", "ins_mask", "del_tgt", "del_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_insertion_loss_and_gradients_match_jax(setups, monkeypatch):
    loss_and_grads_match(setups["insertion"], monkeypatch, "insertion", ["nll_loss"])


@pytest.mark.parametrize("case,max_iter,penalty", [("levenshtein", 3, 0.0),
                                                    ("insertion", 4, 0.5)])
def test_decode_tokens_match_jax(setups, case, max_iter, penalty):
    task, jtask, jm, _, params, tm, jbatch = setups[case]
    src = {k: np.asarray(jbatch[k]) for k in ("src_tokens", "src_lengths")}
    g = task.cfg.generation.__class__(iter_decode_max_iter=max_iter,
                                      iter_decode_eos_penalty=penalty)
    jg = jtask.cfg.generation.__class__(iter_decode_max_iter=max_iter,
                                        iter_decode_eos_penalty=penalty)
    want, wscores, _ = jtask.build_generator(jm, jg).generate(
        params, {k: jnp.asarray(v) for k, v in src.items()})
    tm.eval()
    got, scores, _ = task.build_generator(tm, g).generate(src)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(wscores), rtol=1e-5, atol=1e-6)
    assert (got[:, 0] != 1).sum() > 2 * len(src["src_tokens"])  # more than a frame


ROLL_IN_KEY = 0


def recorded_canvases(monkeypatch, model):
    """The token canvases each Levenshtein decoder pass reads."""
    canvases = []
    real = type(model)._feats

    def recorded(self, tokens, *a, **kw):
        canvases.append(tokens.clone())
        return real(self, tokens, *a, **kw)

    monkeypatch.setattr(type(model), "_feats", recorded)
    return canvases


def test_levenshtein_roll_in_with_a_pad_fill_matches_jax(setups, monkeypatch):
    # JAX's draws from PRNGKey(ROLL_IN_KEY) delete words, so the roll-in fills some
    task, _, jm, jfwd, params, tm, jbatch = setups["levenshtein"]
    rec = JaxDraws(monkeypatch)
    jfwd(jm, params, jbatch, False, {"dropout": jax.random.PRNGKey(ROLL_IN_KEY)})
    with torch.no_grad():
        out = task.forward_fn()(tm, torch_batch(jbatch, rec.handed("levenshtein")), train=True,
                                generator=torch.Generator().manual_seed(0))
    fill = out["word_ins_logits"].argmax(-1)[out["word_ins_mask"]].numpy()
    monkeypatch.undo()
    setup = plant_pad(setups["levenshtein"], most_filled(fill))
    lengths_only(monkeypatch)
    canvases = recorded_canvases(monkeypatch, setup[5])
    out = loss_and_grads_match(setup, monkeypatch, "levenshtein",
                               ["word_ins_loss", "ins_loss", "del_loss", "nll_loss"],
                               key=ROLL_IN_KEY)
    # the roll-in filled pad inside a canvas, and the deletion pass read it
    assert not is_prefix(out["del_mask"]) and not is_prefix(canvases[-1] != PAD)


def test_levenshtein_round_over_a_canvas_with_inner_pads_matches_jax(setups, monkeypatch):
    # a canvas as a round's fill leaves it when it picks pad: words with pads between them
    task, _, jm, _, params, tm, jbatch = setups["levenshtein"]
    tb = torch_batch(jbatch)
    canvas = torch.cat([torch.zeros_like(tb["target"][:, :1]), tb["target"]], dim=1)
    inner = torch.zeros_like(canvas, dtype=torch.bool)
    inner[:, 2::3] = True
    canvas = torch.where(inner & (canvas > 3), PAD, canvas)
    assert not is_prefix(canvas != PAD)
    calls = lengths_only(monkeypatch)
    tm.eval()
    with torch.no_grad():
        enc = tm.encode(tb["src_tokens"], tb["src_lengths"])
        out, valid = enc["encoder_out"], tm.encoder_valid(enc)
        feats = tm._feats(canvas, out, valid)
        tokens, scores = tm.refine_step(canvas, torch.zeros(canvas.shape), out, valid, 1)
    assert calls and all(is_prefix(m) for m in calls)
    jargs = [jnp.asarray(x.numpy()) for x in (canvas, out, valid)]
    apply = {"params": params}
    assert_close(feats.numpy(), jm.apply(apply, *jargs, method="_feats"),
                 "decoder features over inner pads, 1e-5")
    want, wscores = jm.apply(apply, jargs[0], jnp.zeros(canvas.shape), *jargs[1:], 1,
                             method="refine_step")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(wscores), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["levenshtein", "insertion"])
def test_from_flax_round_trip_keeps_the_tree(setups, case):
    params, tm = setups[case][4], setups[case][5]
    got, want = dict(flat(state_dict_to_flax(tm.state_dict()))), dict(flat(params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
