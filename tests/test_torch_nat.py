"""CMLM, vanilla NAT and NACRF (``translation_lev``, ``nat_loss``, mask-predict) against
the JAX package.

``tests/test_torch_translation.py``'s corpus; tiny models (2 + 2 layers of 16, 2
heads, dropout 0) from one flax init, perturbed, carried across by ``from_flax``;
the translation_lev task's forward adapter on both sides, JAX's uniforms recorded
(``jax.random.uniform``) and handed to the port through ``batch["draws"]``:

* ``random_mask`` / ``full_mask`` give JAX's decoder inputs on JAX's draws;
* forward (word and length logits, the CRF NLL) within 1e-5 of each tensor's
  largest magnitude; the loss and every head's log at rtol 1e-4 and every gradient
  within 1e-4 of its largest entry, for CMLM (random_mask), vanilla NAT (full_mask)
  and NACRF;
* the CRF alone on emissions with ties: NLL, Viterbi tokens and scores;
* ``skeptical_unmask`` on tied scores; mask-predict (4 rounds), the one-pass NAT
  and the NACRF Viterbi decode give JAX's tokens;
* the non-causal decoder runs the fused attention (counted) on its keys valid-first
  under a prefix mask, and gives JAX's logits over a canvas with pads inside it;
  mask-predict whose first round fills pad inside a canvas (the pad row of the
  tied embedding planted) gives JAX's tokens; ``from_flax`` both ways keeps the tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.inference.iterative_refinement import skeptical_unmask as jax_skeptical
from s2t_tpu.modules.dynamic_crf import DynamicCRF as JaxCRF
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu.tasks.translation_lev import full_mask as jax_full_mask
from s2t_tpu.tasks.translation_lev import random_mask as jax_random_mask
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.inference.iterative_refinement import skeptical_unmask
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.modules import attention as tattn
from s2t_tpu_torch.modules.dynamic_crf import DynamicCRF
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.tasks.translation_lev import full_mask, random_mask
from tests.test_torch_train_trainer import flat
from tests.test_torch_translation import cfg_dict, write_corpus
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

PAD = 1
MODEL = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=2,
             encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
             decoder_layers=2, decoder_attention_heads=2, dropout=0.0)
CASES = {  # name -> (arch, task_cfg, model overrides)
    "cmlm": ("cmlm_transformer", {"noise": "random_mask"}, {}),
    "nat": ("nonautoregressive_transformer", {"noise": "full_mask"}, {}),
    "nacrf": ("nacrf_transformer", {"noise": "full_mask"},
              {"crf_rank": 4, "crf_beam": 5, "word_ins_factor": 0.5}),
}
# JAX's draws in the order each forward makes them -> the port's ``draws`` keys
DRAW_KEYS = {"random_mask": ("noise_scores", "noise_fractions"), "full_mask": (),
             "levenshtein": ("noise_scores", "noise_fractions", "delete_scores",
                             "delete_fractions"),
             "insertion": ("keep_rates", "keep_uniforms")}


class JaxDraws:
    """``jax.random.uniform`` recorded (eagerly), then replayed in order (under a jit)."""

    def __init__(self, monkeypatch):
        self.orig, self.rec, self.replay = jax.random.uniform, [], None
        monkeypatch.setattr(jax.random, "uniform", self)

    def __call__(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if self.replay is not None:
            return jnp.asarray(self.replay.pop(0))
        out = self.orig(key, shape, dtype, minval, maxval)
        self.rec.append(np.asarray(out))
        return out

    def handed(self, kind):
        assert len(self.rec) == len(DRAW_KEYS[kind])
        return {k: torch.from_numpy(v.copy()) for k, v in zip(DRAW_KEYS[kind], self.rec)}

    def replaying(self):
        self.replay = list(self.rec)
        return self


def nat_dict(root, arch, task_cfg, model=None, **sections):
    d = cfg_dict(root, task="translation_lev", arch=arch, criterion="nat_loss",
                 criterion_cfg={"label_smoothing": 0.1, "length_loss_factor": 0.1},
                 task_cfg=task_cfg, eval={"eval_bleu": False}, **sections)
    d["model"] = {**MODEL, **(model or {})}
    return d


def nat_setup(root, arch, task_cfg, model=None, seed=0):
    """(task, jtask, jm, jfwd, params, tm, jbatch) from one flax init, perturbed."""
    d = nat_dict(root, arch, task_cfg, model)
    task, jtask = setup_task(from_dict(TrainConfig, d)), jax_setup_task(
        jax_from_dict(JaxTrainConfig, d))
    batch = next(iter(task.get_batch_iterator(task.load_dataset("train"), seed=3)
                      .next_epoch_itr()))
    # device arrays: the CRF's scan indexes the mask with a traced step
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k not in ("ids", "nsentences")}
    jm, jfwd = jtask.build_model(), jtask.forward_fn()
    params = jfwd(jm, None, jbatch, True, {"params": jax.random.PRNGKey(seed)})["params"]
    params = perturb(jax.tree.map(np.asarray, params), seed=seed + 7)
    tm = load_flax_params(task.build_model(device="cpu", for_training=True), params)
    return task, jtask, jm, jfwd, params, tm, jbatch


def torch_batch(jbatch, draws=None):
    out = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    if draws is not None:
        out["draws"] = draws
    return out


def loss_and_grads_match(setup, monkeypatch, kind, log_keys, key=11):
    """One training forward of both packages on JAX's draws (from PRNGKey(``key``)):
    loss, logs, gradients."""
    task, jtask, jm, jfwd, params, tm, jbatch = setup
    rngs = {"dropout": jax.random.PRNGKey(key)}
    rec = JaxDraws(monkeypatch)
    jfwd(jm, params, jbatch, False, rngs)  # records this step's draws
    jcrit = jtask.build_criterion()

    def jax_loss(p):
        loss, size, logs = jcrit(jfwd(jm, p, jbatch, False, rngs), jbatch)
        return loss, (size, {k: logs[k] for k in log_keys})

    rec.replaying()
    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(params)
    tb = torch_batch(jbatch, rec.handed(kind))
    tm.zero_grad()
    out = task.forward_fn()(tm, tb, train=True, generator=torch.Generator().manual_seed(0))
    loss, size, logs = task.build_criterion()(out, tb)
    loss.backward()
    assert size.item() == float(jsize) == 1.0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    for k in log_keys:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    got = dict(flat(state_dict_to_flax({
        n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("nat"), n_train=16)


@pytest.fixture(scope="module")
def setups(root):
    return {case: nat_setup(root, arch, task_cfg, model)
            for case, (arch, task_cfg, model) in CASES.items()}


@pytest.mark.parametrize("noise", ["random_mask", "full_mask"])
def test_noise_matches_jax_on_its_draws(monkeypatch, noise):
    rng = np.random.default_rng(4)
    tgt = rng.integers(4, 20, size=(5, 9)).astype(np.int32)
    tgt[:, 0] = 0
    for b, n in enumerate([9, 7, 4, 3, 2]):
        tgt[b, n - 1] = 2
        tgt[b, n:] = 1
    rec = JaxDraws(monkeypatch)
    jfn, tfn = {"random_mask": (jax_random_mask, random_mask),
                "full_mask": (jax_full_mask, full_mask)}[noise]
    want = np.asarray(jfn(jax.random.PRNGKey(3), jnp.asarray(tgt)))
    got = tfn(torch.from_numpy(tgt), draws=rec.handed(noise)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 0).all() and (got[tgt == 2] == 2).all()


@pytest.mark.parametrize("case", ["cmlm", "nacrf"])
def test_forward_matches_jax(setups, monkeypatch, case):
    task, _, jm, jfwd, params, tm, jbatch = setups[case]
    rec = JaxDraws(monkeypatch)
    want = jfwd(jm, params, jbatch, True)  # evaluation: JAX's noise from PRNGKey(0)
    noise = CASES[case][1]["noise"]
    with torch.no_grad():
        got = task.forward_fn()(tm, torch_batch(jbatch, rec.handed(noise)))
    np.testing.assert_array_equal(got["word_ins_mask"].numpy(), np.asarray(want["word_ins_mask"]))
    np.testing.assert_array_equal(got["length_tgt"].numpy(), np.asarray(want["length_tgt"]))
    for key in ("word_ins_logits", "length_logits", "encoder_out") + (
            ("crf_nll",) if case == "nacrf" else ()):
        assert_close(got[key].numpy(), want[key], f"{key}, 1e-5")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(setups, monkeypatch, case):
    logs = ["word_ins_loss", "length_loss", "nll_loss"] + (["crf_loss"] if case == "nacrf" else [])
    loss_and_grads_match(setups[case], monkeypatch, CASES[case][1]["noise"], logs)


def test_crf_matches_jax_on_tied_emissions():
    V, T, B = 9, 6, 3
    rng = np.random.default_rng(2)
    em = rng.normal(size=(B, T, V)).astype(np.float32)
    em[:, :, 4] = em[:, :, 2]  # tied candidates: the lower index first
    em[0, 3, :] = 0.5
    tgt = rng.integers(0, V, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[1, 4:] = False
    mask[2, :] = False  # an all-pad row contributes 0
    jcrf = JaxCRF(V, rank=3, beam=4)
    jargs = jnp.asarray(em), jnp.asarray(tgt), jnp.asarray(mask)
    params = perturb(jax.tree.map(np.asarray, jcrf.init(
        jax.random.PRNGKey(1), *jargs, method=JaxCRF.nll)["params"]))
    crf = DynamicCRF(V, rank=3, beam=4)
    crf.e1.weight.data = torch.from_numpy(params["e1"]["embedding"].copy())
    crf.e2.weight.data = torch.from_numpy(params["e2"]["embedding"].copy())
    args = torch.from_numpy(em), torch.from_numpy(tgt), torch.from_numpy(mask)
    with torch.no_grad():
        nll = crf.nll(*args)
        tokens, score = crf.viterbi(args[0], args[2])
    assert_close(nll.numpy(), jcrf.apply({"params": params}, *jargs, method="nll"), "nll, 1e-5")
    assert nll[2].item() == 0.0
    jtok, jscore = jcrf.apply({"params": params}, jargs[0], jargs[2], method="viterbi")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))
    assert_close(score.numpy(), jscore, "viterbi score, 1e-5")


def test_skeptical_unmask_breaks_ties_as_jax():
    scores = np.array([[0.5, 0.1, 0.1, 0.1, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2, 0.0, 0.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    nonpad = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    for p in (0.75, 0.5, 0.1):
        want = np.asarray(jax_skeptical(jnp.asarray(scores), jnp.asarray(nonpad),
                                        jnp.float32(p)))
        got = skeptical_unmask(torch.from_numpy(scores), torch.from_numpy(nonpad),
                               torch.tensor(p, dtype=torch.float32)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"p={p}")


@pytest.mark.parametrize("case,max_iter", [("cmlm", 4), ("nat", 1), ("nacrf", 1)])
def test_refinement_decode_tokens_match_jax(setups, case, max_iter):
    task, jtask, jm, _, params, tm, jbatch = setups[case]
    src = {k: np.asarray(jbatch[k]) for k in ("src_tokens", "src_lengths")}
    g = task.cfg.generation.__class__(iter_decode_max_iter=max_iter)
    jg = jtask.cfg.generation.__class__(iter_decode_max_iter=max_iter)
    want, wscores, _ = jtask.build_generator(jm, jg).generate(
        params, {k: jnp.asarray(v) for k, v in src.items()})
    tm.eval()
    got, scores, _ = task.build_generator(tm, g).generate(src)
    assert got.shape == (len(src["src_tokens"]), 1, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_close(scores.numpy(), wscores, "scores, 1e-5")


def is_prefix(valid):
    return bool(torch.equal(torch.arange(valid.shape[1])[None, :] < valid.sum(1, keepdim=True),
                            valid))


def lengths_only(monkeypatch):
    """Make the fused attention read only each mask's row counts, as the kernel does;
    returns the list of the masks it is given."""
    calls = []
    real = tattn.fused_attention

    def kernel_like(q, k, v, valid_mask, *args, **kw):
        calls.append(valid_mask.clone())
        prefix = torch.arange(valid_mask.shape[1])[None, :] < valid_mask.sum(1, keepdim=True)
        return real(q, k, v, prefix, *args, **kw)

    monkeypatch.setattr(tattn, "fused_attention", kernel_like)
    return calls


def test_noncausal_decoder_runs_the_fused_attention_on_valid_first_keys(setups, monkeypatch):
    _, _, jm, _, params, tm, jbatch = setups["cmlm"]
    calls = lengths_only(monkeypatch)
    tb = torch_batch(jbatch)
    prev = tb["target"].clone()
    prev[:, 1::3] = PAD  # pads inside every row, as an argmax fill can leave them
    assert not is_prefix(prev != PAD)
    enc = tm.encode(tb["src_tokens"], tb["src_lengths"])
    valid = tm.encoder_valid(enc)
    with torch.no_grad():
        got = tm.nat_decode(prev, enc["encoder_out"], valid)
    # 2 encoder layers in encode, then 2 decoder layers; the kernel reads lengths, so
    # every mask it gets is a prefix: the decoder's of each row's count of non-pads
    assert len(calls) == 4 and all(is_prefix(m) for m in calls)
    torch.testing.assert_close(calls[3].sum(1), (prev != PAD).sum(1))
    want = jm.apply({"params": params}, jnp.asarray(prev.numpy()),
                    jnp.asarray(enc["encoder_out"].detach().numpy()), jnp.asarray(valid.numpy()),
                    method="nat_decode")
    assert_close(got.numpy(), want, "decoder logits over a canvas with inner pads, 1e-5")


def plant_pad(setup, tok, scale=1.02):
    """``setup`` with the pad row of the tied decoder embedding set to ``scale`` x token
    ``tok``'s, on both sides: an argmax fill then picks pad where it would pick ``tok``
    with a positive logit, leaving pad inside a canvas."""
    task, jtask, jm, jfwd, params, tm, jbatch = setup
    params = jax.tree.map(np.copy, params)
    emb = params["decoder"]["embed_tokens"]["embedding"]
    emb[PAD] = scale * emb[tok]
    tm = load_flax_params(task.build_model(device="cpu", for_training=True), params)
    return task, jtask, jm, jfwd, params, tm, jbatch


def most_filled(tokens, least=2):
    """The token from ``least`` up that an argmax fill picks most often among ``tokens``."""
    words = tokens[tokens >= least]
    return int(np.bincount(words).argmax())


def test_mask_predict_with_a_pad_fill_matches_jax(setups, monkeypatch):
    task, jtask, jm, _, params, tm, jbatch = setups["cmlm"]
    src = {k: np.asarray(jbatch[k]) for k in ("src_tokens", "src_lengths")}
    g = task.cfg.generation.__class__(iter_decode_max_iter=3)
    tm.eval()
    tok = most_filled(task.build_generator(tm, g).generate(src)[0].numpy())
    task, jtask, jm, _, params, tm, _ = plant_pad(setups["cmlm"], tok)
    lengths_only(monkeypatch)
    canvases = []
    real = type(tm).nat_decode

    def recorded(self, prev_tokens, *a):
        canvases.append(prev_tokens.clone())
        return real(self, prev_tokens, *a)

    monkeypatch.setattr(type(tm), "nat_decode", recorded)
    tm.eval()
    got, scores, _ = task.build_generator(tm, g).generate(src)
    # round 1 filled pad inside some canvas, and round 2 decoded over it
    assert len(canvases) == 3 and not is_prefix(canvases[1] != PAD)
    want, wscores, _ = jtask.build_generator(jm, jtask.cfg.generation.__class__(
        iter_decode_max_iter=3)).generate(params, {k: jnp.asarray(v) for k, v in src.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_close(scores.numpy(), wscores, "scores, 1e-5")


@pytest.mark.parametrize("case", ["cmlm", "nacrf"])
def test_from_flax_round_trip_keeps_the_tree(setups, case):
    params, tm = setups[case][4], setups[case][5]
    got, want = dict(flat(state_dict_to_flax(tm.state_dict()))), dict(flat(params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
