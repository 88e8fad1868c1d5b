"""wav2vec 2.0 losses and gradients against ``jax.value_and_grad`` (the tiny
model of tests/test_torch_wav2vec2.py, JAX's draws handed over):

* the ``wav2vec`` criterion's loss x sample size and every gradient at 1e-4,
  unquantized in training (masks and negatives on JAX's draws; a negative that
  is its positive is the same frame, bitwise alike in both) and quantized in
  eval (hard one-hot codes);
* ``wav2vec_ctc``: the CTC loss (K3 / K4's plain versions) and gradients in
  training, span-masked on JAX's uniforms; greedy CTC tokens identical.
"""

import jax
import numpy as np
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import wav2vec2 as jw
from s2t_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import state_dict_to_flax
from s2t_tpu_torch.models import wav2vec2 as tw
from s2t_tpu_torch.ops.ctc import ctc_greedy_decode
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import (
    CRIT, LENGTHS, assert_close, jax_pair, port_model, recorded_draws, waves)
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)


def _loss_and_grads(jm, params, tm, fwd_kw, draws, train):
    jcrit = jax_build_criterion(*CRIT)

    def jax_loss(p):
        out = jm.apply({"params": p}, waves(), LENGTHS, **fwd_kw)
        loss, size, _ = jcrit(out, {})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    out = tm(torch.from_numpy(waves()), torch.from_numpy(LENGTHS), train=train,
             generator=torch.Generator().manual_seed(0) if train else None,
             temp=fwd_kw.get("temp", 0.5), draws=draws)
    loss, size, logs = build_criterion(*CRIT)(out, {})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], k, tol=1e-4)
    return got


def test_pretraining_loss_and_grads_match_jax_in_training():
    jm, params = jax_pair(quantize_targets=False)
    tm = port_model(params, quantize_targets=False)
    kw = dict(deterministic=False, temp=2.0, rngs={"dropout": jax.random.PRNGKey(5)})
    _, draws = recorded_draws(lambda: jm.apply({"params": params}, waves(), LENGTHS, **kw))
    got = _loss_and_grads(jm, params, tm, kw, draws, train=True)
    # feature_grad_mult 0.1 reaches the extractor
    assert np.abs(got["feature_extractor/conv0/kernel"]).max() > 0


def test_pretraining_loss_and_grads_match_jax_in_eval():
    jm, params = jax_pair()
    tm = port_model(params)
    kw = dict(deterministic=True, rngs={"dropout": jax.random.PRNGKey(0)})
    _, draws = recorded_draws(lambda: jm.apply({"params": params}, waves(), LENGTHS, **kw))
    assert "gumbel_uniform" not in draws
    got = _loss_and_grads(jm, params, tm, kw, draws, train=False)
    assert np.abs(got["quantizer/vars"]).max() > 0


def test_wav2vec_ctc_loss_grads_and_tokens_match_jax():
    kw = dict(vocab_size=11, mask_prob=0.3)
    jm, params = jax_pair(jw.Wav2VecCtc, jw.Wav2VecCtcConfig, **kw)
    tm = port_model(params, tw.Wav2VecCtc, tw.Wav2VecCtcConfig, **kw)
    assert set(params) == {"w2v", "proj"} and "quantizer" not in params["w2v"]
    rngs = {"dropout": jax.random.PRNGKey(2)}
    _, draws = recorded_draws(lambda: jm.apply({"params": params}, waves(), LENGTHS,
                                               deterministic=False, rngs=rngs))
    target = np.random.default_rng(1).integers(3, 11, size=(3, 4)).astype(np.int32)
    target[:, -1] = 2
    batch = {"target": target, "ntokens": np.float32(12)}
    jcrit = jax_build_criterion("ctc", {})

    def jax_loss(p):
        out = jm.apply({"params": p}, waves(), LENGTHS, deterministic=False, rngs=rngs)
        return jcrit(out, batch)[0]

    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    out = tm(torch.from_numpy(waves()), torch.from_numpy(LENGTHS), train=True,
             generator=torch.Generator().manual_seed(0), draws=draws)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss = build_criterion("ctc", {})(out, tb)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    for k, want in flat(jax.tree.map(np.asarray, jgrads)):
        assert_close(got[k], want, k, tol=1e-4)
    # eval: greedy CTC tokens identical
    want_tok, want_len = jax.jit(lambda p: jax_greedy(
        *(lambda r: (r["ctc_logits"], r["encoder_lengths"]))(
            jm.apply({"params": p}, waves(), LENGTHS))))(params)
    with torch.no_grad():
        ev = tm(torch.from_numpy(waves()), torch.from_numpy(LENGTHS))
    tok, tlen = ctc_greedy_decode(ev["ctc_logits"], ev["encoder_lengths"])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(want_len))
