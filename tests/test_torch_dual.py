"""The dual and multibranch models against the JAX package.

Tiny models (one 32-wide layer a stack, the multibranch senior branch 2) on
seeded features, flax weights carried across by ``from_flax``; the dual model
here, the multibranch one in tests/test_torch_multibranch.py:

* ``s2t_dual`` with the transcript and from the CTC hypothesis (the greedy CTC
  argmax identical), parallel and serial leagues, ``decoder_attend_speech``
  off (no second-stream parameters, as in JAX) and on; ``s2t_multibranch``
  with both collaboration directions and adapters: every output tensor within
  1e-5 of its largest magnitude;
* ``join_speech_and_text_loss``: loss x sample size and every gradient against
  ``jax.value_and_grad`` (the CE down-weighted by the CTC weight);
* the speech_to_text task's adapter hands the dual model its transcript in
  training and eval, as JAX's does;
* neither model has an incremental decoder: the beam generator raises, as
  JAX's fails on ``init_cache``.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models.build import build_model as jax_build_model
from s2t_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.ops.ctc import ctc_greedy_decode
from s2t_tpu_torch.tasks.speech_to_text import encoder_inputs
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

V = 24
DUAL = {"speech_encoder_embed_dim": 32, "speech_encoder_ffn_embed_dim": 64,
        "speech_encoder_layers": 1, "speech_encoder_attention_heads": 2,
        "speech_decoder_embed_dim": 32, "speech_decoder_ffn_embed_dim": 64,
        "speech_decoder_layers": 1, "speech_decoder_attention_heads": 2,
        "speech_subsampling_filter": 32, "speech_dropout": 0.0, "speech_attention_dropout": 0.0,
        "speech_activation_dropout": 0.0, "text_encoder_layers": 1,
        "text_encoder_ffn_embed_dim": 64, "text_dropout": 0.0}
MB = {"encoder_embed_dim": 32, "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 2,
      "junior_layers": 1, "senior_layers": 2, "textual_layers": 1, "decoder_layers": 1,
      "decoder_embed_dim": 32, "decoder_ffn_embed_dim": 64, "decoder_attention_heads": 2,
      "subsampling_filter": 32, "dropout": 0.0, "attention_dropout": 0.0,
      "activation_dropout": 0.0}
CASES = {
    "dual": ("s2t_dual_s", DUAL),
    "dual_serial_attend": ("s2t_dual_s", {**DUAL, "decoder_attend_speech": True,
                                          "encoder_collaboration_mode": "serial",
                                          "decoder_collaboration_mode": "serial"}),
    "multibranch": ("s2t_multibranch_s", MB),
    "multibranch_textual": ("s2t_multibranch_s", {**MB, "collaboration_direction": "textual"}),
    "multibranch_acoustic": ("s2t_multibranch_s", {
        **MB, "encoder_collaboration_mode": "serial", "collaboration_direction": "acoustic",
        "acoustic_adapter": "inter_league", "textual_adapter": "league"}),
}


def batch(seed=0, B=3, U=6):
    rng = np.random.default_rng(seed)
    target = rng.integers(4, V, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    target[2, 4:] = 1
    target[2, 3] = 2
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    transcript = target[:, :-1].copy()
    transcript[transcript == 2] = 1
    return {"features": rng.normal(size=(B, 40, 80)).astype(np.float32),
            "feat_lengths": np.array([40, 31, 17], np.int32)[:B], "prev_tokens": prev,
            "target": target, "transcript": transcript,
            "transcript_lengths": (transcript != 1).sum(1).astype(np.int32),
            "ntokens": np.float32((target != 1).sum())}


def pair(case):
    arch, ov = CASES[case]
    jm = jax_build_model(arch, ov, vocab_size=V)
    b = batch()
    kw = ({"transcript": b["transcript"], "transcript_lengths": b["transcript_lengths"]}
          if arch == "s2t_dual_s" else {})
    params = jax.jit(lambda k: jm.init(k, b["features"], b["feat_lengths"], b["prev_tokens"],
                                       **kw))(jax.random.PRNGKey(0))["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    return arch, ov, jm, params, kw


def tensors(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def check_forward(case):
    arch, ov, jm, params, kw = pair(case)
    tm = load_flax_params(build_model(arch, ov, device="cpu", vocab_size=V), params)
    b, tb = batch(), tensors(batch())
    dec0 = params["decoder"]["layer0"]
    assert ("s2_cross_attn" in dec0) == (case != "dual")
    for inputs in ([kw, {}] if kw else [{}]):  # the transcript, then the CTC hypothesis
        ref = jax.jit(lambda p: jm.apply({"params": p}, b["features"], b["feat_lengths"],
                                         b["prev_tokens"], **inputs))(params)
        with torch.no_grad():
            out = tm(tb["features"], tb["feat_lengths"].long(), tb["prev_tokens"].long(),
                     **{k: tb[k].long() for k in inputs})
        keys = ("encoder_out", "ctc_logits", "decoder_logits",
                "text_encoder_out" if arch == "s2t_dual_s" else "s2_encoder_out")
        for key in keys:
            assert_close(out[key].numpy(), ref[key], f"{key} {bool(inputs)}")
    want_tok, _ = jax_greedy(ref["ctc_logits"], ref["encoder_lengths"])
    got_tok, _ = ctc_greedy_decode(out["ctc_logits"], out["encoder_lengths"])
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    with pytest.raises(AttributeError, match="incremental decoder"):
        SequenceGenerator(tm, beam_size=2, max_len_b=4).generate(
            {"features": b["features"], "feat_lengths": b["feat_lengths"]})


def check_join_loss(case):
    arch, ov, jm, params, kw = pair(case)
    b = batch(seed=1)
    crit = ("join_speech_and_text_loss", {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}})
    jcrit = jax_build_criterion(*crit)
    inputs = ({"transcript": b["transcript"], "transcript_lengths": b["transcript_lengths"]}
              if kw else {})

    def jax_loss(p):
        out = jm.apply({"params": p}, b["features"], b["feat_lengths"], b["prev_tokens"],
                       **inputs)
        loss, size, logs = jcrit(out, b)
        return loss, (size, logs["ce_loss"])

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jce)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)
    tm = load_flax_params(build_model(arch, ov, device="cpu", vocab_size=V, for_training=True),
                          params)
    tb = tensors(b)
    out = tm(tb["features"], tb["feat_lengths"].long(), tb["prev_tokens"].long(),
             **encoder_inputs(tm.cfg, tb, train=False))
    loss, size, logs = build_criterion(*crit)(out, tb)
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logs["trans_loss"].item(), 0.7 * float(jce), rtol=1e-5)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], k, tol=1e-4)


@pytest.mark.parametrize("case", ["dual", "dual_serial_attend"])
def test_forward_matches_jax(case):
    check_forward(case)


def test_join_loss_and_grads_match_jax():
    check_join_loss("dual")
