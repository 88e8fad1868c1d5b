"""The streaming Emformer against the JAX package.

A tiny model (2 layers of 32, 2 heads, segments of 4 frames with 4 left and 2
lookahead frames and 3 memory slots, vocab 16, dropout 0; as
tests/test_streaming.py builds it) initialised by flax, perturbed, carried
across by ``from_flax``:

* the offline forward (encoder output, CTC logits, lengths) within 1e-5 of each
  tensor's largest magnitude, plain and with ``memory_tanh`` and
  ``attention_std_scale`` (the attention suppression of modules/attention.py,
  also held alone against JAX's);
* streaming = offline: the subsampled frames fed segment by segment through
  ``_process_segment`` with the carried state give the offline CTC logits
  (2e-4, as tests/test_streaming.py), and two ``streaming_step`` calls on raw
  features equal JAX's (logits, and every state tensor within 1e-5 of its layer's
  largest left-context magnitude);
* the CTC loss x sample size at rtol 1e-4 and every gradient within 1e-4 of its
  largest entry;
* greedy CTC tokens identical through ``CTCGenerator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import streaming as js
from s2t_tpu.modules.attention import attention_suppression as jax_suppression
from s2t_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import streaming as ts
from s2t_tpu_torch.modules.attention import attention_suppression
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
            encoder_attention_heads=2, subsampling_filter=32, segment_size=4, left_context=4,
            right_context=2, max_memory_size=3, vocab_size=16, dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0)
KNOBS = dict(memory_tanh=True, attention_std_scale=0.5)
LENGTHS = np.array([96, 64], np.int32)


def feats(seed=0, T=96):
    return np.random.default_rng(seed).normal(size=(2, T, 80)).astype(np.float32)


def make_pair(**kw):
    jm = js.EmformerModel(js.EmformerConfig(**{**TINY, **kw}))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats(), LENGTHS)["params"]
    params = perturb(jax.tree.map(np.asarray, params), seed=3)
    tm = load_flax_params(ts.EmformerModel(ts.EmformerConfig(**{**TINY, **kw}), device="cpu",
                                           for_training=True), params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {"plain": make_pair(), "knobs": make_pair(**KNOBS)}


def test_attention_suppression_matches_jax():
    s = np.random.default_rng(1).normal(size=(2, 3, 5, 9)).astype(np.float32) * 3
    s[..., -2:] = -1e9
    for scale in (0.5, 1.0):
        want = jax_suppression(jnp.asarray(s), scale)
        got = attention_suppression(torch.from_numpy(s), scale)
        np.testing.assert_array_equal(got.numpy() == -1e9, np.asarray(want) == -1e9)
        assert_close(got.numpy(), want, "suppressed scores, 1e-5")


@pytest.mark.parametrize("case", ["plain", "knobs"])
def test_offline_forward_matches_jax(pairs, case):
    jm, params, tm = pairs[case]
    want = jm.apply({"params": params}, feats(), LENGTHS)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats()), torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(got["encoder_lengths"].numpy(),
                                  np.asarray(want["encoder_lengths"]))
    for key in ("encoder_out", "ctc_logits"):
        assert_close(got[key].numpy(), want[key], f"{key}, 1e-5")


@pytest.mark.parametrize("case", ["plain", "knobs"])
def test_streaming_equals_offline_and_step_matches_jax(pairs, case):
    jm, params, tm = pairs[case]
    cfg = tm.cfg
    S, R = cfg.segment_size, cfg.right_context
    x = feats(1, 93)[:1]  # 93 frames -> 24 subsampled = 6 segments of 4
    lens = torch.tensor([93])
    with torch.no_grad():
        off = tm(torch.from_numpy(x), lens)["ctc_logits"]
        sub, out_lens = tm._subsample(torch.from_numpy(x), lens)
        T = int(out_lens[0])
        subp = torch.nn.functional.pad(sub, (0, 0, 0, S + R))
        states, outs = tm.init_stream_state(1), []
        for i in range(T // S):
            seg_valid = (torch.arange(S + R)[None, :] + i * S) < T
            y, states = tm._process_segment(subp[:, i * S:i * S + S + R], seg_valid, states)
            outs.append(y[:, :S])
        stream = tm.ctc_head(tm.final_norm(torch.cat(outs, dim=1)))
    np.testing.assert_allclose(stream.numpy(), off[:, :T // S * S].numpy(), atol=2e-4,
                               err_msg="streaming vs offline, atol 2e-4")
    # two raw-feature segments through streaming_step, the second from the carried state
    seg = feats(2, 4 * (S + R))[:1]
    jstate = jm.apply({"params": params}, 1, method=js.EmformerModel.init_stream_state)
    want, wstates = jm.apply({"params": params}, seg, jstate,
                             method=js.EmformerModel.streaming_step)
    want, wstates = jm.apply({"params": params}, seg * 0.5, wstates,
                             method=js.EmformerModel.streaming_step)
    with torch.no_grad():
        got, gstates = tm.streaming_step(torch.from_numpy(seg), tm.init_stream_state(1))
        got, gstates = tm.streaming_step(torch.from_numpy(seg * 0.5), gstates)
    assert_close(got.numpy(), want, "streaming_step logits, 1e-5")
    for g, w in zip(gstates, wstates):
        # 1e-5 of the layer's stream: a memory slot is tanh of a mean of output frames
        scale = max(1.0, float(np.abs(np.asarray(w["left"])).max()))
        for key in w:
            np.testing.assert_allclose(g[key].float().numpy(), np.asarray(w[key], np.float32),
                                       atol=1e-5 * scale, err_msg=f"state {key}, 1e-5")


@pytest.mark.parametrize("case", ["plain", "knobs"])
def test_ctc_loss_gradients_and_greedy_tokens_match_jax(pairs, case):
    jm, params, tm = pairs[case]
    rng = np.random.default_rng(4)
    target = rng.integers(3, 16, size=(2, 6)).astype(np.int32)
    target[:, -1] = 2
    target[1, 4] = 2
    target[1, 5] = 1
    jcrit = jax_build_criterion("ctc", {})

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, feats(3), LENGTHS), {"target": target})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(feats(3)), torch.from_numpy(LENGTHS), train=True,
             generator=torch.Generator().manual_seed(0))
    loss, size, _ = build_criterion("ctc", {})(out, {"target": torch.from_numpy(target).long()})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)
    # greedy tokens
    ref = jm.apply({"params": params}, feats(5), LENGTHS)
    jtok, _ = jax_greedy(ref["ctc_logits"], ref["encoder_lengths"])
    tm.eval()
    tok, _, _ = CTCGenerator(tm, CTCDecoder()).generate({"features": feats(5),
                                                         "feat_lengths": LENGTHS})
    np.testing.assert_array_equal(tok[:, 0].numpy(), np.asarray(jtok))
