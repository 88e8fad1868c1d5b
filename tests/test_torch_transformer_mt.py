"""The text Transformer (``transformer`` / ``transformer_ctc``) against the JAX package.

Tiny models (2 + 2 layers of 16, 2 heads, source vocab 19, target vocab 23,
dropout 0) initialised by flax, perturbed so every leaf counts, carried across by
``from_flax``; 3 padded source rows and teacher-forced targets from a numpy seed:

* forward tensors (encoder output, CTC logits and inter-CTC taps, decoder
  logits) within 1e-5 of each tensor's largest magnitude, lengths and
  ``ctc_lengths`` equal, for post-norm with sinusoidal positions, pre-norm with
  learned positions, ``layernorm_embedding``, ``no_scale_embedding`` and the
  squeeze-excitation gate, DLCL with Shaw relative attention in the encoder and
  the decoder, rel_pos attention, and ``transformer_ctc`` with an inter tap and
  each out-downsampling method (max, mean, JAX's antialiased linear resize);
* the antialiased resize weights against ``jax.image.resize`` at 1e-5;
* the label-smoothed CE (+ 0.3 CTC for ``transformer_ctc``) loss at rtol 1e-4
  and every gradient within 1e-4 of its largest entry;
* beam-5 tokens identical over ``src_tokens`` / ``src_lengths``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import transformer as jt
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import transformer as tt
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=2,
            encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
            decoder_layers=2, decoder_attention_heads=2, dropout=0.0, vocab_size=23,
            src_vocab_size=19, max_source_positions=64, max_target_positions=64)
CTC = dict(use_ctc=True, encoder_normalize_before=True, decoder_normalize_before=True,
           inter_ctc_layers=(1,))
CASES = {
    "post_norm": {},
    "pre_norm_learned_se": dict(encoder_normalize_before=True, decoder_normalize_before=True,
                                encoder_learned_pos=True, decoder_learned_pos=True,
                                layernorm_embedding=True, no_scale_embedding=True,
                                squeeze_excitation=True, share_decoder_input_output_embed=False),
    "dlcl_relative": dict(use_enc_dlcl=True, encoder_normalize_before=True,
                          encoder_attention_type="relative", max_encoder_relative_length=3,
                          max_decoder_relative_length=2),
    "rel_pos": dict(encoder_attention_type="rel_pos", encoder_normalize_before=True),
    "ctc": CTC,
    "ctc_maxpooling": dict(CTC, ctc_out_downsampling=True),
    "ctc_avgpooling": dict(CTC, ctc_out_downsampling=True,
                           ctc_out_downsampling_method="avgpooling"),
    "ctc_linear": dict(CTC, ctc_out_downsampling=True, ctc_out_downsampling_method="interpolate"),
}
LENGTHS = np.array([7, 5, 2], np.int32)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 19, size=(3, 7)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        src[b, n - 1] = 2
        src[b, n:] = 1
    target = rng.integers(4, 23, size=(3, 5)).astype(np.int32)
    target[:, -1] = 2
    target[2, 2] = 2
    target[2, 3:] = 1
    prev = np.concatenate([np.full((3, 1), 2, np.int32), target[:, :-1]], axis=1)
    prev[2, 3:] = 1
    return src, prev, target


def make_pair(**kw):
    src, prev, _ = batch()
    jm = jt.TransformerModel(jt.TransformerMTConfig(**{**TINY, **kw}))
    params = jm.init(jax.random.PRNGKey(0), src, LENGTHS, prev)["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    tm = load_flax_params(tt.TransformerModel(tt.TransformerMTConfig(**{**TINY, **kw}),
                                              device="cpu", for_training=True), params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {}


def get_pair(pairs, case):
    if case not in pairs:
        pairs[case] = make_pair(**CASES[case])
    return pairs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(pairs, case):
    jm, params, tm = get_pair(pairs, case)
    src, prev, _ = batch()
    want = jm.apply({"params": params}, src, LENGTHS, prev)
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long())
    for key in ("encoder_lengths", "ctc_lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("encoder_out", "decoder_logits", "ctc_logits"):
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            assert_close(got[key].numpy(), want[key], f"{key}, 1e-5")
    assert [l for l, _ in got["inter_ctc_logits"]] == [l for l, _ in want["inter_ctc_logits"]]
    for (l, g), (_, w) in zip(got["inter_ctc_logits"], want["inter_ctc_logits"]):
        assert_close(g.numpy(), w, f"inter_ctc_logits @ {l}, 1e-5")
    if case.startswith("ctc"):
        r = 3
        assert got["ctc_logits"].shape[1] == r * src.shape[1]
        T_dec = src.shape[1] if "pooling" in case or "linear" in case else r * src.shape[1]
        assert got["encoder_out"].shape[1] == T_dec


@pytest.mark.parametrize("n_in", [21, 9, 30])
def test_antialiased_linear_resize_matches_jax(n_in):
    x = np.random.default_rng(n_in).normal(size=(2, n_in, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, n_in // 3, 5), method="linear")
    w = tt.antialiased_linear_weights(n_in, n_in // 3)
    got = torch.einsum("btc,ts->bsc", torch.from_numpy(x), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               err_msg="resize, atol 1e-5")


@pytest.mark.parametrize("case", ["post_norm", "pre_norm_learned_se", "ctc_linear"])
def test_loss_and_gradients_match_jax(pairs, case):
    jm, params, tm = get_pair(pairs, case)
    src, prev, target = batch(1)
    crit = (("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})
            if case.startswith("ctc") else ("label_smoothed_cross_entropy", {}))
    jcrit = jax_build_criterion(*crit)

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, src, LENGTHS, prev), {"target": target})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long(),
             train=True, generator=torch.Generator().manual_seed(0))
    loss, size, logs = build_criterion(*crit)(out, {"target": torch.from_numpy(target).long()})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    # a parameter the loss does not reach (the unweighted inter tap's norm) has no grad
    got = dict(flat(state_dict_to_flax({
        n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)
    if case.startswith("ctc"):
        assert logs["ctc_loss"].item() > 0


@pytest.mark.parametrize("case", ["post_norm", "dlcl_relative", "ctc"])
def test_beam5_tokens_match_jax(pairs, case):
    jm, params, tm = get_pair(pairs, case)
    src, _, _ = batch(2)
    kw = dict(beam_size=5, max_len_b=8, input_keys=("src_tokens", "src_lengths"))
    want, _, _ = JaxGenerator(jm, **kw).generate(
        params, {"src_tokens": jnp.asarray(src), "src_lengths": jnp.asarray(LENGTHS)})
    tm.eval()
    got, _, _ = SequenceGenerator(tm, **kw).generate({"src_tokens": src,
                                                      "src_lengths": LENGTHS})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
