"""Four settings the JAX package takes and the port used to refuse, against JAX on the CPU.

* ``decoder_learned_pos`` under ``s2t_transformer``, PDS and SATE: the decoder adds a
  learned position table (flax ``decoder/embed_positions``) in place of the sinusoids;
* a 192-wide decoder over a 256-wide encoder under PDS and SATE: the cross-attention's
  k_proj / v_proj read the encoder's width (flax infers it).

One layer a side.  Each setting is held to JAX on forward (encoder_out, ctc_logits and
decoder_logits within 1e-5 of each tensor's largest magnitude, the port's model-level
forward tolerance: the 256-wide PDS encoder's CTC logits reach 1.18e-5 absolute), on the label-smoothed CE + CTC loss (rtol 1e-5) and every
gradient (atol 1e-5 of each leaf's largest entry), and on identical beam-5 tokens.  The
weights are the port's seeded ones, perturbed, carried to flax (no JAX init), and one
jitted JAX function gives the forward, the loss and the gradients.  ``rng_impl:
unsafe_rbg`` and ``common.user_dir`` are checked where the CLI's settings are
(tests/test_torch_hygiene.py, tests/test_torch_train_trainer.py).
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import pds as jpds
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.models import sate as jsate
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import pds as tpds
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.models import sate as tsate
from tests.test_torch_conformer import perturb, rng_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
COMMON = dict(vocab_size=32, max_target_positions=64)
S2T = dict(encoder_layers=1, decoder_layers=1, encoder_embed_dim=64, decoder_embed_dim=64,
           encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128, subsampling_filter=64,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
           share_decoder_input_output_embed=False, **COMMON)


def pds_kw(dims, dec, **kw):
    return dict(pds_stages=3, pds_ratios=(2, 1, 2), pds_layers=(1, 1, 1),
                pds_kernel_sizes=(5, 5, 5), pds_embed_dims=dims, pds_attn_heads=(4, 4, 4),
                pds_ffn_ratios=(2, 2, 2), pds_position_embed=(1, 1, 1), pds_ctc=(0, 0, 0),
                decoder_layers=1, decoder_embed_dim=dec, decoder_ffn_embed_dim=2 * dec,
                dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                share_decoder_input_output_embed=False, **COMMON, **kw)


def sate_kw(enc, dec, **kw):
    return dict(acoustic_encoder_embed_dim=enc, acoustic_encoder_ffn_embed_dim=2 * enc,
                acoustic_encoder_layers=1, acoustic_encoder_attention_heads=4,
                acoustic_decoder_embed_dim=dec, acoustic_decoder_ffn_embed_dim=2 * dec,
                acoustic_decoder_layers=1, acoustic_decoder_attention_heads=4,
                acoustic_dropout=0.0, acoustic_attention_dropout=0.0,
                acoustic_activation_dropout=0.0, acoustic_share_decoder_input_output_embed=False,
                adapter_type="league", text_encoder_layers=1, text_attention_heads=4,
                text_ffn_embed_dim=2 * enc, **COMMON, **kw)


# case -> (JAX model class, JAX preset, port model class, port preset, fields)
CASES = {
    "s2t_learned_pos": (jst.S2TTransformerModel, jst.s2t_transformer_s,
                        tst.S2TTransformerModel, tst.s2t_transformer_s,
                        dict(S2T, decoder_learned_pos=True)),
    "pds_learned_pos": (jpds.PDSS2TTransformerModel, jpds.pdss2t_transformer_s_8,
                        tpds.PDSS2TTransformerModel, tpds.pdss2t_transformer_s_8,
                        pds_kw((32, 48, 64), 64, decoder_learned_pos=True)),
    "sate_learned_pos": (jsate.S2TSATEModel, jsate.s2t_sate_s, tsate.S2TSATEModel,
                         tsate.s2t_sate_s, sate_kw(64, 64, acoustic_decoder_learned_pos=True)),
    "pds_192_over_256": (jpds.PDSS2TTransformerModel, jpds.pdss2t_transformer_s_8,
                         tpds.PDSS2TTransformerModel, tpds.pdss2t_transformer_s_8,
                         pds_kw((64, 128, 256), 192)),
    "sate_192_over_256": (jsate.S2TSATEModel, jsate.s2t_sate_s, tsate.S2TSATEModel,
                          tsate.s2t_sate_s, sate_kw(256, 192)),
}


CRITERION = ("label_smoothed_cross_entropy_with_ctc",
             {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}})
FORWARD = ("encoder_out", "ctc_logits", "decoder_logits")


def train_batch(seed=4):
    rng = np.random.default_rng(seed)
    feats, lens = rng_batch(seed)
    target = rng.integers(4, 32, size=(4, 5)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]
    return {"features": feats, "feat_lengths": lens, "prev_tokens": np.roll(target, 1, 1),
            "target": target, "ntokens": np.float32((target != 1).sum())}


@pytest.fixture(scope="module")
def pairs():
    """case -> (JAX model, flax params, port model for training, JAX's forward outputs,
    loss, sample size, logs and gradients): the port's seeded weights, perturbed, carried
    to flax, and one jitted JAX function for the forward and the gradients."""
    cache = {}

    def get(case):
        if case not in cache:
            jcls, jpreset, tcls, tpreset, kw = CASES[case]
            jm = jcls(jpreset(**kw))
            tm = tcls(tpreset(**kw), device="cpu", seed=1, for_training=True)
            params = perturb(state_dict_to_flax(tm.state_dict()))
            load_flax_params(tm, params)
            batch = train_batch()
            jcrit = jax_build_criterion(*CRITERION)
            args = (batch["features"], batch["feat_lengths"], batch["prev_tokens"])

            def jax_loss(p):
                out = jm.apply({"params": p}, *args)
                loss, size, logs = jcrit(out, batch)
                return loss, (size, logs, {k: out[k] for k in FORWARD})

            with jax.default_matmul_precision("highest"):
                (loss, (size, logs, out)), grads = jax.jit(
                    jax.value_and_grad(jax_loss, has_aux=True))(params)
            cache[case] = (jm, params, tm, batch,
                           jax.tree.map(np.asarray, (out, loss, size, logs, grads)))
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(pairs, case):
    jm, params, tm, batch, (ref, *_) = pairs(case)
    with torch.no_grad():
        out = tm(torch.from_numpy(batch["features"]),
                 torch.from_numpy(batch["feat_lengths"]).long(),
                 torch.from_numpy(batch["prev_tokens"]).long())
    for key in FORWARD:
        np.testing.assert_allclose(out[key].numpy(), ref[key],
                                   atol=ATOL * max(1.0, np.abs(ref[key]).max()), err_msg=key)
    dec = params["decoder"]
    if "learned_pos" in case:
        assert "embed_positions" in dec and tm.decoder.embed_positions is not None
    else:  # the cross-attention projects the encoder's 256 into the decoder's 192
        assert dec["layer0"]["cross_attn"]["k_proj"]["kernel"].shape == (256, 192)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(pairs, case):
    _, _, tm, batch, (_, jloss, jsize, jlogs, jgrads) = pairs(case)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tm.zero_grad()
    loss, size, logs = build_criterion(*CRITERION)(
        tm(tb["features"], tb["feat_lengths"].long(), tb["prev_tokens"].long()), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logs["ctc_loss"].item(), float(jlogs["ctc_loss"]), rtol=1e-5)
    assert size.item() == float(jsize)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jgrads))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=k)
    if "learned_pos" in case:
        assert np.abs(want["decoder/embed_positions/embedding"]).max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_beam_tokens_identical(pairs, case):
    jm, params, tm, _, _ = pairs(case)
    feats, lens = rng_batch(2)
    batch = {"features": feats, "feat_lengths": lens}
    opts = dict(beam_size=5, max_len_a=0.5, max_len_b=2)
    jt, js, _ = JaxGenerator(jm, **opts).generate(params, batch)
    tt, ts, _ = SequenceGenerator(tm, **opts).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)
