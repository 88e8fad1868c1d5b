"""Every branch of the port's CTC criterion against the JAX criterion on the CPU.

The criteria take seeded model outputs (the final CTC, XCTC and AXCTC logits,
their inter taps, the decoder logits, ragged encoder lengths) and a batch with
a target (EOS and pad), a transcript, an MLO level ``transcript2`` and an
``aligned_target``; under mixup the ``mixup`` dict is the one a JAX encoder
drew (in place, B = 4; ``keep_org``, B + m = 6).  Each case holds the loss
(rtol 1e-5), every log and the gradient of every logits tensor (atol 1e-5 of
its largest entry) to ``jax.value_and_grad`` of the JAX criterion:

* each ``CTCCriterion`` branch alone (CTC, inter-CTC, MLO levels, XCTC,
  inter-XCTC, AXCTC and inter-AXCTC, the AXCTC fallback to the XCTC logits,
  entropy, self-distillation, CTC under both mixup layouts, both mixup
  consistencies) and the recipes' combinations (reproduction_nast,
  reproduction_bil_ctc, reproduction_purectc_aipa_kd, reproduction_aipa_kd);
* ``LabelSmoothedCEWithCTC`` and ``LabelSmoothedCE`` with mixup, with
  ``cal_mixup_loss`` off and with the decoder's mixup consistency;
* the inter-tap lengths quirk: under ``compression_layers`` the tap at the
  compression layer is scored with the final (compressed) lengths, in JAX and
  in the port alike (through the model, loss and every parameter gradient).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s2t_tpu.criterions.ctc as jax_ctc_criterion
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.models import s2t_ctc as tctc
from tests.test_torch_conformer import loss_and_grads_match
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

B, T, U, V, VT = 4, 14, 6, 11, 13
LENGTHS = np.array([14, 11, 9, 6], np.int32)
INTER, INTER_X, INTER_AX = (2, 3), (2,), (1, 3)


@functools.lru_cache(maxsize=None)
def jitted_jax_ctc_loss():
    """JAX's CTC loss under one ``jax.jit`` for the whole test process."""
    return jax.jit(jax_ctc_criterion.ctc_loss, static_argnames=(
        "blank_id", "reduction", "zero_infinity", "normalized"))


@pytest.fixture(scope="module", autouse=True)
def shared_jax_ctc_loss():
    """The JAX CTC criterion calls ``jitted_jax_ctc_loss`` in this module (and in each
    module that imports this fixture): a lattice of one shape is traced and compiled
    once, and every later call of that shape, in any case, reuses it (an eager call
    traces and compiles its own scan).  The function and its numbers are JAX's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ctc_criterion, "ctc_loss", jitted_jax_ctc_loss())
        yield


@pytest.fixture(scope="module")
def mixups():
    """The mixup dicts a tiny JAX encoder draws: in place (m = 2 of 4) and keep_org
    (m = 2 appended)."""
    out = {}
    feats = np.random.default_rng(0).normal(size=(B, 40, 80)).astype(np.float32)
    lens = np.array([40, 33, 21, 17], np.int32)
    for name, kw in (("in_place", {}), ("keep_org", {"inter_mixup_keep_org": True})):
        cfg = jst.s2t_transformer_s(encoder_layers=1, decoder_layers=0, encoder_embed_dim=16,
                                    encoder_ffn_embed_dim=16, encoder_attention_heads=2,
                                    subsampling_filter=16, vocab_size=V, dropout=0.0,
                                    attention_dropout=0.0, activation_dropout=0.0,
                                    inter_mixup=True, inter_mixup_ratio=0.5, **kw)
        enc = jst.S2TTransformerEncoder(cfg)
        params = enc.init(jax.random.PRNGKey(0), feats, lens)
        for key in range(16):
            mix = enc.apply(params, feats, lens, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(key)})["mixup"]
            if np.asarray(mix["flag"]).sum() == 2:  # both mixed rows live
                break
        out[name] = {k: (v if k == "keep_boundary" else np.asarray(v)) for k, v in mix.items()}
    return out


def make_case(seed, mixup=None):
    """(logits leaves, fixed model-output entries, batch), all numpy."""
    rng = np.random.default_rng(seed)
    rows = B if mixup is None else len(mixup["index1"])

    def logits(vocab, scale=2.0):
        return (rng.normal(size=(rows, T, vocab)) * scale).astype(np.float32)

    leaves = {"ctc": logits(V), "inter": [logits(V) for _ in INTER], "xctc": logits(VT),
              "inter_x": [logits(VT) for _ in INTER_X], "axctc": logits(VT),
              "inter_ax": [logits(VT) for _ in INTER_AX],
              "decoder": (rng.normal(size=(rows, U, VT)) * 2).astype(np.float32)}
    lengths = LENGTHS
    if mixup is not None:
        i1, i2 = mixup["index1"], mixup["index2"]
        lengths = np.where(mixup["flag"], np.maximum(LENGTHS[i1], LENGTHS[i2]), LENGTHS[i1])
    target = rng.integers(4, VT, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    target[1, -3:] = [2, 1, 1]
    transcript = rng.integers(3, V, size=(B, 5)).astype(np.int32)
    transcript_lengths = np.array([5, 3, 4, 0], np.int32)
    transcript[np.arange(5)[None, :] >= transcript_lengths[:, None]] = 1
    aligned = rng.integers(4, VT, size=(B, 5)).astype(np.int32)
    aligned[:, -1] = 2
    aligned[2, -2:] = [2, 1]
    batch = {"target": target, "transcript": transcript, "transcript_lengths": transcript_lengths,
             "transcript2": transcript[:, :3].copy(),
             "transcript2_lengths": np.minimum(transcript_lengths, 3).astype(np.int32),
             "aligned_target": aligned, "ntokens": np.float32((target != 1).sum())}
    return leaves, {"encoder_lengths": lengths.astype(np.int32), "mixup": mixup}, batch


def model_out(leaves, fixed, heads):
    """The model-output dict of ``leaves`` with the heads a case has."""
    out = {"encoder_lengths": fixed["encoder_lengths"], "mixup": fixed["mixup"],
           "decoder_logits": leaves["decoder"], "ctc_logits": leaves["ctc"],
           "inter_ctc_logits": tuple(zip(INTER, leaves["inter"])),
           "xctc_logits": None, "inter_xctc_logits": (), "axctc_logits": None,
           "inter_axctc_logits": ()}
    if "xctc" in heads:
        out["xctc_logits"] = leaves["xctc"]
        out["inter_xctc_logits"] = tuple(zip(INTER_X, leaves["inter_x"]))
    if "axctc" in heads:
        out["axctc_logits"] = leaves["axctc"]
        out["inter_axctc_logits"] = tuple(zip(INTER_AX, leaves["inter_ax"]))
    return out


def check_against_jax(criterion, seed, heads=("xctc", "axctc"), mixup=None):
    leaves, fixed, batch = make_case(seed, mixup)
    jcrit = jax_build_criterion(*criterion)
    jfixed = {**fixed, "mixup": None if mixup is None else {
        k: (v if k == "keep_boundary" else jnp.asarray(v)) for k, v in mixup.items()}}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(lv):
        loss, size, logs = jcrit(model_out(lv, jfixed, heads), jbatch)
        return loss, (size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
            jax.tree.map(jnp.asarray, leaves))
    tleaves = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), leaves)
    tfixed = {"encoder_lengths": torch.from_numpy(fixed["encoder_lengths"]), "mixup": None}
    if mixup is not None:
        tfixed["mixup"] = {k: (v if k == "keep_boundary" else torch.from_numpy(np.array(v)))
                           for k, v in mixup.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, size, logs = build_criterion(*criterion)(model_out(tleaves, tfixed, heads), tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(size) == float(jsize)
    assert set(logs) == set(jlogs)
    for key in jlogs:
        np.testing.assert_allclose(float(logs[key].detach()), float(jlogs[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for (path, want), (_, leaf) in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                                       jax.tree_util.tree_flatten_with_path(tleaves)[0]):
        got = np.zeros(want.shape, np.float32) if leaf.grad is None else leaf.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(want),
                                   atol=1e-5 * max(1.0, np.abs(np.asarray(want)).max()),
                                   err_msg=jax.tree_util.keystr(path))
    return float(jloss), jlogs


BRANCHES = {
    "ctc": {"ctc_weight": 1.0},
    "inter": {"ctc_weight": 0.0, "inter_ctc_weight": 0.5},
    "inter_mlo": {"ctc_weight": 0.0, "inter_ctc_weight": 1.0, "inter_ctc_mlo": (2, 1)},
    "xctc": {"ctc_weight": 0.0, "xctc_weight": 1.0},
    "inter_xctc": {"ctc_weight": 0.0, "inter_xctc_weight": 0.7},
    "axctc": {"ctc_weight": 0.0, "axctc_weight": 1.0, "inter_axctc_weight": 0.5},
    "entropy": {"ctc_weight": 0.0, "ctc_entropy_weight": 0.2},
    "self_distill": {"ctc_weight": 0.0, "ctc_self_distill_weight": 0.7,
                     "ctc_self_distill_temperature": 2.0},
    "nast": {"ctc_weight": 1.0, "inter_ctc_weight": 0.5, "xctc_weight": 1.0},
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_ctc_branch_matches_jax(name):
    _, logs = check_against_jax(("ctc", BRANCHES[name]), seed=len(name))
    assert {"inter_ctc_loss", "xctc_loss", "inter_xctc_loss", "axctc_loss", "ctc_entropy",
            "ctc_self_distill_loss", "ctc_loss"} & set(logs)


def test_axctc_falls_back_to_the_xctc_logits():
    _, logs = check_against_jax(("ctc", BRANCHES["axctc"]), seed=5, heads=("xctc",))
    assert {"axctc_loss", "inter_axctc_loss"} <= set(logs)


MIXUP_BRANCHES = {
    "ctc_in_place": ({"ctc_weight": 1.0, "inter_ctc_weight": 0.5, "xctc_weight": 1.0,
                      "axctc_weight": 0.3}, "in_place"),
    "ctc_keep_org": ({"ctc_weight": 1.0, "inter_xctc_weight": 0.5}, "keep_org"),
    "consistent_in_place": ({"ctc_weight": 0.0, "ctc_mixup_consistent_weight": 0.5,
                             "inter_ctc_mixup_consistent_weight": 0.3}, "in_place"),
    "consistent_keep_org": ({"ctc_weight": 0.0, "ctc_mixup_consistent_weight": 0.5,
                             "inter_ctc_mixup_consistent_weight": 0.3}, "keep_org"),
    # egs/librispeech/asr/conf/reproduction_purectc_aipa_kd.yaml
    "purectc_aipa_kd": ({"ctc_weight": 1.0, "inter_ctc_weight": 1.0, "zero_infinity": True,
                         "ctc_mixup_consistent_weight": 0.15,
                         "inter_ctc_mixup_consistent_weight": 0.1}, "keep_org"),
}


@pytest.mark.parametrize("name", list(MIXUP_BRANCHES))
def test_ctc_branch_under_mixup_matches_jax(name, mixups):
    weights, layout = MIXUP_BRANCHES[name]
    check_against_jax(("ctc", weights), seed=3, mixup=mixups[layout])


CE = "label_smoothed_cross_entropy_with_ctc"
CE_CASES = {
    # egs/mustc/st/conf/reproduction_bil_ctc.yaml
    "bil_ctc": ((CE, {"label_smoothing": 0.1, "ctc": {
        "ctc_weight": 0.3, "inter_ctc_weight": 0.2, "xctc_weight": 0.3,
        "inter_xctc_weight": 0.2}}), None),
    # egs/mustc/st/conf/reproduction_aipa_kd.yaml
    "aipa_kd": ((CE, {"label_smoothing": 0.1, "cal_mixup_loss": True,
                      "mixup_consistent_weight": 0.5, "ctc": {
                          "ctc_weight": 0.3, "inter_ctc_weight": 0.2,
                          "ctc_mixup_consistent_weight": 0.15,
                          "inter_ctc_mixup_consistent_weight": 0.1}}), "keep_org"),
    "no_cal_mixup_loss": ((CE, {"cal_mixup_loss": False, "ctc": {"ctc_weight": 0.3}}),
                          "in_place"),
    "decoder_consistent_in_place": ((CE, {"mixup_consistent_weight": 0.4,
                                          "ctc": {"ctc_weight": 0.0}}), "in_place"),
    "plain_ce_mixup": (("label_smoothed_cross_entropy", {"label_smoothing": 0.1}), "in_place"),
}


@pytest.mark.parametrize("name", list(CE_CASES))
def test_label_smoothed_ce_with_mixup_matches_jax(name, mixups):
    criterion, layout = CE_CASES[name]
    check_against_jax(criterion, seed=8, heads=("xctc",),
                      mixup=None if layout is None else mixups[layout])


def test_inter_tap_lengths_quirk_under_compression_matches_jax():
    """The tap at the compression layer is appended before the frames are dropped,
    and the criterion scores it with the final, compressed lengths (no lengths of
    its own), in JAX and in the port."""
    kw = dict(vocab_size=V, encoder_layers=3, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
              encoder_attention_heads=2, subsampling_filter=32, dropout=0.0,
              attention_dropout=0.0, activation_dropout=0.0, inter_ctc_layers=(1, 2),
              compression_layers=(2,), compression_threshold=0.1)
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(B, 60, 80)).astype(np.float32)
    lens = np.array([60, 45, 31, 20], np.int32)
    target = rng.integers(4, V, size=(B, 4)).astype(np.int32)
    target[:, -1] = 2
    batch = {"features": feats, "feat_lengths": lens, "target": target,
             "ntokens": np.float32(B * 4)}
    jm = jctc.S2TCTCModel(jctc.s2t_ctc_base(**kw))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), feats, lens)["params"])
    out = jm.apply({"params": params}, feats, lens)
    full = (lens - 1) // 2 // 2 + 1  # the subsampled lengths, before compression
    assert (np.asarray(out["encoder_lengths"]) < full).any()
    assert out["inter_ctc_logits"][1][0] == 2  # the tap at the compression layer
    tm = tctc.S2TCTCModel(tctc.s2t_ctc_base(**kw), device="cpu", for_training=True)
    loss_and_grads_match(jm, params, tm, ("ctc", {"ctc_weight": 1.0, "inter_ctc_weight": 0.5}),
                         batch, (feats, lens))
