"""SATE's textual CTC research stack and CTC-Aug's cross-stream layers in the port
against the JAX package on the CPU.

Tiny SATE models (a 2-layer acoustic Transformer of 32, a 4-layer textual
encoder, one decoder layer, 2 heads, vocab 40, dropout 0) initialised by flax,
perturbed so that every leaf counts, and carried across with ``from_flax``;
B = 4 at T = 40 with lengths (40, 33, 21, 1):

* the forward of each textual setting (serial cross layers on an early
  snapshot, a snapshot after the first cross layers (``cross_attn_layer`` >=
  ``cross_attn_start_layer``: those run as plain layers and have no s2
  modules), league mode, post-norm with rel_pos plain layers, the shared and
  the per-tap inter-XCTC norm, ``xpae`` from the normed and the unnormed
  stream, a PDS acoustic encoder with its stage taps): ``encoder_out``, every
  logits tensor and tap within atol 1e-5 of the tensor's largest magnitude
  (the perturbed post-norm weights give logits of up to ~30), lengths equal,
  and the flax tree's modules equal to the port's; the post-norm case hands
  JAX's Conv2d subsampler output to the port (``SUBSAMPLE_FROM_JAX`` says
  why) and holds the port's own subsampler output to it apart;
* drop-net in league mode with JAX's draws handed over (recorded from
  ``jax.random.uniform``) at p = 1 and p = 0.5, and drop-net inert under
  serial (reproduction_ctc_aug.yaml's setting);
* the XCTC oracle at ratio 0.5 (smoothed, only_mistake) with JAX's uniform
  mask handed over;
* loss and every gradient against ``jax.value_and_grad``: label-smoothed CE +
  CTC, inter-CTC, XCTC and inter-XCTC with the oracle at ratio 1 in a training
  forward, and the ``ctc`` criterion on ``s2t_ctc_sate`` over a PDS acoustic
  encoder with stage taps: loss and each CTC term rtol 1e-5, gradients atol
  1e-5 of each leaf's largest entry;
* beam-5 tokens of ``s2t_sate`` and CTC greedy / beam-5 tokens of
  ``s2t_ctc_sate`` (its acoustic head, as the JAX task picks, and the XCTC
  head) identical to JAX's;
* ``from_flax`` both ways over every new leaf.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu.models import sate as jsate
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models import sate as tsate
from s2t_tpu_torch.models.s2t_transformer import DROPNET_STREAM
from tests.test_torch_conformer import _paths, flax_init, perturb, rng_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
D, V = 32, 40
SATE = dict(acoustic_encoder_embed_dim=D, acoustic_encoder_ffn_embed_dim=64,
            acoustic_encoder_layers=2, acoustic_encoder_attention_heads=2,
            acoustic_decoder_embed_dim=D, acoustic_decoder_ffn_embed_dim=64,
            acoustic_decoder_layers=1, acoustic_decoder_attention_heads=2,
            acoustic_subsampling_filter=32, acoustic_dropout=0.0,
            acoustic_attention_dropout=0.0, acoustic_activation_dropout=0.0,
            acoustic_share_decoder_input_output_embed=False, adapter_type="inter_league",
            text_encoder_layers=4, text_attention_heads=2, text_ffn_embed_dim=64,
            vocab_size=V, max_target_positions=64)
CROSS = dict(xctc_cross_attn=True, cross_attn_start_layer=2, cross_attn_layer=1)
VARIANTS = {
    # reproduction_ctc_aug.yaml's textual settings at 4 layers: serial cross layers 2-4 on
    # layer 1's snapshot, inter-XCTC at 3 with xpae from the unnormed stream, drop-net
    # set (inert under serial), no positions
    "serial": {**CROSS, "inter_xctc_layers": (3,), "xctc_pae": "inter_league",
               "pae_unnorm_input": True, "text_no_pos_emb": True,
               "cross_attn_league_drop_net": True, "cross_attn_league_drop_net_prob": 0.1,
               "acoustic_inter_ctc_layers": (1,), "acoustic_ctc_pae": "inter_league"},
    # the snapshot after layer 3: cross layers 2 and 3 run before it, as plain layers
    "late_snapshot": {"xctc_cross_attn": True, "cross_attn_start_layer": 2,
                      "cross_attn_layer": 3, "inter_xctc_layers": (2, 3),
                      "share_inter_xctc_norm": True, "xctc_pae": "league",
                      "text_use_xctc": True},
    "league": {"xctc_cross_attn": True, "cross_attn_start_layer": 3, "cross_attn_layer": 2,
               "cross_attn_collaboration_mode": "league", "cross_attn_league_drop_net": True,
               "cross_attn_league_drop_net_prob": 0.5, "inter_xctc_layers": (1, 3),
               "xctc_pae": "gated_league", "textual_encoder_embed_norm": True},
    # post-norm; the plain layers rel_pos, the cross layers abs with no positions
    "postnorm_rel_pos": {**CROSS, "acoustic_encoder_normalize_before": False,
                         "acoustic_decoder_normalize_before": False,
                         "text_attention_type": "rel_pos", "inter_xctc_layers": (2, 4),
                         "xctc_pae": "context", "text_use_xctc": True},
    # a PDS acoustic encoder with its stage taps under the textual XCTC taps
    "pds": {"acoustic_encoder": "pds", "pds_stages": 2, "pds_ratios": (2, 2),
            "pds_layers": (1, 1), "pds_kernel_sizes": (5, 5), "pds_embed_dims": (D, D),
            "pds_attn_heads": (2, 2), "pds_ffn_ratios": (2, 2), "pds_position_embed": (1, 1),
            "pds_ctc": (1, 1), "text_use_xctc": True,
            "inter_xctc_layers": (2,), "xctc_pae": "inter_league", **CROSS},
}
# The perturbed post-norm acoustic attention scores run to thousands, and its softmax
# amplifies the float32 rounding in which the two Conv2d subsamplers differ (6e-7 of their
# output's largest magnitude) some 20-fold: the CTC logits differ by 1.1e-5 of theirs.  A
# float64 run of the port fed JAX's float32 subsampler output agrees with JAX's logits to
# 1.2e-6, and the port's float32 run with its float64 one to 1.4e-6, so the gap is that
# rounding and not the function.  Such a case hands JAX's subsampler output to the port
# (its own output is held to JAX's apart), as the draws are handed over below.
SUBSAMPLE_FROM_JAX = {"postnorm_rel_pos"}
ORACLE = {"xctc_pae_ground_truth_ratio": 0.5, "xctc_pae_ground_truth_only_mistake": True,
          "pae_oracle_smooth": True, "adapter_temperature": 0.8}


def batch(seed=0, U=6):
    feats, lens = rng_batch(seed)
    rng = np.random.default_rng(seed + 100)
    target = rng.integers(4, V, size=(4, U)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    ctc_target = np.where(target == 2, 1, target)
    return {"features": feats, "feat_lengths": lens, "prev_tokens": prev, "target": target,
            "target_lengths": (target != 1).sum(1).astype(np.int32),
            "transcript": ctc_target[:, :-1].copy(),
            "transcript_lengths": (ctc_target[:, :-1] != 1).sum(1).astype(np.int32),
            "ctc_target": ctc_target,
            "ctc_target_lengths": (ctc_target != 1).sum(1).astype(np.int32),
            "ntokens": np.float32((target != 1).sum())}


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, perturbed flax params, port model) per config, built once a module."""
    cache = {}

    def get(name, extra=(), ctc=False):
        key = (name, tuple(sorted(dict(extra).items())), ctc)
        if key not in cache:
            kw = {**SATE, **VARIANTS.get(name, {}), **dict(extra)}
            b = batch()
            if ctc:
                kw = {k: v for k, v in kw.items() if not k.startswith("acoustic_decoder")}
                jm = jctc.S2TCTCModel(jctc.s2t_ctc_sate(**kw))
                params = perturb(flax_init(jm, b["features"], b["feat_lengths"]))
                tm = tctc.S2TCTCModel(tctc.s2t_ctc_sate(**kw), device="cpu", seed=1,
                                      for_training=True)
            else:
                jm = jsate.S2TSATEModel(jsate.s2t_sate_s(**kw))
                params = perturb(flax_init(jm, b["features"], b["feat_lengths"],
                                           b["prev_tokens"]))
                tm = tsate.S2TSATEModel(tsate.s2t_sate_s(**kw), device="cpu", seed=1,
                                        for_training=True)
            cache[key] = (jm, params, load_flax_params(tm, params))
        return cache[key]

    return get


def tensors(b):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    t["feat_lengths"] = t["feat_lengths"].long()
    return t


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=ATOL * max(1.0, np.abs(want).max()), err_msg=what)


def assert_outputs_match(out, ref, keys=("encoder_out", "ctc_logits", "xctc_logits",
                                         "decoder_logits")):
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    for key in keys:
        if key not in ref:
            continue
        assert (out[key] is None) == (ref[key] is None), key
        if ref[key] is not None:
            close(out[key], ref[key], key)
    for key in ("inter_ctc_logits", "inter_xctc_logits"):
        assert [t[0] for t in out[key]] == [t[0] for t in ref[key]], key
        for got, want in zip(out[key], ref[key]):
            close(got[1], want[1], f"{key} @ {got[0]}")
            if len(want) > 2:  # a PDS stage tap's own lengths
                np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def eval_forward(jm, params, tm, b, subsample_from_jax=False):
    args = (b["features"], b["feat_lengths"], b["prev_tokens"])
    t = tensors(b)
    if not subsample_from_jax:
        ref = jm.apply({"params": params}, *args)
        with torch.no_grad():
            return tm(t["features"], t["feat_lengths"], t["prev_tokens"]), ref
    ref, state = jm.apply({"params": params}, *args, capture_intermediates=True,
                          mutable=["intermediates"])
    want = state["intermediates"]["encoder"]["acoustic"]["subsample"]["__call__"][0][0]

    def hand_over(module, inputs, output):
        close(output[0], want, "subsample")
        return (torch.from_numpy(np.array(want)),) + tuple(output[1:])

    hook = tm.encoder.acoustic.subsample.register_forward_hook(hand_over)
    try:
        with torch.no_grad():
            return tm(t["features"], t["feat_lengths"], t["prev_tokens"]), ref
    finally:
        hook.remove()


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(VARIANTS))
def test_textual_taps_and_cross_layers_match_jax(pairs, name):
    jm, params, tm = pairs(name)
    out, ref = eval_forward(jm, params, tm, batch(), name in SUBSAMPLE_FROM_JAX)
    assert_outputs_match(out, ref)
    textual = params["encoder"]["textual"]
    assert _paths(state_dict_to_flax(tm.state_dict())) == _paths(params)
    layers = tm.encoder.textual.layers
    cross = [i for i, l in enumerate(layers) if isinstance(l, tsate.CrossStreamTextLayer)]
    with_s2 = [i for i in cross if layers[i].s2_attn is not None]
    assert with_s2 == [i for i in range(4) if "s2_attn" in textual[f"layer{i}"]]
    if name == "late_snapshot":  # cross layers 2 and 3 (1-indexed) run before the snapshot
        assert cross == [1, 2, 3] and with_s2 == [3]
        assert "inter_xctc_norm2" not in textual  # the shared final norm
    if name == "league":  # league layers have no cross_norm
        assert with_s2 == [2, 3] and "cross_norm" not in textual["layer2"]
    if name == "pds":
        assert len(out["inter_ctc_logits"]) == 2 and len(out["inter_xctc_logits"]) == 1


def test_cross_layers_run_the_fused_attention_path(pairs, monkeypatch):
    """Both attentions of a cross layer take the padding mask, so they reach the fused
    kernel's wrapper (its plain version on the CPU): one call per self-attention and
    one per s2-attention."""
    from s2t_tpu_torch.modules import attention

    jm, params, tm = pairs("serial")
    calls = []
    plain = attention.fused_attention
    monkeypatch.setattr(attention, "fused_attention",
                        lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
    t = tensors(batch())
    with torch.no_grad():
        tm.encode(t["features"], t["feat_lengths"])
    assert len(calls) == 2 + 4 + 3  # acoustic, textual self, textual s2 (layers 2-4)


def _recording_uniform(monkeypatch):
    seen = []
    uniform = jax.random.uniform

    def record(key, shape=(), *args, **kw):
        out = uniform(key, shape, *args, **kw)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "uniform", record)
    return seen


def _hand_over(monkeypatch, seen):
    """The port's drop-net and oracle draws replaced by JAX's, in call order."""
    scalars = [float(v) for v in seen if v.ndim == 0]
    masks = [v for v in seen if v.ndim == 2]
    used = {"drop": 0, "mask": 0}

    def draw(shape, seed):
        if seed[1] == DROPNET_STREAM:  # a league layer's two drop-net draws
            used["drop"] += 1
            assert tuple(shape) == (2,)
            return torch.tensor(scalars[2 * used["drop"] - 2:2 * used["drop"]])
        used["mask"] += 1
        assert tuple(shape) == masks[used["mask"] - 1].shape
        return torch.from_numpy(masks[used["mask"] - 1])

    monkeypatch.setattr(tsate, "host_uniform", draw)
    return scalars, masks, used


def train_forward(jm, params, tm, b, key, monkeypatch, oracle=False):
    """A training forward (dropout 0) of both with JAX's draws handed to the port."""
    kw = dict(target=b["ctc_target"], target_lengths=b["ctc_target_lengths"]) if oracle else {}
    with monkeypatch.context() as m:
        seen = _recording_uniform(m)
        ref = jm.apply({"params": params}, b["features"], b["feat_lengths"], b["prev_tokens"],
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(key)}, **kw)
    scalars, masks, used = _hand_over(monkeypatch, seen)
    t = tensors(b)
    tkw = {k: t[f"ctc_{k}"] for k in kw}
    with torch.no_grad():
        out = tm(t["features"], t["feat_lengths"], t["prev_tokens"], train=True,
                 generator=torch.Generator().manual_seed(0), **tkw)
    assert used == {"drop": len(scalars) // 2, "mask": len(masks)}
    return out, ref, scalars


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_league_drop_net_with_jax_draws_matches_jax(pairs, monkeypatch, prob):
    jm, params, tm = pairs("league", {"cross_attn_league_drop_net_prob": prob})
    b = batch(1)
    plain, _ = eval_forward(jm, params, tm, b)
    picks = set()
    for key in range(3):
        out, ref, scalars = train_forward(jm, params, tm, b, key, monkeypatch)
        assert len(scalars) == 4  # two draws for each of the two league layers with s2
        assert_outputs_match(out, ref)
        draws = np.array(scalars, np.float32).reshape(2, 2)
        picks |= {("keep" if d >= np.float32(prob) else "self" if f < 0.5 else "s2")
                  for d, f in draws}
        if prob == 1.0:  # every league layer drops a stream: not the eval output
            assert not torch.allclose(out["encoder_out"], plain["encoder_out"], atol=1e-3)
    assert {"self", "s2"} <= picks  # both streams were dropped at some draw


def test_drop_net_is_inert_under_serial(pairs, monkeypatch):
    """reproduction_ctc_aug.yaml sets drop-net under serial: neither package draws, and
    training (dropout 0) gives the eval forward."""
    jm, params, tm = pairs("serial")
    b = batch(2)
    out, ref, scalars = train_forward(jm, params, tm, b, 3, monkeypatch)
    plain, _ = eval_forward(jm, params, tm, b)
    assert scalars == [] and all(not l.drop_net or not l.league
                                 for l in tm.encoder.textual.layers
                                 if isinstance(l, tsate.CrossStreamTextLayer))
    assert_outputs_match(out, ref)
    torch.testing.assert_close(out["encoder_out"], plain["encoder_out"], rtol=0, atol=0)


def test_xctc_oracle_with_jax_mask_matches_jax(pairs, monkeypatch):
    jm, params, tm = pairs("serial", ORACLE)
    b = batch(3)
    out, ref, _ = train_forward(jm, params, tm, b, 5, monkeypatch, oracle=True)
    assert_outputs_match(out, ref)
    plain, _ = eval_forward(jm, params, tm, b)  # no oracle in eval
    assert not torch.allclose(out["encoder_out"], plain["encoder_out"], atol=1e-3)


# --------------------------------------------------------------------------- #
def loss_and_grads(jm, params, tm, criterion, b, train, log_keys, ctc=False):
    """The criterion's loss, its CTC terms and every gradient of the port against
    ``jax.value_and_grad``; ``train``: a training forward (dropout 0) with the
    oracle's target (its mask drawn at ratio 1, so the same on both sides)."""
    jcrit = jax_build_criterion(*criterion)
    args = (b["features"], b["feat_lengths"]) + (() if ctc else (b["prev_tokens"],))
    kw = dict(deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
              target=b["ctc_target"], target_lengths=b["ctc_target_lengths"]) if train else {}
    jbatch = {k: b[k] for k in ("target", "transcript", "transcript_lengths", "ntokens")}

    def jax_loss(p):
        loss, size, logs = jcrit(jm.apply({"params": p}, *args, **kw), jbatch)
        return loss, logs

    # compiled whole: the oracle's Viterbi scans run far faster so than eagerly, and the
    # eager op-by-op compiles of a model over a PDS encoder cost more than one jit
    with jax.default_matmul_precision("highest"):
        (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    t = tensors(b)
    targs = [t["features"], t["feat_lengths"]] + ([] if ctc else [t["prev_tokens"]])
    tkw = dict(train=True, generator=torch.Generator().manual_seed(0),
               target=t["ctc_target"], target_lengths=t["ctc_target_lengths"]) if train else {}
    tm.zero_grad()
    loss, _, logs = build_criterion(*criterion)(tm(*targs, **tkw),
                                                {k: t[k] for k in jbatch})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in log_keys:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=1e-5, err_msg=k)
    got = state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})
    assert _paths(got) == _paths(jgrads)
    for (path, g), (_, want) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                    jax.tree_util.tree_flatten_with_path(jgrads)[0]):
        np.testing.assert_allclose(g, np.asarray(want), atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))
    return got


CE_CTC = ("label_smoothed_cross_entropy_with_ctc", {  # reproduction_ctc_aug.yaml's criterion_cfg
    "label_smoothing": 0.1, "ctc": {"ctc_weight": 0.2, "inter_ctc_weight": 0.1,
                                    "xctc_weight": 0.2, "inter_xctc_weight": 0.1}})
CE_LOGS = ("ctc_loss", "inter_ctc_loss", "xctc_loss", "inter_xctc_loss")


def test_sate_ce_ctc_loss_and_grads_match_jax(pairs):
    """reproduction_ctc_aug.yaml's criterion in a training forward: the oracle at ratio 1
    (smoothed, only_mistake) feeds the XCTC PAE, the serial cross layers attend to the
    snapshot."""
    jm, params, tm = pairs("serial", {**ORACLE, "xctc_pae_ground_truth_ratio": 1.0,
                                      "text_use_xctc": True})
    got = loss_and_grads(jm, params, tm, CE_CTC, batch(4), True, CE_LOGS)
    layer = got["encoder"]["textual"]["layer3"]
    assert np.abs(layer["s2_attn"]["q_proj"]["kernel"]).max() > 0


def test_s2t_ctc_sate_over_pds_ctc_criterion_loss_and_grads_match_jax(pairs):
    """nast_pds_big.yaml's shape of model (s2t_ctc_sate over a PDS acoustic encoder, the
    textual XCTC head) with PDS stage taps, inter-XCTC taps and cross layers, under the
    ``ctc`` criterion with every tap weighted: the stage taps score with their own
    lengths."""
    jm, params, tm = pairs("pds", ctc=True)
    crit = ("ctc", {"ctc_weight": 1.0, "inter_ctc_weight": 0.5, "xctc_weight": 1.0,
                    "inter_xctc_weight": 0.5, "zero_infinity": True})
    got = loss_and_grads(jm, params, tm, crit, batch(5), False, CE_LOGS, ctc=True)
    enc = got["encoder"]
    assert np.abs(enc["textual"]["xctc_head"]["proj"]["kernel"]).max() > 0
    assert np.abs(enc["acoustic"]["inter_ctc_head"]["proj"]["kernel"]).max() > 0


# --------------------------------------------------------------------------- #
def test_ctc_aug_beam_tokens_identical_to_jax(pairs):
    jm, params, tm = pairs("serial")
    feats, lens = rng_batch(6)
    b = {"features": feats, "feat_lengths": lens}
    jt, js, _ = JaxGenerator(jm, beam_size=5, max_len_b=8).generate(params, b)
    tt, ts, _ = SequenceGenerator(tm.eval(), beam_size=5, max_len_b=8).generate(b)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_xctc,beam", [(False, 1), (True, 5)])
def test_s2t_ctc_sate_ctc_tokens_identical_to_jax(pairs, use_xctc, beam):
    """The JAX task decodes s2t_ctc_sate from the acoustic head (SATEConfig has no
    use_xctc); CTCGenerator(use_xctc=True) decodes the textual XCTC head."""
    jm, params, tm = pairs("late_snapshot", ctc=True)
    assert not hasattr(jm.cfg, "use_xctc") and not hasattr(tm.cfg, "use_xctc")
    feats, lens = rng_batch(7)
    b = {"features": feats, "feat_lengths": lens}
    jt, js, jenc = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam),
                                   use_xctc=use_xctc).generate(params, b)
    tt, ts, enc = CTCGenerator(tm.eval(), CTCDecoder(beam_size=beam),
                               use_xctc=use_xctc).generate(b)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=0)
    assert enc["ctc_logits"].shape[-1] == V


def test_from_flax_maps_every_new_leaf_both_ways(pairs):
    jm, params, tm = pairs("serial", {"text_use_xctc": True})
    textual = params["encoder"]["textual"]
    assert {"cross_attn_norm", "xctc_head", "inter_xctc_norm3", "xpae"} <= set(textual)
    assert {"attn_norm", "self_attn", "cross_norm", "s2_attn", "ffn_norm", "ffn"} == \
        set(textual["layer1"])
    back = state_dict_to_flax(tm.state_dict())
    assert _paths(back) == _paths(params)
    for (path, got), (_, ref) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                     jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(got, ref, err_msg=jax.tree_util.keystr(path))
    sd = tm.state_dict()
    assert "encoder.textual.layers.1.s2_attn.q_proj.weight" in sd
    assert "encoder.textual.inter_xctc_norms.3.weight" in sd
    assert "encoder.textual.cross_attn_norm.weight" in sd


def test_chip_smoke_carries_the_ctc_aug_recipes():
    """chip_smoke.py phases 25-27 run these recipes' sections (the card has no yaml
    package, so the script carries copies), count their CTC terms and their fused
    attention calls."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke
    from pathlib import Path

    from s2t_tpu_torch.models.pds import pdss2t_transformer_s_16

    def conf(name):
        return yaml.safe_load((Path(__file__).resolve().parent.parent / "egs" / "mustc" / "st"
                               / "conf" / name).read_text())

    aug = conf("reproduction_ctc_aug.yaml")
    assert aug["arch"] == "s2t_sate" and aug["model"] == chip_smoke.CTC_AUG_MODEL
    assert aug["criterion_cfg"] == chip_smoke.CTC_AUG_CRITERION[1]
    assert conf("basis.yaml")["criterion"] == chip_smoke.CTC_AUG_CRITERION[0]
    nast = conf("nast_pds_big.yaml")
    assert {k: nast[k] for k in ("arch", "criterion", "criterion_cfg", "model")} == \
        chip_smoke.NAST_PDS_BIG
    assert conf("ctc_aug_pds_big.yaml")["model"] == chip_smoke.CTC_AUG_PDS_BIG_MODEL
    pds = conf("pds_base_8_444.yaml")
    assert {k: pds[k] for k in ("arch", "model")} == chip_smoke.PDS_BASE_8_444
    cfg = chip_smoke.sate_cfg(chip_smoke.CTC_AUG_MODEL)
    assert chip_smoke.CTC_AUG_TERMS == 2 + len(cfg.acoustic.inter_ctc_layers) + len(
        cfg.inter_xctc_layers)
    assert chip_smoke.encoder_layers(cfg) == 10  # textual: 6 self + 4 s2 (layers 3-6)
    assert chip_smoke.encoder_layers(chip_smoke.sate_cfg(chip_smoke.CTC_AUG_PDS_BIG_MODEL)) == 30
    assert chip_smoke.encoder_layers(tctc.s2t_ctc_sate(**chip_smoke.fields(nast["model"]))) == 24
    taps = pdss2t_transformer_s_16(**{**chip_smoke.fields(pds["model"]),
                                      **chip_smoke.fields(chip_smoke.PDS_TAPS)})
    assert chip_smoke.PDS_TAPS_TERMS == 2 + len(taps.ctc_stages) + len(taps.xctc_stages)
