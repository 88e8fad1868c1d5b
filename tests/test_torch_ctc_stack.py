"""The CTC research stack of the port's Transformer / Conformer encoder against the
JAX package on the CPU.

Tiny models (4 layers of 32, 2 heads, vocab 24, dropout 0) initialised by flax
and carried across with ``from_flax``; inputs from a numpy seed:

* ``ctc_best_alignment``: lattice states and aligned tokens equal to JAX's on
  ragged rows, repeated labels, zero-length labels and constructed ties;
* ``ctc_oracle_probs`` at ratio 1 (plain, smoothed, only_mistake) and ratio 0:
  atol 1e-6; the host draws are reproducible by seed;
* ``Adapter(..., probs=...)`` for each adapter type: atol 1e-5;
* the encoder forward for each tap setting (inter-CTC shared / unshared, the
  shared norm, each PAE type with and without ``pae_unnorm_input``, XCTC tied
  and untied, inter-XCTC with its PAE, AXCTC, compression with and without its
  norm and positions, ``layer_out_norm``, Conformer layers, the oracle at ratio
  1): ``encoder_out`` and every logits tensor within atol 1e-5, lengths equal;
* ``apply_mixup`` inside the encoder, given the draws JAX made (the ``mixup``
  dict it returns): in place, ``keep_org``, inside the stack, ratio decay,
  ``inter_mixup_prob`` < 1: outputs and lengths equal JAX's;
* ``draw_mixup``: the counts and flags of each layout, ratio decay and
  probability, reproducible by (seed, step);
* ``from_flax`` both ways over every new leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.modules import adapter as jadapter
from s2t_tpu.ops.ctc import ctc_best_alignment as jax_best_alignment
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.modules import adapter as tadapter
from s2t_tpu_torch.ops.ctc import ctc_best_alignment
from tests.test_torch_conformer import _paths, load_module, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
D, V = 32, 24
TINY = dict(vocab_size=V, encoder_layers=4, decoder_layers=1, encoder_embed_dim=D,
            decoder_embed_dim=D, encoder_ffn_embed_dim=64, decoder_ffn_embed_dim=64,
            encoder_attention_heads=2, decoder_attention_heads=2, subsampling_filter=32,
            max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
            share_decoder_input_output_embed=False)
CONFORMER = dict(encoder_attention_type="rel_pos", macaron_style=True, use_cnn_module=True,
                 cnn_module_kernel=5, activation_fn="swish")
LENGTHS = (60, 45, 31, 20)


def model_batch(seed=0, B=4, U=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, 60, 80)).astype(np.float32)
    target = rng.integers(4, V, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]
    return {"features": feats, "feat_lengths": np.array(LENGTHS[:B], np.int32),
            "prev_tokens": np.roll(target, 1, axis=1), "target": target,
            "transcript": target[:, :-1].copy(),
            "transcript_lengths": np.array([U - 1, U - 2, U - 1, U - 1][:B], np.int32)}


def jax_pair(kw, batch, seed=0):
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY, **kw))
    params = jm.init(jax.random.PRNGKey(seed), batch["features"], batch["feat_lengths"],
                     batch["prev_tokens"])["params"]
    params = jax.tree.map(np.asarray, params)
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY, **kw), device="cpu")
    return jm, params, load_flax_params(tm, params)


LOGIT_KEYS = ("ctc_logits", "xctc_logits", "axctc_logits")
TAP_KEYS = ("inter_ctc_logits", "inter_xctc_logits", "inter_axctc_logits")


def assert_encoder_matches(out, ref):
    np.testing.assert_array_equal(out["encoder_lengths"].numpy(),
                                  np.asarray(ref["encoder_lengths"]))
    np.testing.assert_allclose(out["encoder_out"].numpy(), np.asarray(ref["encoder_out"]),
                               atol=ATOL)
    for key in LOGIT_KEYS:
        assert (out[key] is None) == (ref[key] is None), key
        if ref[key] is not None:
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL,
                                       err_msg=key)
    for key in TAP_KEYS:
        assert [l for l, _ in out[key]] == [l for l, _ in ref[key]], key
        for (l, got), (_, want) in zip(out[key], ref[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                       err_msg=f"{key} @ {l}")


# --------------------------------------------------------------------------- #
def _alignment_case(kind):
    rng = np.random.default_rng(3)
    B, T, Va, U = 5, 17, 7, 5
    lp = np.log(rng.dirichlet(np.ones(Va), size=(B, T))).astype(np.float32)
    labels = rng.integers(1, Va, size=(B, U)).astype(np.int32)
    in_len = np.array([17, 12, 9, 17, 6], np.int32)
    lab_len = np.array([5, 3, 4, 2, 5], np.int32)
    if kind == "repeats":
        labels[:] = [[3, 3, 3, 5, 5], [2, 2, 4, 4, 4], [6, 6, 6, 6, 6], [1, 2, 1, 2, 1],
                     [4, 4, 1, 1, 4]]
    elif kind == "zero_length":
        lab_len[[0, 2]] = 0
    elif kind == "ties":
        # every frame uniform: each move ties, so JAX's first-maximum order decides;
        # one row with two equal halves
        lp[:3] = np.log(1.0 / Va)
        lp[3, 8:] = lp[3, :9]
    elif kind == "infeasible":
        lab_len[:] = 5
        in_len[:] = [4, 17, 9, 5, 3]  # fewer frames than the lattice needs
    return lp, labels, in_len, lab_len


@pytest.mark.parametrize("kind", ["ragged", "repeats", "zero_length", "ties", "infeasible"])
def test_best_alignment_matches_jax(kind):
    lp, labels, in_len, lab_len = _alignment_case(kind)
    want_tok, want_state = jax_best_alignment(*map(jnp.asarray, (lp, labels, in_len, lab_len)))
    got_tok, got_state = ctc_best_alignment(*map(torch.from_numpy, (lp, labels, in_len, lab_len)))
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert got_tok.dtype == torch.int32 and got_tok.shape == (5, 17)


def _logits_case(seed=4, B=4, T=12, Vo=9, U=4):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, Vo)) * 3).astype(np.float32)
    tokens = rng.integers(1, Vo, size=(B, U)).astype(np.int32)
    return logits, np.array([12, 10, 7, 3], np.int32), tokens, np.array([4, 2, 3, 0], np.int32)


@pytest.mark.parametrize("smooth,only_mistake,ratio", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 1.0), (True, True, 1.0),
    (False, False, 0.0)])
def test_oracle_probs_match_jax(smooth, only_mistake, ratio):
    logits, lens, tokens, tok_lens = _logits_case()
    want = jadapter.ctc_oracle_probs(jax.random.PRNGKey(0), jnp.asarray(logits), lens, tokens,
                                     tok_lens, ratio, temperature=0.8, smooth=smooth,
                                     only_mistake=only_mistake)
    uniform = tadapter.host_uniform(logits.shape[:2], (5, 2))
    got = tadapter.ctc_oracle_probs(torch.from_numpy(logits), torch.from_numpy(lens),
                                    torch.from_numpy(tokens), torch.from_numpy(tok_lens), uniform,
                                    ratio, temperature=0.8, smooth=smooth,
                                    only_mistake=only_mistake)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_oracle_mask_draws_are_the_hosts():
    """At a fractional ratio the oracle substitutes exactly the frames whose host
    draw is under the ratio (the same draws for the same seed), and the
    posterior keeps its gradient at the others."""
    logits, lens, tokens, tok_lens = _logits_case()
    a, b, c = (tadapter.host_uniform((4, 12), s) for s in ((1, 2, 3), (1, 2, 3), (1, 2, 4)))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.dtype == torch.float32
    args = [torch.from_numpy(v) for v in (logits, lens, tokens, tok_lens)]
    t = args[0].clone().requires_grad_()
    mixed = tadapter.ctc_oracle_probs(t, *args[1:], a, 0.5)
    every, none = (tadapter.ctc_oracle_probs(args[0], *args[1:], a, r) for r in (1.0, 0.0))
    assert torch.equal(mixed, torch.where((a < 0.5)[..., None], every, none))
    assert 0 < int((a < 0.5).sum()) < a.numel()
    (mixed * torch.randn(mixed.shape, generator=torch.Generator().manual_seed(0))).sum().backward()
    assert (t.grad[a >= 0.5].abs().sum(-1) > 0).all() and (t.grad[a < 0.5] == 0).all()


@pytest.mark.parametrize("adapter_type", tadapter.ADAPTER_TYPES)
def test_adapter_with_oracle_probs_matches_jax(adapter_type):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 11, D)).astype(np.float32)
    logits = (rng.normal(size=(4, 11, V)) * 3).astype(np.float32)
    probs = rng.dirichlet(np.ones(V), size=(4, 11)).astype(np.float32)
    jm = jadapter.Adapter(D, V, adapter_type, 0.7)
    params = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x, logits)
                                  .get("params", {})))
    want = np.asarray(jm.apply({"params": params}, x, logits, probs=jnp.asarray(probs)))
    tm = load_module(tadapter.Adapter(D, V, adapter_type, 0.7), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(logits), probs=torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# --------------------------------------------------------------------------- #
TAPS = {
    "inter_shared": dict(inter_ctc_layers=(1, 2, 4), ctc_pae="inter_league"),
    "inter_unshared": dict(inter_ctc_layers=(1, 3), share_inter_ctc=False, ctc_pae="league"),
    "inter_shared_norm": dict(inter_ctc_layers=(2,), share_inter_ctc_norm=True, ctc_pae="context"),
    **{f"pae_{t}{'_unnorm' if u else ''}": dict(inter_ctc_layers=(2,), ctc_pae=t,
                                                pae_unnorm_input=u)
       for t in ("linear", "context", "league", "inter_league", "gated_league")
       for u in (False, True)},
    "xctc": dict(use_xctc=True, inter_xctc_layers=(2,), xctc_pae="inter_league",
                 inter_ctc_layers=(1,), ctc_pae="inter_league"),
    "xctc_tied_shared_norm": dict(use_xctc=True, share_xctc_and_embed=True,
                                  inter_xctc_layers=(1, 3), share_inter_xctc_norm=True,
                                  xctc_pae="gated_league", pae_unnorm_input=True),
    "axctc": dict(use_axctc=True, inter_axctc_layers=(2, 4), use_xctc=True),
    "compression": dict(inter_ctc_layers=(2,), compression_layers=(2,),
                        compression_threshold=0.03),
    "compression_norm_pos": dict(inter_ctc_layers=(1, 3), compression_layers=(3,),
                                 compression_threshold=0.03, compression_norm=True,
                                 compression_pos=True, ctc_pae="inter_league"),
    "layer_out_norm": dict(layer_out_norm=True, layer_out_norm_interval=2,
                           inter_ctc_layers=(3,)),
    "conformer": dict(**CONFORMER, inter_ctc_layers=(2,), ctc_pae="inter_league",
                      use_xctc=True, inter_xctc_layers=(3,), xctc_pae="inter_league"),
}


@pytest.mark.parametrize("name", list(TAPS))
def test_encoder_taps_match_jax(name):
    batch = model_batch()
    jm, params, tm = jax_pair(TAPS[name], batch)
    ref = jm.apply({"params": params}, batch["features"], batch["feat_lengths"],
                   batch["prev_tokens"])
    with torch.no_grad():
        out = tm(torch.from_numpy(batch["features"]),
                 torch.from_numpy(batch["feat_lengths"]).long(),
                 torch.from_numpy(batch["prev_tokens"]))
    assert_encoder_matches(out, ref)
    np.testing.assert_allclose(out["decoder_logits"].numpy(), np.asarray(ref["decoder_logits"]),
                               atol=ATOL)
    if name.startswith("compression"):  # the threshold drops frames
        assert (out["encoder_lengths"] < torch.tensor([15, 12, 8, 5])).any()
    assert out["mixup"] is None


ORACLE = {
    "ctc_ratio_1": dict(inter_ctc_layers=(1, 3), ctc_pae="inter_league",
                        ctc_pae_ground_truth_ratio=1.0),
    "both_smooth_unnorm": dict(inter_ctc_layers=(1,), ctc_pae="league", use_xctc=True,
                               inter_xctc_layers=(2,), xctc_pae="inter_league",
                               ctc_pae_ground_truth_ratio=1.0, xctc_pae_ground_truth_ratio=1.0,
                               pae_oracle_smooth=True, pae_unnorm_input=True),
    "only_mistake": dict(use_xctc=True, inter_xctc_layers=(2, 3), xctc_pae="inter_league",
                         xctc_pae_ground_truth_ratio=1.0, xctc_pae_ground_truth_only_mistake=True),
}


@pytest.mark.parametrize("name", list(ORACLE))
def test_encoder_oracle_at_ratio_one_matches_jax(name):
    batch = model_batch(1)
    jm, params, tm = jax_pair(ORACLE[name], batch)
    tgt = np.where(batch["target"] == 2, 1, batch["target"])
    tgt_len = (tgt != 1).sum(1).astype(np.int32)
    ref = jm.apply({"params": params}, batch["features"], batch["feat_lengths"],
                   batch["prev_tokens"], deterministic=False, transcript=batch["transcript"],
                   transcript_lengths=batch["transcript_lengths"], target=tgt,
                   target_lengths=tgt_len, rngs={"dropout": jax.random.PRNGKey(3)})
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = tm(t["features"], t["feat_lengths"].long(), t["prev_tokens"], train=True,
                 generator=torch.Generator().manual_seed(0), transcript=t["transcript"],
                 transcript_lengths=t["transcript_lengths"], target=torch.from_numpy(tgt),
                 target_lengths=torch.from_numpy(tgt_len))
        plain = tm(t["features"], t["feat_lengths"].long(), t["prev_tokens"])
    assert_encoder_matches(out, ref)
    # the oracle moved the stream: the eval forward (no oracle) differs
    assert not torch.allclose(out["encoder_out"], plain["encoder_out"], atol=1e-3)


# --------------------------------------------------------------------------- #
MIXUP = {
    "in_place": dict(inter_mixup=True, inter_mixup_ratio=0.5),
    "keep_org": dict(inter_mixup=True, inter_mixup_ratio=1.0, inter_mixup_keep_org=True,
                     inter_ctc_layers=(2,), ctc_pae="inter_league"),
    "in_stack": dict(inter_mixup=True, inter_mixup_layer=2, inter_mixup_ratio=0.5,
                     inter_ctc_layers=(1, 3)),
    "decay": dict(inter_mixup=True, inter_mixup_ratio=1.0, inter_mixup_keep_org=True,
                  inter_mixup_ratio_decay=True, inter_mixup_ratio_decay_params=(0.0, 10.0, 0.0)),
    "prob": dict(inter_mixup=True, inter_mixup_ratio=0.5, inter_mixup_prob=0.5),
}


@pytest.mark.parametrize("name", list(MIXUP))
def test_apply_mixup_with_jax_draws_matches_jax(name, monkeypatch):
    batch = model_batch(2)
    jm, params, tm = jax_pair(MIXUP[name], batch)
    kw = {"num_updates": jnp.asarray(5)} if name == "decay" else {}
    for key in range(16):  # a key whose draws mix (for "prob", one whose draws do not)
        ref = jm.apply({"params": params}, batch["features"], batch["feat_lengths"],
                       batch["prev_tokens"], deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(key)}, **kw)
        if bool(np.asarray(ref["mixup"]["flag"]).any()) == (name != "prob"):
            break
    else:
        raise AssertionError("no key gave the draws this case needs")
    draws = {k: (v if k == "keep_boundary" else np.asarray(v)) for k, v in ref["mixup"].items()}
    seen = []
    monkeypatch.setattr(tst, "draw_mixup", lambda B, cfg, seed, step=None: seen.append(step)
                        or draws)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = tm(t["features"], t["feat_lengths"].long(), t["prev_tokens"], train=True,
                 generator=torch.Generator().manual_seed(0), num_updates=5 if kw else None)
    assert seen == [5 if kw else None]
    assert_encoder_matches(out, ref)
    np.testing.assert_allclose(out["decoder_logits"].numpy(), np.asarray(ref["decoder_logits"]),
                               atol=ATOL)
    for k in ("index1", "index2", "coef", "flag", "weight"):
        np.testing.assert_array_equal(out["mixup"][k].numpy(), draws[k])
    assert out["mixup"]["keep_boundary"] == int(draws["keep_boundary"])
    if name in ("keep_org", "decay"):
        assert out["encoder_out"].shape[0] == 8  # B + m rows


def test_draw_mixup_counts_flags_and_seed():
    cfg = tst.s2t_transformer_s(inter_mixup=True, inter_mixup_ratio=0.3)
    d = tst.draw_mixup(8, cfg, seed=11, step=3)
    m = 2  # int(8 * 0.3)
    assert d["keep_boundary"] == m and d["flag"].tolist() == [False] * 6 + [True] * 2
    np.testing.assert_array_equal(d["index1"][:6], np.arange(2, 8))
    assert (d["coef"][:6] == 1).all() and (d["weight"] == 1).all()
    assert ((d["coef"][6:] > 0) & (d["coef"][6:] < 1)).all()
    again, other = tst.draw_mixup(8, cfg, 11, 3), tst.draw_mixup(8, cfg, 11, 4)
    assert all(np.array_equal(d[k], again[k]) for k in ("index1", "index2", "coef"))
    assert not all(np.array_equal(d[k], other[k]) for k in ("index1", "index2", "coef"))

    keep = cfg.replace(inter_mixup_keep_org=True, inter_mixup_ratio=1.0)
    d = tst.draw_mixup(4, keep, seed=0)
    assert d["keep_boundary"] == 0 and len(d["flag"]) == 8 and d["flag"][4:].all()
    np.testing.assert_array_equal(d["index1"][:4], np.arange(4))
    np.testing.assert_array_equal(d["weight"], np.ones(8))
    decay = keep.replace(inter_mixup_ratio_decay=True,
                         inter_mixup_ratio_decay_params=(10.0, 20.0, 0.0))
    live = [int(tst.draw_mixup(4, decay, 0, s)["flag"].sum()) for s in (0, 10, 15, 20, 99)]
    assert live == [4, 4, 2, 0, 0]
    assert int(tst.draw_mixup(4, decay, 0)["flag"].sum()) == 4  # no step: no decay
    d = tst.draw_mixup(4, decay, 0, 15)
    np.testing.assert_array_equal(d["weight"], [1, 1, 1, 1, 1, 1, 0, 0])
    never = cfg.replace(inter_mixup_prob=0.0)
    d = tst.draw_mixup(8, never, 0, 0)
    assert not d["flag"].any() and (d["coef"] == 1).all()
    np.testing.assert_array_equal(d["index1"], np.r_[np.arange(2, 8), 0, 1])


def test_from_flax_maps_every_new_leaf_both_ways():
    kw = dict(inter_ctc_layers=(1, 2), share_inter_ctc=False, ctc_pae="gated_league",
              use_xctc=True, inter_xctc_layers=(3,), xctc_pae="league", use_axctc=True,
              inter_axctc_layers=(2, 4), compression_layers=(2,), compression_norm=True,
              layer_out_norm=True)
    batch = model_batch()
    _, params, tm = jax_pair(kw, batch)
    enc = params["encoder"]
    want = {"inter_ctc_head1", "inter_ctc_head2", "inter_ctc_norm1", "inter_ctc_norm2", "pae",
            "xctc_head", "inter_xctc_norm3", "xpae", "axctc_head", "inter_axctc_norm2",
            "inter_axctc_norm4", "compression_norm2",
            *(f"layer_out_norm{i}" for i in range(4))}
    assert want <= set(enc)
    back = state_dict_to_flax(tm.state_dict())
    assert _paths(back) == _paths(params)
    for (path, got), (_, ref) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                     jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(got, ref, err_msg=jax.tree_util.keystr(path))
    sd = tm.state_dict()
    assert "encoder.inter_ctc_heads.2.proj.weight" in sd
    assert "encoder.layer_out_norms.3.weight" in sd and "encoder.xpae.embed_adapter" in sd


def test_compression_layers_must_be_inter_ctc_layers():
    with pytest.raises(ValueError, match="compression_layers"):
        tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY, compression_layers=(2,)),
                                device="cpu")
