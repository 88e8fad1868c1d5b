"""The PDS encoder's stage taps, ``imputer_loss`` and Jacobi decoding in the port
against the JAX package on the CPU.

Tiny 3-stage PDS models (ratios 2/2/2, one layer a stage, width 32 or 24/32/32,
2 heads, vocab 40, one decoder layer, dropout 0) initialised by flax, perturbed
so that every leaf counts, carried across with ``from_flax``; B = 4 at T = 40
with lengths (40, 33, 21, 1):

* the forward of each tap setting (the shared inter-CTC head with the shared
  PAE, XCTC taps with the shared ``inter_xctc_head`` / ``xpae`` and a tied top
  XCTC head; normed heads at an inner ``ctc_layer`` / ``xctc_layer``; per-stage
  heads and PAEs; stages of other widths, where sharing is off, with the PAE
  from the unnormed stream and XCTC taps under fusion): ``encoder_out``,
  every logits tensor within atol 1e-5 of its largest magnitude, each tap's
  layer and stage lengths equal, the flax tree's modules equal to the port's;
* (the stage taps' loss and gradients are held to JAX's under a SATE encoder,
  tests/test_torch_ctc_aug.py)
* greedy and self-ensemble CTC tokens of ``s2t_ctc_pds`` with stage taps
  identical to JAX's;
* ``from_flax`` both ways;
* ``ctc_forward_alphas(force_emits=)`` and ``imputer_loss`` (forced on the
  Viterbi states at every other / third frame, unforced = ``ctc_loss``,
  zero-frame and infeasible rows) against JAX's, values atol 1e-4 and
  gradients atol 1e-5;
* ``ctc_greedy_draft`` equal to JAX's; ``JacobiGenerator`` tokens equal to JAX's
  (scores within 1e-5) and, at ``lenpen`` 1, to the port's own beam-1
  ``SequenceGenerator`` (scores within 1e-4), with and without a CTC head, at a
  ``min_len`` and a frame-scaled horizon, in as many passes as JAX; ``generation.jacobi`` through the task, and its fall back
  to the sequential engine under ``no_repeat_ngram_size``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.inference.jacobi import JacobiGenerator as JaxJacobi
from s2t_tpu.inference.jacobi import ctc_greedy_draft as jax_draft
from s2t_tpu.models import pds as jpds
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.ops import ctc as jops
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.inference.jacobi import JacobiGenerator, ctc_greedy_draft
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import pds as tpds
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.ops import ctc as tops
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
from tests.test_torch_conformer import _paths, flax_init, perturb, rng_batch
from tests.test_torch_ctc_aug import assert_outputs_match, batch, loss_and_grads, tensors
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

V = 40
PDS = dict(pds_stages=3, pds_ratios=(2, 2, 2), pds_layers=(1, 1, 1), pds_kernel_sizes=(5, 5, 5),
           pds_embed_dims=(32, 32, 32), pds_attn_heads=(2, 2, 2), pds_ffn_ratios=(2, 2, 2),
           pds_position_embed=(1, 1, 1), encoder_embed_dim=32, decoder_embed_dim=32,
           decoder_ffn_embed_dim=64, decoder_layers=1, decoder_attention_heads=2, vocab_size=V,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
           share_decoder_input_output_embed=False)
XTAPS = dict(pds_xctc=(0, 1, 1), xctc_pae="inter_league", use_xctc=True)
TAPS = {
    # phase 27's setting: every stage tapped, the shared head and PAE, XCTC at stages 1-2
    "shared": dict(pds_ctc=(1, 1, 1), ctc_pae="inter_league", **XTAPS),
    "inner_layers": dict(pds_ctc=(1, 1, 1), ctc_pae="inter_league", ctc_layer=2, xctc_layer=3,
                         **XTAPS),
    "unshared": dict(pds_ctc=(1, 1, 0), share_inter_ctc=False, ctc_pae="league"),
    # stages of other widths: no sharing; XCTC taps under fusion (it reads the pre-PAE
    # stream)
    "widths_fusion": dict(pds_embed_dims=(24, 32, 32), pds_ctc=(1, 0, 1), ctc_pae="context",
                          pae_unnorm_input=True, pae_embed_norm=True, pae_out_norm=True,
                          pds_xctc=(0, 1, 1), xctc_pae="gated_league", use_xctc=True,
                          pds_fusion=True),
}
MODULES = {  # flax modules each setting creates besides the stages
    "shared": {"ctc_norm0", "ctc_norm1", "ctc_norm2", "inter_ctc_head", "pae", "xctc_norm1",
               "xctc_norm2", "inter_xctc_head", "xpae"},
    "inner_layers": {"ctc_head", "xctc_head"},
    "unshared": {"ctc0", "ctc1", "pae0", "pae1", "ctc_head"},
    "widths_fusion": {"ctc0", "ctc2", "pae0", "ctc_head", "inter_xctc_head", "xpae",
                      "fusion0"},
}


@pytest.fixture(scope="module")
def pds_pairs():
    cache = {}

    def get(name, ctc=False):
        if (name, ctc) not in cache:
            kw = {**PDS, **TAPS[name]}
            b = batch()
            if ctc:
                kw = {k: v for k, v in kw.items() if not k.startswith("decoder")}
                jm = jctc.S2TCTCModel(jctc.s2t_ctc_pds(**kw))
                params = perturb(flax_init(jm, b["features"], b["feat_lengths"]))
                tm = tctc.S2TCTCModel(tctc.s2t_ctc_pds(**kw), device="cpu", for_training=True)
            else:
                jm = jpds.PDSS2TTransformerModel(jpds.pdss2t_transformer_s_16(**kw))
                params = perturb(flax_init(jm, b["features"], b["feat_lengths"],
                                           b["prev_tokens"]))
                tm = tpds.PDSS2TTransformerModel(tpds.pdss2t_transformer_s_16(**kw),
                                                 device="cpu", for_training=True)
            cache[(name, ctc)] = (jm, params, load_flax_params(tm, params))
        return cache[(name, ctc)]

    return get


@pytest.mark.parametrize("name", list(TAPS))
def test_pds_stage_taps_match_jax(pds_pairs, name):
    jm, params, tm = pds_pairs(name)
    b = batch()
    ref = jm.apply({"params": params}, b["features"], b["feat_lengths"], b["prev_tokens"])
    t = tensors(b)
    with torch.no_grad():
        out = tm(t["features"], t["feat_lengths"], t["prev_tokens"])
    assert_outputs_match(out, ref)
    enc = params["encoder"]
    assert MODULES[name] <= set(enc) and _paths(state_dict_to_flax(tm.state_dict())) == \
        _paths(params)
    taps = {"inter_ctc_logits": len(tm.cfg.ctc_stages), "inter_xctc_logits":
            len(tm.cfg.xctc_stages)}
    for key, n in taps.items():  # (global layer, logits, the stage's own lengths)
        assert len(out[key]) == n and all(len(tap) == 3 for tap in out[key])
    if name == "shared":  # the top heads are the shared inter heads: no ctc_head / xctc_head
        assert not {"ctc_head", "xctc_head", "pae2"} & set(enc) and tm.encoder.ctc_tied
        assert [tap[0] for tap in out["inter_ctc_logits"]] == [1, 2, 3]
        assert [tap[1].shape[1] for tap in out["inter_ctc_logits"]] == [20, 10, 5]
    if name == "inner_layers":  # the normed heads read layers 2 and 3
        assert set(enc["ctc_head"]) == {"norm", "proj"}
        assert out["ctc_logits"].shape[1] == 10 and out["xctc_logits"].shape[1] == 5


@pytest.mark.parametrize("self_ensemble,use_xctc", [(True, False), (False, True)])
def test_s2t_ctc_pds_tokens_identical_to_jax(pds_pairs, self_ensemble, use_xctc):
    """The stage taps are 3-tuples at coarser scales: self-ensembling averages the
    final-scale tap only (the last stage's), as in JAX."""
    jm, params, tm = pds_pairs("shared", ctc=True)
    feats, lens = rng_batch(8)
    b = {"features": feats, "feat_lengths": lens}
    jt, _, _ = JaxCTCGenerator(jm, JaxCTCDecoder(self_ensemble=self_ensemble),
                               use_xctc=use_xctc).generate(params, b)
    tt, _, _ = CTCGenerator(tm.eval(), CTCDecoder(self_ensemble=self_ensemble),
                            use_xctc=use_xctc).generate(b)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_from_flax_maps_the_stage_taps_both_ways(pds_pairs):
    for name in ("shared", "inner_layers", "unshared"):
        _, params, tm = pds_pairs(name)
        back = state_dict_to_flax(tm.state_dict())
        for (path, got), (_, ref) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                         jax.tree_util.tree_flatten_with_path(params)[0]):
            np.testing.assert_array_equal(got, ref, err_msg=jax.tree_util.keystr(path))
    sd = tm.state_dict()
    assert {"encoder.ctc_heads.1.proj.weight", "encoder.paes.0.linear_fc1.weight",
            "encoder.ctc_norms.1.weight"} <= set(sd)
    sd = pds_pairs("inner_layers")[2].state_dict()
    assert {"encoder.ctc_head.norm.weight", "encoder.inter_ctc_head.proj.weight",
            "encoder.xctc_norms.2.weight", "encoder.xpae.embed_adapter"} <= set(sd)


@pytest.mark.parametrize("kw,match", [
    (dict(pds_xctc=(1, 1, 0)), "inter_xctc_head"),  # one shared head over two widths
    (dict(pds_xctc=(0, 1, 0), use_xctc=True, pds_embed_dims=(24, 24, 32)), "XCTC"),
])
def test_unsharable_stage_taps_raise(kw, match):
    """Where flax would meet a shared head or adapter at a second width, the port
    refuses the config."""
    cfg = tpds.pdss2t_transformer_s_16(**{**PDS, "pds_embed_dims": (24, 32, 32), **kw})
    with pytest.raises(ValueError, match=match):
        tpds.PDSS2TTransformerModel(cfg, device="cpu")


# --------------------------------------------------------------------------- #
def _imputer_case(seed=3, B=5, T=16, Vo=7, U=4):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, Vo)) * 2).astype(np.float32)
    labels = rng.integers(1, Vo, size=(B, U)).astype(np.int32)
    in_len = np.array([16, 12, 9, 3, 0], np.int32)  # an infeasible and a zero-frame row
    lab_len = np.array([4, 3, 2, 4, 2], np.int32)
    lp = np.array(jax.nn.log_softmax(logits, axis=-1))  # writable, for torch.from_numpy
    _, states = jops.ctc_best_alignment(*map(jnp.asarray, (lp, labels, in_len, lab_len)))
    return lp, labels, in_len, lab_len, np.asarray(states)


@pytest.mark.parametrize("force", ["partial", "none"])
def test_imputer_loss_and_grads_match_jax(force):
    lp, labels, in_len, lab_len, states = _imputer_case()
    # the Viterbi states at every third frame (the rest free), or no state forced
    forced = {"none": np.full_like(states, -1),
              "partial": np.where(np.arange(16)[None] % 3 == 0, states, -1)}[force]

    def jax_loss(x):
        nll = jops.imputer_loss(x, labels, forced, in_len, lab_len, reduction="none")
        return nll.sum(), nll

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jnp.asarray(lp))
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    x = torch.from_numpy(lp).requires_grad_()
    got = tops.imputer_loss(x, torch.from_numpy(labels), torch.from_numpy(forced),
                            torch.from_numpy(in_len), torch.from_numpy(lab_len), reduction="none")
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-5)
    assert got[3].item() == 0 and got[4].item() == 0  # infeasible, zero frames
    free = tops.ctc_loss(torch.from_numpy(lp), torch.from_numpy(labels).long(),
                         torch.from_numpy(in_len), torch.from_numpy(lab_len), reduction="none")
    if force == "none":  # unforced, the imputer loss is the CTC loss
        np.testing.assert_allclose(got.detach().numpy(), free.numpy(), atol=1e-4)
    else:  # a constrained lattice sums fewer paths
        assert (got.detach() >= free - 1e-4).all()
    for red, want_red in (("sum", want.sum()), ("mean", (want / np.maximum(lab_len, 1)).mean())):
        np.testing.assert_allclose(
            tops.imputer_loss(torch.from_numpy(lp), torch.from_numpy(labels),
                              torch.from_numpy(forced), torch.from_numpy(in_len),
                              torch.from_numpy(lab_len), reduction=red).item(), want_red,
            rtol=1e-5)


def test_forced_alphas_match_jax():
    lp, labels, in_len, lab_len, states = _imputer_case(4)
    forced = np.where(np.arange(16)[None] % 2 == 0, states, -1)
    want, want_ext = jops.ctc_forward_alphas(jnp.asarray(lp), jnp.asarray(labels),
                                             jnp.asarray(in_len), force_emits=jnp.asarray(forced))
    got, ext = tops.ctc_forward_alphas(torch.from_numpy(lp), torch.from_numpy(labels),
                                       torch.from_numpy(in_len),
                                       force_emits=torch.from_numpy(forced))
    np.testing.assert_array_equal(ext.numpy(), np.asarray(want_ext))
    want = np.asarray(want)
    reached = want > -1e29
    np.testing.assert_array_equal(got.numpy() > -1e29, reached)
    np.testing.assert_allclose(got.numpy()[reached], want[reached], atol=1e-4)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("path,length,max_len", [
    ([0, 4, 4, 5, 0, 6], 6, 8),  # blank, repeat, blank: a b c </s>
    ([4, 5, 6, 7, 7, 7], 2, 8),  # the length cuts the row
    ([4, 0, 4, 5, 6, 7], 6, 3),  # two tokens fit before EOS
    ([5, 5, 5, 5, 5, 5], 6, 12),  # T < max_len
])
def test_ctc_greedy_draft_matches_jax(path, length, max_len):
    logits = np.full((1, 6, 8), -10.0, np.float32)
    logits[0, np.arange(6), path] = 10.0
    want = np.asarray(jax_draft(jnp.asarray(logits), jnp.asarray([length]), max_len))
    got = ctc_greedy_draft(torch.from_numpy(logits), torch.tensor([length]), max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


JACOBI = dict(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=2,
              encoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
              decoder_layers=1, decoder_attention_heads=2, vocab_size=24, subsampling_filter=32,
              dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
              max_target_positions=32)


@pytest.mark.parametrize("seed,kw,gen", [
    (0, {}, dict(max_len_b=12)),
    (1, {}, dict(max_len_b=12, lenpen=0.5)),
    (2, {"use_ctc": False}, dict(max_len_b=10)),  # cold start: EOS at 0
    (4, {}, dict(max_len_a=0.5, max_len_b=4, min_len=3)),
])
def test_jacobi_matches_jax_and_beam_1(seed, kw, gen):
    cfg = jst.S2TTransformerConfig(**JACOBI, **kw)
    jm = jst.S2TTransformerModel(cfg)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(3, 40, 80)).astype(np.float32)
    lens = np.array([40, 32, 26], np.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), feats, lens,
                                                       np.zeros((3, 4), np.int32))["params"])
    tm = load_flax_params(tst.S2TTransformerModel(tst.S2TTransformerConfig(**JACOBI, **kw),
                                                  device="cpu"), params)
    b = {"features": feats, "feat_lengths": lens}
    jac = JaxJacobi(jm, max_target_positions=32, **gen)
    jt, js, _ = jac.generate(params, b)
    port = JacobiGenerator(tm, max_target_positions=32, **gen)
    tt, ts, _ = port.generate(b)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert port.last_iters == jac.last_iters >= 1
    if gen.get("lenpen", 1.0) != 1.0:
        return  # the beam engine then ranks its finished hypotheses by a normalised score
    gt, gs, _ = SequenceGenerator(tm, beam_size=1, max_target_positions=32, **gen).generate(b)
    for row, (g, j) in enumerate(zip(gt[:, 0].tolist(), tt[:, 0].tolist())):
        g = g[:g.index(2) + 1] if 2 in g else g
        j = j[:j.index(2) + 1] if 2 in j else j
        assert g == j, (row, g, j)
    np.testing.assert_allclose(ts[:, 0].numpy(), gs[:, 0].numpy(), atol=1e-4)


def test_generation_jacobi_through_the_task(tmp_path, caplog):
    (tmp_path / "dict.txt").write_text("".join(f"w{i} 1\n" for i in range(20)))
    d = {"arch": "s2t_transformer_s", "model": JACOBI, "dataset": {"data": str(tmp_path)},
         "generation": {"jacobi": True, "max_len_b": 8}}
    task = SpeechToTextTask(from_dict(TrainConfig, d), S2TDataConfig(),
                            Dictionary.load(tmp_path / "dict.txt"))
    model = task.build_model(device="cpu")
    gen = task.build_generator(model)
    assert isinstance(gen, JacobiGenerator) and gen.eos_id == 2 and gen.pad_id == 1
    feats, lens = rng_batch(9)
    tokens, scores, _ = gen.generate({"features": feats, "feat_lengths": lens})
    assert tokens.shape[:2] == (4, 1) and torch.isfinite(scores).all()
    task.cfg.generation.no_repeat_ngram_size = 2
    with caplog.at_level(logging.WARNING, logger="s2t_tpu_torch"):
        gen = task.build_generator(model)
    assert isinstance(gen, SequenceGenerator) and gen.no_repeat_ngram_size == 2
    assert "generation.jacobi ignored" in caplog.text
