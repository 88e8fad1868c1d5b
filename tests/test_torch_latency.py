"""The latency metrics, the latency-augmented CE and the composite / model criteria
of the port against the JAX package (s2t_tpu/criterions/latency.py, composite.py).

* every metric (expected delays with and without ``stay_on_last_token``, AP, AL,
  DAL, VarianceDelay) and ``latency_training_loss`` for each ``average_method`` and
  each average type, on seeded delays and attention: within 1e-6;
* the criterion on a tiny ``s2t_transformer`` and a tiny text ``transformer``
  (flax-initialised, carried across by ``from_flax``, dropout 0): the captured
  (B, H·L, U, S) cross-attention against JAX's stacked sown intermediates at 1e-6,
  the loss and ``latency_loss`` at rtol 1e-5 and every gradient within 1e-5 of its
  largest entry;
* ``composite_loss`` and ``model`` against JAX's on the same synthetic outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions import latency as jl
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.models import transformer as jt
from s2t_tpu_torch.criterions import latency as tl
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.models import transformer as tt
from tests.test_torch_train_criterion import TINY, flat, make_batch
from tests.test_torch_transformer_mt import TINY as MT_TINY, batch as mt_batch, LENGTHS
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

LATENCY = "latency_augmented_label_smoothed_cross_entropy"


def case(seed=0, B=3, HL=4, U=7, S=11):
    rng = np.random.default_rng(seed)
    attn = rng.random((B, HL, U, S)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    attn[:, :, :, -1] *= 0.5  # rows short of 1, for the mass-preservation branch
    tgt_mask = np.arange(U)[None] < np.array([U, U - 2, U - 4])[:, None]
    src_lens = np.array([S, 8, 5], np.float32)
    return attn, src_lens, tgt_mask


def close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("stay", [True, False])
def test_metrics_match_jax(stay):
    attn, src_lens, tgt_mask = case()
    jd, jsl = jl.expected_delays_from_attention(jnp.asarray(attn), jnp.asarray(src_lens),
                                                jnp.asarray(tgt_mask), stay)
    td, tsl = tl.expected_delays_from_attention(torch.from_numpy(attn),
                                                torch.from_numpy(src_lens),
                                                torch.from_numpy(tgt_mask), stay)
    close(td, jd)
    close(tsl, jsl)
    d, jdm = td.mean(1), jd.mean(1)
    for name in ("average_proportion", "average_lagging", "differentiable_average_lagging"):
        close(getattr(tl, name)(d, tsl, torch.from_numpy(tgt_mask)),
              getattr(jl, name)(jdm, jsl, jnp.asarray(tgt_mask)))
    close(tl.variance_delay(td, tsl, torch.from_numpy(tgt_mask)),
          jl.variance_delay(jd, jsl, jnp.asarray(tgt_mask)))
    # delays that cross the source end and come back (AL's cumulative cut)
    wild = torch.tensor([[2.0, 9.0, 3.0, 12.0, 1.0]])
    mask, sl = torch.ones((1, 5), dtype=torch.bool), torch.tensor([8.0])
    close(tl.average_lagging(wild, sl, mask),
          jl.average_lagging(jnp.asarray(wild.numpy()), jnp.asarray([8.0]), jnp.ones((1, 5), bool)))


@pytest.mark.parametrize("method", ["average", "weighted_average", "max"])
@pytest.mark.parametrize("avg_type", ["average_proportion", "average_lagging",
                                      "differentiable_average_lagging"])
def test_training_loss_matches_jax(method, avg_type):
    attn, src_lens, tgt_mask = case(1)
    kw = dict(latency_weight_avg=0.3, latency_weight_var=0.2, average_method=method,
              latency_weight_avg_type=avg_type, mass_preservation=method != "max")
    want = jl.latency_training_loss(jnp.asarray(attn), jnp.asarray(src_lens),
                                    jnp.asarray(tgt_mask), jl.LatencyTrainingConfig(**kw))
    got = tl.latency_training_loss(torch.from_numpy(attn), torch.from_numpy(src_lens),
                                   torch.from_numpy(tgt_mask), tl.LatencyTrainingConfig(**kw))
    close(got, want)
    with pytest.raises(ValueError, match="average_method"):
        tl.latency_training_loss(torch.from_numpy(attn), None, torch.from_numpy(tgt_mask),
                                 tl.LatencyTrainingConfig(latency_weight_avg=1.0,
                                                          average_method="median"))


def speech_pair():
    batch = make_batch()
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), batch["features"], batch["feat_lengths"],
        batch["prev_tokens"])["params"])
    tm = load_flax_params(tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                                  for_training=True), params)

    def jax_fwd(p, **kw):
        return jm.apply({"params": p}, batch["features"], batch["feat_lengths"],
                        batch["prev_tokens"], deterministic=True, **kw)

    def port_fwd(model):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        return model(tb["features"], tb["feat_lengths"], tb["prev_tokens"], train=False)

    return batch, params, jax_fwd, tm, port_fwd


def text_pair():
    src, prev, target = mt_batch()
    cfg = dict(MT_TINY, encoder_normalize_before=True, decoder_normalize_before=True)
    jm = jt.TransformerModel(jt.TransformerMTConfig(**cfg))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), src, LENGTHS,
                                              prev)["params"])
    tm = load_flax_params(tt.TransformerModel(tt.TransformerMTConfig(**cfg), device="cpu",
                                              for_training=True), params)

    def jax_fwd(p, **kw):
        return jm.apply({"params": p}, src, LENGTHS, prev, deterministic=True, **kw)

    def port_fwd(model):
        return model(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev),
                     train=False)

    return {"target": target}, params, jax_fwd, tm, port_fwd


@pytest.mark.parametrize("make", [speech_pair, text_pair], ids=["s2t_transformer", "transformer"])
def test_criterion_capture_loss_and_grads_match_jax(make):
    batch, params, jax_fwd, tm, port_fwd = make()
    ccfg = {"latency_weight_avg": 0.2, "latency_weight_var": 0.1, "label_smoothing": 0.1}
    jcrit = jax_build_criterion(LATENCY, ccfg)

    def jax_loss(p):
        out, mods = jax_fwd(p, mutable=["intermediates"])
        out["cross_attn"] = jl.stack_cross_attn(mods["intermediates"])
        loss, n, logs = jcrit(out, {"target": jnp.asarray(batch["target"])})
        return loss, (out["cross_attn"], logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jattn, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)

    with tl.capture_cross_attn(tm) as cap:
        out = port_fwd(tm)
    L, H = len(tm.decoder.layers), tm.decoder.num_heads
    assert cap.attn.shape == jattn.shape and cap.attn.shape[1] == H * L
    close(cap.attn, jattn)
    assert tm.decoder.captured_cross_attn is None and not tm.decoder.capture_cross_attn
    loss, n, logs = build_criterion(LATENCY, ccfg)({**out, "cross_attn": cap.attn},
                                                   {"target": torch.from_numpy(batch["target"])})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logs["latency_loss"].item(), float(jlogs["latency_loss"]),
                               rtol=1e-5)
    assert logs["latency_loss"].item() > 0
    got = dict(flat(state_dict_to_flax({  # the CTC head takes no part in this loss
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in tm.named_parameters()})))
    want = dict(flat(jgrads))
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=name)


def test_speech_task_forward_carries_cross_attn(tmp_path):
    """The speech task's adapter under the latency criterion (one Trainer step): its
    output holds ``cross_attn`` and the step logs a positive ``latency_loss``."""
    from s2t_tpu_torch.config import OptimizationConfig
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.trainer import Trainer

    d = Dictionary()
    for i in range(28):
        d.add_symbol(f"w{i}")
    cfg = from_dict(TrainConfig, {"criterion": LATENCY,
                                  "criterion_cfg": {"latency_weight_avg": 0.5}})
    task = SpeechToTextTask(cfg, S2TDataConfig(), d)
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                 for_training=True)
    fwd = task.forward_fn()
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    out = fwd(tm, batch, train=False)
    assert out["cross_attn"].shape[:2] == (4, 8)
    trainer = Trainer(tm, task.build_criterion(), OptimizationConfig(lr=1e-3), device="cpu",
                      forward_fn=fwd)
    m = trainer.train_step(make_batch())
    assert m["latency_loss"].item() > 0 and np.isfinite(m["loss"].item())


def test_composite_and_model_criteria_match_jax():
    rng = np.random.default_rng(0)
    B, U, V = 2, 4, 9
    logits = [rng.normal(size=(B, U, V)).astype(np.float32) for _ in range(2)]
    tgt = rng.integers(2, V, size=(2, B, U)).astype(np.int32)
    tgt[1, 0, 2:] = 1
    ccfg = {"underlying_criterion": "label_smoothed_cross_entropy",
            "underlying_cfg": {"label_smoothing": 0.1}}
    jloss, jn, jlogs = jax_build_criterion("composite_loss", ccfg)(
        {"outputs": tuple({"decoder_logits": jnp.asarray(x)} for x in logits)},
        {"targets": jnp.asarray(tgt)})
    loss, n, logs = build_criterion("composite_loss", ccfg)(
        {"outputs": tuple({"decoder_logits": torch.from_numpy(x)} for x in logits)},
        {"targets": torch.from_numpy(tgt)})
    close(loss, jloss, 1e-6)
    close(n, jn)
    for key in ("loss_0", "loss_1", "ntokens", "nsentences"):
        close(logs[key], jlogs[key], 1e-6)
    # one output without ``outputs``: the output itself against ``target``
    one, _, _ = build_criterion("composite_loss", ccfg)(
        {"decoder_logits": torch.from_numpy(logits[0])}, {"target": torch.from_numpy(tgt[0])})
    close(one, logs["loss_0"], 1e-6)

    mcfg = {"loss_weights": {"a": 2.0, "b": 0.5, "c": 0.0}, "log_keys": ["extra"]}
    losses = {"a": 1.25, "b": 4.0, "c": 100.0}
    jloss, jn, jlogs = jax_build_criterion("model", mcfg)(
        {"losses": {k: jnp.asarray(v) for k, v in losses.items()}, "sample_size": 7.0,
         "extra": jnp.asarray(3.0)}, {"nsentences": 2})
    loss, n, logs = build_criterion("model", mcfg)(
        {"losses": {k: torch.tensor(v) for k, v in losses.items()}, "sample_size": 7.0,
         "extra": torch.tensor(3.0)}, {"nsentences": 2})
    assert set(logs) == set(jlogs) and "loss_c" not in logs
    for key in logs:
        close(logs[key], jlogs[key])
    close(loss, jloss)
    close(n, jn)
