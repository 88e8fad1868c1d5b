"""The port's training-loop breadth against the JAX package (s2t_tpu/optim/builders.py,
s2t_tpu/models/s2t_transformer.py):

* each optimizer of JAX's generic chain (``adafactor``, ``adagrad``, ``sgd``, ``nag``,
  ``adadelta``, ``adamax``, ``lamb``, and ``adam`` with ``lr_groups``) under each of
  ``fixed``, ``manual``, ``triangular``, ``pass_through`` and ``reduce_on_plateau``
  (its lr scale set to 0.5 after the second update on both sides), against
  ``skip_nonfinite(build_optimizer(...))`` for 5 updates of seeded gradients in
  flax's layout carried to the port's: clipping, one non-finite step (skipped) and
  the groups ``encoder`` frozen and ``decoder`` halved; the parameters within 1e-6
  relative (of each leaf's largest entry) and every count alike.  The parameter set
  has factored (both dims >= 128) and unfactored leaves for adafactor;
* the schedules against JAX's at every step, and ``ReduceOnPlateau`` against JAX's;
* the ``Trainer``'s choice of path, ``lr_groups`` raising on a prefix that matches no
  parameter (JAX scales nothing there), and the chain's state round trip;
* ``encoder_layerdrop``: one training forward / backward with JAX's keep bits handed
  over (dropout 0), loss and gradients within 1e-5, the dropped layer's gradients 0;
* ``checkpoint_activations``: for each remat policy the gradients at dropout 0.1 equal
  the non-remat ones bit for bit (a checkpointed layer replays the step generator's
  state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.optim import builders as jb
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import (
    flax_path, flax_to_state_dict, load_flax_params, state_dict_to_flax)
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.optim import builders as tb
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_train_criterion import TINY, flat, make_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

OPTIMIZERS = ["adafactor", "adagrad", "sgd", "nag", "adadelta", "adamax", "lamb", "adam"]
SCHEDULES = ["fixed", "manual", "triangular", "pass_through", "reduce_on_plateau"]
GROUPS = {"encoder": 0.0, "decoder": 0.5}
BAD_STEP = 2


def flax_params():
    rng = np.random.default_rng(0)
    shapes = {
        "encoder": {"layer0": {"fc1": {"kernel": (128, 160), "bias": (160,)},
                               "attn_norm": {"scale": (128,), "bias": (128,)}}},
        "decoder": {"layer0": {"fc1": {"kernel": (48, 24), "bias": (24,)}},
                    "embed_tokens": {"embedding": (200, 136)}},
        "subsample": {"conv0": {"kernel": (5, 130, 140), "bias": (140,)}},
    }

    def make(tree):
        return {k: make(v) if isinstance(v, dict) else
                (0.1 * rng.normal(size=v)).astype(np.float32) for k, v in tree.items()}

    return make(shapes)


def flax_grads(params, n=5):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        if i == BAD_STEP:
            g["decoder"]["layer0"]["fc1"]["bias"][3] = np.nan
        out.append(g)
    return out


def opt_kw(name, sched):
    kw = dict(optimizer=name, lr_scheduler=sched, lr=3e-2, clip_norm=60.0, min_lr=1e-3,
              warmup_updates=2, max_update=20, lr_groups=dict(GROUPS), adam_eps=1e-6,
              weight_decay=0.01)
    if sched == "manual":
        kw["lr_milestones"] = {2: 1e-2, 4: 5e-3}
    return kw


def port_params(params):
    sd = flax_to_state_dict(params)
    return {k: torch.nn.Parameter(v.clone()) for k, v in sd.items()}


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, sched):
    params = flax_params()
    grads = flax_grads(params)
    jcfg = JaxOptimizationConfig(**opt_kw(name, sched))
    tx = jb.skip_nonfinite(jb.build_optimizer(jcfg, jb.build_lr_schedule(jcfg)), 8)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for i, g in enumerate(grads):
        if i == 2 and sched == "reduce_on_plateau":
            state = jb.set_lr_scale(state, 0.5)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    cfg = OptimizationConfig(**opt_kw(name, sched))
    named = port_params(params)
    scales = tb.group_scales(list(named), cfg.lr_groups,
                             lambda n: flax_path(n, named[n].dim())[0])
    assert scales.count(0.0) == 4 and scales.count(0.5) == 3
    opt = tb.SkipNonFiniteChain(named.values(), cfg, tb.build_lr_schedule(cfg), scales)
    for i, g in enumerate(grads):
        if i == 2 and sched == "reduce_on_plateau":
            opt.lr_scale = 0.5
        for k, v in flax_to_state_dict(g).items():
            named[k].grad = v
        gnorm = opt.step()
        assert np.isfinite(gnorm.item()) == (i != BAD_STEP)
    assert int(opt.count) == len(grads) - 1 and int(opt.notfinite_count) == 0
    got = dict(flat(state_dict_to_flax({k: p.detach() for k, p in named.items()})))
    want = dict(flat(jax.tree.map(np.asarray, jp)))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=key)
        if key.startswith("encoder/"):  # frozen
            np.testing.assert_array_equal(got[key], dict(flat(params))[key])


@pytest.mark.parametrize("sched", SCHEDULES + ["inverse_sqrt", "cosine"])
def test_schedules_match_jax(sched):
    kw = opt_kw("sgd", sched)
    kw.pop("lr_groups")
    j = jb.build_lr_schedule(JaxOptimizationConfig(**kw))
    t = tb.build_lr_schedule(OptimizationConfig(**kw))
    for step in range(25):
        np.testing.assert_allclose(float(t(torch.tensor(step, dtype=torch.int32))),
                                   float(j(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    # the first milestone after 0: the base lr before it
    kw = dict(lr_scheduler="manual", lr=0.1, lr_milestones={3: 0.01})
    t = tb.build_lr_schedule(OptimizationConfig(**kw))
    assert [round(float(t(s)), 6) for s in range(5)] == [0.1, 0.1, 0.1, 0.01, 0.01]


def test_reduce_on_plateau_matches_jax():
    losses = [5.0, 4.0, 4.0, 4.00001, 3.0, 3.5, 3.2, 3.1, 3.05, 3.05]
    for kw in ({}, {"shrink": 0.5, "patience": 1}, {"shrink": 0.1, "min_scale": 0.05}):
        j, t = jb.ReduceOnPlateau(**kw), tb.ReduceOnPlateau(**kw)
        assert [t.step(v) for v in losses] == [j.step(v) for v in losses]


def test_trainer_paths_and_lr_groups_naming():
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                    for_training=True)
    crit = build_criterion("label_smoothed_cross_entropy")
    fused = Trainer(model, crit, OptimizationConfig(optimizer="adam"), device="cpu")
    assert isinstance(fused.optimizer, tb.FusedAdamWSkipNonFinite)
    chain = Trainer(model, crit, OptimizationConfig(optimizer="adam", lr_groups={"decoder": 0.0}),
                    device="cpu")
    assert isinstance(chain.optimizer, tb.SkipNonFiniteChain)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert chain.optimizer.scales == [0.0 if n.startswith("decoder.") else 1.0 for n in names]
    with pytest.raises(ValueError, match=r"\['encoderz'\] match no parameter"):
        Trainer(model, crit, OptimizationConfig(optimizer="sgd", lr_groups={"encoderz": 0.0}),
                device="cpu")
    # the chain's state survives a round trip and refuses another optimizer's
    trainer = Trainer(model, crit, OptimizationConfig(optimizer="adafactor"), device="cpu")
    trainer.train_step(make_batch())
    trainer.set_lr_scale(0.25)
    sd = trainer.state_dict()
    again = Trainer(model, crit, OptimizationConfig(optimizer="adafactor"), device="cpu")
    again.load_state_dict(sd)
    assert again.optimizer.lr_scale == 0.25 and int(again.optimizer.count) == 1
    for a, b in zip(again.optimizer.state["v_row"], trainer.optimizer.state["v_row"]):
        assert torch.equal(a, b)
    other = Trainer(model, crit, OptimizationConfig(optimizer="lamb"), device="cpu")
    with pytest.raises(ValueError, match="'adafactor'"):
        other.load_state_dict(sd)


LAYERDROP = dict(TINY, encoder_layers=3, encoder_layerdrop=0.5)


def test_layerdrop_step_matches_jax_with_handed_keep_bits(monkeypatch):
    batch = make_batch()
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**LAYERDROP))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), batch["features"], batch["feat_lengths"],
        batch["prev_tokens"])["params"])
    jcrit = __import__("s2t_tpu.criterions.build", fromlist=["x"]).build_criterion(
        "label_smoothed_cross_entropy")
    # JAX's keep draws, one slot a layer in trace order, filled as the jitted step runs
    slots, uniform = [], jax.random.uniform

    def recording_uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        out = uniform(key, shape, dtype, minval, maxval)
        slots.append(None)
        jax.debug.callback(lambda v, i=len(slots) - 1: slots.__setitem__(i, float(v)), out)
        return out

    monkeypatch.setattr(jax.random, "uniform", recording_uniform)

    def jax_loss(p):
        out = jm.apply({"params": p}, batch["features"], batch["feat_lengths"],
                       batch["prev_tokens"], deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(5)})
        return jcrit(out, batch)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    jax.effects_barrier()
    keep = [u >= 0.5 for u in slots]
    assert len(keep) == 3 and 0 < sum(keep) < 3, keep  # the key drops some layer

    tm = load_flax_params(tst.S2TTransformerModel(tst.s2t_transformer_s(**LAYERDROP),
                                                  device="cpu", for_training=True), params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = tm(tbatch["features"], tbatch["feat_lengths"], tbatch["prev_tokens"], train=True,
             generator=torch.Generator().manual_seed(0), layer_keep=keep)
    loss = build_criterion("label_smoothed_cross_entropy")(out, tbatch)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = dict(flat(state_dict_to_flax({
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in tm.named_parameters()})))
    for key, g in flat(jgrads):
        np.testing.assert_allclose(got[key], g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=key)
        layer = key.split("/")[1] if key.startswith("encoder/layer") else None
        if layer is not None and not keep[int(layer[5:])]:
            assert not np.any(got[key]), key
    # without handed bits the port draws its own, from the step generator's seed
    assert tst.draw_layer_keep(3, 0.5, 7) == tst.draw_layer_keep(3, 0.5, 7)


def remat_grads(**kw):
    cfg = tst.s2t_transformer_s(**{**TINY, "dropout": 0.1, "attention_dropout": 0.1,
                                   "activation_dropout": 0.1}, **kw)
    model = tst.S2TTransformerModel(cfg, device="cpu", seed=3, for_training=True)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    out = model(batch["features"], batch["feat_lengths"], batch["prev_tokens"], train=True,
                generator=torch.Generator().manual_seed(11))
    build_criterion("label_smoothed_cross_entropy_with_ctc")(out, batch)[0].backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", tst.REMAT_POLICIES)
def test_remat_gradients_equal_the_plain_ones(policy):
    plain = remat_grads()
    remat = remat_grads(checkpoint_activations=True, remat_policy=policy)
    assert set(plain) == set(remat)
    for name, g in plain.items():
        assert torch.equal(g, remat[name]), name
    with pytest.raises(ValueError, match="remat_policy"):
        tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY, checkpoint_activations=True,
                                                      remat_policy="offload"),
                                device="cpu", for_training=True)
