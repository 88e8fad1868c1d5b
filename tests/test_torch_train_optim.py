"""``FusedAdamWSkipNonFinite`` + ``inverse_sqrt`` against the JAX transformation.

The same gradients (numpy, seeded) go through the JAX Trainer's optimizer
(``fused_adamw_skip_nonfinite`` chained with ``lr_scale_transform``) and the
port's, over 5 updates with a NaN gradient at the third: parameters agree to
float32 rounding after every update, the skipped update changes nothing and
advances neither the Adam count nor the LR schedule.
"""

import jax.numpy as jnp
import numpy as np
import optax
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from s2t_tpu.optim.builders import fused_adamw_skip_nonfinite, lr_scale_transform
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.optim.builders import FusedAdamWSkipNonFinite, build_lr_schedule
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

SETTINGS = dict(lr=1e-2, warmup_updates=3, warmup_init_lr=1e-4, clip_norm=0.5,
                weight_decay=0.01, adam_betas=(0.9, 0.98), adam_eps=1e-8)
SHAPES = {"a": (3, 4), "b": (5,)}


def run_both(grads, max_consecutive_errors=8):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jcfg = JaxOptimizationConfig(**SETTINGS)
    tx = optax.chain(fused_adamw_skip_nonfinite(jcfg, jax_build_lr_schedule(jcfg),
                                                max_consecutive_errors),
                     lr_scale_transform())
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    cfg = OptimizationConfig(**SETTINGS)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in SHAPES]
    opt = FusedAdamWSkipNonFinite(params, cfg, build_lr_schedule(cfg), max_consecutive_errors)
    history = []
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(params, SHAPES):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        history.append(({k: np.asarray(v) for k, v in jparams.items()},
                        {k: p.detach().numpy().copy() for k, p in zip(SHAPES, params)},
                        int(jstate[0].count), int(opt.count)))
    return history


def make_grads(n, nan_at=(), seed=1):
    rng = np.random.default_rng(seed)
    grads = []
    for i in range(n):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        if i in nan_at:
            g["a"][1, 2] = np.nan
        grads.append(g)
    return grads


def test_matches_jax_through_a_nan_gradient():
    history = run_both(make_grads(5, nan_at=(2,)))
    for i, (want, got, jcount, count) in enumerate(history):
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=f"{k} @ {i}")
        assert count == jcount == (i + 1 if i < 2 else i)  # the NaN step is not counted
    for k in SHAPES:  # the skipped update changed nothing
        np.testing.assert_array_equal(history[2][1][k], history[1][1][k])


def test_gives_up_after_consecutive_bad_steps():
    history = run_both(make_grads(4, nan_at=(1, 2, 3)), max_consecutive_errors=2)
    assert [h[3] for h in history] == [h[2] for h in history] == [1, 1, 1, 2]
    assert np.isnan(history[3][1]["a"]).any() and np.isnan(history[3][0]["a"]).any()


def test_inverse_sqrt_matches_jax():
    cfg = OptimizationConfig(lr=2e-3, warmup_updates=100, warmup_init_lr=1e-7)
    jsched = jax_build_lr_schedule(JaxOptimizationConfig(lr=2e-3, warmup_updates=100,
                                                         warmup_init_lr=1e-7))
    sched = build_lr_schedule(cfg)
    for step in (0, 1, 50, 99, 100, 400, 12345):
        np.testing.assert_allclose(float(sched(step)), float(jsched(jnp.asarray(step))),
                                   rtol=1e-6)
        assert sched(torch.tensor(step, dtype=torch.int32)).dtype == torch.float32
