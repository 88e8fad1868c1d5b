"""The port's ``Trainer`` against the JAX ``Trainer`` on the tiny model.

Both start from the same flax-initialised parameters (carried across with
``from_flax``) and take 3 steps on seeded numpy batches at dropout 0, with
``update_freq`` 1 and 2 (micro-batches on a leading axis).  Per step the
loss, ctc_loss, gnorm, lr and sample_size agree, and after 3 steps every
parameter agrees leaf by leaf through ``state_dict_to_flax``.  Tolerance:
the first Adam updates are g / (|g| + eps) ~ lr * sign(g), so a gradient
entry that is float32 noise around 0 in both packages (the key-projection
biases, whose exact gradient is 0 under the softmax) moves a parameter by up
to 2 * lr in opposite directions; at the default eps 1e-8 that reached
5e-5 here.  The test sets adam_eps 1e-6, which keeps such entries' updates
small without changing the transformation under test, and holds the
parameters to atol 5e-6 after 3 steps (achieved 1.6e-6 and 1.3e-6).
The JAX step reports the criterion's unnormalised loss under "loss" (its logs
override the normalised value); the port reports the normalised loss, so the
test compares the port's loss times the sample size.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.parallel.mesh import make_mesh
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.trainer import Trainer
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(
    vocab_size=32, encoder_layers=2, decoder_layers=2, encoder_embed_dim=64,
    decoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128,
    encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=64,
    max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
)
CRITERION = ("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})
OPT = dict(lr=1e-3, warmup_updates=3, clip_norm=1.0, adam_eps=1e-6)
PARAM_ATOL = 5e-6


def make_batch(rng, B=4, T=48, U=6, V=32):
    target = rng.integers(4, V, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    return {
        "features": rng.normal(size=(B, T, 80)).astype(np.float32),
        "feat_lengths": np.array([48, 40, 33, 21], np.int32)[:B],
        "prev_tokens": prev,
        "target": target,
        "transcript": target[:, :-1],
        "transcript_lengths": np.full((B,), U - 1, np.int32),
        "ntokens": np.float32(B * U),
    }


def batches(update_freq, n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        micro = [make_batch(rng) for _ in range(update_freq)]
        out.append(micro[0] if update_freq == 1 else
                   {k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return out


def on_mesh(state, mesh):
    """The JAX Trainer's initial state placed as its train step returns states (replicated
    on the mesh), so the step compiles once and not again for the second placement."""
    return jax.device_put(state, NamedSharding(mesh, PartitionSpec()))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_three_steps_match_jax_trainer(update_freq):
    steps = batches(update_freq)
    mesh = make_mesh(devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY)),
                          jax_build_criterion(*CRITERION),
                          JaxOptimizationConfig(update_freq=update_freq, **OPT), mesh=mesh)
    first = steps[0] if update_freq == 1 else {k: v[0] for k, v in steps[0].items()}
    state = on_mesh(jtrainer.init_state(first), mesh)
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                    for_training=True)
    load_flax_params(model, jax.tree.map(np.asarray, state.params))
    trainer = Trainer(model, build_criterion(*CRITERION),
                      OptimizationConfig(update_freq=update_freq, **OPT), device="cpu")
    for i, batch in enumerate(steps):
        with jax.default_matmul_precision("highest"):
            state, jm = jtrainer.train_step(state, batch)
        m = trainer.train_step(batch)
        size = float(jm["sample_size"])
        assert m["sample_size"].item() == size
        np.testing.assert_allclose(m["loss"].item() * size, float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss @ {i}")
        np.testing.assert_allclose(m["ctc_loss"].item(), float(jm["ctc_loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["gnorm"].item(), float(jm["gnorm"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    got = dict(flat(state_dict_to_flax(model.state_dict())))
    want = dict(flat(jax.tree.map(np.asarray, state.params)))
    assert set(got) == set(want)
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= PARAM_ATOL, f"max param difference after 3 steps {worst:.3e}"


def test_dropout_step_is_reproducible():
    cfg = tst.s2t_transformer_s(**{**TINY, "dropout": 0.1, "attention_dropout": 0.1,
                                   "activation_dropout": 0.1})
    batch = batches(1, n=1, seed=4)[0]

    def run(seed):
        model = tst.S2TTransformerModel(cfg, device="cpu", seed=3, for_training=True)
        trainer = Trainer(model, build_criterion(*CRITERION), OptimizationConfig(**OPT),
                          device="cpu", seed=seed)
        losses = [trainer.train_step(batch)["loss"].item() for _ in range(2)]
        return losses, model.state_dict()

    (a, sd_a), (b, sd_b), (c, _) = run(1), run(1), run(2)
    assert a == b and a[0] != a[1]  # same (seed, step) -> same bits; steps differ
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert c != a  # another seed draws other dropout bits


def test_training_refuses_unported_knobs():
    # layerdrop, remat, sgd, triangular and lr_groups are ported (their parity cases:
    # tests/test_torch_optimizers.py): each builds and takes a step
    for kw in (dict(encoder_layerdrop=0.1), dict(checkpoint_activations=True)):
        model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY, **kw), device="cpu",
                                        for_training=True)
        Trainer(model, build_criterion(*CRITERION), OptimizationConfig(), device="cpu")
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                    for_training=True)
    for good in (dict(optimizer="sgd"), dict(lr_scheduler="triangular"),
                 dict(lr_groups={"encoder": 0.0})):
        trainer = Trainer(model, build_criterion(*CRITERION), OptimizationConfig(**good),
                          device="cpu")
        assert np.isfinite(trainer.train_step(make_batch(np.random.default_rng(0)))["loss"].item())
    # every PRNG implementation JAX takes builds (the bits come from torch.Generators);
    # a name JAX does not know still raises
    Trainer(model, build_criterion(*CRITERION), OptimizationConfig(rng_impl="unsafe_rbg"),
            device="cpu")
    with pytest.raises(NotImplementedError, match="rng_impl"):
        Trainer(model, build_criterion(*CRITERION), OptimizationConfig(rng_impl="philox"),
                device="cpu")
    # BMUF and the process-group settings are ported (tests/test_torch_parallel.py):
    # the CLI's check takes them; BMUF still refuses a mesh with model parallelism
    from s2t_tpu_torch.config import BMUFConfig, DistributedConfig, TrainConfig, \
        check_train_supported
    from s2t_tpu_torch.parallel.mesh import make_mesh
    for good in (TrainConfig(bmuf=BMUFConfig(active=True)),
                 TrainConfig(distributed=DistributedConfig(data_parallel=2)),
                 TrainConfig(distributed=DistributedConfig(model_parallel=2))):
        check_train_supported(good)
    with pytest.raises(ValueError, match="pure data parallelism"):
        Trainer(model, build_criterion(*CRITERION), OptimizationConfig(), device="cpu",
                mesh=make_mesh(DistributedConfig(model_parallel=2), world_size=2),
                bmuf_cfg=BMUFConfig(active=True))
    serving = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu")
    with pytest.raises(ValueError, match="for_training=True"):
        Trainer(serving, build_criterion(*CRITERION), OptimizationConfig(), device="cpu")
