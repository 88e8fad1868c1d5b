"""Training ``s2t_w2v2_transformer`` (the tiny model and wav corpus of
tests/test_torch_w2v2_s2t.py) as JAX can and cannot:

* the speech_to_text task's adapter runs the fbank first and the model refuses
  the features (JAX fails there with a ZeroDivisionError);
* through ``waveform_forward`` the loss and every gradient match
  ``jax.value_and_grad`` on JAX's span draws, and the port's Trainer takes two steps;
* ``wav2vec_ctc`` through the task fails at ``build_model`` in both (its config
  has no ``src_vocab_size``).
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.config import OptimizationConfig, TrainConfig, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models.wav2vec2 import waveform_forward
from s2t_tpu_torch.tasks import setup_task
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_train_trainer import flat
from tests.test_torch_w2v2_s2t import CRIT, setup  # noqa: F401  (the fixture)
from tests.test_torch_wav2vec2 import assert_close, recorded_draws
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)


def test_training_goes_through_waveform_forward(setup):
    root, d, jtask, jm, params = setup
    task = setup_task(from_dict(TrainConfig, d))
    ds = task.load_dataset("test")
    batch = next(iter(task.get_batch_iterator(ds, shuffle=False).next_epoch_itr()))
    batch = {k: v for k, v in batch.items() if k not in ("ids", "nsentences")}
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    with pytest.raises(ZeroDivisionError):  # JAX's adapter: the fbank, then the model
        jtask.forward_fn()(jm, params, jb, False, rngs={"dropout": jax.random.PRNGKey(0)})
    tm = load_flax_params(task.build_model(device="cpu", for_training=True), params)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    with pytest.raises(ValueError, match=r"\(B, N\) waveforms"):
        task.forward_fn()(tm, tb, train=False)
    # through the waveforms: loss and gradients against jax.value_and_grad on JAX's draws
    rngs = {"dropout": jax.random.PRNGKey(4)}
    args = (batch["features"], batch["feat_lengths"], batch["prev_tokens"])
    _, draws = recorded_draws(lambda: jm.apply({"params": params}, *args, deterministic=False,
                                               rngs=rngs))
    jcrit = jax_build_criterion("label_smoothed_cross_entropy_with_ctc", CRIT)

    def jax_loss(p):
        return jcrit(jm.apply({"params": p}, *args, deterministic=False, rngs=rngs), jb)[0]

    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    crit = build_criterion("label_smoothed_cross_entropy_with_ctc", CRIT)
    out = waveform_forward(tm, {**tb, "draws": draws}, train=True,
                           generator=torch.Generator().manual_seed(0))
    loss = crit(out, tb)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    for k, want in flat(jax.tree.map(np.asarray, jgrads)):
        assert_close(got[k], want, k, tol=1e-4)
    trainer = Trainer(tm, crit, OptimizationConfig(lr=1e-3, warmup_updates=2), device="cpu",
                      forward_fn=waveform_forward)
    losses = [trainer.train_step(batch)["loss"].item() for _ in range(2)]
    assert np.isfinite(losses).all() and losses[0] != losses[1]
    # wav2vec_ctc has no src_vocab_size: the task's build_model fails in both
    for build in (lambda: jax_setup_task(jax_from_dict(JaxTrainConfig, {
            **d, "arch": "wav2vec_ctc", "model": {}})).build_model(),
            lambda: setup_task(from_dict(TrainConfig, {**d, "arch": "wav2vec_ctc", "model": {}}))
            .build_model(device="cpu")):
        with pytest.raises(ValueError, match="src_vocab_size"):
            build()
