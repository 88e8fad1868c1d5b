"""``language_modeling``, ``MonolingualDataset``, ``adaptive_loss`` and the ``cosine``
scheduler against the JAX package.

* ``cosine`` equals ``optax.warmup_cosine_decay_schedule`` as JAX builds it at
  every edge step (0, the end of the warm-up, decay_steps, beyond), with and
  without a warm-up and with max_update inside the warm-up;
* a 30-word corpus (seeded lines) batches as JAX's, key for key: blocks of
  ``tokens_per_sample`` (the tail dropped), of ``max_target_positions`` when that
  is unset, a stream shorter than one block padded, dummy rows all pad;
* a tiny adaptive-input / adaptive-softmax LM (2 layers of 32, cutoffs 10 / 20)
  from one flax init: the task's forward adapter and ``adaptive_loss`` give JAX's
  loss and sample size at rtol 1e-4 and every gradient within 1e-4 of its largest
  entry.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.optim.builders import cosine as jax_cosine
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.config import OptimizationConfig, TrainConfig, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.optim.builders import build_lr_schedule
from s2t_tpu_torch.tasks import setup_task
from tests.test_torch_train_trainer import flat
from tests.test_torch_translation import assert_batches_equal
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

WORDS = [f"w{i}" for i in range(30)]
MODEL = dict(decoder_embed_dim=32, decoder_ffn_embed_dim=64, decoder_layers=2,
             decoder_attention_heads=2, dropout=0.0, adaptive_softmax_cutoff=[10, 20],
             adaptive_input_cutoff=[10, 20])

COSINE = {  # name -> (config, the edge steps)
    "warmup": (dict(lr=1.0, warmup_updates=16, max_update=100, min_lr=1e-4,
                    warmup_init_lr=1e-7), [0, 1, 15, 16, 17, 50, 99, 100, 101, 1000]),
    "no_warmup": (dict(lr=0.5, warmup_updates=0, max_update=10), [0, 1, 9, 10, 11, 50]),
    "max_update_in_warmup": (dict(lr=0.3, warmup_updates=20, max_update=5, min_lr=0.01),
                             [0, 5, 19, 20, 21, 22, 100]),
    "default_warmup_init": (dict(lr=2.0, warmup_updates=3, max_update=8), [0, 2, 3, 4, 8, 9]),
}


@pytest.mark.parametrize("case", list(COSINE))
def test_cosine_matches_optax_at_its_edges(case):
    kw, steps = COSINE[case]
    kw = dict(kw, lr_scheduler="cosine")
    want = jax_cosine(JaxOptimizationConfig(**kw))
    got = build_lr_schedule(OptimizationConfig(**kw))
    for s in steps:
        np.testing.assert_allclose(float(got(torch.tensor(s))), float(want(np.int32(s))),
                                   rtol=1e-6, atol=1e-12, err_msg=f"{case} step {s}")


def write_corpus(root: Path, n_lines=24, seed=0) -> Path:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    for split, n in (("train", n_lines), ("valid", 3), ("short", 1)):
        lines = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 9)))) for _ in range(n)]
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return root


def cfg_dict(root, **sections):
    d = {"task": "language_modeling", "arch": "transformer_lm_wiki103", "model": dict(MODEL),
         "criterion": "adaptive_loss", "task_cfg": {"tokens_per_sample": 12},
         "dataset": {"data": str(root), "max_tokens": 40, "num_buckets": 2,
                     "max_target_positions": 64},
         "optimization": {"lr": 1e-3, "lr_scheduler": "cosine", "warmup_updates": 2,
                          "max_update": 4}}
    for k, v in sections.items():
        d[k] = {**d.get(k, {}), **v} if isinstance(v, dict) else v
    return d


def tasks(d):
    return setup_task(from_dict(TrainConfig, d)), jax_setup_task(jax_from_dict(JaxTrainConfig, d))


@pytest.mark.parametrize("case", ["tokens_per_sample", "max_target_positions", "dummy_rows"])
def test_monolingual_batches_match_jax(tmp_path, case):
    root = write_corpus(tmp_path)
    d = cfg_dict(root)
    if case == "max_target_positions":
        d = cfg_dict(root, task_cfg={"tokens_per_sample": None},
                     dataset={"max_target_positions": 8})
    elif case == "dummy_rows":
        d = cfg_dict(root, dataset={"required_batch_size_multiple": 4, "max_tokens": 60})
    task, jtask = tasks(d)
    assert task.block_size == jtask.block_size == (8 if case == "max_target_positions" else 12)
    assert_batches_equal(task, jtask, "train")
    ds, jds = task.load_dataset("train"), jtask.load_dataset("train")
    np.testing.assert_array_equal(ds.blocks, jds.blocks)
    np.testing.assert_array_equal(ds.ordered_indices(seed=5, epoch=2),
                                  jds.ordered_indices(seed=5, epoch=2))
    if case == "dummy_rows":
        batch = ds.collater([ds[0], ds[1]], batch_multiple=4)
        want = jds.collater([jds[0], jds[1]], batch_multiple=4)
        for key in want:
            np.testing.assert_array_equal(np.asarray(batch[key]), np.asarray(want[key]), key)
        assert (batch["prev_tokens"][2:] == 1).all() and (batch["target"][2:] == 1).all()


def test_a_stream_shorter_than_a_block_is_padded_and_the_block_falls_back_to_128(tmp_path):
    root = write_corpus(tmp_path)
    task, jtask = tasks(cfg_dict(root, task_cfg={"tokens_per_sample": None},
                                 dataset={"max_target_positions": 0}))
    assert task.block_size == jtask.block_size == 128
    ds, jds = task.load_dataset("short"), jtask.load_dataset("short")
    assert ds.blocks.shape == (1, 128) and (ds.blocks[0, -1] == 1)
    np.testing.assert_array_equal(ds.blocks, jds.blocks)


def test_adaptive_loss_and_gradients_match_jax(tmp_path):
    root = write_corpus(tmp_path)
    task, jtask = tasks(cfg_dict(root))
    batch = next(iter(task.get_batch_iterator(task.load_dataset("train"), seed=3)
                      .next_epoch_itr()))
    jm = jtask.build_model()
    jfwd = jtask.forward_fn()
    jbatch = {k: np.asarray(v) for k, v in batch.items() if k not in ("ids", "nsentences")}
    params = jfwd(jm, None, jbatch, True, {"params": jax.random.PRNGKey(0)})["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    jcrit = jax_build_criterion("adaptive_loss", {})

    def jax_loss(p):
        loss, size, _ = jcrit(jfwd(jm, p, jbatch, True), jbatch)
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm = load_flax_params(task.build_model(device="cpu", for_training=True), params)
    tbatch = {k: torch.as_tensor(v) for k, v in jbatch.items()}
    out = task.forward_fn()(tm, tbatch, train=True, generator=torch.Generator().manual_seed(0))
    loss, size, logs = build_criterion("adaptive_loss", {})(out, tbatch)
    loss.backward()
    assert size.item() == float(jsize) == float((jbatch["target"] != 1).sum())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    assert logs["nll_loss"].item() == loss.item()
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)
