"""The port's mesh over two gloo ranks against JAX's one-device Trainer.

One process group for the file: a module-scoped fixture writes the inputs (the port's
state dicts of one flax init, seeded numpy batches, the ring's q / k / v), starts two
ranks of ``tests/torch_parallel_worker.py`` as ``torchrun`` would, and computes the JAX
references while they run; every case reads their results.

* DP, TP (model=2), FSDP (data=2), the two-stage pipeline and SP (seq=2): loss,
  ctc_loss and the global norm of each of two steps (dropout 0) at rtol 1e-5, and every
  parameter after them at atol 5e-6, against the JAX ``Trainer`` on one device with the
  same flax weights and global batch; JAX's own tests hold its sharded steps to that
  one-device step (tests/test_parallel.py, test_seq_parallel.py, test_pipeline_parallel.py).
  JAX's seq_parallel model without a "seq" mesh axis runs the plain path, and its
  pipelined model on one device computes the stages in order, so the plain Trainer is
  their one-device step.  The parameter tolerance is the one-device Trainer test's
  (tests/test_torch_train_trainer.py: Adam's first updates are ~lr sign(g), so float
  noise around 0 moves an entry both ways; adam_eps 1e-6 bounds it).
* Each pipe rank holds only its own stage's parameters (another's are empty).
* The ring: forward and dQ / dK / dV of two seq ranks against JAX's ``ring_attention``
  on a two-device mesh, atol 1e-5.
* The DP and FSDP checkpoints load into the one-device port Trainer, whose third step
  equals the sharded one's and JAX's (rtol 1e-5); loaded back into a Trainer of their
  own mesh they take the same step.
* BMUF and SlowMo: each replica against JAX's one-device step of its rows, followed by
  JAX's ``bmuf_sync`` / ``bmuf_restart_point`` (and the optimizer state's mean under
  ``average_sync``), through a warm-up update, a block sync and a local update:
  metrics rtol 1e-5, parameters, global model and momentum atol 5e-6.
* A sharded forward, fp32 or bf16, keeps no gathered whole parameter (nor its cast)
  alive for its backward (TP's gathered embeddings, FSDP's every parameter): the graph
  saves the shards and the backward gathers them again.
* Tensor parallelism with dropout: inside the Megatron layers the two ranks draw other
  bits (the fused kernel's seeds and keep-masks, the FFN's activation masks), and two
  TP steps at residual / activation dropout and quant noise 0.1 equal the port's
  one-device Trainer's at the same seed (rtol 1e-5, parameters atol 5e-6): a shard's
  draws are its slice of the one-device draw.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from s2t_tpu.config import BMUFConfig as JaxBMUFConfig
from s2t_tpu.config import DistributedConfig as JaxDistributedConfig
from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.optim.bmuf import bmuf_restart_point, bmuf_sync
from s2t_tpu.parallel.mesh import make_mesh as jax_make_mesh
from s2t_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu.trainer import TrainState
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.trainer import Trainer
from s2t_tpu_torch.modules.dropout import threshold_u8
from s2t_tpu_torch.ops.attention_cuda import keep_mask
from tests.torch_parallel_worker import (BMUF, CRITERION, MODES, OPT, TINY, TP_DROPOUT,
                                         TP_DROPOUT_STEPS)
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
RTOL, PARAM_ATOL = 1e-5, 5e-6


def make_batch(rng, B=4, T=48, U=6, V=32):
    target = rng.integers(4, V, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    return {
        "features": rng.normal(size=(B, T, 80)).astype(np.float32),
        "feat_lengths": np.array([48, 40, 33, 21], np.int32)[:B],
        "prev_tokens": prev, "target": target, "transcript": target[:, :-1],
        "transcript_lengths": np.full((B,), U - 1, np.int32),
    }


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def worst_param(port_sd, jax_params, shared=False):
    got = dict(flat(state_dict_to_flax({k: torch.as_tensor(v) for k, v in port_sd.items()},
                                       shared)))
    want = dict(flat(jax.tree.map(np.asarray, jax_params)))
    assert set(got) == set(want)
    return max(np.abs(got[k] - want[k]).max() for k in want)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stack_stages(params, S=2):
    """The plain tree's encoder layers as JAX's pipelined model stacks them: stage s's
    layer j is layer s * L / S + j, on a leading stage axis."""
    enc = dict(params["encoder"])
    L = TINY["encoder_layers"]
    per = L // S
    layers = [enc.pop(f"layer{i}") for i in range(L)]
    enc["pipe_stages"] = {
        f"layer{j}": jax.tree.map(lambda *xs: np.stack(xs), *[layers[s * per + j]
                                                              for s in range(S)])
        for j in range(per)}
    return {**params, "encoder": enc}


def on_mesh(state, mesh):
    return jax.device_put(state, NamedSharding(mesh, PartitionSpec()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    rng = np.random.default_rng(0)
    batches = [make_batch(rng) for _ in range(3)]
    halves = [(make_batch(rng), make_batch(rng)) for _ in range(3)]
    bmuf_batches = [{k: np.concatenate([a[k], b[k]]) for k in a} for a, b in halves]
    mesh = jax_make_mesh(devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY)),
                          jax_build_criterion(*CRITERION), JaxOptimizationConfig(**OPT),
                          mesh=mesh)
    b0 = batches[0]

    def init_shapes(jm):  # JAX's init traced, not compiled: the tree's structure
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), b0["features"],
                                                b0["feat_lengths"], b0["prev_tokens"]))
        return jax.tree.map(lambda s: s.shape, shapes["params"])

    # the port's seeded weights carried to flax (no JAX init to compile), checked against
    # the structure of JAX's init, the plain and the pipelined model's
    params0 = state_dict_to_flax(tst.S2TTransformerModel(
        tst.s2t_transformer_s(**TINY), device="cpu", seed=0).state_dict())
    assert init_shapes(jtrainer.model) == jax.tree.map(np.shape, params0)
    stacked = stack_stages(params0)
    assert init_shapes(jst.S2TTransformerModel(jst.s2t_transformer_s(
        **TINY, pipeline_parallel=2))) == jax.tree.map(np.shape, stacked)
    init = on_mesh(TrainState(step=jnp.zeros((), jnp.int32), params=params0,
                              opt_state=jax.jit(jtrainer.tx.init)(params0)), mesh)
    rs = np.random.default_rng(1)
    ring = {n: rs.normal(size=(2, 16, 2, 8)).astype(np.float32) for n in ("q", "k", "v", "dout")}
    ring["valid"] = np.arange(16)[None, :] < np.array([16, 11])[:, None]
    data = {"sd": {k: v.numpy() for k, v in flax_to_state_dict(params0).items()},
            "sd_pipe": {k: v.numpy() for k, v in flax_to_state_dict(stacked).items()},
            "batches": batches, "bmuf_batches": bmuf_batches, "ring": ring}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(tmp / "in.pkl"), str(tmp)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))

    # the JAX references while the ranks run: one compiled step (B = 4) serves them all
    def step(state, batch):
        with jax.default_matmul_precision("highest"):
            return jtrainer.train_step(state, batch)

    # a state's own buffers (the step donates its input) through the host, and the
    # replicas' syncs in numpy: no op compiles on its own
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    copy = lambda s: on_mesh(host(s), mesh)  # noqa: E731
    state, ref = copy(init), []
    for b in batches:
        state, m = step(state, b)
        ref.append(jax.tree.map(np.asarray, m))
        if len(ref) == 2:
            two_step_params = jax.tree.map(np.asarray, state.params)
    bmuf_ref = {}
    for variant, kw in BMUF.items():
        cfg = JaxBMUFConfig(**kw)
        states = [copy(init), copy(init)]
        g = host(init.params)
        mom = jax.tree.map(np.zeros_like, g)
        rows = []
        for t, pair in enumerate(halves):
            ms = []
            for r in range(2):
                states[r], m = step(states[r], pair[r])
                ms.append(jax.tree.map(np.asarray, m))
            rows.append(ms)
            step_after = t + 1
            warm = step_after <= cfg.warmup_iterations
            if warm or (cfg.sync_interval > 0 and step_after % cfg.sync_interval == 0):
                avg = jax.tree.map(lambda a, b: (a + b) / 2, host(states[0].params),
                                   host(states[1].params))
                if warm:
                    g, mom, restart = avg, jax.tree.map(np.zeros_like, avg), avg
                else:
                    g, mom = bmuf_sync(cfg, g, avg, mom)
                    restart = bmuf_restart_point(cfg, g, mom)
                opt = [host(s.opt_state) for s in states]
                if cfg.average_sync:
                    mean = jax.tree.map(
                        lambda a, b: (a + b) / 2 if np.issubdtype(a.dtype, np.floating)
                        else a, opt[0], opt[1])
                    opt = [mean, mean]
                # each replica its own buffers: the step donates its state
                states = [copy(s.replace(params=restart, opt_state=o))
                          for s, o in zip(states, opt)]
        bmuf_ref[variant] = {"rows": rows, "params": [jax.tree.map(np.asarray, s.params)
                                                      for s in states],
                             "global": jax.tree.map(np.asarray, g),
                             "momentum": jax.tree.map(np.asarray, mom)}
    jmesh = jax_make_mesh(JaxDistributedConfig(data_parallel=1, seq_parallel=2),
                          devices=jax.devices()[:2])
    valid = jnp.asarray(ring["valid"])
    out, vjp = jax.vjp(lambda q, k, v: jax_ring_attention(q, k, v, valid, jmesh),
                       *(jnp.asarray(ring[n]) for n in "qkv"))
    ring_ref = {"out": np.asarray(out),
                **dict(zip(("dq", "dk", "dv"), map(np.asarray, vjp(jnp.asarray(ring["dout"])))))}

    for p in procs:
        log = p.communicate(timeout=300)[0].decode(errors="replace")
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for rank in range(2):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "ref": ref, "two_step_params": two_step_params,
            "bmuf": bmuf_ref, "ring": ring_ref, "data": data}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax_one_device_trainer(runs, mode):
    for rank in range(2):
        got = runs["ranks"][rank][mode]
        assert got["mesh"][{"dp": "data", "fsdp": "data", "tp": "model", "pipe": "pipe",
                            "sp": "seq"}[mode]] == 2
        for i, (m, jm) in enumerate(zip(got["steps"], runs["ref"])):
            size = float(jm["sample_size"])
            assert m["sample_size"] == size
            np.testing.assert_allclose(m["loss"] * size, float(jm["loss"]), rtol=RTOL,
                                       err_msg=f"{mode} loss @ {i}")
            np.testing.assert_allclose(m["ctc_loss"], float(jm["ctc_loss"]), rtol=RTOL)
            np.testing.assert_allclose(m["gnorm"], float(jm["gnorm"]), rtol=RTOL,
                                       err_msg=f"{mode} gnorm @ {i}")
        want = runs["two_step_params"]
        if mode == "pipe":  # the port's stages back in JAX's stacked tree
            want = stack_stages(want)
        worst = worst_param(got["params"], want)
        assert worst <= PARAM_ATOL, f"{mode}: max param difference {worst:.3e}"
    shapes = runs["ranks"][0][mode]["local_shapes"]
    q = "decoder.layers.0.self_attn.q_proj.weight"
    if mode == "tp":  # column / row shards under the Megatron layers, the table's embedding
        assert shapes[q] == (16, 32)
        assert shapes["decoder.layers.0.self_attn.out_proj.weight"] == (32, 16)
        assert shapes["encoder.layers.0.ffn.fc1.weight"] == (32, 32)
        assert shapes["decoder.embed_tokens.weight"] == (32, 16)
    elif mode == "fsdp":  # the largest dim over "data": fc1's (in, out) = (32, 64)
        assert shapes["encoder.layers.0.ffn.fc1.weight"] == (32, 32)
        assert shapes[q] == (32, 16)
    else:
        assert shapes[q] == (32, 32)
    if mode == "pipe":  # each pipe rank holds its own stage only
        for rank in range(2):
            shapes = runs["ranks"][rank][mode]["local_shapes"]
            for s in range(2):
                fc1 = shapes[f"encoder.pipe_stages.{s}.layers.0.ffn.fc1.weight"]
                assert fc1 == ((64, 32) if s == rank else (0,)), (rank, s, fc1)


def test_ring_attention_matches_jax_ring_forward_and_backward(runs):
    for rank in range(2):
        got = runs["ranks"][rank]["ring"]
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[key], runs["ring"][key], atol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_checkpoint_loads_into_the_one_device_trainer(runs, mode):
    got = runs["ranks"][0][mode]
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                    for_training=True)
    trainer = Trainer(model, build_criterion(*CRITERION), OptimizationConfig(**OPT),
                      device="cpu")
    ckpt = got["ckpt"]
    trainer.load_state_dict({"step": ckpt["step"],
                             "params": {k: torch.as_tensor(v) for k, v in ckpt["params"].items()},
                             "opt_state": {k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                                           else v for k, v in ckpt["opt_state"].items()}})
    assert trainer.step == 2
    m = trainer.train_step(runs["data"]["batches"][2])
    jm = runs["ref"][2]
    size = float(jm["sample_size"])
    for key in ("loss", "gnorm", "ctc_loss"):
        np.testing.assert_allclose(float(m[key]), got["step3"][key], rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(got["step3_reloaded"][key], got["step3"][key], rtol=RTOL)
    np.testing.assert_allclose(float(m["loss"]) * size, float(jm["loss"]), rtol=RTOL)


@pytest.mark.parametrize("variant", list(BMUF))
def test_bmuf_matches_jax_replica_steps_and_sync(runs, variant):
    ref = runs["bmuf"][variant]
    for rank in range(2):
        got = runs["ranks"][rank]["bmuf_" + variant]
        for i, (m, pair) in enumerate(zip(got["steps"], ref["rows"])):
            size = sum(float(jm["sample_size"]) for jm in pair)
            assert m["sample_size"] == size
            np.testing.assert_allclose(m["loss"] * size, sum(float(jm["loss"]) for jm in pair),
                                       rtol=RTOL, err_msg=f"loss @ {i}")
            np.testing.assert_allclose(m["gnorm"], np.mean([float(jm["gnorm"]) for jm in pair]),
                                       rtol=RTOL, err_msg=f"gnorm @ {i}")
        assert worst_param(got["params"], ref["params"][rank]) <= PARAM_ATOL
        assert worst_param(got["global"], ref["global"]) <= PARAM_ATOL
        assert worst_param(got["momentum"], ref["momentum"]) <= PARAM_ATOL
        avg = jax.tree.map(lambda a, b: (a + b) / 2, *ref["params"])
        assert worst_param(got["eval_params"], avg) <= PARAM_ATOL


def test_tp_ranks_draw_their_own_dropout_bits(runs):
    r0, r1 = (runs["ranks"][r]["tp_dropout"] for r in range(2))
    assert r0["seeds"] and len(r0["seeds"]) == len(r1["seeds"])
    rate = threshold_u8(TP_DROPOUT["attention_dropout"])
    for (s0, shape), (s1, shape1) in zip(r0["seeds"], r1["seeds"]):
        assert shape == shape1 and s0 != s1
        B, T, H, _ = shape  # head h of rank 0 and head h of rank 1 (h + H / 2) differ
        m0, m1 = (keep_mask(torch.tensor([s]), B, H, T, rate) for s in (s0, s1))
        assert (m0 != m1).any()
    # every FFN of the 2 + 1 layers, each rank 32 of its 64 hidden units
    assert len(r0["masks"]) == len(r1["masks"]) == 3
    for m0, m1 in zip(r0["masks"], r1["masks"]):
        assert m0.shape == m1.shape and m0.shape[-1] == 32
        assert (m0 != m1).any()


def test_tp_step_with_dropout_matches_the_one_device_step(runs):
    model_kw, opt_kw = TP_DROPOUT_STEPS
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**{**TINY, **model_kw}),
                                    device="cpu", for_training=True)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in runs["data"]["sd"].items()})
    trainer = Trainer(model, build_criterion(*CRITERION),
                      OptimizationConfig(**OPT, **opt_kw), device="cpu")
    want = [trainer.train_step(b) for b in runs["data"]["batches"][:2]]
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for rank in range(2):
        got = runs["ranks"][rank]["tp_dropout"]
        for i, (m, w) in enumerate(zip(got["steps"], want)):
            for key in ("loss", "ctc_loss", "gnorm"):
                np.testing.assert_allclose(m[key], float(w[key]), rtol=RTOL,
                                           err_msg=f"{key} @ {i}")
        worst = max(np.abs(got["params"][n] - params[n]).max() for n in params)
        assert worst <= PARAM_ATOL, f"max param difference {worst:.3e}"


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_sharded_forward_keeps_no_whole_parameter(runs, mode):
    for rank in range(2):
        for dtype, (gathered, alive, casts) in zip(("fp32", "bf16"),
                                                   runs["ranks"][rank][mode]["gathers"]):
            assert gathered > 0 and alive == 0 and casts == 0, (dtype, gathered, alive, casts)
