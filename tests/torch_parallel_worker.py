"""One rank of the two-rank gloo process group that ``tests/test_torch_parallel.py``
starts, as ``torchrun`` would: RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the
environment, ``python -m tests.torch_parallel_worker IN_PICKLE OUT_DIR``.

It imports torch and the port only.  From the inputs the test wrote (the port's state
dicts of one flax init, the batches, the ring's q / k / v) it runs every mode of the
mesh in the one process group: data, tensor and FSDP parallel steps, the two-stage
pipeline, sequence parallelism (the ring alone, forward and backward, then whole
steps), the DP and FSDP checkpoints, BMUF in both variants, and tensor parallelism
with dropout (the draws each rank records, two steps); it writes this rank's
results to ``OUT_DIR/rank{r}.pkl`` as numpy arrays.
"""

from __future__ import annotations

import pickle
import sys
import weakref
from pathlib import Path

import torch

TINY = dict(
    vocab_size=32, encoder_layers=2, decoder_layers=1, encoder_embed_dim=32,
    decoder_embed_dim=32, encoder_ffn_embed_dim=64, decoder_ffn_embed_dim=64,
    encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=32,
    max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
)
CRITERION = ("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})
OPT = dict(lr=1e-3, warmup_updates=3, clip_norm=1.0, adam_eps=1e-6)
# mode -> (model fields, distributed fields)
MODES = {
    "dp": ({}, dict(data_parallel=2)),
    "tp": ({}, dict(model_parallel=2)),
    "fsdp": ({}, dict(data_parallel=2, fsdp=True)),
    "pipe": (dict(pipeline_parallel=2), dict(pipeline_parallel=2)),
    "sp": (dict(seq_parallel=True), dict(seq_parallel=2)),
}
BMUF = {
    "bmuf": dict(active=True, block_momentum=0.875, block_lr=1.0, sync_interval=2,
                 warmup_iterations=1, use_nbm=True, average_sync=False),
    "slowmo": dict(active=True, variant="slowmo", block_momentum=0.5, slowmo_lr=0.5,
                   sync_interval=2, warmup_iterations=1, use_nbm=False, average_sync=True),
}

# tensor parallelism with dropout: one step recording every rank's draws inside the
# Megatron layers, then TP_DROPOUT_STEPS' model and optimizer fields for two steps (the
# fused kernel's attention dropout is a rank's own seed, so it stays 0 there)
TP_DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
TP_DROPOUT_STEPS = (dict(dropout=0.1, activation_dropout=0.1), dict(quant_noise_p=0.1))


def numpy_tree(x):
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def build_trainer(model_kw, sd, dist_kw=None, bmuf_kw=None, opt_kw=None):
    from s2t_tpu_torch.config import BMUFConfig, DistributedConfig, OptimizationConfig
    from s2t_tpu_torch.criterions.build import build_criterion
    from s2t_tpu_torch.models import s2t_transformer as tst
    from s2t_tpu_torch.trainer import Trainer

    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**{**TINY, **model_kw}),
                                    device="cpu", for_training=True)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return Trainer(model, build_criterion(*CRITERION), OptimizationConfig(**OPT, **(opt_kw or {})),
                   device="cpu", dist_cfg=None if dist_kw is None else DistributedConfig(
                       **dist_kw), bmuf_cfg=None if bmuf_kw is None else BMUFConfig(**bmuf_kw))


def metrics_row(m):
    return {k: float(m[k]) for k in ("loss", "gnorm", "sample_size", "ctc_loss")}


def gathers_after_forward(trainer, batch):
    """(whole parameters gathered, of them still alive, casts of a gathered Linear
    weight to the compute dtype still alive) after a training forward and before its
    backward, which then runs (gathering again) and is discarded.  The casts are
    recorded around ``cast.Linear.forward``."""
    import torch.nn.functional as F
    from s2t_tpu_torch.modules import cast

    casts = []

    def linear(self, x):
        w = self.weight
        wx = w.to(x.dtype)
        if wx is not w and w.grad_fn is not None and "GatherParam" in w.grad_fn.name():
            casts.append(weakref.ref(wx))
        return F.linear(x, wx, None if self.bias is None else self.bias.to(x.dtype))

    forward, cast.Linear.forward = cast.Linear.forward, linear
    try:
        micro = trainer._local_batch(trainer._to_device(batch))
        out = trainer._forward_train({**micro, "_step": 0}, trainer._generator(0))
        loss = trainer.criterion(out, micro)[0]
    finally:
        cast.Linear.forward = forward
    gathered = [ref for ref, *_ in trainer.sharded.gathers.live.values()]
    counts = (len(gathered), sum(ref() is not None for ref in gathered),
              sum(ref() is not None for ref in casts))
    loss.backward()
    for p in trainer.optimizer.params:
        p.grad = None
    return counts


def run_mode(mode, data):
    model_kw, dist_kw = MODES[mode]
    sd = data["sd_pipe"] if "pipeline_parallel" in model_kw else data["sd"]
    trainer = build_trainer(model_kw, sd, dist_kw)
    gathers = None
    if mode in ("tp", "fsdp"):  # fp32, and bf16 compute (the graph saves the casts)
        gathers = [gathers_after_forward(trainer, data["batches"][0]),
                   gathers_after_forward(build_trainer({**model_kw, "dtype_str": "bfloat16"},
                                                       sd, dist_kw), data["batches"][0])]
    out = {"gathers": gathers,
           "steps": [metrics_row(trainer.train_step(b)) for b in data["batches"][:2]],
           "local_shapes": {n: tuple(p.shape) for n, p in trainer.model.named_parameters()},
           "mesh": dict(trainer.mesh.shape)}
    state = trainer.state_dict()
    out["params"] = numpy_tree(state["params"])
    if mode in ("dp", "fsdp"):
        # the checkpoint, a third step, and the checkpoint loaded back into a Trainer of
        # the same mesh taking that step again
        out["ckpt"] = numpy_tree(state)
        out["step3"] = metrics_row(trainer.train_step(data["batches"][2]))
        again = build_trainer(model_kw, sd, dist_kw)
        again.load_state_dict(state)
        out["step3_reloaded"] = metrics_row(again.train_step(data["batches"][2]))
    return out


def run_ring(data):
    from s2t_tpu_torch.parallel.collectives import gather, split
    from s2t_tpu_torch.parallel.mesh import make_mesh
    from s2t_tpu_torch.config import DistributedConfig
    from s2t_tpu_torch.parallel.ring_attention import ring_attention

    group = make_mesh(DistributedConfig(seq_parallel=2)).group("seq")
    q, k, v = (torch.tensor(data["ring"][n], requires_grad=True) for n in "qkv")
    valid = torch.as_tensor(data["ring"]["valid"])
    out = ring_attention(split(q, 1, group), split(k, 1, group), split(v, 1, group),
                         split(valid, 1, group), group)
    full = gather(out, 1, group)
    # every rank holds the whole output: each backpropagates half of the loss
    (full * torch.as_tensor(data["ring"]["dout"])).sum().mul(0.5).backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for g in grads:
        torch.distributed.all_reduce(g, group=group)
    return {"out": full.detach().numpy(), "dq": grads[0].numpy(), "dk": grads[1].numpy(),
            "dv": grads[2].numpy()}


def run_bmuf(variant, data):
    trainer = build_trainer({}, data["sd"], dict(data_parallel=2), BMUF[variant])
    steps = [metrics_row(trainer.train_step(b)) for b in data["bmuf_batches"]]
    state = trainer.state_dict()
    return {"steps": steps, "params": numpy_tree(state["params"]),
            "global": numpy_tree(state["bmuf_global"]),
            "momentum": numpy_tree(state["bmuf_momentum"]),
            "eval_params": numpy_tree(trainer.eval_params())}


def run_tp_dropout(data):
    """The fused kernel's seeds and the FFN's activation keep-masks of one TP step at
    TP_DROPOUT (recorded around the port's functions), then two steps at
    TP_DROPOUT_STEPS."""
    import s2t_tpu_torch.modules.attention as attention
    import s2t_tpu_torch.modules.layers as layers

    seeds, masks = [], []
    fused, drop = attention.fused_attention, layers.dropout

    def record_fused(q, k, v, valid_mask, rate, seed):
        if seed is not None:
            seeds.append((int(seed.reshape(())), tuple(q.shape)))
        return fused(q, k, v, valid_mask, rate, seed)

    def record_drop(x, rate, generator, shard=None):
        if shard is not None and generator is not None:
            again = torch.Generator()
            again.set_state(generator.get_state())
            masks.append(drop(torch.ones_like(x), rate, again, shard).ne(0).numpy())
        return drop(x, rate, generator, shard)

    attention.fused_attention, layers.dropout = record_fused, record_drop
    try:
        build_trainer(TP_DROPOUT, data["sd"], dict(model_parallel=2)).train_step(
            data["batches"][0])
    finally:
        attention.fused_attention, layers.dropout = fused, drop
    model_kw, opt_kw = TP_DROPOUT_STEPS
    trainer = build_trainer(model_kw, data["sd"], dict(model_parallel=2), opt_kw=opt_kw)
    steps = [metrics_row(trainer.train_step(b)) for b in data["batches"][:2]]
    return {"seeds": seeds, "masks": masks, "steps": steps,
            "params": numpy_tree(trainer.state_dict()["params"])}


def main(argv=None):
    from s2t_tpu_torch.parallel.mesh import init_distributed

    argv = argv or sys.argv[1:]
    torch.set_num_threads(1)
    with open(argv[0], "rb") as f:
        data = pickle.load(f)
    init_distributed("cpu")
    rank = torch.distributed.get_rank()
    results = {}
    for mode in MODES:
        results[mode] = run_mode(mode, data)
    results["ring"] = run_ring(data)
    for variant in BMUF:
        results["bmuf_" + variant] = run_bmuf(variant, data)
    results["tp_dropout"] = run_tp_dropout(data)
    with open(Path(argv[1]) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
