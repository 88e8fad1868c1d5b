"""Trainer: one training step, forward with dropout -> loss -> backward -> clip ->
AdamW -> non-finite skip, the validation step and the trainer state, over a mesh of
processes or one device, optionally BMUF (counterpart of s2t_tpu/trainer.py).

``Trainer(model, criterion, opt_cfg, device, seed, forward_fn).train_step(batch)``
is the step ``bench.py`` section B drives through the JAX ``Trainer``; the
forward adapter (default ``s2t_forward``; a task's ``forward_fn()`` runs its
feature pipeline first) is called as ``forward_fn(model, batch, train=...,
generator=...)``:

* with ``update_freq`` = n > 1 every batch leaf carries a leading axis of n
  micro-batches; their summed losses are backpropagated one by one and the
  summed gradients and loss are normalised by the GLOBAL sample size
  (trainer.py:351-355) before the global norm is taken;
* the optimizer is ``FusedAdamWSkipNonFinite`` under the LR schedule for Adam
  without ``lr_groups`` and ``SkipNonFiniteChain`` (clip -> optimizer -> the groups'
  factors -> the lr scale, skipped when non-finite) otherwise, as the JAX trainer
  picks (trainer.py:131-143); ``lr_groups`` keys are the flax tree's top-level keys
  of the parameters (``interop/from_flax.flax_path``);
* it returns ``loss``, ``gnorm``, ``lr`` (the schedule at the step count
  before this update, trainer.py:366-369), ``sample_size`` and the
  criterion's logs, all summed over the micro-batches.

Dropout bits come from a ``torch.Generator`` on the model's device seeded
from (seed, step) -- and the micro-batch index when n > 1 -- the counterpart
of ``jax.random.fold_in`` (trainer.py:325, :334), so a step is reproducible.
The model must be built with ``for_training=True`` (float32 master
parameters, compute in ``cfg.dtype``).

With ``quant_noise_p`` > 0 every forward and backward of a step runs on
block-noised copies of the dense kernels and embeddings
(``modules/quant_noise.py``) through ``torch.func.functional_call``; the
optimizer updates the un-noised parameters.  The masks come from a generator
seeded by the step's seed folded with 0x51AE, as JAX folds its key (one draw for
all data ranks, which share the weights; a replica's own under BMUF); a
``quant_noise_masks`` dict handed to ``train_step`` replaces the draw.

``valid_step(batch)`` runs the adapter in eval mode without gradients and
returns the summed loss, the sample size and the criterion's logs.

Over a ``mesh`` (``parallel/mesh.py``; by default the factorisation of the process
group by ``dist_cfg``, world size 1 without one) a step equals the one-device step:

* "data": every rank is handed the same global batch and keeps its contiguous rows;
  the ranks' raw summed gradients, losses, sample sizes and logs are SUMMED over the
  group before the division by the global sample size (a mean would be off by the
  world size), so the norm, the clip and the non-finite skip agree on every rank.
  Dropout draws from the step generator folded with the data rank.
* "model" / FSDP: ``parallel/tensor_parallel.py`` shards the parameters by the JAX
  rule table; the global norm sums each shard's squares over its groups.  Dropout on
  the replicated activations draws alike on the model ranks; inside a Megatron layer
  (the attention's heads, the FFN's hidden units) and in the quant noise of its
  shards each rank draws its own.
* "seq" / "pipe": the model splits the encoder's frames or stages over the group
  (``parallel/ring_attention.py``, ``parallel/pipeline.py``); every rank backpropagates
  1 / (seq x pipe) of the loss that all of them compute, and the gradients are summed
  over those groups too (``parallel/collectives.py``).

The parameters start as rank 0's on every rank.  ``bmuf_cfg.active``: the data ranks
are BMUF replicas (``optim/bmuf.py``; s2t_tpu/trainer.py:413-517): each takes its own
step on its rows, normalised by its own sample size; in the warm-up every update
averages the replicas (and with ``average_sync`` their floating optimizer state), and
every ``sync_interval`` updates the block update moves the global model and the
replicas restart from it (or the NBM lookahead).  ``eval_params()`` is the replica
average, which ``valid_step`` evaluates; ``state_dict()`` adds ``bmuf_global`` /
``bmuf_momentum``.  Every rank calls ``state_dict()`` (it gathers shards); the
checkpoint holds the one-device layout and loads into a Trainer of any mesh.
``set_lr_scale(value)`` sets the runtime lr multiplier (reduce_on_plateau).
``state_dict()`` / ``load_state_dict()`` carry the float32 master
parameters, the optimizer's state (both Adam moments, or the chain's), its
counters and lr scale and the step, as host tensors and ints
(``utils/checkpoint.py`` saves them).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from s2t_tpu_torch.config import OptimizationConfig, check_supported
from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.modules.quant_noise import quant_noise_params
from s2t_tpu_torch.optim.builders import (
    FusedAdamWSkipNonFinite, SkipNonFiniteChain, build_lr_schedule, group_scales)
from s2t_tpu_torch.parallel.collectives import all_reduce_
from s2t_tpu_torch.parallel.context import use_mesh
from s2t_tpu_torch.parallel.mesh import make_mesh, shard_batch
from s2t_tpu_torch.parallel.tensor_parallel import shard_model, sharded_norm

_MASK64 = (1 << 64) - 1
QUANT_NOISE_FOLD = 0x51AE  # the JAX step folds its dropout key with this for quant noise


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of their combination."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def flax_top_key(model) -> Callable[[str], str]:
    """A parameter name -> the first key of its flax path (``lr_groups``' keys); a
    decoder table tied to a CTC head is flax's top-level ``shared_embed``."""
    from s2t_tpu_torch.interop.from_flax import flax_path

    shared = bool(getattr(getattr(model, "cfg", None), "share_ctc_and_embed", False))
    ndim = {n: p.dim() for n, p in model.named_parameters()}

    def key(name: str) -> str:
        try:
            return flax_path(name, ndim[name], shared)[0]
        except KeyError:
            return name.split(".")[0]

    return key


def s2t_forward(model, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: torch.Generator | None = None) -> Dict[str, Any]:
    """The forward adapter for speech-to-text batches (the JAX trainer's s2t_forward):
    in training it hands the step count to mixup's ratio decay."""
    kw = {}
    if train and getattr(getattr(model, "cfg", None), "inter_mixup_ratio_decay", False) \
            and "_step" in batch:
        kw["num_updates"] = int(batch["_step"])
    return model(batch["features"], batch["feat_lengths"], batch["prev_tokens"],
                 train=train, generator=generator, **kw)


class _Forward(nn.Module):
    """``forward_fn`` over ``model`` as a module, so ``functional_call`` can swap
    the model's parameters for their noised copies for one call."""

    def __init__(self, model, forward_fn):
        super().__init__()
        self.model = model
        self.forward_fn = forward_fn

    def forward(self, batch, train, generator):
        return self.forward_fn(self.model, batch, train=train, generator=generator)


class Trainer:
    def __init__(self, model, criterion, opt_cfg: OptimizationConfig, device="cuda",
                 seed: int = 1, forward_fn: Optional[Callable] = None, mesh=None,
                 dist_cfg=None, bmuf_cfg=None):
        check_supported(opt_cfg)
        self.device = resolve_device(device)
        params = [p for p in model.parameters() if p.requires_grad]
        if not params:
            raise ValueError("Trainer: the model has no trainable parameters; build it with "
                             "for_training=True")
        if any(p.device.type != self.device.type for p in params):
            raise ValueError(f"Trainer: the model's parameters are not on {self.device}")
        self.mesh = mesh if mesh is not None else make_mesh(dist_cfg)
        self.tp = self.mesh.size("model") > 1
        self.fsdp = bool(dist_cfg.fsdp) if dist_cfg is not None else False
        self.bmuf = bmuf_cfg if (bmuf_cfg is not None and bmuf_cfg.active) else None
        if self.bmuf is not None and (self.tp or self.fsdp or self.mesh.size("pipe") > 1
                                      or self.mesh.size("seq") > 1):
            raise ValueError(
                "bmuf.active requires pure data parallelism (replicas "
                "own full model copies); disable model_parallel/fsdp/"
                "pipeline_parallel/seq_parallel")
        self.model = model
        if self.mesh.world_size > 1:  # every rank starts from rank 0's parameters
            with torch.no_grad():
                for p in model.parameters():
                    torch.distributed.broadcast(p.data, src=0)
        self.sharded = shard_model(model, self.mesh, self.tp, self.fsdp)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        params = [p for _, p in named]
        self.criterion = criterion
        self.forward_fn = forward_fn or s2t_forward
        self.opt_cfg = opt_cfg
        self.seed = seed
        # the dropout seed of this rank: folded with its data rank (the replica under
        # BMUF, s2t_tpu/trainer.py:451-453), so the ranks' rows draw other bits
        self.rank_seed = fold_in(seed, self.mesh.index("data")) \
            if self.mesh.size("data") > 1 else seed
        # quant noise masks the weights: one draw for the data ranks, which share them,
        # and a replica's own under BMUF (JAX draws it from the step key of the global
        # program, or of the replica)
        self.noise_seed = self.rank_seed if self.bmuf is not None else seed
        # every seq / pipe rank computes the loss; each backpropagates its share
        self.loss_scale = 1.0 / (self.mesh.size("seq") * self.mesh.size("pipe"))
        self.schedule = build_lr_schedule(opt_cfg)
        if opt_cfg.optimizer in ("adam", "adamw") and not opt_cfg.lr_groups:
            self.optimizer = FusedAdamWSkipNonFinite(params, opt_cfg, self.schedule,
                                                     max_consecutive_errors=8)
        else:
            scales = None
            if opt_cfg.lr_groups:
                scales = group_scales(self.param_names, opt_cfg.lr_groups, flax_top_key(model))
            self.optimizer = SkipNonFiniteChain(params, opt_cfg, self.schedule, scales,
                                                max_consecutive_errors=8)
        if self.sharded is not None:
            self.optimizer.norm_fn = sharded_norm(self.param_names,
                                                  [p.numel() for p in params], self.sharded)
        if self.bmuf is not None:
            from s2t_tpu_torch.optim.bmuf import bmuf_init

            self.bmuf_global, self.bmuf_momentum = bmuf_init(dict(named))
        self.step = 0  # updates attempted, skipped ones included (the JAX state.step)

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for key, val in batch.items():
            if isinstance(val, dict):  # nested inputs (a zip batch's pairs, handed-over draws)
                out[key] = self._to_device(val)
                continue
            t = val if isinstance(val, torch.Tensor) else torch.as_tensor(np.asarray(val))
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def _micro_batches(self, batch):
        accum = self.opt_cfg.update_freq
        if accum == 1:
            return [batch]
        for key, val in batch.items():
            if val.dim() == 0 or val.shape[0] != accum:
                raise ValueError(f"update_freq={accum}: batch[{key!r}] needs a leading axis of "
                                 f"{accum} micro-batches, got shape {tuple(val.shape)}")
        return [{key: val[i] for key, val in batch.items()} for i in range(accum)]

    def _seed(self, base: int, step: int, micro: int | None = None) -> int:
        seed = fold_in(base, step)
        return seed if micro is None else fold_in(seed, micro)

    def _generator(self, step: int, micro: int | None = None) -> torch.Generator:
        """The dropout generator of (step, micro-batch), on the model's device."""
        return torch.Generator(device=self.device).manual_seed(
            self._seed(self.rank_seed, step, micro))

    def _call(self, batch, train, gen, quant_noise_masks=None, params=None, noise_seed=0):
        """The forward adapter, on ``params`` (name -> tensor) in place of the model's
        own where given, and quant noise; a sharded model gathers a parameter where it
        is read, and its graph saves the shard (``ShardedModel.saving``)."""
        cfg = self.opt_cfg
        params = dict(params or {})
        if train and cfg.quant_noise_p > 0:
            named = {**dict(self.model.named_parameters()), **params}
            qn_gen = torch.Generator(device=self.device).manual_seed(noise_seed)
            params = quant_noise_params(
                named, cfg.quant_noise_p, cfg.quant_noise_block_size, qn_gen,
                quant_noise_masks,
                None if self.sharded is None else self.sharded.quant_noise_shards())
        with use_mesh(self.mesh), (contextlib.nullcontext() if self.sharded is None
                                   else self.sharded.saving()):
            if not params:
                return self.forward_fn(self.model, batch, train=train, generator=gen)
            return torch.func.functional_call(
                _Forward(self.model, self.forward_fn),
                {f"model.{k}": v for k, v in params.items()}, (batch, train, gen))

    def _forward_train(self, micro, gen, quant_noise_masks=None, noise_seed=0):
        return self._call(micro, True, gen, quant_noise_masks, noise_seed=noise_seed)

    def _local_batch(self, batch):
        return shard_batch(batch, self.mesh, 1 if self.opt_cfg.update_freq > 1 else 0)

    def _sum_over(self, axes, values):
        """``values`` (a list of scalars) summed over the groups of ``axes``, in one
        float64 all-reduce; returns float64 scalars."""
        flat = torch.stack([torch.as_tensor(v, device=self.device).double().reshape(())
                            for v in values])
        for axis in axes:
            all_reduce_(flat, self.mesh.group(axis))
        return list(flat.unbind())

    def _reduce_grads(self) -> None:
        """Sum the gradients over the data, seq and pipe groups (FSDP's data-sharded
        parameters were summed over data by their gather's backward; a stage's is
        whole on its pipe rank), one flat all-reduce a set of groups."""
        axes = [a for a in ("data", "seq", "pipe") if self.mesh.size(a) > 1]
        if self.bmuf is not None or not axes:
            return
        buckets: Dict[tuple, list] = {}
        for name, p in zip(self.param_names, self.optimizer.params):
            done = self.sharded.reduced(name) if self.sharded is not None else ()
            buckets.setdefault(tuple(a for a in axes if a not in done), []).append(p)
        for key, ps in buckets.items():
            if not key:
                continue
            flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                              .reshape(-1).float() for p in ps])
            for axis in key:
                all_reduce_(flat, self.mesh.group(axis))
            for p, part in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad = part.view_as(p).to(p.dtype)

    def train_step(self, batch: Dict[str, Any],
                   quant_noise_masks: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One update of the global ``batch``.  ``quant_noise_masks``: the quant-noise
        drop masks to use in place of this step's draw (parameter name -> bool mask, the
        port's layout)."""
        self.model.train()
        for p in self.optimizer.params:
            p.grad = None
        micros = self._micro_batches(self._local_batch(self._to_device(batch)))
        loss_sum, size_sum, logs_sum = 0.0, 0.0, {}
        for i, micro in enumerate(micros):
            index = None if len(micros) == 1 else i
            gen = self._generator(self.step, index)
            noise_seed = fold_in(self._seed(self.noise_seed, self.step, index), QUANT_NOISE_FOLD)
            # the update count, for forward adapters with an in-step schedule (trainer.py:316)
            micro = {**micro, "_step": self.step}
            out = self._forward_train(micro, gen, quant_noise_masks, noise_seed)
            loss, sample_size, logs = self.criterion(out, micro)
            if self.loss_scale != 1.0:
                (loss.float() * self.loss_scale).backward()
            else:
                loss.float().backward()
            loss_sum = loss_sum + loss.detach().float()
            size_sum = size_sum + torch.as_tensor(sample_size, dtype=torch.float32)
            for key, val in logs.items():
                logs_sum[key] = logs_sum.get(key, 0.0) + val.detach()
        size_sum = torch.as_tensor(size_sum, dtype=torch.float32).to(self.device)
        self._reduce_grads()
        if self.mesh.size("data") > 1 and self.bmuf is None:
            keys = list(logs_sum)
            summed = self._sum_over(("data",), [loss_sum, size_sum] +
                                    [logs_sum[k] for k in keys])
            loss_sum, size_sum = summed[0].float(), summed[1].float()
            logs_sum = {k: v.to(torch.as_tensor(logs_sum[k]).dtype)
                        for k, v in zip(keys, summed[2:])}
        # normalise summed grads / loss by the GLOBAL sample size
        norm = torch.clamp(size_sum, min=1.0)
        gnorm = self.optimizer.step(grad_divisor=norm)
        metrics = {
            **logs_sum,
            "loss": loss_sum / norm,
            "gnorm": gnorm,
            "lr": float(self.schedule(self.step)),
            "sample_size": size_sum,
        }
        if self.bmuf is not None:
            metrics = self._bmuf_update(metrics)
        self.step += 1
        return metrics

    # ------------------------------------------------------------------ BMUF
    def _replica_mean(self, tensors):
        """The mean over the data ranks of each tensor (one flat all-reduce)."""
        tensors = list(tensors)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        all_reduce_(flat, self.mesh.group("data"))
        flat.div_(self.mesh.size("data"))
        return [part.view_as(t).to(t.dtype) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def _average_opt_state(self) -> None:
        """``average_sync``: the replicas' floating optimizer state averaged."""
        opt = self.optimizer
        if isinstance(opt, FusedAdamWSkipNonFinite):
            opt.mu, opt.nu = self._replica_mean([opt.mu, opt.nu])
            return
        leaves = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif isinstance(t, list):
                for v in t:
                    walk(v)
            elif torch.is_floating_point(t):
                leaves.append(t)

        walk(opt.state)
        with torch.no_grad():
            for t, avg in zip(leaves, self._replica_mean(leaves)):
                t.copy_(avg)

    @torch.no_grad()
    def _bmuf_update(self, metrics):
        """The sync after this replica's update (s2t_tpu/trainer.py:455-517), and the
        step's metrics over the replicas: the loss weighted by each one's sample size,
        the mean norm, the sums of the sample size and the logs."""
        from s2t_tpu_torch.optim.bmuf import bmuf_restart_point, bmuf_sync

        cfg = self.bmuf
        names, params = self.param_names, self.optimizer.params
        step_after = self.step + 1
        if step_after <= cfg.warmup_iterations or (
                cfg.sync_interval > 0 and step_after % cfg.sync_interval == 0):
            avg = dict(zip(names, self._replica_mean(params)))
            if step_after <= cfg.warmup_iterations:
                self.bmuf_global = {k: v.clone() for k, v in avg.items()}
                self.bmuf_momentum = {k: torch.zeros_like(v) for k, v in avg.items()}
                restart = avg
            else:
                self.bmuf_global, self.bmuf_momentum = bmuf_sync(
                    cfg, self.bmuf_global, avg, self.bmuf_momentum)
                restart = bmuf_restart_point(cfg, self.bmuf_global, self.bmuf_momentum)
            for n, p in zip(names, params):
                p.copy_(restart[n])
            if cfg.average_sync:
                self._average_opt_state()
        keys = [k for k in metrics if k not in ("loss", "gnorm", "lr", "sample_size")]
        ss = metrics["sample_size"]
        summed = self._sum_over(("data",), [metrics["loss"] * ss, ss, metrics["gnorm"]] +
                                [metrics[k] for k in keys])
        tot = torch.clamp(summed[1], min=1.0)
        out = {k: v.to(torch.as_tensor(metrics[k]).dtype) for k, v in zip(keys, summed[3:])}
        out.update(loss=(summed[0] / tot).float(), gnorm=(summed[2] / self.mesh.size("data"))
                   .float(), lr=metrics["lr"], sample_size=summed[1].float())
        return out

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The parameters to evaluate and decode with: the replica average under BMUF
        (every data rank calls it), the model's own otherwise."""
        named = dict(zip(self.param_names, self.optimizer.params))
        if self.bmuf is None:
            return {k: v.detach() for k, v in named.items()}
        return dict(zip(named, self._replica_mean(named.values())))

    @torch.no_grad()
    def valid_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Loss (summed), sample size and the criterion's logs of one global batch in
        eval mode (no dropout, the eval feature transforms), summed over the data ranks;
        under BMUF on the replica average."""
        self.model.eval()
        batch = shard_batch(self._to_device(batch), self.mesh)
        params = self.eval_params() if self.bmuf is not None else None
        out = self._call(batch, False, None, params=params)
        loss, sample_size, logs = self.criterion(out, batch)
        res = {"loss": loss.detach().float(),
               "sample_size": torch.as_tensor(sample_size, dtype=torch.float32), **logs}
        if self.mesh.size("data") > 1:
            keys = list(res)
            summed = self._sum_over(("data",), [res[k] for k in keys])
            res = {k: v.to(torch.as_tensor(res[k]).dtype) for k, v in zip(keys, summed)}
        return res

    def set_lr_scale(self, value: float) -> None:
        """The runtime lr multiplier of every later update (the JAX ``set_lr_scale``)."""
        self.optimizer.lr_scale = float(value)

    def state_dict(self) -> Dict[str, Any]:
        """Host copies of the master parameters, the optimizer's state and counters
        and the step (the JAX ``TrainState``: step, params, opt_state), whole: a
        sharded Trainer gathers them (every rank calls this)."""
        params = {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}
        opt = self.optimizer.state_dict()
        if self.sharded is not None:
            params.update({k: v.to("cpu", copy=True)
                           for k, v in self.sharded.full_state().items()})
            opt = self._opt_state(opt, self.sharded.full_flat)
        out = {"step": self.step, "params": params, "opt_state": opt}
        if self.bmuf is not None:
            out["bmuf_global"] = {k: v.to("cpu", copy=True) for k, v in self.bmuf_global.items()}
            out["bmuf_momentum"] = {k: v.to("cpu", copy=True)
                                    for k, v in self.bmuf_momentum.items()}
        return out

    def _opt_state(self, state, convert):
        """The optimizer state with every flat buffer over the parameters converted
        (whole <-> this rank's shards); a leaf of another shape raises."""
        n_local = sum(p.numel() for p in self.optimizer.params)
        n_full = sum(int(torch.Size(s).numel()) for s in self.sharded.full_shapes.values())

        def conv(t):
            if isinstance(t, dict):
                return {k: conv(v) for k, v in t.items()}
            if isinstance(t, list):
                return [conv(v) for v in t]
            if isinstance(t, torch.Tensor) and t.dim() == 1 and t.numel() in (n_local, n_full):
                return convert(t.to(self.device)).to("cpu")
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                raise NotImplementedError(
                    "a sharded Trainer's checkpoint carries flat optimizer buffers only; "
                    f"{self.opt_cfg.optimizer!r} keeps a leaf of shape {tuple(t.shape)}")
            return t

        return conv(state)

    def load_state_dict(self, state: Dict[str, Any], params_only: bool = False) -> None:
        """Restore ``state_dict()``'s output (the one-device layout, from a Trainer of any
        mesh); ``params_only`` keeps the fresh optimizer and step
        (``checkpoint.reset_optimizer``)."""
        params = state["params"]
        if self.sharded is not None:
            params = {k: self.sharded.local(k, v) if k in self.sharded.specs else v
                      for k, v in params.items()}
        self.model.load_state_dict(params, strict=True)
        if params_only:
            return
        opt = state["opt_state"]
        if self.sharded is not None:
            opt = self._opt_state(opt, self.sharded.local_flat)
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])
        if self.bmuf is not None and "bmuf_global" in state:
            self.bmuf_global = {k: v.to(self.device) for k, v in state["bmuf_global"].items()}
            self.bmuf_momentum = {k: v.to(self.device)
                                  for k, v in state["bmuf_momentum"].items()}
