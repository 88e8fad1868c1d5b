"""Tensor parallelism and FSDP on one model (the port's side of ``tp_rules``).

``shard_model(model, mesh, tp, fsdp)`` stores every parameter as this rank's shard of
the layout that ``tp_rules.param_specs`` gives it, and runs the model in one of two
ways per parameter:

* Megatron layers, where the heads or the FFN's hidden units divide "model": a plain
  ``MultiHeadAttention`` (abs, rope or Shaw relative) takes column-parallel q / k / v
  projections and a row-parallel out_proj and splits its H / tp own heads, so the
  fused attention kernels run on this rank's heads; ``FeedForward`` takes a
  column-parallel fc1 and a row-parallel fc2.  The input of a column-parallel layer
  goes through ``copy_to_group`` and a row-parallel output through
  ``reduce_from_group``, its bias added after the sum.  Their dropout is each rank's
  own, as Megatron's model-parallel stream: the FFN's activation dropout and the dense
  attention's take this rank's slice of the whole tensor's draw, the fused kernel a
  seed of this rank (``attention.shard_seed``); quant noise on their shards is this
  rank's slice of the whole parameter's mask (``quant_noise_shards``).
* Every other sharded parameter (embeddings on the feature dim, the conv module's
  pointwise convs, pos_proj, and under FSDP the largest dim over "data") is gathered
  whole where the forward reads it (``gather_param``) and its gradient sliced back.
  The Conformer's GLU reads the whole pointwise_conv1, so a contiguous column split
  never pairs the wrong halves.

The gather is the module's attribute itself: its owner's class gets a property of the
parameter's name that gathers the stored shard (``_GatheredAttributes``), so every read
(a layer's ``forward``, ``forward_with_attn``, a tied output projection) sees the whole
tensor while ``named_parameters`` keeps the shard.  Inside ``ShardedModel.saving()``
autograd saves no gathered tensor: it keeps the shard and gathers it again when the
backward needs it, so a whole parameter lives from its read to its last use in the
forward and again in its backward (FSDP's per-layer gather; under remat the
recompute gathers again).

FSDP's gather sums the data ranks' gradients of the whole parameter in its backward
(a reduce-scatter); those parameters skip the Trainer's data-parallel sum
(``reduced``).  Under "pipe" a rank holds only its own stages' parameters (JAX shards
the stacked stage axis over "pipe"); another stage's is an empty tensor, so its
optimizer state is empty too, and the stages' gradients, each whole on its owner, skip
the sum over "pipe".  The global gradient norm adds each shard's squared norm over the
groups that shard it (``shard_groups``), so it is one number on every rank.
``full_state`` / ``load_full_state`` gather and slice the parameters (and flat
optimizer buffers) so a checkpoint holds the one-device layout.
"""

from __future__ import annotations

import contextlib
import re
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from s2t_tpu_torch.parallel.collectives import (
    all_gather_cat, copy_to_group, gather_param, reduce_from_group)
from s2t_tpu_torch.parallel.tp_rules import param_specs


class ColumnParallelLinear(nn.Module):
    """A ``Linear`` whose output features are this rank's 1 / tp of them."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.group = group

    def forward(self, x):
        x = copy_to_group(x, self.group)
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class RowParallelLinear(nn.Module):
    """A ``Linear`` over this rank's 1 / tp of the input features: partial sums,
    summed over the group, then the (whole) bias."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.group = group

    def forward(self, x):
        y = reduce_from_group(F.linear(x, self.weight.to(x.dtype)), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's contiguous shard of ``t`` under ``spec`` (an axis or None a dim)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.size(axis)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(axis) * size, size)
    return t


def stage_owners(model, mesh) -> Dict[str, int]:
    """Parameter name -> the pipe rank whose stages hold it (``pipe_stages.{s}``: rank
    s // (S / P)); empty without a "pipe" axis."""
    P = mesh.size("pipe")
    if P == 1:
        return {}
    S = int(getattr(model.cfg, "pipeline_parallel", 1) or 1)
    if S % P:
        raise ValueError(f"pipeline_parallel={S} stages do not divide over the mesh's "
                         f"{P} pipe ranks")
    out = {}
    for name, _ in model.named_parameters():
        m = re.search(r"(?:^|\.)pipe_stages\.(\d+)\.", name)
        if m:
            out[name] = int(m.group(1)) // (S // P)
    return out


def _megatron_modules(model, tp: int):
    """(module path, kind) of the attentions and FFNs that split over ``tp`` ranks."""
    from s2t_tpu_torch.modules.attention import MultiHeadAttention
    from s2t_tpu_torch.modules.layers import FeedForward

    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention) and mod.num_heads % tp == 0 \
                and mod.attention_type in ("abs", "rope", "relative") and not mod.gauss:
            out.append((name, "attention"))
        elif isinstance(mod, FeedForward) and mod.fc1.out_features % tp == 0:
            out.append((name, "ffn"))
    return out


class _Gathers:
    """The whole tensors gathered in a forward, by storage (weakly) and by autograd
    node, for ``saving``'s hooks."""

    def __init__(self):
        self.live: Dict[int, tuple] = {}
        self.nodes: Dict[object, tuple] = {}

    def clear(self):
        self.live.clear()
        self.nodes.clear()

    def gather(self, shard, dims, groups, reduce):
        full = gather_param(shard, dims, groups, reduce)
        self.live[full.untyped_storage().data_ptr()] = (weakref.ref(full), shard, dims, groups)
        if full.grad_fn is not None:
            self.nodes[full.grad_fn] = (shard, dims, groups)
        return full

    def _source(self, t: torch.Tensor):
        """(shard, dims, groups) of the whole parameter that ``t`` is, or is a view
        of, or whose cast (``Tensor.to`` in a module's compute dtype) ``t`` is or is a
        view of; else None."""
        if t.layout != torch.strided or t.is_nested:
            return None
        entry = self.live.get(t.untyped_storage().data_ptr())
        if entry is not None and entry[0]() is not None:
            return entry[1:]
        fn = (t if t._base is None else t._base).grad_fn
        if fn is not None and fn.name() == "ToCopyBackward0":
            return self.nodes.get(fn.next_functions[0][0])
        return None

    def pack(self, t: torch.Tensor):
        source = self._source(t)
        if source is None:
            return t
        # a whole parameter saved for backward: keep its shard and how to rebuild it
        return (*source, t.dtype, t.size(), t.stride(), t.storage_offset())

    @staticmethod
    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        shard, dims, groups, dtype, size, stride, offset = saved
        with torch.no_grad():
            full = shard.detach()
            for dim, group in zip(dims, groups):
                full = all_gather_cat(full, dim, group)
            full = full.to(dtype)
        return full.as_strided(size, stride, offset)


def _gathered_attributes(module: nn.Module, specs: Dict[str, tuple], gathers: _Gathers):
    """Give ``module`` a class whose attributes ``specs`` names (parameter -> (dims,
    groups, reduce)) read the stored shard gathered whole."""
    def getter(name):
        def get(self):
            return gathers.gather(self._parameters[name], *specs[name])
        return property(get)

    cls = type(module)
    module.__class__ = type(cls.__name__, (cls,), {n: getter(n) for n in specs})


class ShardedModel:
    """The model's parameters as shards (see the module docstring)."""

    def __init__(self, model: nn.Module, mesh, tp: bool, fsdp: bool):
        self.model, self.mesh = model, mesh
        sizes = dict(mesh.shape)
        self.full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.specs = param_specs(model, sizes, tp, fsdp)
        self.order = list(self.full_shapes)
        local: set = set()  # (param name, axis) pairs the Megatron layers use as shards
        group = mesh.group("model")
        if tp and mesh.size("model") > 1:
            for path, kind in _megatron_modules(model, mesh.size("model")):
                names = (("q_proj", "k_proj", "v_proj"), ("out_proj",)) if kind == "attention" \
                    else (("fc1",), ("fc2",))
                mod = model.get_submodule(path)
                prefix = f"{path}." if path else ""
                if not all(self.specs[f"{prefix}{c}.weight"][0] == "model" for c in names[0]) \
                        or self.specs[f"{prefix}{names[1][0]}.weight"][1] != "model":
                    continue  # the table left a dim whole: gathered instead
                for cols in names[0]:
                    lin = getattr(mod, cols)
                    setattr(mod, cols, ColumnParallelLinear(lin.weight.data, None if lin.bias is
                                                            None else lin.bias.data, group))
                    local.add((f"{prefix}{cols}.weight", "model"))
                    if lin.bias is not None:
                        local.add((f"{prefix}{cols}.bias", "model"))
                lin = getattr(mod, names[1][0])
                setattr(mod, names[1][0], RowParallelLinear(
                    lin.weight.data, None if lin.bias is None else lin.bias.data, group))
                local.add((f"{prefix}{names[1][0]}.weight", "model"))
                tp_n = mesh.size("model")
                mod.shard = (mesh.index("model"), tp_n)
                if kind == "attention":
                    mod.num_heads //= tp_n
                    mod.embed_dim //= tp_n
        # store every parameter as its shard (another pipe rank's stage as nothing); a
        # read of one split along more than its Megatron axis gathers it
        self.gathers = _Gathers()
        self.stage_owner = stage_owners(model, mesh)
        params = dict(model.named_parameters())
        owners: Dict[str, Dict[str, tuple]] = {}
        for name, spec in self.specs.items():
            if not self.holds(name):
                with torch.no_grad():
                    params[name].data = params[name].data.new_empty(0)
                continue
            if all(a is None for a in spec):
                continue
            p = params[name]
            with torch.no_grad():
                p.data = _slice(p.data, spec, mesh).contiguous()
            dims = [d for d, a in enumerate(spec) if a is not None and (name, a) not in local]
            if dims:
                path, _, attr = name.rpartition(".")
                owners.setdefault(path, {})[attr] = (
                    tuple(dims), tuple(mesh.group(spec[d]) for d in dims),
                    tuple(spec[d] == "data" for d in dims))
        for path, specs in owners.items():
            _gathered_attributes(model.get_submodule(path), specs, self.gathers)

    def holds(self, name: str) -> bool:
        """Whether this rank holds parameter ``name`` (not another pipe rank's stage)."""
        return self.stage_owner.get(name, self.mesh.index("pipe")) == self.mesh.index("pipe")

    def reduced(self, name: str) -> Tuple[str, ...]:
        """The axes whose sum of the gradients of ``name`` the Trainer skips: "data"
        when FSDP's gather summed it, "pipe" for a stage (whole on its owner)."""
        return (("data",) if "data" in self.specs[name] else ()) + \
            (("pipe",) if name in self.stage_owner else ())

    @contextlib.contextmanager
    def saving(self):
        """A forward whose autograd graph keeps shards of the gathered parameters."""
        self.gathers.clear()
        with torch.autograd.graph.saved_tensors_hooks(self.gathers.pack, self.gathers.unpack):
            yield

    def quant_noise_shards(self):
        """name -> (whole shape, whole mask -> this rank's part) of every sharded
        parameter: its quant-noise mask is drawn whole and sliced."""
        return {n: (torch.Size(self.full_shapes[n]), lambda m, n=n: self.local(n, m))
                for n, spec in self.specs.items()
                if any(a is not None for a in spec) or n in self.stage_owner}

    def shard_axes(self, name: str) -> Tuple[str, ...]:
        """The axes over which the parameter's elements are split (the norm's sums)."""
        axes = {a for a in self.specs[name] if a is not None}
        return tuple(sorted(axes | ({"pipe"} if name in self.stage_owner else set())))

    @torch.no_grad()
    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole of a tensor laid out as parameter ``name``'s part: its shards
        gathered, a stage's broadcast from the pipe rank that holds it."""
        if self.holds(name):
            for dim, axis in enumerate(self.specs[name]):
                if axis is not None:
                    local = all_gather_cat(local, dim, self.mesh.group(axis))
        if name in self.stage_owner:
            if not self.holds(name):
                local = local.new_empty(self.full_shapes[name])
            dist.broadcast(local, src=self.mesh.ranks("pipe")[self.stage_owner[name]],
                           group=self.mesh.group("pipe"))
        return local

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        if not self.holds(name):
            return full.new_empty(0)
        return _slice(full, self.specs[name], self.mesh).contiguous()

    def full_state(self) -> Dict[str, torch.Tensor]:
        params = dict(self.model.named_parameters())
        return {n: self.full(n, params[n].detach()) for n in self.order}

    def full_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat buffer over the local parameters (an optimizer moment) -> over the
        whole ones, in the model's parameter order."""
        params = dict(self.model.named_parameters())
        parts = flat.split([params[n].numel() for n in self.order])
        return torch.cat([self.full(n, part.view(params[n].shape)).reshape(-1)
                          for n, part in zip(self.order, parts)])

    def local_flat(self, flat: torch.Tensor) -> torch.Tensor:
        sizes = [int(torch.Size(self.full_shapes[n]).numel()) for n in self.order]
        return torch.cat([self.local(n, part.view(self.full_shapes[n])).reshape(-1)
                          for n, part in zip(self.order, flat.split(sizes))])


def shard_model(model: nn.Module, mesh, tp: bool, fsdp: bool) -> Optional[ShardedModel]:
    """Shard ``model`` in place over ``mesh`` (None when nothing is split)."""
    if not ((tp and mesh.size("model") > 1) or (fsdp and mesh.size("data") > 1)
            or stage_owners(model, mesh)):
        return None
    return ShardedModel(model, mesh, tp, fsdp)


def sharded_norm(names: List[str], sizes: List[int], sharded: ShardedModel):
    """The global gradient norm over a flat buffer of local gradients: float64 squared
    sums, one a set of shard axes, each summed over its axes' groups, added in one
    order on every rank, so every rank reads the same norm."""
    from s2t_tpu_torch.parallel.collectives import all_reduce_

    keys = [sharded.shard_axes(n) for n in names]
    order = sorted(set(keys))
    index = {key: torch.tensor([i for i, k in enumerate(keys) if k == key]) for key in order}

    def norm(g: torch.Tensor) -> torch.Tensor:
        sq = torch.stack([part.double().square().sum() for part in g.split(sizes)])
        total = torch.zeros((), dtype=torch.float64, device=g.device)
        for key in order:
            s = sq[index[key].to(g.device)].sum()
            for axis in key:
                all_reduce_(s, sharded.mesh.group(axis))
            total = total + s
        return total.sqrt().float()

    return norm
