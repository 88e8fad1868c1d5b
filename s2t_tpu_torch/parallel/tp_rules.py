"""Tensor-parallel / FSDP parameter placement rules (counterpart of
s2t_tpu/parallel/tp_rules.py).

The JAX rule table, by flax path and flax shape: column-parallel (the output dim over
"model") for q / k / v projections, FFN fc1, the conv module's pointwise-in and the
relative attention's pos_proj; row-parallel (the input dim over "model") for the
attention out_proj, fc2 and pointwise-out; embeddings over their feature dim; a dim
that "model" does not divide stays whole; FSDP puts "data" on the largest dim still
whole that it divides.  Stacked pipeline stages carry "pipe" on their leading axis.

``spec_for`` is the table itself (held to JAX's ``_spec_for`` in the tests);
``param_specs`` reads it for every parameter of a port model through
``interop/from_flax.flax_path`` and turns each flax spec into the port's layout (a
flax Dense kernel (in, out) is a torch weight (out, in), and so on).  The port's
stage weights are per-stage tensors held on every pipe rank, so "pipe" never appears
in a port spec.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1", "pointwise_conv1", "pos_proj")
ROW_PARALLEL = ("out_proj", "fc2", "pointwise_conv2")


def spec_for(path: Tuple[str, ...], shape, sizes: Dict[str, int], tp: bool,
             fsdp: bool) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dim of the flax leaf at ``path`` (s2t_tpu/parallel/
    tp_rules.py:25-63); ``sizes``: the mesh's axis sizes."""
    dims = [None] * len(shape)
    tp_size = sizes.get("model", 1)
    dp_size = sizes.get("data", 1)
    parent = path[-2] if len(path) >= 2 else ""
    leafname = path[-1]
    pp = "pipe_stages" in path and sizes.get("pipe", 1) > 1 and len(shape) >= 1
    off = 0
    if pp:
        dims[0] = "pipe"
        off = 1
    if tp and tp_size > 1 and len(shape) >= 1 + off:
        if leafname == "kernel" and len(shape) == 2 + off:
            if parent in COLUMN_PARALLEL and shape[1 + off] % tp_size == 0:
                dims[1 + off] = "model"
            elif parent in ROW_PARALLEL and shape[off] % tp_size == 0:
                dims[off] = "model"
        elif leafname == "bias" and parent in COLUMN_PARALLEL and len(shape) == 1 + off \
                and shape[off] % tp_size == 0:
            dims[off] = "model"
        elif leafname == "embedding" and len(shape) == 2 + off and shape[1 + off] % tp_size == 0:
            dims[1 + off] = "model"
    if fsdp and dp_size > 1:
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if dims[i] is None and shape[i] % dp_size == 0 and shape[i] >= dp_size:
                dims[i] = "data"
                break
    return tuple(dims)


def _flax_layout(name: str, shape: Tuple[int, ...], shared) -> Tuple[tuple, tuple, tuple]:
    """(flax path, flax shape, perm) of a port parameter: flax dim j is port dim
    perm[j].  The port's pipe stages ``pipe_stages.{s}`` stand for flax's stacked
    ``pipe_stages`` without the stage axis."""
    from s2t_tpu_torch.interop.from_flax import _flax_leaf, flax_path

    path = flax_path(name, len(shape), shared)
    # distinct dummy sizes show how the layout permutes the dims
    probe = tuple(range(2, 2 + len(shape)))
    _, arr = _flax_leaf(name.rpartition(".")[0], name.rpartition(".")[2],
                        np.empty(probe, dtype=np.float32))
    perm = tuple(probe.index(s) for s in arr.shape)
    return path, tuple(shape[i] for i in perm), perm


def param_specs(model, sizes: Dict[str, int], tp: bool, fsdp: bool
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Port parameter name -> the mesh axis of each of its (port-layout) dims."""
    cfg = getattr(model, "cfg", None)
    shared = bool(getattr(cfg, "share_ctc_and_embed", False))
    n_stages = int(getattr(cfg, "pipeline_parallel", 1) or 1)
    out = {}
    for name, p in model.named_parameters():
        path, fshape, perm = _flax_layout(name, tuple(p.shape), shared)
        stacked = "pipe_stages" in path
        if stacked:  # the table sees the stacked leaf; the port holds one stage of it
            fspec = spec_for(path, (n_stages,) + fshape, sizes, tp, fsdp)[1:]
        else:
            fspec = spec_for(path, fshape, sizes, tp, fsdp)
        spec = [None] * p.dim()
        for j, axis in enumerate(fspec):
            spec[perm[j]] = axis
        out[name] = tuple(spec)
    return out
