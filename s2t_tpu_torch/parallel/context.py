"""Scoped mesh context (counterpart of s2t_tpu/parallel/context.py).

Model code does not carry the mesh; the Trainer activates it around its forwards with
``use_mesh`` so that the pipelined encoder and the sequence-parallel layers find their
process groups, and a model run outside any Trainer sees no mesh.  The mesh lives in a
``contextvars.ContextVar``, as in JAX, so a thread never sees another's.

``ring_scope`` marks the stretch of the encoder whose activations are split over time
(``seq_parallel``): inside it an encoder self-attention over a pure padding mask runs
``ring_attention``; the decoder and everything after the stack run outside it.

JAX's ``constrain``, ``suppress_constraint_axes`` and ``conv_grad_guard`` are not here:
they hint XLA's partitioner at a layout, or pin one around an XLA fault, and eager
PyTorch has no partitioner.  Their places are taken by the explicit gathers and slices
of ``parallel/collectives.py`` (ROADMAP.md section 3).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar("s2t_tpu_torch_mesh",
                                                               default=None)
_RING: contextvars.ContextVar = contextvars.ContextVar("s2t_tpu_torch_ring", default=False)


@contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the calls made inside the block."""
    token = _CURRENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT_MESH.reset(token)


def get_mesh():
    return _CURRENT_MESH.get()


def seq_parallel_enabled() -> bool:
    m = _CURRENT_MESH.get()
    return m is not None and m.size("seq") > 1


@contextmanager
def ring_scope(active: bool = True):
    """Encoder self-attention inside the block attends through the "seq" ring."""
    token = _RING.set(active)
    try:
        yield
    finally:
        _RING.reset(token)


def ring_active() -> bool:
    return _RING.get() and seq_parallel_enabled()
