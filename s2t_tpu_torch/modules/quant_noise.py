"""Quantization-noise training for iterative product quantization (counterpart
of s2t_tpu/modules/quant_noise.py).

Each training step drops contiguous ``block_size``-wide blocks of input features
of every dense kernel and token embedding with probability p and rescales the
survivors by 1 / (1 - p).  The forward and backward see the noised weights, the
optimizer updates the un-noised ones, and a dropped block gets zero gradient
that step (s2t_tpu/trainer.py:282-291).

A parameter is noised when its flax counterpart (``interop/from_flax.py``'s
name map) is a 2-D ``kernel`` (flax (in, out), the port's (out, in)) or an
``embedding`` (vocab, dim) whose blocked axis is a multiple of ``block_size``:
in the port's layout the blocked axis is 1 for both.  Biases, norms and conv
kernels pass through.  The masks are drawn from a ``torch.Generator`` (JAX
draws them from its step key, so the bits differ by design); ``masks`` hands
a set over, keyed by the port's parameter name, in the port's layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from s2t_tpu_torch.interop.from_flax import flax_path


def blocked_axis(name: str, shape) -> Optional[int]:
    """1 when the parameter ``name`` of ``shape`` takes quant noise, else None."""
    if len(shape) != 2:
        return None
    return 1 if flax_path(name, 2)[-1] in ("kernel", "embedding") else None


def draw_masks(params: Dict[str, torch.Tensor], p: float, block_size: int,
               generator: torch.Generator, shards: Optional[Dict[str, Tuple]] = None
               ) -> Dict[str, torch.Tensor]:
    """One Bernoulli(p) drop mask per eligible parameter, block-repeated along axis 1.
    ``shards``: name -> (whole shape, whole mask -> this rank's slice) of a parameter
    held as a tensor-parallel shard, whose mask is drawn whole and sliced."""
    masks = {}
    for name, w in params.items():
        shape, take = (shards or {}).get(name, (w.shape, None))
        if blocked_axis(name, shape) is None or shape[1] % block_size:
            continue
        draw = torch.rand((shape[0], shape[1] // block_size), generator=generator,
                          device=w.device) < p
        mask = draw.repeat_interleave(block_size, dim=1)
        masks[name] = mask if take is None else take(mask)
    return masks


def quant_noise_params(params: Dict[str, torch.Tensor], p: float, block_size: int = 8,
                       generator: Optional[torch.Generator] = None,
                       masks: Optional[Dict[str, torch.Tensor]] = None,
                       shards: Optional[Dict[str, Tuple]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The noised copies of the eligible entries of ``params`` (name -> tensor);
    the gradient flows back to the originals through the mask."""
    if p <= 0.0:
        return {}
    if masks is None:
        masks = draw_masks(params, p, block_size, generator, shards)
    scale = 1.0 / (1.0 - p)
    return {name: torch.where(mask, 0.0, params[name] * scale)
            for name, mask in masks.items()}
