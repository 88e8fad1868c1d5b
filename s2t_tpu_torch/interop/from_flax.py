"""Carry a JAX ``S2TTransformerModel.init(...)["params"]`` tree into the port.

The tree arrives as nested mappings of numpy arrays (``jax.tree.map(np.asarray,
params)``); no jax is imported here.  Layouts:

    Dense      kernel (in, out)      -> Linear weight (out, in)
    Conv       kernel (k, in, out)   -> Conv1d weight (out, in, k)
    LayerNorm  scale / bias          -> weight / bias
    Embed      embedding             -> weight

Module names follow the port: ``layer{i}`` -> ``layers.{i}``, ``conv{i}`` ->
``convs.{i}``, and the tied ``shared_embed`` table -> the decoder's
``embed_tokens``.  Any leaf left unmapped on either side raises.

``state_dict_to_flax`` is the inverse: a port state dict (after training,
say) as the nested flax tree, so it can be compared leaf by leaf with a JAX
``TrainState.params``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(layer|conv)(\d+)$")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _module_path(parts) -> str:
    if parts == ("shared_embed",):
        return "decoder.embed_tokens"
    names = []
    for p in parts:
        m = _INDEXED.match(p)
        names.append(f"{m.group(1)}s.{m.group(2)}" if m else p)
    return ".".join(names)


def _leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            return "weight", arr.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {arr.ndim} has no port layout")
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise KeyError(name)


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Rename and re-layout every leaf; raises on a leaf it cannot map."""
    sd, unmapped = {}, []
    for path, arr in _flatten(params).items():
        try:
            name, val = _leaf(path[-1], arr)
        except KeyError:
            unmapped.append("/".join(path))
            continue
        sd[f"{_module_path(path[:-1])}.{name}"] = torch.from_numpy(np.array(val))
    if unmapped:
        raise KeyError(f"flax leaves with no port counterpart: {unmapped}")
    return sd


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load the JAX tree into ``model`` (in its device and dtype).  Every
    port parameter must be covered and every JAX leaf used, with equal shapes."""
    sd = flax_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"from_flax: port params not in the JAX tree {missing}; "
                       f"JAX leaves not in the port {extra}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError("from_flax: shape mismatch " + ", ".join(
            f"{k} port {tuple(own[k].shape)} vs JAX {tuple(sd[k].shape)}" for k in bad))
    model.load_state_dict(sd, strict=True)
    return model


def _flax_module_path(name: str, shared_embed: bool) -> tuple:
    if name == "decoder.embed_tokens" and shared_embed:
        return ("shared_embed",)
    return tuple(re.sub(r"\b(layer|conv)s\.(\d+)\b", r"\1\2", name).split("."))


def _flax_leaf(module: str, name: str, arr: np.ndarray):
    if name == "bias":
        return "bias", arr
    if name != "weight":
        raise KeyError(name)
    if module.endswith("embed_tokens"):
        return "embedding", arr
    if arr.ndim == 1:
        return "scale", arr
    if arr.ndim == 2:
        return "kernel", arr.T
    if arr.ndim == 3:
        return "kernel", arr.transpose(2, 1, 0)
    raise KeyError(name)


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       shared_embed: bool = False) -> Dict:
    """Port state dict -> nested flax params of float32 numpy arrays.
    ``shared_embed``: the model ties its CTC head to the decoder embedding
    (``share_ctc_and_embed``), which flax keeps as a top-level
    ``shared_embed`` table.  Raises on a leaf it cannot map."""
    tree: Dict = {}
    unmapped = []
    for key, val in state_dict.items():
        module, _, name = key.rpartition(".")
        arr = val.detach().float().cpu().numpy()
        try:
            leaf, out = _flax_leaf(module, name, arr)
        except KeyError:
            unmapped.append(key)
            continue
        node = tree
        for part in _flax_module_path(module, shared_embed):
            node = node.setdefault(part, {})
        node[leaf] = np.array(out)
    if unmapped:
        raise KeyError(f"port parameters with no flax counterpart: {unmapped}")
    return tree
