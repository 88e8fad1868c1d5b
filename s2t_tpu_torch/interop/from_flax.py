"""Carry a JAX model's ``.init(...)["params"]`` tree (``S2TTransformerModel``,
``PDSS2TTransformerModel``, ``S2TSATEModel``, ``S2TCTCModel``, ``TransformerLM``, the
wav2vec models, ``BerardModel``, ``EmformerModel``, the text ``TransformerModel``,
``FConvModel``, the NAT models, ``BARTModel``, the LSTM models, ``LightConvModel``, ...)
into the port.

The tree arrives as nested mappings of numpy arrays (``jax.tree.map(np.asarray,
params)``); no jax is imported here.  Layouts:

    Dense      kernel (in, out)      -> Linear weight (out, in)
    Conv       kernel (k, in, out)   -> Conv1d weight (out, in, k); the conv
                                        module's depthwise (k, 1, D) -> (D, 1, k)
    Conv 2-D   kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
    LayerNorm  scale / bias          -> weight / bias
    Embed      embedding             -> weight

Module names follow the port: ``layer{i}`` -> ``layers.{i}``, ``conv{i}`` ->
``convs.{i}``, the CTC research stack's per-layer modules ``inter_ctc_head{l}``,
``inter_ctc_norm{l}``, ``inter_xctc_norm{l}``, ``inter_axctc_norm{l}``,
``compression_norm{l}`` and ``layer_out_norm{i}`` -> ``inter_ctc_heads.{l}``,
... ``layer_out_norms.{i}``, the PDS encoder's ``stage{i}_layer{j}`` -> ``stages.{i}.{j}``,
``ds{i}`` -> ``downsamplers.{i}``, ``fusion{i}`` -> ``fusion_blocks.{i}``,
``final_layer{j}`` -> ``final_layers.{j}`` and its stage taps ``ctc_norm{i}``,
``xctc_norm{i}``, ``pae{i}`` and ``ctc{i}`` -> ``ctc_norms.{i}``, ``xctc_norms.{i}``,
``paes.{i}`` and ``ctc_heads.{i}``, the pipelined encoder's ``pipe_stages`` (every leaf
stacked on a leading stage axis S) -> ``pipe_stages.{s}``, one stage a module (its
``layer{j}`` -> ``layers.{j}``), and the tied ``shared_embed`` table -> the
decoder's ``embed_tokens``, as is an LM's adaptive input ``adaptive_embed`` (its
``embed{k}`` tables and ``proj{k}`` kernels, like the adaptive softmax's ``head``,
``proj{k}`` and ``tail{k}``, keep their names); the other names (``encoder/embed_norm``,
``encoder/ctc_head`` with its ``norm``, ``encoder/pae``, ``encoder/xctc_head``,
``encoder/xpae``, ``encoder/axctc_head``, ``encoder/inter_ctc_head``,
``encoder/inter_xctc_head``, SATE's ``encoder/acoustic``, ``encoder/adapter`` and
``encoder/textual`` with its ``cross_attn_norm`` and a cross-stream layer's
``s2_attn`` and ``cross_norm``, a Conformer layer's ``macaron_ffn`` and
``conv_module``, ...) are the port's attribute paths.  The bare leaves ``norm_scale``,
``norm_bias`` (a frozen per-channel affine), ``fusion_weight``, ``pos_bias_u``,
``pos_bias_v``, ``embed_adapter``, Shaw attention's ``relative_position_keys``, the
Gaussian attention's ``gauss_sigma`` / ``gauss_mask_weight``, DLCL's ``weights`` and
a lightweight conv's (H, k) ``weight`` keep their names, as do wav2vec's
``step_proj``, ``step_bias``, ``gn_scale`` and ``gn_bias``; DLCL's, the Conv1d
subsampler's and wav2vec's ``norm{i}`` -> ``norms.{i}``.  Berard: ``input{i}`` ->
``inputs.{i}``, ``blstm{i}_fwd`` / ``blstm{i}_bwd`` -> ``blstms.{i}.fwd`` / ``.bwd``,
an LSTM's ``kernel_ih`` / ``kernel_hh`` -> ``weight_ih`` / ``weight_hh`` transposed
(its ``bias`` kept), the decoder's ``cell{i}_<leaf>`` -> ``cells.{i}.<leaf>``;
wav2vec: ``rproj{i}`` -> ``rprojs.{i}``, the k-means quantizer's (V, G, d)
``embedding`` -> ``codebook``.  fconv: ``conv{i}`` (the unfolded-window kernel),
``res{i}``, ``attn_q{i}``, ``attn_o{i}`` -> ``convs.{i}``, ``ress.{i}``,
``attn_qs.{i}``, ``attn_os.{i}``; the NAT models' ``length_head``, ``del_head``,
``ins_head``, ``slot_proj`` and the CRF's ``crf/e1`` / ``crf/e2`` tables keep their
names.  BART: the top-level ``shared`` table -> the decoder's ``embed_tokens`` (the
encoder borrows it).  The LSTM models: ``enc_fw{i}``, ``enc_bw{i}``, ``dec{i}``,
``lstm{i}`` -> ``enc_fws.{i}``, ``enc_bws.{i}``, ``decs.{i}``, ``lstms.{i}``, each flax
``OptimizedLSTMCell``'s gate Denses (``ii`` ... ``io`` kernels, ``hi`` ... ``ho``
kernels and biases) fused into Berard's ``weight_ih`` / ``weight_hh`` / ``bias`` in the
gate order i, f, g, o and split back; ``src_embed`` / ``tgt_embed`` are tables.  The
conv models: ``enc{i}`` / ``dec{i}`` -> ``encs.{i}`` / ``decs.{i}``.  The multilingual
Transformer has no module ``decoder``: its ``encoder_{lang}``, ``encoder_shared``,
``decoder_{lang}``, ``decoder_shared`` and top-level tables ``shared_embed``,
``shared_encoder_embed`` and ``shared_decoder_embed`` keep their names (a top-level
table goes to the decoder's ``embed_tokens`` only in a tree with a ``decoder``).
RoBERTa's ``embed_tokens``, ``embed_positions``, ``embed_segments``, ``emb_norm``,
``lm_dense``, ``lm_norm``, ``cls_dense``, ``cls_out`` and its bare ``lm_bias`` keep
theirs; GPT-2 is one ``decoder``.  Any leaf left unmapped on either side raises.

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

# the CTC research stack's per-layer modules: flax ``<name>{l}`` -> the port's ``<name>s.{l}``
# and the PDS stage taps' ``ctc_norm{i}`` / ``xctc_norm{i}`` / ``pae{i}``
_PER_LAYER = "inter_ctc_head|inter_ctc_norm|inter_xctc_norm|inter_axctc_norm|compression_norm|" \
    "layer_out_norm|ctc_norm|xctc_norm|pae"
# flax module name -> the port's module path, and back (on the dotted port path)
_TO_PORT = ((re.compile(rf"^({_PER_LAYER})(\d+)$"), r"\1s.\2"),
            (re.compile(r"^norm(\d+)$"), r"norms.\1"),
            (re.compile(r"^stage(\d+)_layer(\d+)$"), r"stages.\1.\2"),
            (re.compile(r"^ds(\d+)$"), r"downsamplers.\1"),
            (re.compile(r"^fusion(\d+)$"), r"fusion_blocks.\1"),
            (re.compile(r"^final_layer(\d+)$"), r"final_layers.\1"),
            (re.compile(r"^ctc(\d+)$"), r"ctc_heads.\1"),
            (re.compile(r"^(senior|textual)(\d+)$"), r"\1_stack.\2"),
            (re.compile(r"^blstm(\d+)_(fwd|bwd)$"), r"blstms.\1.\2"),
            (re.compile(r"^(layer|conv|input|rproj|res|attn_q|attn_o|enc|dec|enc_fw|enc_bw|lstm)(\d+)$"), r"\1s.\2"))
_TO_FLAX = ((re.compile(r"\bpipe_stages\.\d+\."), "pipe_stages."),
            (re.compile(rf"\b({_PER_LAYER})s\.(\d+)\b"), r"\1\2"),
            (re.compile(r"\bnorms\.(\d+)\b"), r"norm\1"),
            (re.compile(r"\bstages\.(\d+)\.(\d+)\b"), r"stage\1_layer\2"),
            (re.compile(r"\bdownsamplers\.(\d+)\b"), r"ds\1"),
            (re.compile(r"\bfusion_blocks\.(\d+)\b"), r"fusion\1"),
            (re.compile(r"\bfinal_layers\.(\d+)\b"), r"final_layer\1"),
            (re.compile(r"\bctc_heads\.(\d+)\b"), r"ctc\1"),
            (re.compile(r"\b(senior|textual)_stack\.(\d+)\b"), r"\1\2"),
            (re.compile(r"\bblstms\.(\d+)\.(fwd|bwd)\b"), r"blstm\1_\2"),
            (re.compile(r"\b(layer|conv|input|rproj|res|attn_q|attn_o|enc|dec|enc_fw|enc_bw|lstm)s\.(\d+)\b"), r"\1\2"))
# parameters that are leaves of their own, with the same name on both sides
_BARE = frozenset({"norm_scale", "norm_bias", "fusion_weight", "pos_bias_u", "pos_bias_v",
                   "embed_adapter", "relative_position_keys", "gauss_sigma",
                   "gauss_mask_weight", "weights", "mask_emb", "vars", "step_proj",
                   "step_bias", "gn_scale", "gn_bias", "lm_bias", "symbol_embeddings"})
# an LSTM's kernels (Berard's): flax ``kernel_ih`` (D, 4H) / ``kernel_hh`` (H, 4H) <->
# ``weight_ih`` / ``weight_hh``, transposed; a decoder cell's leaves ``cell{i}_<leaf>``
# <-> the module ``cells.{i}``
_LSTM_KERNELS = {"kernel_ih": "weight_ih", "kernel_hh": "weight_hh"}
_LSTM_WEIGHTS = {v: k for k, v in _LSTM_KERNELS.items()}
_CELL_LEAF = re.compile(r"^cell(\d+)_(kernel_ih|kernel_hh|bias)$")
# the LSTM models' flax OptimizedLSTMCells: one Dense a gate, ``ii`` ... ``io`` over the
# input and ``hi`` ... ``ho`` (with the bias) over the state <-> Berard's fused layout
_GATED_CELL = re.compile(r"^(enc_fw|enc_bw|dec|lstm)\d+$")
_GATE = re.compile(r"^[ih][ifgo]$")
_FUSED = {"kernel_ih": ("i", "kernel"), "kernel_hh": ("h", "kernel"), "bias": ("h", "bias")}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _fuse_gates(flat: Dict[tuple, np.ndarray]) -> Dict[tuple, np.ndarray]:
    """An OptimizedLSTMCell's eight gate Denses -> ``kernel_ih`` (D, 4H), ``kernel_hh``
    (H, 4H) and ``bias`` (4H), gates in the order i, f, g, o."""
    out, cells = {}, {}
    for path, arr in flat.items():
        if len(path) >= 3 and _GATED_CELL.match(path[-3]) and _GATE.match(path[-2]):
            cells.setdefault(path[:-2], {})[path[-2:]] = arr
        else:
            out[path] = arr
    for cell, leaves in cells.items():
        for fused, (side, leaf) in _FUSED.items():
            out[(*cell, fused)] = np.concatenate([leaves[(side + g, leaf)] for g in "ifgo"],
                                                 axis=-1)
    return out


def _module_path(parts, has_decoder: bool = True) -> str:
    if has_decoder and parts[:1] in (("shared_embed",), ("shared",), ("adaptive_embed",)):
        parts = ("decoder", "embed_tokens", *parts[1:])
    return ".".join(next((pat.sub(repl, p) for pat, repl in _TO_PORT if pat.match(p)), p)
                    for p in parts)


def _leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 3:
            return "weight", arr.transpose(2, 1, 0)
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim} has no port layout")
    if name in _LSTM_KERNELS:
        return _LSTM_KERNELS[name], arr.T
    if name == "embedding" and arr.ndim == 3:  # the k-means quantizer's (V, G, d) codebook
        return "codebook", arr
    if name in ("scale", "embedding"):
        return "weight", arr
    if name in ("bias", "weight", *_BARE):  # "weight": a lightweight conv's (H, k) kernel
        return name, arr
    raise KeyError(name)


def _unstack_stages(flat: Dict[tuple, np.ndarray]) -> Dict[tuple, np.ndarray]:
    """The pipelined encoder's ``pipe_stages`` leaves, stacked on a leading stage axis
    S in flax, as S leaves ``pipe_stages/{s}/...``."""
    out = {}
    for path, arr in flat.items():
        if "pipe_stages" in path:
            i = path.index("pipe_stages") + 1
            for s_idx in range(arr.shape[0]):
                out[(*path[:i], str(s_idx), *path[i:])] = arr[s_idx]
        else:
            out[path] = arr
    return out


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Rename and re-layout every leaf; raises on a leaf it cannot map."""
    sd, unmapped = {}, []
    has_decoder = "decoder" in params
    for path, arr in _unstack_stages(_fuse_gates(_flatten(params))).items():
        cell = _CELL_LEAF.match(path[-1])
        if cell:
            path = (*path[:-1], f"cells.{cell.group(1)}", cell.group(2))
        try:
            name, val = _leaf(path[-1], arr)
        except KeyError:
            unmapped.append("/".join(path))
            continue
        module = _module_path(path[:-1], has_decoder)
        sd[f"{module}.{name}" if module else name] = torch.from_numpy(np.array(val))
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


def _flax_module_path(name: str, shared_embed) -> tuple:
    if not name:  # a parameter of the model itself (wav2vec 2.0's mask_emb)
        return ()
    if name == "decoder.embed_tokens" and shared_embed:
        return ("shared_embed" if shared_embed is True else shared_embed,)
    if name.startswith("decoder.embed_tokens."):  # an LM's adaptive input
        return ("adaptive_embed", *name.split(".")[2:])
    for pattern, repl in _TO_FLAX:
        name = pattern.sub(repl, name)
    return tuple(name.split("."))


def _flax_leaf(module: str, name: str, arr: np.ndarray):
    if name in ("bias", *_BARE):
        return name, arr
    if name in _LSTM_WEIGHTS:
        return _LSTM_WEIGHTS[name], arr.T
    if name == "codebook":
        return "embedding", arr
    if name != "weight":
        raise KeyError(name)
    if re.search(r"(embed_tokens|embed_positions|embed_segments|embed\d+|crf\.e[12]|char_embeddings|"
                 r"^(src|tgt)_embed|^shared(_encoder|_decoder)?_embed)$", module):
        return "embedding", arr
    if module.endswith(".conv") and arr.ndim == 2:  # a lightweight conv's (H, k) kernel
        return "weight", arr
    if arr.ndim == 1:
        return "scale", arr
    if arr.ndim == 2:
        return "kernel", arr.T
    if arr.ndim == 3:
        return "kernel", arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return "kernel", arr.transpose(2, 3, 1, 0)
    raise KeyError(name)


def flax_path(key: str, ndim: int, shared_embed=False) -> tuple:
    """The flax path (module parts, then the leaf name) of the port parameter
    ``key`` of rank ``ndim``, without its values."""
    module, _, name = key.rpartition(".")
    leaf, _ = _flax_leaf(module, name, np.empty((0,) * ndim))
    return (*_flax_module_path(module, shared_embed), leaf)


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor], shared_embed=False) -> Dict:
    """Port state dict -> nested flax params of float32 numpy arrays.
    ``shared_embed``: the decoder's table is a top-level one in flax, named
    ``shared_embed`` (True: a CTC head tied to it, ``share_ctc_and_embed``) or the
    name given (BART's ``"shared"``).  Raises on a leaf it cannot map."""
    tree: Dict = {}
    unmapped = []
    stages: Dict = {}  # (flax path) -> {stage: array}: stacked on a leading axis below
    for key, val in state_dict.items():
        module, _, name = key.rpartition(".")
        arr = val.detach().float().cpu().numpy()
        stage = re.search(r"\bpipe_stages\.(\d+)\.", key)
        if stage:
            try:
                leaf, out = _flax_leaf(module, name, arr)
            except KeyError:
                unmapped.append(key)
                continue
            path = (*_flax_module_path(module, shared_embed), leaf)
            stages.setdefault(path, {})[int(stage.group(1))] = out
            continue
        try:
            leaf, out = _flax_leaf(module, name, arr)
        except KeyError:
            unmapped.append(key)
            continue
        parts = _flax_module_path(module, shared_embed)
        if len(parts) >= 2 and parts[-2] == "cells":  # a decoder cell's leaves
            parts, leaf = parts[:-2], f"cell{parts[-1]}_{leaf}"
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        if parts and _GATED_CELL.match(parts[-1]) and leaf in _FUSED:  # split by gate
            side, name = _FUSED[leaf]
            for g, part in zip("ifgo", np.split(out, 4, axis=-1)):
                node.setdefault(side + g, {})[name] = np.array(part)
            continue
        node[leaf] = np.array(out)
    for path, by_stage in stages.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.stack([by_stage[i] for i in sorted(by_stage)])
    if unmapped:
        raise KeyError(f"port parameters with no flax counterpart: {unmapped}")
    return tree
