"""Every attention head dim the recipes use is one the port's kernels take.

The attention stacks of every ``egs/**/*.yaml``: the config its ``arch``
preset builds with its ``model`` section (the JAX package resolves each, so
the fields a recipe leaves out take their preset's values), and from it each
(embed dim, heads) pair: the encoder's (``encoder_embed_dim`` /
``encoder_attention_heads``) or, for a PDS encoder, each stage's
(``pds_embed_dims`` / ``pds_attn_heads``) and its final layers' (the
encoder dim over the last stage's heads), and the decoder's when it has
layers.  Each head dim divides evenly, is at most 128 and passes the
wrapper's checks in bf16 and f32 on the (B, T, H D) projection layout: on
``meta`` tensors only "not CUDA tensors" stops it.  A head dim above 128
and T >= 65536 still raise by name.
"""

import dataclasses
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

from s2t_tpu_torch.ops import _build, attention_cuda
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

EGS = Path(__file__).resolve().parent.parent / "egs"


def attention_pairs(cfg):
    """(embed dim, heads) of each attention stack a JAX model config builds,
    nested configs (a SATE model's acoustic encoder) included."""
    pairs = []
    for f in dataclasses.fields(cfg):
        sub = getattr(cfg, f.name)
        if dataclasses.is_dataclass(sub):
            pairs += attention_pairs(sub)
    stages = tuple(getattr(cfg, "pds_embed_dims", ()) or ())
    if stages:
        heads = tuple(cfg.pds_attn_heads)
        pairs += list(zip(stages, heads))
        if getattr(cfg, "pds_final_layers", 0) > 0:
            pairs.append((cfg.encoder_embed_dim, heads[-1]))
    elif hasattr(cfg, "encoder_attention_heads"):
        pairs.append((cfg.encoder_embed_dim, cfg.encoder_attention_heads))
    if getattr(cfg, "decoder_layers", 0) > 0 and hasattr(cfg, "decoder_attention_heads"):
        pairs.append((cfg.decoder_embed_dim, cfg.decoder_attention_heads))
    return pairs


def recipe_head_dims():
    yaml = pytest.importorskip("yaml")
    import s2t_tpu.models as jax_models
    from s2t_tpu.registry import ARCHS

    for mod in pkgutil.iter_modules(jax_models.__path__):  # every preset registers
        importlib.import_module(f"s2t_tpu.models.{mod.name}")
    dims = {}
    for path in sorted(EGS.glob("**/*.yaml")):
        conf = yaml.safe_load(path.read_text()) or {}
        if not conf.get("arch"):
            continue
        _, preset = ARCHS.get(conf["arch"])
        model = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in (conf.get("model") or {}).items()}
        for dim, heads in attention_pairs(preset(**model)):
            assert dim % heads == 0, f"{path}: {dim} / {heads}"
            dims.setdefault(dim // heads, []).append(path.name)
    return dims


def test_every_recipe_head_dim_passes_the_wrapper(monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda *_a, **_k: None)
    dims = recipe_head_dims()
    # the recipes' head dims, the instantiated ones and those padded up to one
    assert {30, 40, 42, 44, 45, 48, 50, 56, 60, 64, 80, 90, 96, 128} <= set(dims)
    assert max(dims) <= attention_cuda.MAX_HEAD_DIM, {d: dims[d] for d in dims if d > 128}
    for D in sorted(dims):
        for dtype in (torch.bfloat16, torch.float32):
            proj = torch.empty((2, 8, 4 * D), device="meta", dtype=dtype).view(2, 8, 4, D)
            mask = torch.ones((2, 8), dtype=torch.bool, device="meta")
            with pytest.raises(ValueError, match="CUDA tensors"):
                attention_cuda.fused_attention(proj, proj, proj, mask)


def test_head_dim_above_128_and_long_sequences_raise_by_name(monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda *_a, **_k: None)
    mask = torch.ones((1, 8), dtype=torch.bool, device="meta")
    wide = torch.empty((1, 8, 2, 160), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 160"):
        attention_cuda.fused_attention(wide, wide, wide, mask)
    T = attention_cuda.MAX_T
    long = torch.empty((1, T, 1, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"T={T}"):
        attention_cuda.fused_attention(long, long, long,
                                       torch.ones((1, T), dtype=torch.bool, device="meta"))
    assert attention_cuda.PADDED_HEAD_DIMS == (32, 48, 64, 80, 96, 112, 128)
