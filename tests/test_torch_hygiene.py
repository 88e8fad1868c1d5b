"""Boundaries of the s2t_tpu_torch port.

* The port and chip_smoke.py import neither jax, flax nor s2t_tpu (checked
  in the source and in a fresh interpreter).
* Entry points run on the card unless the caller asks for the CPU.
* The kernel wrappers never hand a non-CPU tensor to the plain version.
* The differentiable ops keep the autograd graph; training knobs that are
  not ported raise instead of being ignored.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import s2t_tpu_torch
from s2t_tpu_torch.hub import GeneratorHub
from s2t_tpu_torch.models.s2t_transformer import S2TTransformerModel, s2t_transformer_s
from s2t_tpu_torch.ops import _build, attention_cuda, ctc_cuda
from s2t_tpu_torch.ops.ctc import ctc_loss

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(s2t_tpu_torch.__file__).resolve().parent
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "s2t_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_imported_modules_pull_in_no_jax():
    code = "\n".join(
        ["import importlib, sys", f"sys.path.insert(0, {str(ROOT)!r})"]
        + [f"importlib.import_module({m!r})" for m in _module_names()]
        + ["import chip_smoke",
           "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)" % (FORBIDDEN,),
           "assert not bad, bad", "print('clean')"]
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = s2t_transformer_s(vocab_size=16, encoder_layers=1, decoder_layers=1,
                            encoder_embed_dim=32, decoder_embed_dim=32,
                            encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32,
                            subsampling_filter=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S2TTransformerModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GeneratorHub.build(cfg)
    assert S2TTransformerModel(cfg, device="cpu").device.type == "cpu"


def test_kernel_wrapper_raises_instead_of_falling_back(monkeypatch):
    def no_library(*_a, **_k):
        raise RuntimeError("library cannot load")

    def plain_must_not_run(*_a, **_k):
        raise AssertionError("plain version used for a device tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    monkeypatch.setattr(attention_cuda, "fused_attention_plain", plain_must_not_run)
    # a tensor that is not on the CPU (the meta device stands in for the card here)
    q = torch.empty((2, 8, 2, 32), device="meta")
    mask = torch.ones((2, 8), dtype=torch.bool, device="meta")
    before = attention_cuda.fused_attention.launches
    with pytest.raises(RuntimeError, match="library cannot load"):
        attention_cuda.fused_attention(q, q, q, mask)
    assert attention_cuda.fused_attention.launches == before


def test_kernel_wrapper_rejects_non_cuda_device_tensors(monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda *_a, **_k: None)
    q = torch.empty((2, 8, 2, 32), device="meta")
    mask = torch.ones((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_cuda.fused_attention(q, q, q, mask)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _n: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["attention_fwd"])


def _no_library(monkeypatch):
    def no_library(*_a, **_k):
        raise RuntimeError("library cannot load")

    def plain_must_not_run(*_a, **_k):
        raise AssertionError("plain version used for a device tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    for mod, name in ((attention_cuda, "fused_attention_plain"),
                      (ctc_cuda, "ctc_alpha_plain"), (ctc_cuda, "ctc_beta_grad_plain")):
        monkeypatch.setattr(mod, name, plain_must_not_run)


def test_training_kernel_wrappers_raise_instead_of_falling_back(monkeypatch):
    _no_library(monkeypatch)
    meta = dict(device="meta")  # a tensor that is not on the CPU stands in for the card
    q = torch.empty((2, 8, 2, 32), **meta)
    lse = torch.empty((2, 2, 8), **meta)
    lengths = torch.empty((2,), dtype=torch.int32, **meta)
    lattice = torch.empty((8, 2, 5), **meta)
    rows = torch.empty((2, 5), **meta)
    calls = [
        lambda: attention_cuda.fused_attention_bwd(q, q, q, q, q, lse, lengths),
        lambda: attention_cuda.fused_attention_fwd(q, q, q, lengths, with_lse=True),
        lambda: ctc_cuda.ctc_alpha(lattice, rows, lengths),
        lambda: ctc_cuda.ctc_beta_grad(lattice, lattice, rows, rows, lengths, lengths.float()),
    ]
    counters = (attention_cuda.fused_attention, attention_cuda.fused_attention_bwd,
                ctc_cuda.ctc_alpha, ctc_cuda.ctc_beta_grad)
    before = [f.launches for f in counters]
    for call in calls:
        with pytest.raises(RuntimeError, match="library cannot load"):
            call()
    assert [f.launches for f in counters] == before


def test_differentiable_ops_keep_the_graph():
    q, k, v = (torch.randn(2, 5, 2, 32, requires_grad=True) for _ in range(3))
    valid = torch.tensor([[True] * 5, [True] * 3 + [False] * 2])
    out = attention_cuda.fused_attention(q, k, v, valid, 0.1, torch.tensor([7]))
    assert out.grad_fn is not None
    logits = torch.randn(2, 6, 7, requires_grad=True)
    nll = ctc_loss(logits, torch.tensor([[2, 3], [4, 4]]), torch.tensor([6, 5]),
                   torch.tensor([2, 2]), reduction="none", normalized=False)
    assert nll.grad_fn is not None
    (out.sum() + nll.sum()).backward()
    assert all(t.grad is not None for t in (q, k, v, logits))


def test_training_with_layerdrop_raises():
    cfg = s2t_transformer_s(vocab_size=16, encoder_layers=1, decoder_layers=1,
                            encoder_embed_dim=32, decoder_embed_dim=32,
                            encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32,
                            subsampling_filter=32)
    with pytest.raises(NotImplementedError, match="encoder_layerdrop"):
        S2TTransformerModel(cfg.replace(encoder_layerdrop=0.2), device="cpu", for_training=True)
    # a serving model built from the same config may still train-forward: it raises too
    model = S2TTransformerModel(cfg.replace(encoder_layerdrop=0.2), device="cpu")
    feats, lens = torch.zeros(1, 16, 80), torch.tensor([16])
    with pytest.raises(NotImplementedError, match="encoder_layerdrop"):
        model(feats, lens, torch.tensor([[2, 5]]), train=True, generator=torch.Generator())
