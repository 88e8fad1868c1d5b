"""Boundaries of the s2t_tpu_torch port.

* The port, chip_smoke.py and phase_profile.py import neither jax, flax nor s2t_tpu (checked
  in the source and in a fresh interpreter), and none of PyYAML,
  ``tokenizers`` or sacreBLEU at module level (the card's machine may lack
  them; the modules that need them import them inside the call).
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
from s2t_tpu_torch.cli import generate as cli_generate
from s2t_tpu_torch.cli import train as cli_train
from s2t_tpu_torch.config import OptimizationConfig, TrainConfig, check_train_supported
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.ops import _build, attention_cuda, ctc_cuda, fbank_cuda
from s2t_tpu_torch.ops.ctc import ctc_loss
from s2t_tpu_torch.trainer import Trainer
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(s2t_tpu_torch.__file__).resolve().parent
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "phase_profile.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "s2t_tpu")
OPTIONAL = ("yaml", "tokenizers", "sacrebleu")  # imported inside the calls that need them


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


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_optional_package_at_module_level(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    in_functions = {n for f in ast.walk(tree)
                    if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) for n in ast.walk(f)}
    bad = []
    for node in ast.walk(tree):
        if node in in_functions:
            continue
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] in OPTIONAL]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] in OPTIONAL:
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad} at module level"


def test_imported_modules_pull_in_no_jax():
    code = "\n".join(
        ["import importlib, sys", f"sys.path.insert(0, {str(ROOT)!r})"]
        + [f"importlib.import_module({m!r})" for m in _module_names()]
        + ["import chip_smoke",
           "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)"
           % (FORBIDDEN + OPTIONAL,),
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
    tiny = dict(vocab_size=16, encoder_layers=1, decoder_layers=1, encoder_embed_dim=32,
                decoder_embed_dim=32, encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32,
                subsampling_filter=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("s2t_transformer_s", tiny)
    model = build_model("s2t_transformer_s", tiny, device="cpu", for_training=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, None, OptimizationConfig())
    assert cli_train.parse_args(["data"]).device == "cuda"
    assert cli_generate.parse_args(["data"]).device == "cuda"


@pytest.mark.parametrize("arch,kw", [
    ("s2t_sate_s", dict(acoustic_encoder_layers=1, acoustic_decoder_layers=1,
                        text_encoder_layers=1, acoustic_encoder_embed_dim=32,
                        acoustic_decoder_embed_dim=32, acoustic_subsampling_filter=32)),
    ("s2t_ctc_sate", dict(acoustic_encoder_layers=1, text_encoder_layers=1,
                          acoustic_encoder_embed_dim=32, acoustic_subsampling_filter=32)),
    ("s2t_conformer", dict(encoder_layers=1, decoder_layers=1, encoder_embed_dim=32,
                           decoder_embed_dim=32, subsampling_filter=32)),
])
def test_sate_and_conformer_entry_points_need_cuda_unless_cpu_requested(monkeypatch, arch, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(arch, {**kw, "vocab_size": 16})
    model = build_model(arch, {**kw, "vocab_size": 16}, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    if arch != "s2t_ctc_sate":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GeneratorHub.build(model.cfg)


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
                      (ctc_cuda, "ctc_alpha_plain"), (ctc_cuda, "ctc_beta_grad_plain"),
                      (fbank_cuda, "fbank_plain")):
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
        lambda: fbank_cuda.fbank(torch.empty((2, 800), **meta), lengths),
    ]
    counters = (attention_cuda.fused_attention, attention_cuda.fused_attention_bwd,
                ctc_cuda.ctc_alpha, ctc_cuda.ctc_beta_grad, fbank_cuda.fbank)
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
    """LayerDrop trains (it raised before it was ported): a dropped layer is skipped
    in training only, and the keep bits come from the step generator's seed; an
    unknown remat policy still raises; BMUF and a process group pass the CLI's check."""
    cfg = s2t_transformer_s(vocab_size=16, encoder_layers=2, decoder_layers=1,
                            encoder_embed_dim=32, decoder_embed_dim=32,
                            encoder_ffn_embed_dim=32, decoder_ffn_embed_dim=32,
                            subsampling_filter=32, encoder_layerdrop=1.0)
    model = S2TTransformerModel(cfg, device="cpu", for_training=True)
    feats, lens = torch.randn(1, 16, 80), torch.tensor([16])
    out = model(feats, lens, torch.tensor([[2, 5]]), train=True, generator=torch.Generator())
    out["decoder_logits"].sum().backward()
    assert all(p.grad is None for p in model.encoder.layers.parameters())  # both dropped
    assert model.encoder.subsample.convs[0].weight.grad is not None
    kept = model(feats, lens, torch.tensor([[2, 5]]), train=True, generator=torch.Generator(),
                 layer_keep=[True, False])["encoder_out"]
    assert not torch.equal(kept, out["encoder_out"])
    assert torch.equal(model(feats, lens, torch.tensor([[2, 5]]))["encoder_out"],
                       model(feats, lens, torch.tensor([[2, 5]]))["encoder_out"])
    with pytest.raises(ValueError, match="remat_policy"):
        S2TTransformerModel(cfg.replace(checkpoint_activations=True, remat_policy="x"),
                            device="cpu", for_training=True)
    from s2t_tpu_torch.config import from_dict
    # BMUF and FSDP are ported (tests/test_torch_parallel.py)
    for good in ({"bmuf": {"active": True}}, {"distributed": {"fsdp": True}}):
        check_train_supported(from_dict(TrainConfig, good))


def test_fbank_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda *_a, **_k: None)
    meta = dict(device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fbank_cuda.fbank(torch.empty((2, 800), **meta), lengths)
    with pytest.raises(ValueError, match="num_mel_bins"):
        fbank_cuda.fbank(torch.empty((2, 800), **meta), lengths, num_mel_bins=0)


def test_training_cli_refuses_unported_settings():
    for section, name, value in (("common", "profile", True),
                                 ("common", "tensorboard_logdir", "tb"),
                                 ("optimization", "rng_impl", "philox")):
        cfg = TrainConfig()
        setattr(getattr(cfg, section), name, value)
        with pytest.raises(NotImplementedError, match=name):
            check_train_supported(cfg)
    # BMUF, every distributed setting, common.user_dir (read by nothing, as in JAX) and
    # every rng_impl JAX takes pass the check
    for section, name, value in (("bmuf", "active", True), ("distributed", "fsdp", True),
                                 ("distributed", "seq_parallel", 2),
                                 ("distributed", "coordinator_address", "host:1234"),
                                 ("common", "user_dir", "plugins"),
                                 ("optimization", "rng_impl", "unsafe_rbg")):
        cfg = TrainConfig()
        setattr(getattr(cfg, section), name, value)
        check_train_supported(cfg)
    # validation-time decoding, the pretrained-component transplant, quant noise and the
    # training-loop breadth (schedulers, optimizers, lr_groups) are ported
    cfg = TrainConfig()
    cfg.eval.eval_wer = cfg.eval.eval_bleu = cfg.eval.eval_ctc_wer = True
    cfg.checkpoint.finetune_from_model = cfg.checkpoint.load_pretrained_encoder_from = "x.pt"
    cfg.optimization.quant_noise_p = 0.1
    cfg.optimization.lr_scheduler, cfg.optimization.optimizer = "triangular", "lamb"
    cfg.optimization.lr_groups = {"encoder": 0.0}
    check_train_supported(cfg)
