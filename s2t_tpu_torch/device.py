"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and raise when CUDA is absent;
only an explicit ``device="cpu"`` runs the plain PyTorch path on the host.
Nothing continues on the CPU silently.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pin_fp32() -> None:
    """Full float32 on CUDA: matmuls at "highest" precision and no TF32 in
    cuDNN convolutions (which default to TF32 and keep ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the host"
            )
        pin_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def torch_dtype(dtype_str: str) -> torch.dtype:
    if dtype_str not in DTYPES:
        raise ValueError(f"dtype_str {dtype_str!r} not in {tuple(DTYPES)}")
    return DTYPES[dtype_str]
