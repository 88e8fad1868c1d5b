"""The bfloat16 attention kernels' contract, checked on the CPU.

* The bf16 tolerances that chip_smoke.py holds the tensor-core kernels to
  (``KERNEL_ATOL``, ``GRAD_RTOL``) admit the TPU kernel's own bf16 numerics:
  the Pallas kernel in interpret mode, forward and ``jax.grad``, rounds P and
  dS to bf16 before its products, as the CUDA kernels do, and it lies within
  those tolerances of the port's ``fused_attention_plain`` evaluated in f32 on
  the same bf16-rounded inputs.  The constants are read from chip_smoke so the
  two cannot drift apart.
* The wrapper refuses bf16 tensors that the kernels' 16-byte copies cannot
  read (an unaligned pointer, b/t/h strides off a multiple of 8) with
  ValueError before any launch.
* The bounds chip_smoke.py reports beside the kernels' times, and the kernel
  names its SASS check reads from the compiled libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from s2t_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from s2t_tpu_torch.ops import _build, attention_cuda
from s2t_tpu_torch.ops.attention_cuda import fused_attention_plain

B, T, H, D = 2, 100, 2, 64
LENGTHS = [100, 57]


def bf16_case(seed=0):
    """q, k, v, dO rounded to bf16 (as float32 arrays) and the valid mask."""
    rng = np.random.default_rng(seed)
    arrays = [torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
              .to(torch.bfloat16).float().numpy() for _ in range(4)]
    valid = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return (*arrays, valid)


def test_pallas_bf16_numerics_lie_within_the_card_tolerances():
    q, k, v, g, valid = bf16_case()
    # the TPU kernel on bf16 inputs: P and dS rounded to bf16, f32 accumulation
    qb, kb, vb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    mask = jnp.asarray(valid)
    out, vjp = jax.vjp(lambda *a: jax_fused_attention(*a, mask, interpret=True), qb, kb, vb)
    assert out.dtype == jnp.bfloat16
    grads = vjp(gb)
    # the plain version in f32 on the same bf16-rounded inputs, autograd for its gradient
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = fused_attention_plain(tq, tk, tv, torch.from_numpy(valid))
    ref.backward(torch.from_numpy(g))

    out_err = np.abs(np.asarray(out, np.float32) - ref.detach().numpy()).max()
    assert out_err <= chip_smoke.KERNEL_ATOL[torch.bfloat16]
    for name, got, want in zip("qkv", grads, (tq.grad, tk.grad, tv.grad)):
        err = chip_smoke.rel_err(torch.from_numpy(np.asarray(got, np.float32)), want)
        assert err <= chip_smoke.GRAD_RTOL[torch.bfloat16], f"d{name}: {err}"
        assert err > 1e-4, f"d{name}: {err} shows no bf16 rounding"  # the check is not vacuous
    assert out_err > 1e-4


def _refused(call):
    before = (attention_cuda.fused_attention.launches, attention_cuda.fused_attention_bwd.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call()
    assert (attention_cuda.fused_attention.launches,
            attention_cuda.fused_attention_bwd.launches) == before


@pytest.mark.parametrize("layout", ["t_stride_36", "offset_4_elements"])
def test_wrapper_refuses_unaligned_bf16_before_any_launch(monkeypatch, layout):
    monkeypatch.setattr(_build, "load_library", lambda *_a, **_k: None)
    meta = dict(device="meta", dtype=torch.bfloat16)  # stands in for the card here
    if layout == "t_stride_36":  # (B, T, H, D) strides (576, 72, 36, 1)
        bad = torch.empty((2, 8, 2, 36), **meta)[..., :32]
    else:  # contiguous, but 8 bytes past a 16-byte boundary
        bad = torch.empty(2 * 8 * 2 * 32 + 4, **meta)[4:].view(2, 8, 2, 32)
    good = torch.empty((2, 8, 2, 32), **meta)
    mask = torch.ones((2, 8), dtype=torch.bool, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    lse = torch.empty((2, 2, 8), device="meta")
    _refused(lambda: attention_cuda.fused_attention(good, bad, good, mask))
    _refused(lambda: attention_cuda.fused_attention_fwd(bad, good, good, lengths, with_lse=True))
    _refused(lambda: attention_cuda.fused_attention_bwd(good, good, good, good, bad, lse, lengths))
    # float32 takes the FMA kernels, which read any strides: the layout passes, and the
    # tensors are then refused only for not being on the card
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_cuda.fused_attention(bad.float(), good.float(), good.float(), mask)


@pytest.mark.parametrize("mangled, label", [
    # names as nvcc 12.8 mangles the kernels of csrc/attention_*.cu (anonymous namespace)
    ("_ZN49_GLOBAL__N__efbb92f7_16_attention_bwd_cu_7773617817delta_bf16_kernelILi128EEEvPK13"
     "__nv_bfloat16S3_PfiiiNS_7StridesES5_", "delta_bf16_kernel<128>"),
    ("_ZN49_GLOBAL__N__efbb92f7_16_attention_fwd_cu_7773617820attention_fwd_kernelIfLi64EEEvPKT_",
     "attention_fwd_kernel<64>"),
    ("fbank_kernel", "fbank_kernel"),
])
def test_sass_check_reads_kernel_names(mangled, label):
    assert chip_smoke.kernel_label(mangled) == label


def test_bounds_at_the_main_path_shapes():
    serving = chip_smoke.attention_bound(64, 250, 4, 64, [250] * 64, torch.bfloat16)
    training = chip_smoke.attention_bwd_bound(40, 250, 8, 64, [250] * 40, torch.bfloat16)
    assert serving[1] == training[1] == "bytes"
    assert serving[0] == pytest.approx(0.0097863, abs=5e-8)
    assert training[0] == pytest.approx(0.0246448, abs=5e-8)
