"""The bfloat16 attention kernels' contract, checked on the CPU.

* The bf16 tolerances that chip_smoke.py holds the tensor-core kernels to
  (``KERNEL_ATOL``, ``GRAD_RTOL``) admit the TPU kernel's own bf16 numerics:
  the Pallas kernel in interpret mode, forward and ``jax.grad``, rounds P and
  dS to bf16 before its products, as the CUDA kernels do, and it lies within
  those tolerances of the port's ``fused_attention_plain`` evaluated in f32 on
  the same bf16-rounded inputs.  The constants are read from chip_smoke so the
  two cannot drift apart.
* Delta = rowsum(dO o O) of the backward must come from the f32 O: on a
  length-1 row under dropout (all of P on one key, where dS cancels to 0),
  the kernels' FlashAttention-form gradient with Delta from the bf16-rounded
  O misses ``GRAD_RTOL`` against autograd through the plain version, and
  with Delta from the f32 O it holds.
* The wrapper takes bf16 tensors at any element alignment (the kernels copy
  16, 4 or 2 bytes as the rows allow): layouts it once refused (an unaligned
  pointer, b/t/h strides off a multiple of 8) now pass its checks, and on
  ``meta`` tensors only "not CUDA tensors" stops them, before any launch.
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
from s2t_tpu_torch.modules.dropout import threshold_u8
from s2t_tpu_torch.ops import _build, attention_cuda
from s2t_tpu_torch.ops.attention_cuda import fused_attention_plain, keep_mask
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

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


def flash_form_grads(q, k, v, do, valid, rate, seed, delta_from_bf16_o):
    """The bf16 kernels' backward in f32 torch ops: P and the dropout multiplier Z
    (the port's keep_mask) from the forward, O = (P o Z) V, Delta = rowsum(dO o O)
    from O in f32 or rounded to bf16, dS = P o (dP o Z - Delta), P o Z and dS
    rounded to bf16 before their products, as attention_bwd.cu rounds them."""
    B, T, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    bias = torch.where(valid[:, None, None, :], 0.0, attention_cuda.NEG)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias, dim=-1)
    rate_u8 = threshold_u8(rate)
    z = keep_mask(seed, B, H, T, rate_u8).float() / (1.0 - rate_u8 / 256.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p * z, v)
    if delta_from_bf16_o:
        out = out.to(torch.bfloat16).float()
    delta = (do * out).sum(-1).transpose(1, 2)  # (B, H, T)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = (p * (dp * z - delta[..., None])).to(torch.bfloat16).float()
    pz = (p * z).to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pz, do)
    return dq, dk, dv


def test_delta_from_the_f32_output_holds_a_one_key_row():
    """The case of chip_smoke.py phase 3: B=2, T=100, H=4, D=32, p = 0.15,
    lengths [1, 100]; row 0's queries put all their probability on key 0."""
    rng = np.random.default_rng(5)
    shape = (2, 100, 4, 32)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(torch.bfloat16).float() for _ in range(4))
    valid = torch.arange(100)[None, :] < torch.tensor([1, 100])[:, None]
    seed = torch.tensor([20240517])
    tq, tk, tv = (a.clone().requires_grad_() for a in (q, k, v))
    fused_attention_plain(tq, tk, tv, valid, 0.15, seed).backward(do)
    rtol = chip_smoke.GRAD_RTOL[torch.bfloat16]
    errs = {}
    for from_bf16 in (True, False):
        grads = flash_form_grads(q, k, v, do, valid, 0.15, seed, from_bf16)
        errs[from_bf16] = [chip_smoke.rel_err(g, w) for g, w in zip(grads, (tq.grad, tk.grad, tv.grad))]
    assert max(errs[True]) > rtol, errs  # the fault: Delta from the bf16 O
    assert max(errs[False]) <= rtol, errs  # the repair: Delta from the f32 O


def _refused(call):
    """The call passes every layout check and stops, before any launch, only
    because ``meta`` tensors are not CUDA tensors."""
    before = (attention_cuda.fused_attention.launches, attention_cuda.fused_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert (attention_cuda.fused_attention.launches,
            attention_cuda.fused_attention_bwd.launches) == before


@pytest.mark.parametrize("layout", ["t_stride_36", "offset_4_elements"])
def test_wrapper_refuses_unaligned_bf16_before_any_launch(monkeypatch, layout):
    """The two bf16 layouts the 16-byte-only kernels refused: their alignment no
    longer matters, and the wrapper refuses them only for lying off the card."""
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
    _refused(lambda: attention_cuda.fused_attention(bad.float(), good.float(), good.float(), mask))
    # what still stops a layout by name: the head-dim stride
    with pytest.raises(ValueError, match="stride 1"):
        attention_cuda.fused_attention(good, torch.empty((2, 8, 2, 64), **meta)[..., ::2], good,
                                       mask)


@pytest.mark.parametrize("stray", ["out32", "lse"])
def test_backward_refuses_saved_tensors_off_the_inputs_device(monkeypatch, stray):
    # q/k/v/dout on "meta" stand in for the card, with their own device check bypassed;
    # an out32 or lse elsewhere would reach the kernel as a foreign pointer
    monkeypatch.setattr(_build, "load_library", lambda *_a, **_k: None)
    monkeypatch.setattr(attention_cuda, "_check", lambda *_a, **_k: None)
    good = torch.empty((2, 8, 2, 32), device="meta", dtype=torch.bfloat16)
    out32 = torch.empty((2, 8, 2, 32), device="cpu" if stray == "out32" else "meta")
    lse = torch.empty((2, 2, 8), device="cpu" if stray == "lse" else "meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    before = attention_cuda.fused_attention_bwd.launches
    with pytest.raises(ValueError, match="inputs' device"):
        attention_cuda.fused_attention_bwd(good, good, good, out32, good, lse, lengths)
    assert attention_cuda.fused_attention_bwd.launches == before


@pytest.mark.parametrize("mangled, label", [
    # names as nvcc 12.8 mangles the kernels of csrc/attention_*.cu (anonymous namespace)
    ("_ZN49_GLOBAL__N__efbb92f7_16_attention_bwd_cu_7773617817delta_bf16_kernelILi128EEEvPK13"
     "__nv_bfloat16S3_PfiiiNS_7StridesES5_", "delta_bf16_kernel<128>"),
    ("_ZN49_GLOBAL__N__efbb92f7_16_attention_fwd_cu_7773617820attention_fwd_kernelIfLi64EEEvPKT_",
     "attention_fwd_kernel<64>"),
    ("_ZN49_GLOBAL__N__efbb92f7_16_attention_bwd_cu_7773617815dkdv_mma_kernelILi48ELb0EEEvNS_4ArgsE",
     "dkdv_mma_kernel<48, false>"),
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


@pytest.mark.parametrize("chain_ms, by", [((0.02, 0.021), "operations"), ((1e-4, 1e-4), "bytes")])
def test_ctc_bounds_take_the_larger_of_bytes_and_chain(chain_ms, by):
    """K3 and K4 at the training shape (B=40, T'=250, S=59): each bound is the larger
    of the kernel's bytes at 3.35 TB/s and its measured chain floor, and names it."""
    bounds = chip_smoke.ctc_bounds(40, 250, 59, [250] * 40, chain_ms)
    bytes_ms = {"ctc_alpha": 0.0014118, "ctc_beta_grad": 0.0021192}
    for (name, (ms, bound_by, parts)), chain in zip(bounds.items(), chain_ms):
        assert parts["bytes_ms"] == pytest.approx(bytes_ms[name], abs=5e-8)
        assert parts["chain_ms"] == chain
        assert ms == max(parts["bytes_ms"], chain) and bound_by == by

