"""Smoke run of the s2t_tpu_torch serving, training and raw-audio slices on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases (any failure ends the run with a non-zero exit):
  1. build   every CUDA source of s2t_tpu_torch/csrc with nvcc (sm_90a), one
             process per source, all started together, printing each kernel's
             registers and spills (-Xptxas -v); then cuobjdump -sass counts the
             tensor-core instructions (HMMA, HGMMA) of every attention kernel
             and fails if a bf16 kernel (forward, dK/dV, dQ) has none;
  2. kernel  the attention forward (K1f) against its plain PyTorch version on
             the card at the s/m/l head plans, T' = 250 and 1000, ragged
             lengths with a 0-length row, fp32 and bf16, native (B, T, H, D)
             and head-major strided layouts; times kernel, plain version and
             torch's scaled_dot_product_attention (a yardstick only);
  3. grad    K1f with dropout 0 / 0.15 and its log-sum-exp, and the attention
             backward (K1b), against the plain version and its autograd
             backward with the same seed, at the same head plans, dtypes and
             layouts; the kept share of the dropout mask; at the training
             shape K1f with lse and K1b at p = 0.1 (the main path) and p = 0,
             beside the backward of scaled_dot_product_attention at p = 0;
  4. ctc     the CTC alpha (K3) and beta/gradient (K4) kernels against their
             plain versions at the training shape (B=40, T'=250, S=59) and a
             long one (T'=1000, S=401), ragged lengths, repeated labels, an
             infeasible and a 0-frame row; times beside torch's ctc_loss;
  5. serve   s2t_transformer_s at full width (seeded random weights) answers
             the four fixture wavs with beam 5 through the hub, fp32, on the
             card (kernel) and on the CPU (plain): encoder outputs within
             ENC_ATOL and identical top-beam tokens, or a printed near-tie;
  6. speed   the same model in bf16 on 64 synthetic 10 s waveforms;
  7. train   s2t_transformer_m at full width, fp32, dropout 0: 3 steps of the
             port's Trainer on the card (kernels) and on the CPU (plain),
             per-step loss / ctc_loss / gnorm and the parameters after 3 steps;
  8. train   s2t_transformer_m in bf16 at the bench shape (B=40, T=1000, U=30,
     speed   V=10000, preset dropouts, ctc_weight 0.3): one warm-up step, 20
             timed steps, steps/s, frames/s, tokens/s, MFU, and one profiled
             step (device busy share, top device ops, each kernel's share);
 10. fbank   the Kaldi fbank (K5) against fbank_plain over every frame and
             against fbank_numpy over each row's frames: silence, a square
             wave, a DC offset, the fixture wavs and ragged lengths 399 ...
             123457 padded to 160,000 samples; times at B=40 x 10 s;
 11. train   cli.train trains s2t_transformer_m at full width in bf16 from a
     audio   seeded corpus of 16-bit wavs (80 train / 16 dev, 4-12 s, V=10000):
             K5 then utterance CMVN + SpecAugment inside the step, label-smoothed
             CE + CTC, 3 epochs with validation and checkpoints, then a 4th
             epoch resumed from checkpoint_last.pt; one profiled step; one
             fp32 forward_fn + criterion pass card vs CPU;
 12. generate cli.generate beam-5 decodes 8 dev utterances as fbank_numpy
             features from phase 11's checkpoint_last.pt;
  9. summary the kernels line, the card's name and power limit, and the
             final {"ok": true, ...} line.
The launch counters are set to 0 before each main-path run and read after
it: serving (phases 5-6) launches K1f 12 times per encode; a training step
(phases 7-8) launches K1f 12, K1b 12, K3 1 and K4 1 times; a raw-audio
forward (phase 11, train or valid) adds K5 once; decoding (phase 12)
launches K1f 12 times per encode.
Every kernel and library time is taken twice: ``ms`` with CUDA events around
back-to-back calls (the call's host work included, which is what a call of a
few tens of microseconds reads) and ``device_ms``, the device time of the
call's own kernels (all kernels of a library call) in a torch.profiler trace.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from s2t_tpu_torch.cli.train import step_batch
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.hub import GeneratorHub
from s2t_tpu_torch.models.s2t_transformer import (
    S2TTransformerModel, s2t_transformer_m, s2t_transformer_s)
from s2t_tpu_torch.ops import _build
from s2t_tpu_torch.ops.attention_cuda import (
    HEAD_DIMS, fused_attention, fused_attention_bwd, fused_attention_fwd, fused_attention_plain,
    keep_mask)
from s2t_tpu_torch.ops.ctc import _extend_labels, _lattice_logp, _transition_mask
from s2t_tpu_torch.ops.ctc_cuda import (
    NEG_INF, ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain)
from s2t_tpu_torch.ops.fbank_cuda import fbank, mel_bin_ranges
from s2t_tpu_torch.trainer import Trainer
from s2t_tpu_torch.utils.flops import s2t_train_flops
from s2t_tpu_torch.utils.masking import lengths_to_mask

ROOT = Path(__file__).resolve().parent
WAVS = [str(ROOT / "tests" / "fixtures" / "audio" / f"utt{i}.wav") for i in range(4)]

# kernel vs plain: fp32 sums in another order; bf16 output is one rounding of
# an f32 result (half a bf16 ulp is 1.6e-2 below |x| = 8) after P rounded to bf16
# before P V, as the Pallas kernel rounds it, held to the plain version evaluated
# in f32 on the same bf16 inputs (tests/test_torch_attention_bf16.py holds the
# Pallas kernel's own bf16 numerics inside this and GRAD_RTOL)
KERNEL_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# fp32 serving, card (kernel, cuBLAS, cuDNN without TF32) vs CPU (plain):
# 12 encoder layers summed in another order
ENC_ATOL = 1e-3
# attention backward, kernel vs autograd through the plain version (in f32 on the
# same inputs), relative to the largest entry of the reference gradient: fp32 sums
# in another order; bf16 adds one rounding of each output, of P o Z and dS before
# their products, and Delta = rowsum(dO o O) taken from the bf16 forward output,
# each ~2^-8 relative
GRAD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4  # log-sum-exp in f32 of f32-accumulated scores (|lse| < ~20)
KEPT_SHARE_TOL = 0.005  # kept share of the dropout mask vs 1 - k/256, absolute
# CTC kernels vs plain: the same f32 operations in the same order per state
CTC_ATOL = {"alpha": 1e-3, "demit": 1e-5}
# fp32 training card vs CPU over 3 steps (the same f32 math, reductions in another
# order through 18 layers): loss and ctc_loss relative, gnorm relative
TRAIN_RTOL = {"loss": 1e-4, "ctc_loss": 1e-4, "gnorm": 1e-3}
TRAIN_LAUNCHES = {"attention_fwd": 12, "attention_bwd": 12, "ctc_alpha": 1, "ctc_beta_grad": 1}
# name fragments of each attention wrapper's own kernels in a profiler trace (the
# bf16 tensor-core kernels and the fp32 FMA kernels both match)
FWD_KERNELS = ("attention_fwd",)
BWD_KERNELS = ("delta_", "dkdv_", "dq_")
# the bf16 kernels whose SASS must hold tensor-core instructions, by library
MMA_KERNELS = {"attention_fwd": ("attention_fwd_mma_kernel",),
               "attention_bwd": ("dkdv_mma_kernel", "dq_mma_kernel")}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32 without tensor cores
GEN = dict(beam_size=5, max_len_a=0.0, max_len_b=100, lenpen=1.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Event-timed ms per call of ``iters`` back-to-back calls: the call's host work
    (checks, allocation, the launch) is inside, so a call of a few tens of
    microseconds reads its host time; ``device_ms`` reads the card's own."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3):
    """Device time per call of the CUDA kernels ``fn`` launched, from a torch.profiler
    trace of ``iters`` calls: the kernels whose names contain one of ``names`` (a
    hand-written kernel's own), or everything the call ran on the device when
    ``names`` is None (a library call).  Each name counts its mean duration times
    its launches per call, so an event the trace drops or doubles moves no sum;
    device events that start before the trace's first host event are not this
    trace's and are left out; a trace with no device event is taken again (at
    most 3 times).  Returns (ms, {name: ms})."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        t0 = min((e.time_range.start for e in events if e.device_type == cpu), default=0)
        spans = {}
        for e in events:
            if e.device_type != cuda or e.time_range.start < t0:
                continue
            key = e.name if names is None else next((n for n in names if n in e.name), None)
            if key is not None:
                spans.setdefault(key, []).append((e.time_range.end - e.time_range.start) / 1e3)
        if spans:
            split = {k: float(np.mean(v)) * max(1, round(len(v) / iters)) for k, v in spans.items()}
            return sum(split.values()), split
        log(f"[profiler] a trace recorded no device kernel matching {names}: taken again")
    raise AssertionError(f"three traces recorded no device kernel matching {names}")


def attention_bound(B, T, H, D, lengths, dtype):
    """Least time on the card: inputs read once, output written once, and the
    flops these lengths need (keys past a row's length are skipped, a
    0-length row attends to all T)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * T * H * D * elem + B * T  # q, k, v, o + the (B, T) mask
    kv = [min(int(n), T) if n > 0 else T for n in lengths]
    flops = 4 * H * D * T * sum(kv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
def kernel_label(mangled: str) -> str:
    """'attention_fwd_mma_kernel<64>' from a mangled kernel name
    (_ZN<len><namespace><len><name>[I...Li<D>E...]...); other names as they are."""
    pos = 3 if mangled.startswith("_ZN") else len(mangled)
    while pos < len(mangled):
        digits = re.match(r"\d+", mangled[pos:])
        if not digits:
            break
        start = pos + digits.end()
        name, pos = mangled[start:start + int(digits.group())], start + int(digits.group())
        if name.endswith("_kernel"):
            d = re.match(r"I\w*?Li(\d+)E", mangled[pos:])
            return name + (f"<{d.group(1)}>" if d else "")
    return mangled


def phase_build():
    t0 = time.perf_counter()
    built = _build.build()
    for name, (secs, out) in built.items():
        log(f"[build] {name}.cu in {secs:.1f} s")
        for line in out.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                log(f"[build]   {kernel_label(entry.group(1))}:")
            elif "registers" in line or "spill" in line:
                log(f"[build]     {line.strip()}")
    log(f"[build] sources {list(_build.sources())}: {time.perf_counter() - t0:.1f} s "
        f"({len(built)} compiled)")
    return sass_check()


def sass_check():
    """Count the tensor-core instructions (HMMA, HGMMA) in the SASS of every kernel of
    the attention libraries with cuobjdump; fail if a bf16 kernel has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib in MMA_KERNELS:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            label = kernel_label(body.split("\n", 1)[0].strip())
            counts[label] = {op: len(re.findall(rf"\b{op}\b", body))
                             for op in ("HMMA", "HGMMA", "LDSM", "FFMA")}
            log(f"[sass] {lib}: {label} {json.dumps(counts[label])}")
    for kernels in MMA_KERNELS.values():
        for kernel in kernels:
            found = {k: c for k, c in counts.items() if k.startswith(kernel + "<")}
            if len(found) != len(HEAD_DIMS) or any(c["HMMA"] + c["HGMMA"] == 0
                                                    for c in found.values()):
                raise AssertionError(f"{kernel}: no tensor-core instructions in its SASS for "
                                     f"every head dim: {found}")
    return counts


def attention_case(B, T, H, D, dtype, layout, lengths, seed, time_it):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, T, H, D) if layout == "native" else (B, H, T, D)
    qkv = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]
    if layout == "head_major":
        qkv = [a.transpose(1, 2) for a in qkv]  # (B, T, H, D) view of a (B, H, T, D) buffer
    q, k, v = qkv
    mask = torch.arange(T, device="cuda")[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
    out = fused_attention(q, k, v, mask)
    ref = fused_attention_plain(q.float(), k.float(), v.float(), mask)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    res = {"B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).split(".")[-1],
           "layout": layout, "max_abs_err": err, "atol": KERNEL_ATOL[dtype]}
    if time_it:
        bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :]
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

        res["ms"] = cuda_ms(lambda: fused_attention(q, k, v, mask))
        res["device_ms"] = device_ms(lambda: fused_attention(q, k, v, mask), FWD_KERNELS)[0]
        res["plain_ms"] = cuda_ms(lambda: fused_attention_plain(q, k, v, mask), iters=5)
        res["library_ms"] = cuda_ms(sdpa)
        res["library_device_ms"] = device_ms(sdpa)[0]
        res["bound_ms"], res["bound_by"] = attention_bound(B, T, H, D, lengths, dtype)
    return res


def phase_kernel():
    rng = np.random.default_rng(0)
    cases = []
    B = 64
    plans = [(4, 64), (8, 64), (16, 64)]  # s, m, l head plans
    for T in (250, 1000):
        lengths = rng.integers(1, T + 1, size=B)
        lengths[0], lengths[1] = T, 0
        for H, D in plans:
            for dtype in (torch.float32, torch.bfloat16):
                for layout in ("native", "head_major"):
                    cases.append((B, T, H, D, dtype, layout, lengths, layout == "native"))
    lengths = rng.integers(1, 251, size=B)
    lengths[1] = 0
    for D in (32, 128):  # the other head dims the kernel takes
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((B, 250, 4, D, dtype, "native", lengths, False))
    results = []
    with torch.inference_mode():
        for i, c in enumerate(cases):
            r = attention_case(*c[:7], seed=i, time_it=c[7])
            results.append(r)
            timing = "".join(
                f" {key}={r[key]:.4f}" for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                                   "library_device_ms", "bound_ms")
                if key in r)
            log(f"[kernel] B={r['B']} T={r['T']} H={r['H']} D={r['D']} {r['dtype']:<8} "
                f"{r['layout']:<10} max_abs_err={r['max_abs_err']:.3e} (atol {r['atol']})"
                f"{timing}{' bound_by=' + r['bound_by'] if 'bound_by' in r else ''}")
            if not r["max_abs_err"] <= r["atol"]:
                raise AssertionError(f"attention kernel disagrees with its plain version: {r}")
        # the serving shape of phase 4: 64 requests of 10 s (T' = 250), bf16, s head plan
        main = attention_case(64, 250, 4, 64, torch.bfloat16, "native", [250] * 64,
                              seed=len(cases), time_it=True)
    log(f"[kernel] serving shape {json.dumps(main)}")
    if not main["max_abs_err"] <= main["atol"]:
        raise AssertionError(f"attention kernel disagrees at the serving shape: {main}")
    return results, main


# --------------------------------------------------------------------------- #
def counters():
    return {"attention_fwd": fused_attention, "attention_bwd": fused_attention_bwd,
            "ctc_alpha": ctc_alpha, "ctc_beta_grad": ctc_beta_grad, "fbank": fbank}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in f32."""
    want = want.float()
    return (got.float() - want).abs().max().item() / max(1.0, want.abs().max().item())


def attention_bwd_bound(B, T, H, D, lengths, dtype):
    """K1b: q, k, v, o, dO read and dq, dk, dv written once, lse / Delta (B, H, T)
    f32; the flops of its five products (S, dP, dV, dK, dQ) over the keys these
    lengths need."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 8 * B * T * H * D * elem + 2 * 4 * B * H * T + 4 * B
    kv = [min(int(n), T) if n > 0 else T for n in lengths]
    flops = 10 * H * D * T * sum(kv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def grad_case(B, T, H, D, dtype, layout, lengths, rate, seed, time_it=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, T, H, D) if layout == "native" else (B, H, T, D)
    qkv = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]
    if layout == "head_major":
        qkv = [a.transpose(1, 2) for a in qkv]
    q, k, v = qkv
    do = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
    mask = torch.arange(T, device="cuda")[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
    lens = mask.sum(-1, dtype=torch.int32)
    rate_u8 = min(int(round(rate * 256)), 255)
    dseed = torch.randint(0, 2 ** 62, (1,), generator=g, device="cuda")
    out, lse = fused_attention_fwd(q, k, v, lens, rate_u8, dseed, with_lse=True)
    dq, dk, dv = fused_attention_bwd(q, k, v, out, do, lse, lens, rate_u8, dseed)
    qf, kf, vf = (a.detach().float().requires_grad_() for a in (q, k, v))
    ref = fused_attention_plain(qf, kf, vf, mask, rate, dseed)
    ref.backward(do.float())
    with torch.no_grad():
        bias = torch.where(mask[:, None, None, :], 0.0, -1e9)
        lse_ref = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(D) + bias, -1)
        rows = lens > 0  # a 0-length row's lse is rounded away by the -1e9 bias
        lse_err = (lse[rows] - lse_ref[rows]).abs().max().item()
    torch.cuda.synchronize()
    res = {"B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).split(".")[-1], "layout": layout,
           "dropout": rate, "out_rel_err": rel_err(out, ref), "lse_err": lse_err,
           "dq_rel_err": rel_err(dq, qf.grad), "dk_rel_err": rel_err(dk, kf.grad),
           "dv_rel_err": rel_err(dv, vf.grad),
           "grad_max_abs_err": max((a.float() - b).abs().max().item()
                                   for a, b in ((dq, qf.grad), (dk, kf.grad), (dv, vf.grad))),
           "rtol": GRAD_RTOL[dtype]}
    if time_it:
        # the forward with lse and the backward at this rate (the main path) and at p = 0,
        # where the library's backward (no dropout) is the like-for-like yardstick
        out0, lse0 = fused_attention_fwd(q, k, v, lens, 0, None, with_lse=True)
        calls = {
            "fwd": (lambda: fused_attention_fwd(q, k, v, lens, rate_u8, dseed, True), FWD_KERNELS),
            "fwd_p0": (lambda: fused_attention_fwd(q, k, v, lens, 0, None, True), FWD_KERNELS),
            "": (lambda: fused_attention_bwd(q, k, v, out, do, lse, lens, rate_u8, dseed),
                 BWD_KERNELS),
            "p0": (lambda: fused_attention_bwd(q, k, v, out0, do, lse0, lens, 0, None),
                   BWD_KERNELS),
        }
        for name, (fn, names) in calls.items():
            pre = f"{name}_" if name else ""
            res[f"{pre}ms"] = cuda_ms(fn)
            res[f"{pre}device_ms"], split = device_ms(fn, names)
            if names is BWD_KERNELS:
                res[f"{pre}device_ms_by_kernel"] = split
        qp, kp, vp = (a.detach().requires_grad_() for a in (q, k, v))
        plain_out = fused_attention_plain(qp, kp, vp, mask, rate, dseed)
        res["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(plain_out, (qp, kp, vp), do,
                                                              retain_graph=True), iters=5)
        qt, kt, vt = (a.detach().transpose(1, 2).requires_grad_() for a in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias.to(dtype))
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

        res["library_ms"] = cuda_ms(library)
        res["library_device_ms"] = device_ms(library)[0]
        res["bound_ms"], res["bound_by"] = attention_bwd_bound(B, T, H, D, lengths, dtype)
    return res


def check_grad_case(r):
    bad = [key for key in ("out_rel_err", "dq_rel_err", "dk_rel_err", "dv_rel_err")
           if not r[key] <= r["rtol"]]
    if bad or not r["lse_err"] <= LSE_ATOL:
        raise AssertionError(f"attention kernels disagree with the plain version ({bad}): {r}")


def phase_attention_grad():
    rng = np.random.default_rng(1)
    cases = []
    B, T = 16, 250
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[1] = T, 0
    for H, D in [(4, 64), (8, 64), (16, 64)]:  # s, m, l head plans
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.15):
                for layout in ("native", "head_major"):
                    cases.append((B, T, H, D, dtype, layout, lengths, rate))
    for D in (32, 128):  # the other head dims the kernels take
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((8, T, 4, D, dtype, "native", lengths[:8], 0.15))
    long_lengths = np.array([1000, 0, 731, 402])
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((4, 1000, 8, 64, dtype, "native", long_lengths, 0.15))
    results = []
    for i, c in enumerate(cases):
        r = grad_case(*c, seed=100 + i)
        results.append(r)
        log(f"[grad] B={r['B']} T={r['T']} H={r['H']} D={r['D']} {r['dtype']:<8} {r['layout']:<10} "
            f"p={r['dropout']:<4} rel err out {r['out_rel_err']:.2e} dq {r['dq_rel_err']:.2e} "
            f"dk {r['dk_rel_err']:.2e} dv {r['dv_rel_err']:.2e} (rtol {r['rtol']}; max abs "
            f"{r['grad_max_abs_err']:.2e}) lse {r['lse_err']:.2e} (atol {LSE_ATOL})")
        check_grad_case(r)
    # the kept share of the kernel's dropout mask over a large tensor (the training
    # shape): with Q = K = 0 every probability is 1/T, and with V = 1 each output is
    # (kept keys / T) / (1 - k/256); the plain version's mask gives the same share
    k_u8, (B, T, H, D) = 38, (40, 250, 8, 64)  # k = round(0.15 * 256)
    zeros = torch.zeros((B, T, H, D), device="cuda")
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    dseed = torch.tensor([20241016], device="cuda")
    out, _ = fused_attention_fwd(zeros, zeros, torch.ones_like(zeros), lens, k_u8, dseed)
    share = out.mean().item() * (1 - k_u8 / 256)
    plain_share = keep_mask(dseed, B, H, T, k_u8).float().mean().item()
    log(f"[grad] kept share at p=0.15 over {B}x{H}x{T}x{T}: kernel {share:.6f}, plain "
        f"{plain_share:.6f} (1 - k/256 = {1 - k_u8 / 256:.6f}, tolerance {KEPT_SHARE_TOL})")
    if not (abs(share - (1 - k_u8 / 256)) <= KEPT_SHARE_TOL and abs(share - plain_share) < 1e-5):
        raise AssertionError("the dropout mask keeps the wrong share")
    # the training shape of s2t_transformer_m: bf16, B=40, T'=250, H=8, D=64, p=0.1
    main = grad_case(40, 250, 8, 64, torch.bfloat16, "native", [250] * 40, 0.1,
                     seed=99, time_it=True)
    log(f"[grad] training shape {json.dumps(main)}")
    check_grad_case(main)
    return results, share, main


def ctc_bounds(B, T, S, lengths):
    """K3 reads emit for the frames below each length and writes every alpha row;
    K4 reads emit and alphas for those frames and writes every gradient row."""
    used = sum(min(int(n), T) for n in lengths)
    k3 = (4 * S * (used + B * T) + 4 * B * S + 4 * B) / HBM_BYTES_PER_S * 1e3
    k4 = (4 * S * (2 * used + B * T) + 2 * 4 * B * S + 8 * B) / HBM_BYTES_PER_S * 1e3
    return k3, k4


def ctc_case(B, T, U, V, seed, time_it=False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(3, V, size=(B, U))
    labels[0, 1::2] = labels[0, 0::2][: U // 2]  # repeated labels
    labels[1] = 5  # U repeats need 2U - 1 frames: infeasible in U + 1
    label_lengths = rng.integers(U // 2, U + 1, size=B)
    input_lengths = rng.integers(max(T // 2, U + 2), T + 1, size=B)
    label_lengths[:2] = U
    input_lengths[0], input_lengths[1], input_lengths[-1] = T, U + 1, 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(B, T, V, generator=g, device="cuda")
    labels_t = torch.as_tensor(labels, device="cuda")
    ext = _extend_labels(labels_t, 0)
    S = ext.shape[1]
    emit = _lattice_logp(logits, ext, normalized=False).transpose(0, 1).contiguous()
    skip = torch.where(_transition_mask(ext, 0), 0.0, NEG_INF).float().contiguous()
    lens = torch.as_tensor(input_lengths, dtype=torch.int32, device="cuda")
    ll = torch.as_tensor(label_lengths, device="cuda")
    state = torch.arange(S, device="cuda")[None, :]
    final = torch.where((state == 2 * ll[:, None] - 1) | (state == 2 * ll[:, None]),
                        0.0, NEG_INF).float().contiguous()
    alphas = ctc_alpha(emit, skip, lens)
    alphas_p = ctc_alpha_plain(emit, skip, lens)

    def logz(a):
        last = a[-1]
        a_label = torch.where(ll > 0, last.gather(1, (2 * ll - 1).clamp(min=0)[:, None])[:, 0],
                              NEG_INF)
        return torch.logaddexp(a_label, last.gather(1, (2 * ll)[:, None])[:, 0])

    lz, lz_p = logz(alphas), logz(alphas_p)
    demit = ctc_beta_grad(emit, alphas_p, skip, final, lens, lz_p.contiguous())
    demit_p = ctc_beta_grad_plain(emit, alphas_p, skip, final, lens, lz_p)
    torch.cuda.synchronize()
    reach = alphas_p > -1e29
    feasible = torch.as_tensor((input_lengths >= 2 * label_lengths - 1) & (input_lengths > 0),
                               device="cuda") & (lz_p > -1e29)
    res = {"B": B, "T": T, "S": S,
           "alpha_err": (alphas - alphas_p)[reach].abs().max().item(),
           "unreached_agree": bool(torch.equal(alphas > -1e29, reach)),
           "nll_err": (lz - lz_p)[feasible].abs().max().item(),
           "infeasible_nll_over_5e29": bool((-lz_p[1]).item() > 5e29),
           "demit_err": (demit - demit_p).abs().max().item(), "atol": CTC_ATOL}
    if time_it:
        def alpha():
            return ctc_alpha(emit, skip, lens)

        def beta():
            return ctc_beta_grad(emit, alphas, skip, final, lens, lz)

        res["alpha_ms"] = cuda_ms(alpha)
        res["alpha_device_ms"] = device_ms(alpha, ("ctc_alpha_kernel",))[0]
        res["alpha_plain_ms"] = cuda_ms(lambda: ctc_alpha_plain(emit, skip, lens), iters=3, warmup=1)
        res["beta_ms"] = cuda_ms(beta)
        res["beta_device_ms"] = device_ms(beta, ("ctc_beta_grad_kernel",))[0]
        res["beta_plain_ms"] = cuda_ms(
            lambda: ctc_beta_grad_plain(emit, alphas, skip, final, lens, lz), iters=3, warmup=1)
        lp = torch.log_softmax(logits, dim=-1).transpose(0, 1).detach().requires_grad_()
        args = (labels_t, lens.clamp(min=1).long(), ll)  # the library refuses 0 frames

        def lib():
            return torch.nn.functional.ctc_loss(lp, *args, reduction="sum", zero_infinity=True)

        res["library_fwd_ms"] = cuda_ms(lib)
        res["library_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(lib(), lp))
        res["library_bwd_ms"] = res["library_fwd_bwd_ms"] - res["library_fwd_ms"]
        res["library_fwd_device_ms"] = device_ms(lib)[0]
        loss = lib()
        res["library_bwd_device_ms"] = device_ms(
            lambda: torch.autograd.grad(loss, lp, retain_graph=True))[0]
        res["alpha_bound_ms"], res["beta_bound_ms"] = ctc_bounds(B, T, S, input_lengths)
        res["chain_steps"] = int(min(input_lengths.max(), T)) - 1
    return res


def phase_ctc():
    cases = [ctc_case(40, 250, 29, 10000, seed=7, time_it=True),  # the training shape
             ctc_case(8, 1000, 200, 10000, seed=8)]
    for r in cases:
        log(f"[ctc] {json.dumps(r)}")
        if not (r["alpha_err"] <= CTC_ATOL["alpha"] and r["nll_err"] <= CTC_ATOL["alpha"]
                and r["demit_err"] <= CTC_ATOL["demit"] and r["unreached_agree"]
                and r["infeasible_nll_over_5e29"]):
            raise AssertionError(f"CTC kernels disagree with their plain versions: {r}")
    return cases


# --------------------------------------------------------------------------- #
def rescore(model, gen, features, lengths, tokens):
    """Cumulative log-prob of each hypothesis prefix under teacher forcing:
    the same scores the beam accumulates (its bans never touch a chosen token)."""
    dev = model.device
    with torch.inference_mode():
        enc = model.encode(features.to(dev), lengths.to(dev))
        hyp = torch.as_tensor(tokens, device=dev)[None]
        prev = torch.cat([torch.full((1, 1), gen.eos_id, device=dev), hyp[:, :-1]], dim=1)
        mask = torch.arange(enc["encoder_out"].shape[1], device=dev)[None] < enc["encoder_lengths"][:, None]
        lp = torch.log_softmax(model.decode(prev, enc["encoder_out"], mask).float(), dim=-1)
        return lp[0].gather(-1, hyp[0, :, None])[:, 0].cumsum(0).cpu()


def phase_serve_parity():
    cfg = s2t_transformer_s(vocab_size=10000, max_target_positions=1024)
    card = GeneratorHub.build(cfg, device="cuda", seed=0, **GEN)
    host = GeneratorHub.build(cfg, device="cpu", seed=0, **GEN)
    batch = card._speech_batch(WAVS)
    feats = torch.from_numpy(batch["features"])
    lens = torch.from_numpy(batch["feat_lengths"]).long()
    with torch.inference_mode():
        before = fused_attention.launches
        enc_card = card.model.encode(feats.cuda(), lens.cuda())
        torch.cuda.synchronize()
        if fused_attention.launches - before != cfg.encoder_layers:
            raise AssertionError(f"encode launched the kernel {fused_attention.launches - before}"
                                 f" times, expected {cfg.encoder_layers}")
        enc_host = host.model.encode(feats, lens)
    enc_err = (enc_card["encoder_out"].cpu() - enc_host["encoder_out"]).abs().max().item()
    log(f"[serve] fp32 encoder_out {tuple(enc_host['encoder_out'].shape)} card vs CPU "
        f"max_abs_err={enc_err:.3e} (atol {ENC_ATOL})")
    if not enc_err <= ENC_ATOL:
        raise AssertionError("encoder outputs disagree between the card and the CPU")
    if not torch.equal(enc_card["encoder_lengths"].cpu(), enc_host["encoder_lengths"]):
        raise AssertionError("encoder lengths disagree between the card and the CPU")

    fused_attention.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    tok_card = card.generate(WAVS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    encodes = 1
    if fused_attention.launches != cfg.encoder_layers * encodes:
        raise AssertionError(f"serving launched the kernel {fused_attention.launches} times")
    t0 = time.perf_counter()
    tok_host = host.generate(WAVS)
    host_s = time.perf_counter() - t0
    log(f"[serve] 4 requests, beam 5: card {card_s:.3f} s, CPU {host_s:.3f} s; "
        f"lengths {[len(t) for t in tok_card]}")
    for b, (a, c) in enumerate(zip(tok_card, tok_host)):
        if np.array_equal(a, c):
            continue
        n = min(len(a), len(c))
        step = int(np.flatnonzero(a[:n] != c[:n])[0]) if (a[:n] != c[:n]).any() else n
        hyp_a = np.append(a, card.generator.eos_id)[: step + 1]
        hyp_c = np.append(c, card.generator.eos_id)[: step + 1]
        gaps = []
        for name, hub in (("card", card), ("cpu", host)):
            sa = rescore(hub.model, hub.generator, feats[b:b + 1], lens[b:b + 1], hyp_a)[-1].item()
            sc = rescore(hub.model, hub.generator, feats[b:b + 1], lens[b:b + 1], hyp_c)[-1].item()
            gaps.append(abs(sa - sc))
            if name == "card":
                encodes += 2  # each rescore encodes once on the card
            log(f"[serve] request {b} diverges at step {step}: on {name} candidate "
                f"{hyp_a[-1]} scores {sa:.6f}, candidate {hyp_c[-1]} scores {sc:.6f}")
        if not max(gaps) <= ENC_ATOL:
            raise AssertionError(f"request {b}: tokens differ and the gap {max(gaps):.3e} "
                                 f"is no near-tie (tolerance {ENC_ATOL})")
        log(f"[serve] request {b}: near-tie (gap {max(gaps):.3e} <= {ENC_ATOL}), accepted")
    if all(np.array_equal(a, c) for a, c in zip(tok_card, tok_host)):
        log("[serve] top-beam tokens identical on the card and the CPU")
    return encodes


def synced_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(fn, kernels=()):
    """Run ``fn`` once under torch.profiler: device busy ms (union of the
    kernel and copy intervals), the aten ops with the most device time, the
    device ms of the CUDA kernels whose names contain each of ``kernels``, and
    the synchronised wall ms of the call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, start, end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy_us += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_us += end - start
    averages = prof.key_averages()
    ops = sorted(((a.key, a.self_device_time_total / 1e3) for a in averages
                  if a.key.startswith("aten::") and a.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    kernel_ms = {name: sum(a.self_device_time_total for a in averages if name in a.key) / 1e3
                 for name in kernels}
    return {"busy_ms": busy_us / 1e3, "top_ops": ops[:8], "kernel_ms": kernel_ms,
            "wall_ms": wall_ms}


def phase_speed(n_timed: int = 3, B: int = 64, seconds: float = 10.0):
    cfg = s2t_transformer_s(vocab_size=10000, max_target_positions=1024, dtype_str="bfloat16")
    hub = GeneratorHub.build(cfg, device="cuda", seed=0, **GEN)
    rng = np.random.default_rng(0)
    waves = [list((rng.normal(size=(B, int(16000 * seconds))) * 3000.0).astype(np.float32))
             for _ in range(n_timed + 1)]
    out = hub.generate(waves[0])  # warm-up: cuBLAS/cuDNN plans, allocator
    encodes = 1
    walls = []
    for w in waves[1:]:
        walls.append(synced_s(lambda: out.extend(hub.generate(w))))
        encodes += 1
    if len(out) != B * (n_timed + 1):
        raise AssertionError("wrong number of answers")
    # where the time goes, on the last batch: host features, encoder, encoder + beam
    t0 = time.perf_counter()
    batch = hub._speech_batch(waves[-1])
    fbank_s = time.perf_counter() - t0
    feats = torch.from_numpy(batch["features"]).cuda()
    lens = torch.from_numpy(batch["feat_lengths"]).long().cuda()
    with torch.inference_mode():
        enc = {}
        encode_s = synced_s(lambda: enc.update(hub.model.encode(feats, lens)))
    if not torch.isfinite(enc["encoder_out"]).all():
        raise AssertionError("non-finite encoder output")
    beam_s = synced_s(lambda: hub.generator.generate(batch))
    prof = device_profile(lambda: hub.generator.generate(batch))
    busy_ms, top_ops = prof["busy_ms"], prof["top_ops"]
    encodes += 3
    wall = float(np.median(walls))
    res = {"batch": B, "audio_s_per_request": seconds, "wall_s": walls,
           "utt_per_s": B / wall, "rtf": B * seconds / wall,
           "host_fbank_s": fbank_s, "encode_s": encode_s, "encode_plus_beam_s": beam_s,
           "profiled_device_busy_ms": busy_ms,
           "device_busy_share_of_encode_plus_beam": busy_ms / 1e3 / beam_s,
           "top_aten_ops_device_ms": top_ops}
    log(f"[speed] bf16 untuned first measurement: {json.dumps(res)}")
    return encodes, res


# --------------------------------------------------------------------------- #
CRITERION = ("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})
KERNEL_NAMES = ("attention_fwd_mma_kernel", "delta_bf16_kernel", "dkdv_mma_kernel",
                "dq_mma_kernel", "ctc_alpha_kernel", "ctc_beta_grad_kernel")  # the bf16 path


def train_batch(rng, B, T, U, V, lengths):
    """A seeded batch as bench.py section B makes it (transcript = target[:, :-1])."""
    targets = rng.integers(4, V, size=(B, U)).astype(np.int32)
    targets[:, -1] = 2
    prev = np.roll(targets, 1, axis=1)
    prev[:, 0] = 2
    return {
        "features": rng.normal(size=(B, T, 80)).astype(np.float32),
        "feat_lengths": np.asarray(lengths, np.int32),
        "prev_tokens": prev,
        "target": targets,
        "transcript": targets[:, :-1],
        "transcript_lengths": np.full((B,), U - 1, np.int32),
        "ntokens": np.float32(B * U),
    }


def check_step_launches(counts, steps=1):
    want = {**{k: 0 for k in counters()}, **{k: n * steps for k, n in TRAIN_LAUNCHES.items()}}
    if counts != want:
        raise AssertionError(f"{steps} training step(s) launched {counts}, expected {want}")


def phase_train_parity(steps: int = 3):
    """fp32 s2t_transformer_m, dropout 0: the port's Trainer on the card and on
    the CPU from the same seeded weights and batches."""
    cfg = s2t_transformer_m(vocab_size=10000, max_target_positions=1024, dropout=0.0,
                            attention_dropout=0.0, activation_dropout=0.0)
    opt = OptimizationConfig(lr=2e-3, warmup_updates=3, clip_norm=10.0, adam_eps=1e-6)
    rng = np.random.default_rng(0)
    batches = [train_batch(rng, 4, 1000, 30, 10000, [1000, 873, 640, 412]) for _ in range(steps)]
    runs, launches = {}, {k: 0 for k in TRAIN_LAUNCHES}
    for device in ("cuda", "cpu"):
        model = S2TTransformerModel(cfg, device=device, seed=0, for_training=True)
        trainer = Trainer(model, build_criterion(*CRITERION), opt, device=device, seed=1)
        metrics, t0 = [], time.perf_counter()
        for batch in batches:
            reset_counts()  # the main path: one training step on the card
            m = trainer.train_step(batch)
            if device == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
                check_step_launches(counts)
                launches = {k: launches[k] + counts[k] for k in launches}
            metrics.append({k: float(m[k]) for k in ("loss", "ctc_loss", "gnorm", "lr")})
        secs = time.perf_counter() - t0
        runs[device] = (metrics, {n: p.detach().cpu() for n, p in model.named_parameters()})
        log(f"[train] fp32 {device}: {steps} steps in {secs:.2f} s: {json.dumps(metrics)}")
    (card, card_p), (host, host_p) = runs["cuda"], runs["cpu"]
    errs = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in TRAIN_RTOL} for a, b in zip(card, host)]
    diffs = {n: (card_p[n] - host_p[n]).abs() for n in host_p}
    worst = sorted(diffs, key=lambda n: -diffs[n].max().item())[:3]
    param_err = diffs[worst[0]].max().item()
    n_params = sum(d.numel() for d in diffs.values())
    over = sum(int((d > 1e-5).sum()) for d in diffs.values())
    # Adam's first updates are ~lr * sign(g): an entry whose gradient is near 0 and
    # flips sign between the devices (float32 noise, or a ReLU input within rounding
    # of 0 that passes on one device and not the other) moves up to 2 lr apart per step
    param_bound = 2 * sum(m["lr"] for m in host)
    res = {"steps": steps, "card": card, "cpu": host, "rel_err": errs, "rtol": TRAIN_RTOL,
           "max_param_diff": param_err, "param_bound": param_bound,
           "worst_params": {n: diffs[n].max().item() for n in worst},
           "share_of_entries_over_1e-5": over / n_params,
           "launches_per_step": TRAIN_LAUNCHES}
    log(f"[train] fp32 card vs CPU: rel err per step {json.dumps(errs)} (rtol {TRAIN_RTOL}); "
        f"max param difference after {steps} steps {param_err:.3e} (bound 2 sum(lr) = "
        f"{param_bound:.3e}; worst {json.dumps(res['worst_params'])}, {over} of {n_params} "
        f"entries differ by more than 1e-5); launches per step {TRAIN_LAUNCHES}")
    if any(not e[k] <= TRAIN_RTOL[k] for e in errs for k in TRAIN_RTOL) or \
            not param_err <= param_bound:
        raise AssertionError("fp32 training disagrees between the card and the CPU")
    return res, launches


def phase_train_speed(n_timed: int = 20, B: int = 40, T: int = 1000, U: int = 30, V: int = 10000):
    """bf16 s2t_transformer_m at the bench.py section B shape and optimizer."""
    cfg = s2t_transformer_m(vocab_size=V, dtype_str="bfloat16", max_target_positions=1024)
    model = S2TTransformerModel(cfg, device="cuda", seed=0, for_training=True)
    trainer = Trainer(model, build_criterion(*CRITERION),
                      OptimizationConfig(lr=2e-3, warmup_updates=10000, clip_norm=10.0),
                      device="cuda", seed=1)
    batch = train_batch(np.random.default_rng(0), B, T, U, V, [T] * B)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}  # device-resident, as bench
    reset_counts()  # the main path: 1 warm-up + n_timed timed + 1 profiled step
    losses = [trainer.train_step(batch)["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        losses.append(trainer.train_step(batch)["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = device_profile(lambda: losses.append(trainer.train_step(batch)["loss"]), KERNEL_NAMES)
    counts = read_counts()
    check_step_launches(counts, n_timed + 2)
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all() or not losses.max() > losses.min():
        raise AssertionError(f"bf16 training loss is not finite or does not move: {losses}")
    flops = s2t_train_flops(B, T, U, d_model=cfg.encoder_embed_dim, ffn=cfg.encoder_ffn_embed_dim,
                            enc_layers=cfg.encoder_layers, dec_layers=cfg.decoder_layers, vocab=V)
    steps_per_s = n_timed / wall
    step_ms = wall / n_timed * 1e3
    res = {"batch": B, "frames": T, "target_tokens": U, "vocab": V, "timed_steps": n_timed,
           "wall_s": wall, "step_ms": step_ms, "steps_per_s": steps_per_s,
           "frames_per_s": steps_per_s * B * T, "tokens_per_s": steps_per_s * B * U,
           "model_flops_per_step": flops, "mfu_vs_989_tflops": flops * steps_per_s / 989e12,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first_last": [losses[0].item(), losses[-1].item()],
           "profiled_step_wall_ms": prof["wall_ms"], "profiled_device_busy_ms": prof["busy_ms"],
           "device_busy_share_of_profiled_step": prof["busy_ms"] / prof["wall_ms"],
           "device_busy_share_of_timed_step": prof["busy_ms"] / step_ms,
           "top_aten_ops_device_ms": prof["top_ops"],
           "kernel_device_ms": prof["kernel_ms"],
           "kernel_share_of_busy": {k: v / prof["busy_ms"] for k, v in prof["kernel_ms"].items()}}
    log(f"[train speed] bf16 untuned first measurement: {json.dumps(res)}")
    return res, counts


# --------------------------------------------------------------------------- #
# K5 against fbank_plain (fbank_torch: float64 frames and DFT through cuFFT, the
# power rounded to f32 once, an f32 mel matmul and log) and against fbank_numpy
# (the same precisions on the host): the tolerance of tests/test_fbank_pallas.py,
# |err| <= FBANK_ATOL + FBANK_RTOL |ref|.  All three round a float64 power to f32
# (direct DFT or FFT change only its last float64 bits), so they differ by about
# an f32 ulp of the mel sums under the log; the bound is the parity tests' own,
# which the JAX formulations' f32 DFT sums of 400 int16-scale samples (about
# five digits) still meet
FBANK_ATOL, FBANK_RTOL = 5e-4, 1e-4
FBANK_RAGGED = (399, 400, 401, 559, 560, 8037, 123457)
FBANK_N = 160000  # the timing shape: 40 rows of 10 s, T = 998


def fbank_bound(B, N, n_mels=80):
    """Least time for one fbank call: the samples read and the features written
    once, and the operations of the FFT formulation (the fewest known for the
    function): per frame preprocessing (mean, preemphasis, window: 5 per sample),
    a 512-point real FFT (2.5 N log2 N), the power (3 per bin), the mel product
    over the nonzero weights of the Kaldi triangles (2 per weight, 501 weights
    for 80 bins) and the log, at the f32 rate (no tensor cores: see fbank.cu).
    Returns (bound ms, what bounds it, {"bytes_ms", "operations_ms"})."""
    _, lo, hi = mel_bin_ranges(n_mels)
    T = 1 + (N - 400) // 160 if N >= 400 else 0
    nbytes = 4 * B * N + 4 * B * T * n_mels + 4 * B + 4 * B
    per_frame = 5 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * int((hi - lo).sum()) + n_mels
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, B * T * per_frame / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            {"bytes_ms": t_bytes * 1e3, "operations_ms": t_ops * 1e3})


def fbank_rows():
    """The content rows (silence, a +-32767 square wave, a DC offset of 1000 with
    sigma 1 noise, the four fixture wavs) and the ragged rows (noise of sigma 2000
    at FBANK_RAGGED lengths): [(name, waveform)]."""
    from s2t_tpu_torch.data.dataset import load_waveform

    rng = np.random.default_rng(10)
    n = np.arange(32000)
    rows = [("silence", np.zeros(16000, np.float32)),
            ("square", np.where((n // 50) % 2 == 0, 32767.0, -32767.0).astype(np.float32)),
            ("dc1000", (1000.0 + rng.normal(size=24000)).astype(np.float32))]
    rows += [(Path(w).stem, load_waveform(w)) for w in WAVS]
    rows += [(f"len{L}", (rng.normal(size=L) * 2000.0).astype(np.float32)) for L in FBANK_RAGGED]
    return rows


def fbank_check(got, want):
    """(max |err|, worst err / (atol + rtol |want|)) over two f32 tensors."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), (err / (FBANK_ATOL + FBANK_RTOL * want.float().abs())).max().item()


def phase_fbank():
    from s2t_tpu_torch.data.audio.fbank import fbank_numpy
    from s2t_tpu_torch.ops.fbank_cuda import fbank_plain

    rows = fbank_rows()
    wave = np.zeros((len(rows), FBANK_N), np.float32)
    for i, (_, w) in enumerate(rows):
        wave[i, : len(w)] = w
    lengths = torch.as_tensor([len(w) for _, w in rows], device="cuda")
    wave_t = torch.from_numpy(wave).cuda()
    got, flens = fbank(wave_t, lengths)
    plain, plain_flens = fbank_plain(wave_t, lengths)
    torch.cuda.synchronize()
    if not torch.equal(flens, plain_flens):
        raise AssertionError(f"K5 frame lengths {flens.tolist()} != plain {plain_flens.tolist()}")
    report, worst = [], 0.0
    for i, (name, w) in enumerate(rows):
        ref = torch.from_numpy(fbank_numpy(w))
        n = int(flens[i])
        if n != ref.shape[0]:
            raise AssertionError(f"row {name}: {n} frames, fbank_numpy has {ref.shape[0]}")
        err_p, ratio_p = fbank_check(got[i], plain[i])  # all T frames, the padded tail included
        err_n, ratio_n = fbank_check(got[i, :n].cpu(), ref) if n else (0.0, 0.0)
        worst = max(worst, ratio_p, ratio_n)
        report.append({"row": name, "samples": len(w), "frames": n, "vs_plain": err_p,
                       "vs_numpy": err_n})
        log(f"[fbank] {name:<9} {len(w):>6} samples {n:>4} frames: max |err| vs plain "
            f"{err_p:.3e} (all {got.shape[1]} frames), vs fbank_numpy {err_n:.3e}")
    silent = got[0, flens[0]:].unique()  # the silent tail is log(EPSILON) in every formulation
    log(f"[fbank] silent frames give {silent.tolist()}; worst err / (atol + rtol |ref|) = "
        f"{worst:.3f} (atol {FBANK_ATOL}, rtol {FBANK_RTOL})")
    if not worst <= 1.0:
        raise AssertionError(f"K5 disagrees with fbank_plain / fbank_numpy: {report}")

    # the timing shape: 40 rows of 10 s of sigma-2000 noise
    B = 40
    g = torch.Generator(device="cuda").manual_seed(11)
    wave_t = torch.randn((B, FBANK_N), generator=g, device="cuda") * 2000.0
    lengths = torch.full((B,), FBANK_N, device="cuda")
    got, _ = fbank(wave_t, lengths)
    plain, _ = fbank_plain(wave_t, lengths)
    err, ratio = fbank_check(got, plain)
    if not ratio <= 1.0:
        raise AssertionError(f"K5 disagrees with fbank_plain at the timing shape: max |err| {err}")
    res = {"B": B, "N": FBANK_N, "T": got.shape[1], "max_abs_err": err, "err_ratio": ratio,
           "rows": report,
           "ms": cuda_ms(lambda: fbank(wave_t, lengths)),
           "device_ms": device_ms(lambda: fbank(wave_t, lengths), ("fbank_kernel",))[0],
           "plain_ms": cuda_ms(lambda: fbank_plain(wave_t, lengths), iters=10)}
    res["bound_ms"], res["bound_by"], res["bound_parts"] = fbank_bound(B, FBANK_N)
    log(f"[fbank] timing shape {json.dumps({k: v for k, v in res.items() if k != 'rows'})}")
    return res


# --------------------------------------------------------------------------- #
# phases 11-12: the raw-audio training path through the task, data and CLI layers
CORPUS = {"train": 80, "dev": 16}
SYMBOLS = 9996  # + the 4 special symbols: V = 10000, the bench's vocabulary
TEST_UTTS = 8
# fairseq's LibriSpeech ("lb") SpecAugment policy, the recipes' train transforms
SPECAUGMENT = {"time_warp_W": 0, "freq_mask_N": 1, "freq_mask_F": 27, "time_mask_N": 1,
               "time_mask_T": 100, "time_mask_p": 1.0}
# fp32 forward_fn + criterion, card (kernels) vs CPU (plain): every output and loss,
# max |err| over max(1, max |CPU|); test_torch_task.py holds the CPU path to JAX at 1e-4
FORWARD_RTOL = 1e-4


def write_wav(path: Path, samples: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.rint(samples), -32768, 32767).astype("<i2").tobytes())


def write_corpus(root: Path, seed: int = 0) -> None:
    """A seeded raw-audio corpus: 16-bit wavs of 4-12 s (sigma-2000 noise),
    targets of 10-30 words drawn from a Zipf(1.1) law over SYMBOLS words (so a
    model can learn something from the text alone), ``src_text`` = the target
    words for CTC, and ``dict.txt``."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(SYMBOLS)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    p = 1.0 / np.arange(1, SYMBOLS + 1) ** 1.1
    p /= p.sum()
    for split, n in CORPUS.items():
        lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
        for i in range(n):
            samples = int(rng.integers(4 * 16000, 12 * 16000 + 1))
            write_wav(root / f"{split}{i}.wav", rng.normal(size=samples) * 2000.0)
            text = " ".join(words[j] for j in rng.choice(SYMBOLS, size=int(rng.integers(10, 31)),
                                                         p=p))
            lines.append(f"{split}{i}\t{split}{i}.wav\t{samples}\t{text}\t{text}")
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def audio_cfg(root: Path, max_epoch: int, dtype: str = "bfloat16"):
    from s2t_tpu_torch.config import TrainConfig, from_dict

    return from_dict(TrainConfig, {
        "task": "speech_to_text",
        "arch": "s2t_transformer_m",  # full width; the preset's dropouts
        "criterion": CRITERION[0],
        "criterion_cfg": CRITERION[1],
        "model": {"dtype_str": dtype},
        # with use_audio_input the size columns and caps count samples
        "dataset": {"data": str(root), "max_tokens": 6_400_000,
                    "max_source_positions": 200_000},
        "optimization": {"max_epoch": max_epoch, "lr": 2e-3, "warmup_updates": 4,
                         "clip_norm": 10.0},
        "checkpoint": {"save_dir": str(root / "ckpt"), "keep_last_epochs": 2},
        "common": {"seed": 1, "log_interval": 1},
        "generation": {"beam": 5, "max_len_b": 100, "scoring": "wer", "post_process": None},
    })


def audio_task(cfg, use_audio: bool = True):
    """The task from a data config built in Python (no config.yaml to read)."""
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask

    data_cfg = S2TDataConfig(use_audio_input=use_audio, transforms={
        "_train": {"transforms": ["utterance_cmvn", "specaugment"], "specaugment": SPECAUGMENT},
        "_eval": {"transforms": ["utterance_cmvn"]}})
    return SpeechToTextTask(cfg, data_cfg, Dictionary.load(Path(cfg.dataset.data) / "dict.txt"))


def check_counts(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, expected {want}")


def path_counts(train_steps, forwards):
    """Launches of a run of ``train_steps`` train steps and ``forwards`` forwards
    in all (train + valid): K5, K1f and K3 once per forward (K1f per encoder
    layer), K1b and K4 per train step."""
    return {"attention_fwd": 12 * forwards, "attention_bwd": 12 * train_steps,
            "ctc_alpha": forwards, "ctc_beta_grad": train_steps, "fbank": forwards}


def to_device(batch, device):
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in step_batch(batch).items()}


def phase_train_audio(root: Path):
    from s2t_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    write_corpus(root)
    corpus_s = time.perf_counter() - t0
    cfg = audio_cfg(root, max_epoch=3)
    task = audio_task(cfg)
    reset_counts()  # the main path: cli.train from raw audio, 3 epochs
    t0 = time.perf_counter()
    out = cli_train.main(cfg, task=task, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = out["trainer"].step
    valid_ds = task.datasets[cfg.dataset.valid_subset]
    n_valid = len(task.get_batch_iterator(valid_ds, max_tokens=cfg.dataset.max_tokens,
                                          seed=cfg.common.seed, shuffle=False))
    check_counts(counts, path_counts(steps, steps + n_valid * len(out["history"])),
                 f"cli.train ({steps} steps, {len(out['history'])} validations of {n_valid} batch)")
    losses = [r["loss"] for r in out["train_log"]]
    valid = [h["loss"] for h in out["history"]]
    epoch_mean = [np.mean([r["loss"] for r in out["train_log"] if r["epoch"] == e])
                  for e in (1, 3)]
    if not (np.isfinite(losses).all() and np.isfinite(valid).all() and valid[-1] < valid[0]
            and epoch_mean[1] < epoch_mean[0]):
        raise AssertionError(f"raw-audio training: losses not finite or not falling: train "
                             f"{losses}, valid {valid}")
    ckpt = Path(cfg.checkpoint.save_dir)
    files = sorted(p.name for p in ckpt.glob("*.pt"))
    want = {"checkpoint_last.pt", "checkpoint_best.pt", "checkpoint3.pt", "checkpoint2.pt"}
    if not want <= set(files) or "checkpoint1.pt" in files:  # keep_last_epochs 2
        raise AssertionError(f"checkpoint files {files}, expected {sorted(want)} and no "
                             "checkpoint1.pt")
    log(f"[train audio] 3 epochs, {steps} steps in {wall:.2f} s: train losses "
        f"{[round(x, 4) for x in losses]}, valid {[round(x, 4) for x in valid]}; launches "
        f"{json.dumps(counts)}; checkpoints {files}")
    timing = out["timing"]

    # a 4th epoch resumes from checkpoint_last.pt: step and epoch continue
    cfg4 = audio_cfg(root, max_epoch=4)
    task4 = audio_task(cfg4)
    reset_counts()  # the main path: the resumed run
    out4 = cli_train.main(cfg4, task=task4, device="cuda")
    torch.cuda.synchronize()
    counts4 = read_counts()
    steps4 = out4["trainer"].step - steps
    log4 = out4["train_log"]
    epochs4 = [h["epoch"] for h in out4["history"]]
    if not (log4 and log4[0]["step"] == steps + 1 and steps4 > 0 and epochs4 == [3, 4]
            and all(r["epoch"] == 4 for r in log4)):
        raise AssertionError(f"the resumed run did not continue at step {steps + 1} in epoch 4: "
                             f"train log {log4}, validated epochs {epochs4}")
    check_counts(counts4, path_counts(steps4, steps4 + n_valid * len(epochs4)), "resumed cli.train")
    log(f"[train audio] resumed at step {log4[0]['step']} in epoch 4: {steps4} steps, losses "
        f"{[round(r['loss'], 4) for r in log4]}, validated epochs {epochs4}; launches "
        f"{json.dumps(counts4)}")
    launches = {k: counts[k] + counts4[k] for k in counts}

    # where a step from raw audio spends its time: the host (wav reads, collation),
    # the step, and one profiled step on the device
    trainer = out4["trainer"]
    train_ds = task4.datasets[cfg4.dataset.train_subset]
    t0 = time.perf_counter()
    batch = next(iter(task4.get_batch_iterator(train_ds, max_tokens=cfg4.dataset.max_tokens,
                                               seed=1, shuffle=False,
                                               buffer_size=1).next_epoch_itr()))
    host_batch_s = time.perf_counter() - t0
    prof = device_profile(lambda: trainer.train_step(step_batch(batch)),
                          KERNEL_NAMES + ("fbank_kernel",))
    res = {"corpus_write_s": corpus_s, "train_steps": steps, "resumed_steps": steps4,
           "wall_s": wall, "valid_batches": n_valid, "train_losses": losses,
           "valid_losses": valid, "timing": timing,
           "steps_per_s_in_step": steps / timing["step_s"],
           "steps_per_s_with_data": steps / (timing["step_s"] + timing["data_s"]),
           "data_wait_share": timing["data_s"] / (timing["step_s"] + timing["data_s"]),
           "host_batch_s": host_batch_s, "batch_shape": list(batch["features"].shape),
           "profiled_step_wall_ms": prof["wall_ms"], "profiled_device_busy_ms": prof["busy_ms"],
           "device_busy_share_of_profiled_step": prof["busy_ms"] / prof["wall_ms"],
           "fbank_share_of_busy": prof["kernel_ms"]["fbank_kernel"] / prof["busy_ms"],
           "kernel_device_ms": prof["kernel_ms"], "top_aten_ops_device_ms": prof["top_ops"]}
    res["host_batch_share_of_step"] = host_batch_s / (host_batch_s + prof["wall_ms"] / 1e3)

    res["fp32_forward"] = forward_card_vs_cpu(task, valid_ds, cfg)
    log(f"[train audio] {json.dumps({k: v for k, v in res.items() if 'losses' not in k})}")
    return res, launches


def forward_card_vs_cpu(task, valid_ds, cfg):
    """One fp32 forward_fn + criterion pass on a dev batch from the same weights,
    card (K5, K1f, K3) vs CPU (their plain versions): the encoder output and the
    CTC logits over each row's valid frames, the decoder logits over its target
    tokens, elementwise, and the two summed losses."""
    cfg32 = audio_cfg(Path(cfg.dataset.data), max_epoch=3, dtype="float32")
    batch = next(iter(task.get_batch_iterator(valid_ds, max_tokens=cfg.dataset.max_tokens,
                                              seed=1, shuffle=False).next_epoch_itr()))
    outs, losses = {}, {}
    for device in ("cuda", "cpu"):
        t = audio_task(cfg32)
        model = t.build_model(device=device, seed=0)
        if model.device.type != device:
            raise AssertionError(f"the fp32 model was built on {model.device}, not {device}")
        b = to_device(batch, device)
        reset_counts()  # a check of the card's pass, not the main path
        with torch.no_grad():
            out = t.forward_fn()(model, b, train=False)
            loss, _, logs = t.build_criterion()(out, b)
        counts = read_counts()
        if device == "cuda":
            check_counts(counts, path_counts(0, 1), "the fp32 card forward")
        outs[device] = {k: v.cpu() for k, v in out.items() if v is not None}
        losses[device] = {"loss": float(loss), "ctc_loss": float(logs["ctc_loss"])}
        del model
    card, cpu = outs["cuda"], outs["cpu"]
    if not torch.equal(card["encoder_lengths"], cpu["encoder_lengths"]):
        raise AssertionError(f"encoder lengths card {card['encoder_lengths'].tolist()} != CPU "
                             f"{cpu['encoder_lengths'].tolist()}")
    frames = lengths_to_mask(cpu["encoder_lengths"], cpu["encoder_out"].shape[1])
    tokens = torch.as_tensor(np.asarray(batch["target"])) != task.tgt_dict.pad()
    err = {"encoder_out": rel_err(card["encoder_out"][frames], cpu["encoder_out"][frames]),
           "ctc_logits": rel_err(card["ctc_logits"][frames], cpu["ctc_logits"][frames]),
           "decoder_logits": rel_err(card["decoder_logits"][tokens],
                                     cpu["decoder_logits"][tokens])}
    err.update({k: abs(losses["cuda"][k] - losses["cpu"][k]) / abs(losses["cpu"][k])
                for k in losses["cpu"]})
    res = {"batch_shape": list(batch["features"].shape), "valid_frames": int(frames.sum()),
           "target_tokens": int(tokens.sum()), **losses, "rel_err": err}
    log(f"[train audio] fp32 forward_fn + criterion on a dev batch "
        f"{tuple(batch['features'].shape)}: card {losses['cuda']}, CPU {losses['cpu']}; "
        f"rel err (max |err| / max(1, max |CPU|)) {err} (limit {FORWARD_RTOL})")
    if not all(v <= FORWARD_RTOL for v in err.values()):
        raise AssertionError("the raw-audio forward disagrees between the card and the CPU")
    return res


def phase_generate(root: Path):
    """Decode TEST_UTTS dev utterances, as fbank_numpy features, with cli.generate
    from phase 11's checkpoint_last.pt."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.data.audio.fbank import fbank_numpy
    from s2t_tpu_torch.data.dataset import load_waveform
    from s2t_tpu_torch.utils.checkpoint import load_checkpoint

    rows = (root / "dev.tsv").read_text().splitlines()[1:TEST_UTTS + 1]
    lines = ["id\taudio\tn_frames\ttgt_text"]
    for row in rows:
        uid, wav, _, text, _ = row.split("\t")
        feats = fbank_numpy(load_waveform(wav, str(root)))
        np.save(root / f"{uid}.npy", feats)
        lines.append(f"{uid}\t{uid}.npy\t{feats.shape[0]}\t{text}")
    (root / "test.tsv").write_text("\n".join(lines) + "\n")
    cfg = audio_cfg(root, max_epoch=3)
    cfg.dataset.gen_subset = "test"
    cfg.generation.results_path = str(root / "gen")
    task = audio_task(cfg, use_audio=False)
    tree, meta = load_checkpoint(Path(cfg.checkpoint.save_dir) / "checkpoint_last.pt")
    reset_counts()  # the main path: cli.generate
    out = cli_generate.main(cfg, tree["params"], task=task, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    encodes = len(task.get_batch_iterator(task.datasets["test"], max_tokens=cfg.dataset.max_tokens,
                                          shuffle=False))
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": 12 * encodes},
                 "cli.generate")
    text = (Path(cfg.generation.results_path) / "generate-test.txt").read_text().splitlines()
    for tag in ("T", "H", "D"):
        n = sum(line.startswith(f"{tag}-") for line in text)
        if n != TEST_UTTS:
            raise AssertionError(f"generate-test.txt has {n} {tag}- lines, expected {TEST_UTTS}")
    score = [line for line in text if line.startswith("Generate test with beam=5: WER: ")]
    if len(score) != 1:
        raise AssertionError(f"generate-test.txt has no WER line: {text[-1]!r}")
    res = {"checkpoint_step": meta["step"], "utterances": out["n_utts"], "score": score[0],
           "gen_time_s": out["gen_time"], "utts_per_s": out["utts_per_sec"], "rtf": out["rtf"],
           "launches": counts, "first_lines": text[:3]}
    log(f"[generate] {json.dumps(res)}")
    return res, counts


# --------------------------------------------------------------------------- #
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA H100", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    sass = phase_build()
    cases, main_shape = phase_kernel()
    grad_cases, kept_share, grad_main = phase_attention_grad()
    ctc_cases = phase_ctc()

    reset_counts()
    encodes = phase_serve_parity()
    more, speed = phase_speed()
    encodes += more
    serve_launches = fused_attention.launches
    if serve_launches != 12 * encodes:
        raise AssertionError(f"serving launched the attention kernel {serve_launches} times for "
                             f"{encodes} encodes, expected {12 * encodes}")
    log(f"[main path] serving: attention_fwd launches {serve_launches} over {encodes} encodes "
        f"({serve_launches // encodes} per encode)")
    parity, parity_launches = phase_train_parity()
    train_speed, speed_launches = phase_train_speed()
    train_launches = {k: parity_launches[k] + speed_launches[k] for k in TRAIN_LAUNCHES}
    steps = train_launches["ctc_alpha"]
    log(f"[main path] training: {json.dumps(train_launches)} over {steps} steps "
        f"({json.dumps(TRAIN_LAUNCHES)} per step)")

    fbank_main = phase_fbank()
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_") as tmp:
        audio, audio_launches = phase_train_audio(Path(tmp))
        generate, gen_launches = phase_generate(Path(tmp))
    log(f"[main path] raw-audio training (2 runs): {json.dumps(audio_launches)}; generate: "
        f"{json.dumps(gen_launches)}")
    path_launches = {k: train_launches.get(k, 0) + audio_launches[k] + gen_launches[k]
                     for k in counters()}
    path_launches["attention_fwd"] += serve_launches

    ctc_main = ctc_cases[0]
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "s2t_tpu/ops/attention_pallas.py:100",
        "launches": path_launches["attention_fwd"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "device_ms": main_shape["device_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "library_device_ms": main_shape["library_device_ms"],
    }, {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "s2t_tpu/ops/attention_pallas.py:116",
        "launches": path_launches["attention_bwd"],
        "max_abs_err": grad_main["grad_max_abs_err"],
        "ms": grad_main["ms"],
        "device_ms": grad_main["device_ms"],
        "plain_ms": grad_main["plain_ms"],
        "bound_ms": grad_main["bound_ms"],
        "bound_by": grad_main["bound_by"],
        "library_ms": grad_main["library_ms"],  # its backward at p = 0; K1b at p = 0 in the JSON
        "library_device_ms": grad_main["library_device_ms"],
    }, {
        "name": "ctc_alpha",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "s2t_tpu/ops/ctc_pallas.py:59",
        "launches": path_launches["ctc_alpha"],
        "max_abs_err": ctc_main["alpha_err"],
        "ms": ctc_main["alpha_ms"],
        "device_ms": ctc_main["alpha_device_ms"],
        "plain_ms": ctc_main["alpha_plain_ms"],
        "bound_ms": ctc_main["alpha_bound_ms"],
        "bound_by": "bytes",
        "library_ms": ctc_main["library_fwd_ms"],
        "library_device_ms": ctc_main["library_fwd_device_ms"],
    }, {
        "name": "ctc_beta_grad",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "s2t_tpu/ops/ctc_pallas.py:82",
        "launches": path_launches["ctc_beta_grad"],
        "max_abs_err": ctc_main["demit_err"],
        "ms": ctc_main["beta_ms"],
        "device_ms": ctc_main["beta_device_ms"],
        "plain_ms": ctc_main["beta_plain_ms"],
        "bound_ms": ctc_main["beta_bound_ms"],
        "bound_by": "bytes",
        "library_ms": ctc_main["library_bwd_ms"],
        "library_device_ms": ctc_main["library_bwd_device_ms"],
    }, {
        "name": "fbank",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/fbank.cu",
        "replaces": "s2t_tpu/ops/fbank_pallas.py:64",
        "launches": path_launches["fbank"],
        "max_abs_err": fbank_main["max_abs_err"],
        "ms": fbank_main["ms"],
        "device_ms": fbank_main["device_ms"],
        "plain_ms": fbank_main["plain_ms"],
        "bound_ms": fbank_main["bound_ms"],
        "bound_by": fbank_main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the Kaldi fbank
        "library_device_ms": None,
    }]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "kernels": kernels, "sass": sass, "kernel_cases": cases, "serving_shape": main_shape,
            "grad_cases": grad_cases, "kept_share": kept_share, "training_shape": grad_main,
            "ctc_cases": ctc_cases, "speed": speed, "train_parity": parity,
            "train_speed": train_speed, "train_launches": train_launches, "fbank": fbank_main,
            "train_audio": audio, "generate": generate, "path_launches": path_launches,
            "nvidia_smi": smi.stdout.strip(), "wall_s": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
