"""Smoke run of the s2t_tpu_torch serving slice on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases (any failure ends the run with a non-zero exit):
  1. build   every CUDA source of s2t_tpu_torch/csrc with nvcc (sm_90a);
  2. kernel  the attention kernel against its plain PyTorch version on the
             card at the s/m/l head plans, T' = 250 and 1000, ragged lengths
             with a 0-length row, fp32 and bf16, native (B, T, H, D) and
             head-major strided layouts; times kernel, plain version and
             torch's scaled_dot_product_attention (a yardstick only);
  3. serve   s2t_transformer_s at full width (seeded random weights) answers
             the four fixture wavs with beam 5 through the hub, fp32, on the
             card (kernel) and on the CPU (plain): encoder outputs within
             ENC_ATOL and identical top-beam tokens, or a printed near-tie;
  4. speed   the same model in bf16 on 64 synthetic 10 s waveforms;
  5. summary the kernels line, the card's name and power limit, and the
             final {"ok": true, ...} line.
The kernel launch counter is set to 0 before the serving runs of phases 3-4
(the main path) and read after them: 12 launches per encode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from s2t_tpu_torch.hub import GeneratorHub
from s2t_tpu_torch.models.s2t_transformer import s2t_transformer_s
from s2t_tpu_torch.ops import _build
from s2t_tpu_torch.ops.attention_cuda import fused_attention, fused_attention_plain

ROOT = Path(__file__).resolve().parent
WAVS = [str(ROOT / "tests" / "fixtures" / "audio" / f"utt{i}.wav") for i in range(4)]

# kernel vs plain: fp32 sums in another order; bf16 output is one rounding of
# an f32 result (half a bf16 ulp is 1.6e-2 below |x| = 8), held to the plain
# version evaluated in f32 on the same bf16 inputs
KERNEL_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# fp32 serving, card (kernel, cuBLAS, cuDNN without TF32) vs CPU (plain):
# 12 encoder layers summed in another order
ENC_ATOL = 1e-3
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32 without tensor cores
GEN = dict(beam_size=5, max_len_a=0.0, max_len_b=100, lenpen=1.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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
def phase_build():
    t0 = time.perf_counter()
    built = _build.build()
    for name, (secs, out) in built.items():
        log(f"[build] {name}.cu in {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] sources {list(_build.sources())}: {time.perf_counter() - t0:.1f} s "
        f"({len(built)} compiled)")


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
        res["ms"] = cuda_ms(lambda: fused_attention(q, k, v, mask))
        res["plain_ms"] = cuda_ms(lambda: fused_attention_plain(q, k, v, mask), iters=5)
        res["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias))
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
                f" {key}={r[key]:.4f}" for key in ("ms", "plain_ms", "library_ms", "bound_ms")
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


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: device busy ms (union of the
    kernel and copy intervals) and the aten ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
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
    ops = sorted(((a.key, a.self_device_time_total / 1e3) for a in prof.key_averages()
                  if a.key.startswith("aten::") and a.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    return busy_us / 1e3, ops[:6]


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
    busy_ms, top_ops = device_profile(lambda: hub.generator.generate(batch))
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

    phase_build()
    cases, main_shape = phase_kernel()
    encodes = phase_serve_parity()
    more, speed = phase_speed()
    encodes += more
    launches = fused_attention.launches
    if launches != 12 * encodes:
        raise AssertionError(f"kernel launched {launches} times for {encodes} encodes, "
                             f"expected {12 * encodes}")
    log(f"[main path] attention_fwd launches {launches} over {encodes} encodes "
        f"({launches // encodes} per encode)")

    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "s2t_tpu/ops/attention_pallas.py:100",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "kernels": kernels, "kernel_cases": cases, "serving_shape": main_shape,
            "speed": speed, "nvidia_smi": smi.stdout.strip(),
            "wall_s": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
