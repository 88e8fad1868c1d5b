"""Split each phase of ``chip_smoke.py`` into four kinds of host time, by sampling.

    python3 phase_profile.py [--root TREE] [--out split.json]

Runs ``TREE/chip_smoke.py``'s ``main`` (TREE: a checkout's root, the directory of
this file by default) with TREE's own package in this process while a thread samples
the main thread's stack every ``INTERVAL_S``.  cProfile cannot do this job: ``torch.profiler`` takes
over the interpreter's profile hook the first time the script traces the card, and
cProfile records nothing after that.  Each sample is one of:

* ``trace``: inside ``device_ms`` / ``device_profile`` / ``torch.profiler`` (tracing
  the card and reading the trace back);
* ``cli``: inside the port's CLIs (``s2t_tpu_torch/cli``) or the data they read
  (the ``write_*`` corpus writers, the data package);
* ``cpu_ref``: inside the port's models, ops or generator with the innermost tensor
  of that code on the CPU (the float32 references the card is held to);
* ``card``: the rest (the card's own work and the host code that drives it, the
  kernels' builds).

A phase's samples are those taken before the ``[phase time] NAME`` line that ends it
(the script's ``log``, patched here to note the time).  Prints one JSON object (and
writes it to ``--out``): per phase its seconds, the seconds of each kind, and its
``HOTSPOTS`` costliest places: the innermost line of ``chip_smoke.py`` on the stack and
the innermost function of the port under it.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

INTERVAL_S = 0.02
HOTSPOTS = 8
KINDS = ("card", "cpu_ref", "trace", "cli")
TRACE_FUNCS = {"device_ms", "device_profile"}


def _first_tensor_device(frame):
    import torch

    for val in list(frame.f_locals.values()):
        if isinstance(val, torch.Tensor):
            return val.device.type
        if isinstance(val, torch.nn.Module):
            try:  # a module still in its __init__ has no parameters yet
                p = next(val.parameters(), None)
            except AttributeError:
                continue
            if p is not None:
                return p.device.type
    return None


def place(frame) -> str:
    """'chip_smoke_function:line > port_module.function' of one main-thread stack."""
    port = script = None
    f = frame
    while f is not None and script is None:
        path = f.f_code.co_filename
        if path.endswith("chip_smoke.py"):
            script = f"{f.f_code.co_name}:{f.f_lineno}"
        elif port is None and "s2t_tpu_torch/" in path:
            port = f"{Path(path).stem}.{f.f_code.co_name}"
        f = f.f_back
    return f"{script} > {port}" if port else str(script)


def classify(frame) -> str:
    """The kind of one main-thread stack, innermost frame first."""
    port_device = None
    f = frame
    while f is not None:
        name, path = f.f_code.co_name, f.f_code.co_filename
        if name in TRACE_FUNCS or "torch/profiler" in path or "torch/autograd/profiler" in path:
            return "trace"
        if "s2t_tpu_torch/cli/" in path or "s2t_tpu_torch/data/" in path or (
                path.endswith("chip_smoke.py") and name.startswith("write_")):
            return "cli"
        if port_device is None and "s2t_tpu_torch/" in path:
            port_device = _first_tensor_device(f)
        f = f.f_back
    return "cpu_ref" if port_device == "cpu" else "card"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose chip_smoke.py runs")
    ap.add_argument("--out", help="also write the split to this JSON file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke

    main_id = threading.get_ident()
    samples, marks, done = [], [], threading.Event()

    def sampler():
        while not done.is_set():
            frame = sys._current_frames().get(main_id)
            if frame is not None:
                samples.append((time.perf_counter(), classify(frame), place(frame)))
            time.sleep(INTERVAL_S)

    log = chip_smoke.log

    def marking_log(msg: str) -> None:
        if msg.startswith("[phase time] "):
            marks.append((time.perf_counter(), msg[len("[phase time] "):].split(":")[0]))
        log(msg)

    chip_smoke.log = marking_log
    thread = threading.Thread(target=sampler, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    try:
        rc = chip_smoke.main([])
    finally:
        done.set()
        thread.join()
    phases: dict = {}
    start, i = t0, 0
    for end, name in marks:
        row = phases.setdefault(name, {"s": 0.0, **{k: 0.0 for k in KINDS}, "places": {}})
        row["s"] += end - start
        while i < len(samples) and samples[i][0] <= end:
            _, kind, where = samples[i]
            row[kind] += INTERVAL_S
            key = f"{kind} {where}"
            row["places"][key] = row["places"].get(key, 0.0) + INTERVAL_S
            i += 1
        start = end
    # the samples' seconds, rescaled to the phase's wall time (the sleeps drift)
    for row in phases.values():
        total = sum(row[k] for k in KINDS)
        if total:
            for k in KINDS:
                row[k] = round(row[k] * row["s"] / total, 1)
        row["s"] = round(row["s"], 1)
        top = sorted(row["places"].items(), key=lambda kv: -kv[1])[:HOTSPOTS]
        row["places"] = {k: round(v, 1) for k, v in top}
    result = {"root": str(root), "rc": rc, "interval_s": INTERVAL_S, "phases": phases,
              "kinds_s": {k: round(sum(r[k] for r in phases.values()), 1) for k in KINDS}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
