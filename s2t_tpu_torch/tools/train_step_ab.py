"""Time the bf16 training step of several checkouts in turn on one card.

    python3 -m s2t_tpu_torch.tools.train_step_ab TREE [TREE ...] [--out results.json]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and
``s2t_tpu_torch/``).  Each runs in a process of its own, from its own root, so
it imports its own package, builds its own kernels and runs ``chip_smoke.py``'s
phase 8: s2t_transformer_m in bf16 at the bench shape, one warm-up step, 20
timed steps and one profiled step.  Give two checkouts as A B B A to compare
them on one host, whose step time varies between machines.  Prints one JSON
line per run and, last, the median step ms and device busy ms per tree.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

RUN_TIMEOUT_S = 600  # one checkout: its build, the model, 22 steps
KEYS = ("step_ms", "steps_per_s", "profiled_step_wall_ms", "profiled_device_busy_ms",
        "peak_memory_gb", "kernel_device_ms")
CHILD = f"""
import json, torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke._build.build()
res = chip_smoke.phase_train_speed()[0]
print("RESULT " + json.dumps({{k: res[k] for k in {KEYS!r}}}))
"""


def run_tree(tree: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=RUN_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--out", help="also write every run to this JSON file")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        res = {"run": i, "tree": str(tree), **run_tree(tree.resolve())}
        runs.append(res)
        print(json.dumps(res), flush=True)
    summary = {str(tree): {key: statistics.median(r[key] for r in runs if r["tree"] == str(tree))
                           for key in ("step_ms", "profiled_device_busy_ms")}
               for tree in dict.fromkeys(args.trees)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "runs": runs,
                                              "median": summary}, indent=1))
    print(json.dumps({"median": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
