"""Build the port's CUDA sources into shared libraries and load them with ctypes.

Each ``s2t_tpu_torch/csrc/<name>.cu`` is compiled on first use by its own
``nvcc`` process into ``s2t_tpu_torch/_build/lib<name>-<hash>.so``; the hash
covers the source, the shared ``*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is reused.  The sources have a plain C
interface (no PyTorch headers), which keeps a build to seconds.  Pointers and
the stream are passed as ``ctypes.c_void_p``.  A failed build raises with the compiler's output.
``start`` launches the compilers and returns at once, so that a caller can do other
work while they run; ``build`` (and a library's first load) waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# loaded libraries, one per source, for the life of the process
_loaded: Dict[str, ctypes.CDLL] = {}
# compilers started and not yet waited for: name -> (process, its output file, the
# library's temporary and final paths, start time, {"end": time the process exited})
_pending: Dict[str, tuple] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of s2t_tpu_torch are built on the machine with the card"
        )
    return path


def sources() -> Tuple[str, ...]:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared headers, e.g. dropout_hash.cuh
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def start(names: Optional[Iterable[str]] = None) -> None:
    """Start one ``nvcc`` for each named source (default: all) that is out of date and
    not compiling already, all together, and return without waiting."""
    names = tuple(names) if names is not None else sources()
    todo = [n for n in names if n not in _pending and not library_path(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:  # a file, not a pipe: nothing need read it while it runs
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        exited: Dict[str, float] = {}
        threading.Thread(target=lambda p=proc, e=exited: (p.wait(), e.update(
            end=time.perf_counter())), daemon=True).start()
        _pending[name] = (proc, log, tmp, out, time.perf_counter(), exited)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources (default: all) that are out of date, one
    ``nvcc`` per source, all started together (or by ``start`` earlier), and wait
    for them.  Returns {name: (seconds from start to exit, compiler output)} for
    the sources it compiled."""
    names = tuple(names) if names is not None else sources()
    start(names)
    done, failed = {}, []
    for name in names:
        if name not in _pending:
            continue
        proc, log_path, tmp, out, t0, exited = _pending.pop(name)
        proc.wait()
        log = log_path.read_text()
        log_path.unlink()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (exited.get("end", time.perf_counter()) - t0, log)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return done


def load_library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``, declaring each function's
    ``(restype, argtypes)`` from ``signatures``."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
    return lib
