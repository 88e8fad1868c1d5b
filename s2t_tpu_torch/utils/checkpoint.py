"""Checkpointing: save and resume, last / best / epoch / interval files,
rotation, best-k tracking and averaging (counterpart of
s2t_tpu/utils/checkpoint.py:44-201).

The file format is the port's own: ``torch.save`` of a tree of tensors and
plain Python values (``Trainer.state_dict()``), with the metadata (step,
epoch, validation metric, the epoch iterator's state) in a ``.json``
sidecar, as in the JAX package.  ``async_save`` writes on a thread.  Loading
the JAX package's msgpack checkpoints waits for the interop slice.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

_BEST_SCORE = re.compile(r"_(-?[\d.]+)_\d+\.pt$")


def save_tree(path: str | Path, tree: Any) -> None:
    tmp = str(path) + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_tree(path: str | Path) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _best_score(p: Path) -> float:
    m = _BEST_SCORE.search(p.name)
    return float(m.group(1)) if m else 0.0


class CheckpointManager:
    """Rotation and best-k tracking (file names as the JAX package's)."""

    def __init__(
        self,
        save_dir: str | Path,
        keep_last_epochs: int = -1,
        keep_interval_updates: int = -1,
        keep_best_checkpoints: int = -1,
        best_metric: str = "loss",
        maximize_best: bool = False,
        async_save: bool = False,
    ):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_epochs = keep_last_epochs
        self.keep_interval_updates = keep_interval_updates
        self.keep_best_checkpoints = keep_best_checkpoints
        self.best_metric = best_metric
        self.maximize_best = maximize_best
        self.async_save = async_save
        self._best: Optional[float] = None
        self._threads: List[threading.Thread] = []

    def _write(self, name: str, tree: Any, meta: Dict[str, Any]):
        path = self.save_dir / name

        def do():
            save_tree(path, tree)
            with open(str(path) + ".json", "w") as f:
                json.dump(meta, f)

        if self.async_save:
            t = threading.Thread(target=do, daemon=True)
            t.start()
            self._threads.append(t)
        else:
            do()

    def wait(self):
        for t in self._threads:
            t.join()
        self._threads.clear()

    def _is_better(self, val: float) -> bool:
        if self._best is None:
            return True
        return val > self._best if self.maximize_best else val < self._best

    def save(self, tree: Any, step: int, epoch: int, val_metric: Optional[float] = None,
             end_of_epoch: bool = True, extra_meta: Optional[Dict[str, Any]] = None) -> None:
        """Write ``checkpoint<epoch>.pt`` (or ``checkpoint_<epoch>_<step>.pt``
        mid-epoch), ``checkpoint_last.pt`` and, on a new best metric,
        ``checkpoint_best.pt``; then rotate.  ``extra_meta`` (the epoch
        iterator's state) goes into the json sidecar."""
        meta = {"step": step, "epoch": epoch, "val_metric": val_metric,
                "best_metric_name": self.best_metric}
        if extra_meta:
            meta.update(extra_meta)
        self._write(f"checkpoint{epoch}.pt" if end_of_epoch else f"checkpoint_{epoch}_{step}.pt",
                    tree, meta)
        self._write("checkpoint_last.pt", tree, meta)
        if val_metric is not None:
            if self._is_better(val_metric):
                self._best = val_metric
                self._write("checkpoint_best.pt", tree, meta)
            if self.keep_best_checkpoints > 0:
                self._write(f"checkpoint.best_{self.best_metric}_{val_metric:.4f}_{step}.pt",
                            tree, meta)
        self.wait()
        self._rotate()

    @staticmethod
    def _unlink(paths):
        for p in paths:
            p.unlink(missing_ok=True)
            Path(str(p) + ".json").unlink(missing_ok=True)

    def _rotate(self):
        if self.keep_last_epochs > 0:
            epochs = [p for p in self.save_dir.glob("checkpoint[0-9]*.pt")
                      if re.match(r"checkpoint\d+\.pt$", p.name)]
            epochs.sort(key=lambda p: int(p.stem[len("checkpoint"):]))
            self._unlink(epochs[: -self.keep_last_epochs])
        if self.keep_interval_updates > 0:
            interval = sorted(self.save_dir.glob("checkpoint_*_*.pt"),
                              key=lambda p: int(p.stem.split("_")[-1]))
            self._unlink(interval[: -self.keep_interval_updates])
        if self.keep_best_checkpoints > 0:
            self._unlink(self.best_checkpoints(None)[self.keep_best_checkpoints:])

    def best_checkpoints(self, n: Optional[int]) -> List[Path]:
        ckpts = sorted(self.save_dir.glob(f"checkpoint.best_{self.best_metric}_*.pt"),
                       key=_best_score, reverse=self.maximize_best)
        return ckpts if n is None else ckpts[:n]


def load_checkpoint(path: str | Path):
    """Returns (tree, meta dict)."""
    tree = load_tree(path)
    meta_path = str(path) + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def average_checkpoints(paths: List[str | Path]) -> Dict[str, torch.Tensor]:
    """Uniform parameter averaging in float64, returned as float32."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        tree, _ = load_checkpoint(p)
        params = tree.get("params", tree)
        if acc is None:
            acc = {k: v.double() for k, v in params.items()}
        else:
            if set(params) != set(acc):
                raise KeyError(f"{p}: parameters differ from the first checkpoint's")
            for k, v in params.items():
                acc[k] += v.double()
    return {k: (v / len(paths)).float() for k, v in acc.items()}
