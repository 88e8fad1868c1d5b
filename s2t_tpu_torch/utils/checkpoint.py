"""Checkpointing: save and resume, last / best / epoch / interval files,
rotation, best-k tracking, averaging and pretrained-component transplant
(counterpart of s2t_tpu/utils/checkpoint.py:44-277).

The file format is the port's own: ``torch.save`` of a tree of tensors and
plain Python values (``Trainer.state_dict()``), with the metadata (step,
epoch, validation metric, the epoch iterator's state) in a ``.json``
sidecar, as in the JAX package.  A save serialises the tree once; its other names
(``checkpoint_last.pt``, ``checkpoint_best.pt``, ...) are hard links to that file.
``async_save`` writes on a thread.  Loading
the JAX package's msgpack checkpoints waits for the interop slice.
``transplant_component`` copies one component of a state dict into another
(``--load-pretrained-{encoder,decoder}-from``), components named as in JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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

    def _write(self, names: List[str], tree: Any, meta: Dict[str, Any]):
        """Serialise ``tree`` once to the first of ``names``; the others are hard links to
        that file (a copy where the file system has none).  A later save replaces a name
        through its own temporary file, which leaves the other names' data as it was."""
        paths = [self.save_dir / name for name in names]

        def do():
            save_tree(paths[0], tree)
            for path in paths[1:]:
                tmp = Path(str(path) + ".tmp")
                tmp.unlink(missing_ok=True)
                try:
                    os.link(paths[0], tmp)
                except OSError:
                    shutil.copyfile(paths[0], tmp)
                os.replace(tmp, path)
            for path in paths:
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
        names = [f"checkpoint{epoch}.pt" if end_of_epoch else f"checkpoint_{epoch}_{step}.pt",
                 "checkpoint_last.pt"]
        if val_metric is not None:
            if self._is_better(val_metric):
                self._best = val_metric
                names.append("checkpoint_best.pt")
            if self.keep_best_checkpoints > 0:
                names.append(f"checkpoint.best_{self.best_metric}_{val_metric:.4f}_{step}.pt")
        self._write(names, tree, meta)
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


def _component_keys(params: Dict[str, torch.Tensor], component: str) -> Dict[tuple, str]:
    """The keys of ``params`` under ``component`` ("encoder", "decoder",
    "encoder/acoustic", ...), by their path below it in the flax tree (the
    port's names through ``interop/from_flax.py``'s map)."""
    from s2t_tpu_torch.interop.from_flax import flax_path

    parts = tuple(component.split("/"))
    out = {}
    for key, val in params.items():
        path = flax_path(key, val.dim())
        if path[:len(parts)] == parts:
            out[path[len(parts):]] = key
    return out


def transplant_component(target_params: Dict[str, torch.Tensor],
                         source_params: Dict[str, torch.Tensor], component: str,
                         strict: bool = True, source_component: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """A copy of ``target_params`` (a state dict) whose ``component`` comes from
    ``source_params`` (s2t_tpu/utils/checkpoint.py:204-277).  ``source_component``
    names it in the source when the path differs (SATE: "encoder" into
    "encoder/acoustic").  Every target entry of the component must be in the
    source with its shape; ``strict`` also refuses source entries the target
    lacks (``strict=False``: a wav2vec 2.0 pretraining checkpoint's quantizer and
    projections into a fine-tuning model).  Raises KeyError otherwise."""
    tgt = _component_keys(target_params, component)
    src = _component_keys(source_params, source_component or component)
    if not src:
        raise KeyError(f"component path {source_component or component!r} missing in the source")
    if not tgt:
        raise KeyError(f"component path {component!r} missing in the target")
    missing, extra = set(tgt) - set(src), set(src) - set(tgt)
    if missing or (extra and strict):
        raise KeyError(f"component {component} structure mismatch: target only "
                       f"{sorted('/'.join(m) for m in missing)}, source only "
                       f"{sorted('/'.join(e) for e in extra)}")
    out = dict(target_params)
    for path, key in tgt.items():
        val = source_params[src[path]]
        if tuple(val.shape) != tuple(target_params[key].shape):
            raise KeyError(f"shape mismatch at {component}/{'/'.join(path)}: "
                           f"{tuple(target_params[key].shape)} vs {tuple(val.shape)}")
        out[key] = val.clone()
    return out
