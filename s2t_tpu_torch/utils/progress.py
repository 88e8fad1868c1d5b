"""Progress logging: ``simple`` and ``json`` lines, or ``none`` (counterpart
of s2t_tpu/utils/progress.py).  The TensorBoard, W&B and AzureML sinks are
not ported and raise ``NotImplementedError``."""

from __future__ import annotations

import json
import logging
from typing import Dict, Optional

logger = logging.getLogger("s2t_tpu_torch")

LOG_FORMATS = ("simple", "json", "none")


class ProgressLogger:
    def __init__(self, log_format: str = "simple", tensorboard_logdir: Optional[str] = None,
                 wandb_project: Optional[str] = None, azureml_logging: bool = False):
        for name, value in (("tensorboard_logdir", tensorboard_logdir),
                            ("wandb_project", wandb_project), ("azureml_logging", azureml_logging)):
            if value:
                raise NotImplementedError(f"ProgressLogger {name}={value!r}: the sink is not "
                                          "ported to s2t_tpu_torch")
        if log_format not in LOG_FORMATS:
            raise ValueError(f"log_format {log_format!r} not in {LOG_FORMATS}")
        self.log_format = log_format

    def log(self, stats: Dict[str, float], step: int, tag: str = "train",
            epoch: Optional[int] = None):
        if self.log_format == "json":
            print(json.dumps({"step": step, "tag": tag, **{
                k: round(float(v), 5) for k, v in stats.items() if isinstance(v, (int, float))
            }}), flush=True)
        elif self.log_format == "simple":
            parts = [f"{k} {float(v):.4g}" for k, v in stats.items()
                     if isinstance(v, (int, float))]
            prefix = f"epoch {epoch} | " if epoch is not None else ""
            logger.info("%s%s | step %d | %s", prefix, tag, step, " | ".join(parts))

    def close(self):
        pass
