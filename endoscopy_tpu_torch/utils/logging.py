"""The run log (port of ``endoscopy_tpu/utils/logging.py``'s
``MetricLogger``).

Metrics go to a JSONL run log, optionally mirrored to wandb when it is
importable. Timing is ``utils/trace.py``'s: the trainers write each
epoch's spans and counters into this log.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """JSONL metric log: one line per ``log()`` call with step/epoch tags;
    no file without a ``log_dir``."""

    def __init__(self, log_dir: Optional[str], run_name: str = "run",
                 use_wandb: bool = False) -> None:
        self.path = None
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{run_name}.jsonl")
            self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:  # optional dependency
                import wandb
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: Dict, step: Optional[int] = None,
            epoch: Optional[int] = None) -> None:
        record = {"ts": time.time(), **metrics}
        if step is not None:
            record["step"] = int(step)
        if epoch is not None:
            record["epoch"] = int(epoch)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
