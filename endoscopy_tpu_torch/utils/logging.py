"""Training observability (port of ``endoscopy_tpu/utils/logging.py``).

Metrics go to a JSONL run log, optionally mirrored to wandb when it is
importable; :class:`Throughput` counts images per second;
:func:`profiler_trace` writes a ``torch.profiler`` trace of a scope.
"""

from __future__ import annotations

import contextlib
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


class Throughput:
    """images/sec since the last ``reset()``, over the steps counted."""

    def __init__(self, images_per_step: int) -> None:
        self.images_per_step = images_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps * self.images_per_step / max(dt, 1e-9)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` scope (the host, and the card when there is
    one) that writes its Chrome trace to ``log_dir/trace.json``; a no-op
    when ``log_dir`` is falsy. The JAX package's version has no caller;
    ``tools/torch_port/profile_step.py`` profiles the port's step."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
