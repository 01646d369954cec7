"""Graceful preemption (copy of ``endoscopy_tpu/train/preempt.py``).

SIGTERM (a spot instance reclaimed, a scheduler's eviction) sets a flag
that ``BaseTrainer.fit`` polls at each epoch boundary: fit saves a
checkpoint to ``TRAIN.SAVE_CP`` and returns, and the CLI exits 143
(128 + SIGTERM), so an orchestrator tells "preempted, resumable" from
success or a crash. Resume with ``MODEL.PRE_TRAIN_RESUME``.

The handler is installed by the CLI (``cli.learn``), never at import time:
library users keep their own signal disposition unless they opt in.
"""

from __future__ import annotations

import signal
import threading

_requested = threading.Event()


def install(signals=(signal.SIGTERM,)) -> None:
    """Route the given signals to the preemption flag (main thread only)."""

    def _handler(signum, frame):  # noqa: ARG001 — signal API
        _requested.set()
        print(f"[preempt] signal {signum}: will checkpoint and stop at the "
              "next epoch boundary", flush=True)

    for s in signals:
        signal.signal(s, _handler)


def requested() -> bool:
    """True once a preemption signal arrived (or request() was called)."""
    return _requested.is_set()


def request() -> None:
    """Programmatic preemption (tests, embedding frameworks)."""
    _requested.set()


def reset() -> None:
    """Clear the flag (tests; a fresh run after a handled preemption)."""
    _requested.clear()
