"""What the host did during the window, for the run's standard error.

A host-bound step moves with the host: with the speed of the core that
runs the main thread, with garbage collections and with other threads.
:class:`Window` reads them at the window's start and end, so a run that
reads slow says why: the main thread's CPU milliseconds a step (the same
work on a slower core takes longer), the whole process's, the
collector's pauses, and the steps' intervals (a uniform slowdown moves
the median; a stall, the longest steps). None of it enters a metric.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np


class Window:
    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = [0, 0, 0]
        self._gc_t = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n[info["generation"]] += 1
            self._gc_t = None

    @staticmethod
    def _now():
        t = os.times()
        return time.perf_counter(), time.thread_time(), t.user + t.system

    def start(self) -> None:
        gc.callbacks.append(self._on_gc)
        self._t = self._now()

    def stop(self) -> None:
        self._u = self._now()
        gc.callbacks.remove(self._on_gc)

    def summary(self, steps: int, host_marks, intervals_ms) -> dict:
        (w0, th0, p0), (w1, th1, p1) = self._t, self._u
        out = {"wall_s": w1 - w0,
               "main_cpu_ms_per_step": (th1 - th0) * 1e3 / steps,
               "process_cpu_ms_per_step": (p1 - p0) * 1e3 / steps,
               "gc_s": self.gc_s, "gc_collections": self.gc_n}
        if len(host_marks) > 1:
            out["host_step_ms"] = _quantiles(np.diff(host_marks) * 1e3)
        if intervals_ms is not None and len(intervals_ms):
            iv = np.asarray(intervals_ms)
            q = _quantiles(iv)
            q["over_1.5x_median"] = int((iv > 1.5 * q["p50"]).sum())
            q["longest_steps"] = [[int(i), float(iv[i])]
                                  for i in np.argsort(-iv)[:5]]
            out["device_step_ms"] = q
        return out


def _quantiles(v: np.ndarray) -> dict:
    p = np.percentile(v, [50, 90, 95, 99])
    return {"p50": float(p[0]), "p90": float(p[1]), "p95": float(p[2]),
            "p99": float(p[3]), "max": float(v.max()), "n": int(len(v))}
