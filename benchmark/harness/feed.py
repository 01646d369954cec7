"""Step boundaries, from around the loaders the trainer iterates.

``train_one`` takes a labeled batch, then an unlabeled batch, then
enqueues the step. :class:`Feed` wraps both loaders; at each labeled
``next()`` it records a CUDA event on the current stream (a step's
boundary: the stream reaches it when the previous step's work is done)
and the host time since the unlabeled batch's return (the previous
step's enqueue and the drain that follows it). It also sums the host
time spent inside both loaders' ``next()``. Nothing inside the program
is touched.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class StepClock:
    def __init__(self, events: bool):
        self.events_on = events
        self.reset()

    def reset(self) -> None:
        self.events: list = []
        self.wait_s = 0.0
        self.enqueue_s = 0.0
        self.enqueue_n = 0
        self.steps = 0
        self.marks: list = []  # host time of each step boundary
        self._last_return = None
        self.capture = None  # a list: copies of every batch handed out

    def epoch_start(self) -> None:
        self._last_return = None

    def mark(self, now: float) -> None:
        if self.events_on:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)
        self.marks.append(now)
        if self._last_return is not None:
            self.enqueue_s += now - self._last_return
            self.enqueue_n += 1
        self.steps += 1

    def intervals_ms(self, end_event) -> np.ndarray:
        """Device time between successive step boundaries, the last step
        ending at ``end_event`` (call after a synchronize)."""
        marks = self.events + [end_event]
        return np.array([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])


def _copy(batch):
    return tuple(x.clone() if torch.is_tensor(x) else np.array(x)
                 for x in batch)


class _Timed:
    def __init__(self, loader, clock: StepClock, boundary: bool,
                 alter=None):
        self.loader, self.clock, self.boundary = loader, clock, boundary
        self.alter = alter

    def __getattr__(self, name):  # manifest, sample, close, ...
        return getattr(self.loader, name)

    def __iter__(self):
        clock = self.clock
        if self.boundary:
            clock.epoch_start()
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            if self.boundary:
                clock.mark(t0)
            batch = next(it)
            if self.alter is not None:
                batch = self.alter(batch)
            t1 = time.perf_counter()
            clock.wait_s += t1 - t0
            if not self.boundary:
                clock._last_return = t1
            if clock.capture is not None:
                clock.capture.append(_copy(batch))
            yield batch


class Feed:
    """``(labeled, unlabeled)`` wrapped, sharing one :class:`StepClock`.
    ``alter`` (a fault for the tests and the readings) maps each batch
    before the trainer takes it."""

    def __init__(self, labeled, unlabeled, events: bool = True, alter=None):
        self.clock = StepClock(events)
        self.loaders = (_Timed(labeled, self.clock, True, alter),
                        _Timed(unlabeled, self.clock, False, alter))
