"""Spans and counters of the port's own host work.

``span(name)`` times a stretch of code on the thread that runs it
(``time.perf_counter_ns``) and adds its duration, its *self* time (the
duration less what the spans opened inside it cover) and one to its count
to process-wide totals. ``count(name, n)`` adds to a counter. Names are
``/``-separated by layer: ``train/step``, ``step/views``, ``jpeg/decode``,
``randaugment/launches``. While a ``torch.profiler`` runs, a span also
opens ``torch.profiler.record_function(name)``, so it lands in the
profiler's trace beside the kernels, on the same clock; with no profiler
running it makes no such object.

Each thread keeps its own totals (made at its first span or count and
registered once under a lock), so the hot path takes no lock; its open
spans are a stack of the time their children cover. :func:`totals` sums
every thread's, :func:`since` is the difference from an earlier
:func:`totals`.

Every trainer's ``train_one`` runs inside :func:`epoch`: the outermost
such scope on a thread opens the span ``train/epoch`` and, when it ends,
keeps what happened in it, on every thread, as :func:`last_epoch`:
``{"spans": {name: (total_ns, self_ns, n)}, "counters": {name: n}}``.
:func:`per_step` turns such a record into the run log's
``time/<span>_ms_per_step`` and ``count/<counter>_per_step`` fields.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from time import perf_counter_ns

import torch

_ZERO = (0, 0, 0)
_lock = threading.Lock()
_threads: list = []  # every thread's _Totals, in the order they started
_local = threading.local()
_last = None


class _Totals:
    __slots__ = ("spans", "counters", "stack", "epochs")

    def __init__(self):
        self.spans = {}  # name -> (total_ns, self_ns, n)
        self.counters = {}  # name -> n
        self.stack = []  # each open span's children's ns, innermost last
        self.epochs = 0  # open epoch() scopes


def _mine() -> _Totals:
    try:
        return _local.totals
    except AttributeError:
        t = _local.totals = _Totals()
        with _lock:
            _threads.append(t)
        return t


class span:
    """``with span(name):`` times the block on this thread."""

    __slots__ = ("name", "_t", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t = t = _mine()
        t.stack.append(0)
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self._t0
        t = self._t
        children = t.stack.pop()
        if t.stack:
            t.stack[-1] += dt
        total, own, n = t.spans.get(self.name, _ZERO)
        # one store of a new tuple: a reader on another thread never sees
        # a total without its count
        t.spans[self.name] = (total + dt, own + dt - children, n + 1)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    c = _mine().counters
    c[name] = c.get(name, 0) + n


def totals() -> dict:
    """Every thread's spans and counters, summed."""
    with _lock:
        threads = list(_threads)
    spans, counters = {}, {}
    for t in threads:
        for name, (a, b, n) in t.spans.copy().items():
            x = spans.get(name, _ZERO)
            spans[name] = (x[0] + a, x[1] + b, x[2] + n)
        for name, n in t.counters.copy().items():
            counters[name] = counters.get(name, 0) + n
    return {"spans": spans, "counters": counters}


def since(before: dict) -> dict:
    """What :func:`totals` gained since ``before``: the spans that ran and
    the counters that moved."""
    now = totals()
    spans = {}
    for name, (a, b, n) in now["spans"].items():
        x = before["spans"].get(name, _ZERO)
        if n != x[2]:
            spans[name] = (a - x[0], b - x[1], n - x[2])
    counters = {}
    for name, n in now["counters"].items():
        if n != before["counters"].get(name, 0):
            counters[name] = n - before["counters"].get(name, 0)
    return {"spans": spans, "counters": counters}


def counter(name: str) -> int:
    """The counter's value, over every thread."""
    return totals()["counters"].get(name, 0)


@contextmanager
def epoch():
    """A ``train_one`` call's scope. Only the outermost on a thread
    counts: it runs inside the span ``train/epoch`` and leaves its record
    for :func:`last_epoch`."""
    global _last
    t = _mine()
    t.epochs += 1
    try:
        if t.epochs > 1:
            yield
            return
        before = totals()
        with span("train/epoch"):
            yield
        _last = since(before)
    finally:
        t.epochs -= 1


def last_epoch():
    """The record of the last outermost :func:`epoch`, None before one
    ended."""
    return _last


def per_step(record: dict) -> dict:
    """A record's spans in ms and its counters, each a step (over its
    count of ``train/step`` spans), as the run log's
    ``time/<span>_ms_per_step`` and ``count/<counter>_per_step`` fields;
    empty when the record took no step."""
    steps = record["spans"].get("train/step", _ZERO)[2]
    if not steps:
        return {}
    out = {f"time/{name}_ms_per_step": v[0] / 1e6 / steps
           for name, v in record["spans"].items()}
    out.update({f"count/{name}_per_step": n / steps
                for name, n in record["counters"].items()})
    return out
