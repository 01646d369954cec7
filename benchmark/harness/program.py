"""The program's own spans and counters over the window.

The port keeps, in ``endoscopy_tpu_torch/utils/trace.py``, a record of
its last ``train_one`` call: every span's total and self nanoseconds and
count, and every counter, on every thread. ``cell.py`` reads the metrics
right after the window's ``train_one``, so the record is the window's.
A step is one ``train/step`` span; the record must hold one for each of
the window's steps. A program without the tracer (an older commit), or
a record without the span or counter asked for, gives None: the metric
is left out of the line.

The harness reads per-layer metrics only in the ``--trace 1`` run, under
its CUDA profiler, whose per-launch cost stretches the host's
launch-heavy spans (the forward, the backward) and so moves time out of
the waits (the drain) into the device's idle share. The spans need no
profiler: an untraced run of the same cell times them unstretched.
"""

from __future__ import annotations


def record(ctx):
    """The window's record, or None where the program keeps none."""
    try:
        from endoscopy_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = trace.last_epoch()
    if rec is None:
        return None
    steps = rec["spans"].get("train/step", (0, 0, 0))[2]
    if steps != ctx.steps:
        raise ValueError(f"the program's record holds {steps} train/step "
                         f"spans; the window took {ctx.steps} steps")
    return rec


def span_ms(ctx, name: str, own: bool = False):
    """Milliseconds a step in the span ``name``: its whole time, or with
    ``own`` its self time (less the spans opened inside it)."""
    rec = record(ctx)
    if rec is None or name not in rec["spans"]:
        return None
    total_ns, self_ns, _ = rec["spans"][name]
    return (self_ns if own else total_ns) / 1e6 / ctx.steps


def counter(ctx, name: str):
    """The counter's gain over the window, None where it did not move."""
    rec = record(ctx)
    if rec is None:
        return None
    return rec["counters"].get(name)
