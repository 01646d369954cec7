"""The share of the traced window, in %, in which no kernel, copy or set
ran on any stream of the card: 1 less the union of the device intervals
in the trace (``harness/trace.py::union_s``) over their span, from the
window's first operation to its last (``span_s``). The profiler's own
host work before the first step and after the last is outside the span;
inside it, in a host-bound cell, the profiler slows the host's enqueue
and so adds idle time of its own (PERF.md gives the stretch)."""

from harness.trace import span_s, union_s


def read(ctx):
    if not ctx.events:
        return None
    return 100.0 * (1.0 - union_s(ctx.events) / span_s(ctx.events))
