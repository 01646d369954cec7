"""Host milliseconds a step in the forward and the losses: the self time
of the span ``step/forward_backward`` (each ``forward_backward`` call of
``BaseTrainer._accumulate``), less its child ``step/backward``.
Read in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "step/forward_backward", own=True)
