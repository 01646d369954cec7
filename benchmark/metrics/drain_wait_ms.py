"""Host milliseconds a step blocked on the device in the drain: the span
``step/drain`` (``BaseTrainer._drain_pending``, the loss of two steps
before fetched to the host). The fetch copies on the step's stream, behind
the step just enqueued, so the host waits there for the card to finish
it. Read in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``): a host slowed at each launch falls behind the
card, and a wait the unprofiled host spends here shows as device idle
time instead. Size the drain itself from an untraced run."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "step/drain")
