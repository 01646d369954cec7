"""Host milliseconds a step in ``loss.backward()``: the span
``step/backward`` (``BaseTrainer._backward``), the autograd engine
enqueueing the backward kernels.
Read in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "step/backward")
