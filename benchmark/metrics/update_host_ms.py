"""Host milliseconds a step in the update: the span ``step/update``
(``BaseTrainer._accumulate`` outside the forward and backward: the train
mode and the gradients set to none before, the zero-fill of missing
gradients, the sums over ranks, the freeze mask, the learning rate,
``optimizer.step`` and the EMA after).
Read in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "step/update")
