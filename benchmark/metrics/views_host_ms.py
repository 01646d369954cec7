"""Host milliseconds a step in the views, less the copy of the uint8 rows
to the card: the self time of the span ``step/views`` (the trainer's
``_views``), from the program's record of the window. Read in the
``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "step/views", own=True)
