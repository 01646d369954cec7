"""Host milliseconds a step in the host-to-device copy of the loaders' uint8
rows: the span ``views/copy_in`` (``aug/views.py::_u8_on_device``), inside
the views; rows already on the card (the JPEG route) copy nothing. Read
in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "views/copy_in")
