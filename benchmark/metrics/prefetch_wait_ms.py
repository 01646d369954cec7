"""Host milliseconds a step on the main thread waiting for the native
loaders' prefetched batches: the span ``loader/prefetch_wait``
(``data/native_loader.py::_CardStream.batches``), inside the loaders'
``next()``.
Read in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "loader/prefetch_wait")
