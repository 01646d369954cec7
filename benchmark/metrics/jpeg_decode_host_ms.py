"""Host milliseconds a step in nvJPEG's batched decode calls, on the
loaders' prefetch threads: the span ``jpeg/decode``
(``data/jpeg_card.py::decode_raw``, which returns once the decode on the
card is done), summed over both loaders.
Read in the ``--trace 1`` run only, so the host is a profiled one
(``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "jpeg/decode")
