"""The share of the JPEG payloads, in %, that nvJPEG decoded a second time,
alone, after a batched call failed on its input: the counters
``jpeg/redecodes`` over ``jpeg/payloads`` (``data/jpeg_card.py``). The
pool holds no broken file, so 0 is expected."""

from harness.program import counter


def read(ctx):
    payloads = counter(ctx, "jpeg/payloads")
    if not payloads:
        return None
    return 100.0 * (counter(ctx, "jpeg/redecodes") or 0) / payloads
