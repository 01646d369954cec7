"""Host milliseconds a step inside Swin's window attention: the self time
of the span ``model/window_attention`` (``models/swin.py``:
``WindowAttention.forward``, the enqueue of the bias gather, the
products, the float32 logits chain, the softmax and the projection),
from the program's record of the window. None for a program without the
span (``harness/program.py``)."""

from harness.program import span_ms


def read(ctx):
    return span_ms(ctx, "model/window_attention", own=True)
