"""Passes a step through Swin's fused window-attention kernel: the counter
``window_attention/fused`` (``ops/window_attention.py`` adds one at each
forward and one at each backward that runs the kernel) over the window's
steps. Swin-T has 12 window-attention blocks, so one forward and one
backward a step read 24.0; another value means the mechanism changed.
None for a program without the kernel, or whose window attention took
the plain path (``harness/program.py``)."""

from harness.program import counter


def read(ctx):
    n = counter(ctx, "window_attention/fused")
    return None if n is None else n / ctx.steps
