"""Megabytes a step of float32 window-attention logits the forward
materialises: the counter ``swin/window_logit_bytes`` (``models/swin.py``
adds ``B·nW · heads · n² · 4`` at each ``WindowAttention`` forward) over
the window's steps, over 1e6. Swin-T at 224 px holds 2,189,712 logits an
image, so 480 view images a step read 4,204.2; another value means the
mechanism changed. None for a program without the counter."""

from harness.program import counter


def read(ctx):
    n = counter(ctx, "swin/window_logit_bytes")
    return None if n is None else n / ctx.steps / 1e6
