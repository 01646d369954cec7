"""Launches of the RandAugment kernel a step: the counter
``randaugment/launches`` (``ops/randaugment_kernel.py``) over the
window's steps. One strong view, so one launch, is expected."""

from harness.program import counter


def read(ctx):
    n = counter(ctx, "randaugment/launches")
    return None if n is None else n / ctx.steps
