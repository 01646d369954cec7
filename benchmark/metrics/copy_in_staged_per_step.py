"""Batches of host rows staged to the card a step: the counter
``views/staged`` (``aug/views.py::_u8_on_device``: each batch copied into
page-locked memory and sent on a copy stream) over the window's steps.
Two are expected in the cached cells, the labeled and the unlabeled
batch; rows already on the card (the JPEG route) stage nothing. None for
a program that stages nothing, or keeps no such counter."""

from harness.program import counter


def read(ctx):
    n = counter(ctx, "views/staged")
    return None if n is None else n / ctx.steps
