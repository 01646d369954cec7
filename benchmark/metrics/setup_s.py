"""Seconds from the process's start (the first line of ``run.py``) to the
window's first step: imports, the kernels' builds or loads, the pool, the
weights, the trainer, the three checked steps and the warm-up."""


def read(ctx):
    return ctx.setup_s
