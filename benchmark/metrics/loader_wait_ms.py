"""Host milliseconds a step inside the train loaders' ``next()`` (the
labeled and the unlabeled one together), from the benchmark's wrapper
around them (``harness/feed.py``)."""


def read(ctx):
    return ctx.clock.wait_s * 1e3 / ctx.steps
