"""Host milliseconds a step from the unlabeled batch's return to the
next step's labeled ``next()``: the step's views, forward, backward,
optimizer and EMA enqueued, and the loss fetched two steps late
(``harness/feed.py``). The window's last step has no next ``next()``
and is not counted."""


def read(ctx):
    if ctx.clock.enqueue_n == 0:
        return None
    return ctx.clock.enqueue_s * 1e3 / ctx.clock.enqueue_n
