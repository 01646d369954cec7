"""The share of the deferred step losses, in %, whose step the card had
not yet finished when the drain read them: the counters ``drain/waited``
over ``drain/fetches`` (``BaseTrainer._drain_pending``, each loss read
two steps after its step through its own event). Near 100 where the card
sets the pace, near 0 where the host does. None for a program whose
drain keeps no such counters."""

from harness.program import counter


def read(ctx):
    fetches = counter(ctx, "drain/fetches")
    if not fetches:
        return None
    return 100.0 * (counter(ctx, "drain/waited") or 0) / fetches
