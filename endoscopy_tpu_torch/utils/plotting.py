"""Optional-matplotlib guard shared by the plotting call sites (copy of
``endoscopy_tpu/utils/plotting.py``).

It imports nothing of the port's tensor code, so the EDA CLI can draw on a
data-preparation box that has pandas and matplotlib and no card.
"""

from __future__ import annotations


def _plt():
    """Agg-backend pyplot, or None when matplotlib is unavailable (the
    callers then return their arrays and write no PNG)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:  # pragma: no cover
        return None
