"""The resize kernel's share of its memory roofline, in %: the least
bytes the canonical rows need (the source pixels the bilinear taps reach,
``taps(side)²·3`` an image, read once, and ``S²·3`` written) at 3.35
TB/s, over the device time of the ``resize_bilinear`` kernels in the
trace. Each step decodes B + B·MU files in two launches (the labeled and
the unlabeled stream); the bound counts that many images for every two
launches. The taps come from the core's arithmetic
(``reference/jpeg.py::taps``), not from the whole file."""

from reference.jpeg import taps


def image_bytes(side: int, size: int) -> int:
    return taps(side, size) ** 2 * 3 + size * size * 3


def read(ctx):
    if ctx.events is None or ctx.traffic.get("loader") != "native":
        return None
    times = [(e - s) / 1e6 for name, s, e in ctx.events
             if "resize_bilinear" in name]
    if not times:
        return None
    side = int(ctx.traffic["files"]["side"])
    images = len(times) / 2 * ctx.images_per_step
    bound_s = images * image_bytes(side, ctx.canonical_size) \
        / ctx.hbm_bytes_per_s
    return 100.0 * bound_s / sum(times)
