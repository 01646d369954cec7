"""The RandAugment kernel's share of its memory roofline, in %: the least
bytes the strong view needs (B·MU images at IMG_SIZE in bf16, read once
and written once, plus each image's 8 int32 and 4 float32 parameters)
at 3.35 TB/s, over the kernel's mean device time a launch in the trace
(kernels named ``randaugment``). The bytes come from the configuration,
so the metric reads the same work whatever computes it."""


def strong_view_bytes(config) -> int:
    b = int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    side = int(config.DATA.IMG_SIZE)
    return 2 * b * side * side * 3 * 2 + b * (8 * 4 + 4 * 4)


def read(ctx):
    if ctx.events is None:
        return None
    times = [(e - s) / 1e6 for name, s, e in ctx.events
             if "randaugment" in name]
    if not times:
        return None
    bound_s = strong_view_bytes(ctx.config) / ctx.hbm_bytes_per_s
    return 100.0 * bound_s / (sum(times) / len(times))
