"""Dataset images the window consumed a second: each step takes B
labeled and B·MU unlabeled images (an unlabeled image counts once,
though it gives two views), over the window's seconds on the host clock,
its closing synchronize included."""


def read(ctx):
    return ctx.steps * ctx.images_per_step / ctx.window_s
