"""The whole step's share of the card's dense bf16 peak, in %: model
FLOPs a step (the benchmark's reference model, counted by
``reference/flops.py`` at IMG_SIZE, times the view images a step, B · (1
+ 2 MU)) times the steps, over the window's seconds, over 989 TFLOP/s
(H100 SXM data sheet)."""

from reference.flops import train_flops_per_image


def read(ctx):
    per_image = train_flops_per_image(ctx.reference_model,
                                      int(ctx.config.DATA.IMG_SIZE))
    flops = per_image * ctx.view_images_per_step * ctx.steps
    return 100.0 * flops / ctx.window_s / ctx.peak_flops
