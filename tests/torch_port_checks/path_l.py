"""Paths L and M's configs: Swin-T and the rest of the zoo in the
supervised trainer.

The fields of ``configs/kaggle_supervised_patho.yaml`` written out, since
the card's machine has no PyYAML, with ``MODEL.NAME`` the one field
changed: ``swin_tiny_patch4_window7_224`` (Swin-T, the timm name the
reference trains) for path L; path M puts each name of ``M_NAMES`` there.
``zoo.py`` holds them against the file on the CPU. No JAX, pandas, cv2,
PIL or PyYAML.
"""

import math

PATHO_SWIN = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "swin_tiny_patch4_window7_224",
              "MARGIN": "None"},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 100, "OPT_NAME": "Adam",
              "SCH_NAME": "cosine", "FREQ_EVAL": 2, "CLS_WEIGHT": True,
              "USE_EMA": True},
}
PRESETS = {"kaggle_supervised_patho": PATHO_SWIN}
# path M: every registry name this slice ports but path K's and path L's
M_NAMES = ("resnet101", "resnet50se", "resnet101se", "resnet152se",
           "seresnext50", "resnet50cbam", "resnet50sa", "densenet121",
           "swin", "swin_small", "swin_mlp", "coatnet", "vit_lsa")

# Swin-T's window-attention blocks at 224 px: the stage's token side, its
# heads and its blocks (every second one shifted, but not stage 4's: one
# window of the whole side)
SWIN_T_STAGES = ((56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2))
WINDOW = 7
# the images of the card's comparison at each stage: 28 windows of each
# position, so a block walks 8 (the Swin cell's count) and the last block 4
WA_IMAGES = 28

# The window-attention kernel against the plain path, each as a share of
# the largest |float64 value| of the same function from the same bf16
# values (window_attention_errors), and in bf16 steps of that value: one
# step of the largest is 2^-8 to 2^-7 of it, by where it lies in its
# binade, and no smaller value has a larger step. The output: both paths
# round P and the output to bf16, and a value that the other summation
# order puts across a rounding boundary moves by one step (read: up to
# 0.0071 of the largest, one step of a value in [2, 4) beside a largest of
# about 2.2); each path's own distance from float64 reads about half a
# step. d(qkv) and the bias gradient: the plain path rounds dP to bf16
# (2^-9 of each), the kernel keeps it in float32, so the two differ by up
# to two steps (read: 0.0060 and 0.0025), and the kernel may be no further
# from float64 than the plain path is (1.25 times, for the rounding of the
# comparison); its bias gradient sums float32 dS alone (read: 3e-7).
WA_OUT_STEPS = 1
WA_GRAD_STEPS = 2
WA_EXACT_RATIO = 1.25
WA_DBIAS_EXACT_TOL = 1e-5


def window_attention_case(side: int, heads: int, shifted: bool, images: int,
                          seed: int, device: str = "cuda"):
    """``(qkv, bias, mask, dout)`` of one Swin-T block at 224 px over
    ``images`` images: ``qkv`` bf16 (B·nW, 49, 3, heads, 32) and ``dout``
    bf16 (B·nW, 49, heads·32) drawn N(0, 1), the dense bias float32
    (heads, 49, 49) N(0, 0.5) (the benchmark draws its tables with std
    heads^-1/2), and the block's shift mask (nW, 49, 49) or None."""
    import torch

    from endoscopy_tpu_torch.models import swin

    gen = torch.Generator().manual_seed(seed)
    ws, shift = swin.stage_window(side, side, WINDOW, WINDOW // 2)
    nw, n = (side // ws) ** 2, ws * ws
    bnw = images * nw
    qkv = torch.randn((bnw, n, 3, heads, 32), generator=gen)
    dout = torch.randn((bnw, n, heads * 32), generator=gen)
    bias = torch.randn((heads, n, n), generator=gen) * 0.5
    mask = (torch.from_numpy(swin.shift_attn_mask(side, side, ws, shift))
            if shifted and shift else None)
    return (qkv.to(device, torch.bfloat16), bias.to(device),
            None if mask is None else mask.to(device),
            dout.to(device, torch.bfloat16))


def window_attention_grads(fn, qkv, bias, mask, dout):
    """``fn``'s output, d(qkv) and the bias gradient, from fresh leaves."""
    q = qkv.detach().requires_grad_(True)
    b = bias.detach().requires_grad_(True)
    out = fn(q, b, mask)
    out.backward(dout)
    return out.detach(), q.grad, b.grad


def window_attention_errors(qkv, bias, mask, dout) -> dict:
    """The kernel's and the plain path's output, d(qkv) and bias gradient
    on the card, each held against the same function in float64 from the
    same bf16 values (P not rounded): for each, the largest |Δ| kernel to
    plain, kernel to float64 and plain to float64, and one bf16 step of the
    largest |float64 value| (``step``), each over that value."""
    import torch

    from endoscopy_tpu_torch.ops import window_attention as wa

    kernel = window_attention_grads(wa.window_attention, qkv, bias, mask,
                                    dout)
    plain = window_attention_grads(wa.window_attention_plain, qkv, bias,
                                   mask, dout)
    exact = window_attention_grads(
        wa.window_attention_plain, qkv.double(), bias.double(),
        None if mask is None else mask.double(), dout.double())
    out = {}
    for name, k, p, e in zip(("out", "dqkv", "dbias"), kernel, plain, exact):
        k, p = k.double(), p.double()
        scale = e.abs().max().item()

        def gap(a, b):
            return (a - b).abs().max().item() / scale
        out[name] = {"kernel_plain": gap(k, p), "kernel_exact": gap(k, e),
                     "plain_exact": gap(p, e),
                     "step": 2.0 ** (math.frexp(scale)[1] - 8) / scale}
    return out


def window_attention_faults(err: dict) -> list:
    """What of ``window_attention_errors``'s ``err`` is over the limits
    above; empty where the kernel holds."""
    faults = []

    def over(name, what, value, limit):
        if not value <= limit:
            faults.append(f"{name} {what} {value:.3g} over {limit:.3g}")

    for name, steps in (("out", WA_OUT_STEPS), ("dqkv", WA_GRAD_STEPS),
                        ("dbias", WA_GRAD_STEPS)):
        e = err[name]
        over(name, "kernel_plain", e["kernel_plain"], steps * e["step"])
        over(name, "kernel_exact", e["kernel_exact"],
             WA_EXACT_RATIO * e["plain_exact"] if name != "out"
             else max(WA_EXACT_RATIO * e["plain_exact"], e["step"] / 2))
    over("dbias", "kernel_exact", err["dbias"]["kernel_exact"],
         WA_DBIAS_EXACT_TOL)
    return faults
