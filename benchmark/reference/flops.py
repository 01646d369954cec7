"""Model FLOPs of one training step per image, on the reference models.

The arithmetic of ``chip_smoke.py::train_flops_per_image``, copied and
hooked onto this package's models, so that no change to the port can move
the count: the forward's multiply-adds of every convolution, dense layer
and attention product (``q kᵀ`` and ``a v``: ``2 · n² · dim`` a sample),
times 3 for the forward and both gradients, less the stem's input
gradient (the first layer's input needs none); 2 FLOPs per multiply-add.
BN, LN, activations, softmax, pooling and the loss are not counted.
"""

from __future__ import annotations

import torch
from torch import nn

from .models import Attention


def forward_macs(model: nn.Module, img: int) -> dict:
    """Multiply-adds of one image's forward by layer, in the order the
    layers run."""
    macs = {}

    def count(name):
        def hook(m, inp, out):
            if isinstance(m, nn.Conv2d):
                per = (m.in_channels // m.groups) * m.kernel_size[0] \
                    * m.kernel_size[1]
                macs[name] = out.numel() * per
            elif isinstance(m, nn.Linear):
                macs[name] = out.numel() * m.in_features
            else:
                b, n, c = inp[0].shape
                macs[name + ".products"] = 2 * b * n * n * c
        return hook

    hooks = [m.register_forward_hook(count(name))
             for name, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.Linear, Attention))]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            p = next(model.parameters())
            model(torch.zeros(1, 3, img, img, device=p.device, dtype=p.dtype))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return macs


def train_flops_per_image(model: nn.Module, img: int) -> int:
    macs = forward_macs(model, img)
    fwd = sum(macs.values())
    stem = next(iter(macs))  # the first layer to run
    return 2 * (3 * fwd - macs[stem])
