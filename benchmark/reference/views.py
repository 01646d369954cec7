"""The FixMatch step's three views in float32, and their random draws.

The draws repeat the trainer's: a ``torch.Generator`` seeded with
``TRAIN.SEED`` on the card, and per step the labeled view's draws for the
labeled batch, then the weak and strong views' for the unlabeled batch,
in that order and with the same calls (the reference repository's
distributions, as the port draws them). The views follow the reference
repository's transforms:

- labeled: hflip, vflip (each p=0.3), rotate by U(-20, 20) degrees (PIL,
  nearest, black fill), centre crop, ColorJitter(0.2, 0.2, 0.2) in a
  random op order, ImageNet normalize;
- weak: centre crop, normalize;
- strong: centre crop, hflip (p=0.5), reflect-pad RandomCrop(IMG_SIZE,
  IMG_SIZE / 8), RandAugmentMC(2, 10), CutoutAbs(16), normalize.

Everything is computed in float32 from the canonical uint8 batch.
"""

from __future__ import annotations

import torch

from . import imgops as ops
from .randaug import randaugment_mc_plain, sample_randaugment_params

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img / 255.0 - mean) / std


def labeled_draws(g: torch.Generator, b: int) -> dict:
    dev = g.device
    hflips = torch.rand(b, generator=g, device=dev) < 0.3
    vflips = torch.rand(b, generator=g, device=dev) < 0.3
    angles = torch.rand(b, generator=g, device=dev) * 40.0 - 20.0
    factors = 0.8 + 0.4 * torch.rand((b, 3), generator=g, device=dev)
    orders = torch.argsort(torch.rand((b, 4), generator=g, device=dev),
                           dim=1)
    return {"hflips": hflips, "vflips": vflips, "angles": angles,
            "factors": factors, "orders": orders}


def fixmatch_draws(g: torch.Generator, b: int, img_size: int) -> dict:
    flips = torch.rand(b, generator=g, device=g.device) < 0.5
    tops, lefts = ops.sample_crop_offsets(g, b, 2 * int(img_size * 0.125))
    pi, pf = sample_randaugment_params(g, b, img_size, img_size)
    return {"flips": flips, "tops": tops, "lefts": lefts, "pi": pi,
            "pf": pf}


def _flip_where(x, flips, flip=ops.hflip):
    return torch.where(flips.view(-1, 1, 1, 1), flip(x), x)


def _center(x: torch.Tensor, img_size: int) -> torch.Tensor:
    return x if x.shape[1] == img_size else ops.center_crop(x, img_size)


# ColorJitter's slots as ``orders`` indexes them: brightness, contrast,
# saturation (colour), hue (the identity at hue 0)
_SLOT = {0: ops.brightness, 1: ops.contrast, 2: ops.color}


def labeled_view(u8: torch.Tensor, img_size: int, d: dict) -> torch.Tensor:
    x = u8.float()
    x = _flip_where(x, d["hflips"])
    x = _flip_where(x, d["vflips"], ops.vflip)
    x = _center(ops.rotate(x, d["angles"]), img_size)
    factors, orders = d["factors"].float(), d["orders"]
    for i in range(4):
        for slot, op in _SLOT.items():
            take = (orders[:, i] == slot).view(-1, 1, 1, 1)
            x = torch.where(take, op(x, factors[:, slot]), x)
    return normalize(x)


def fixmatch_views(u8: torch.Tensor, img_size: int, d: dict):
    """(weak, strong), each ``(B, S, S, 3)`` float32 normalized."""
    weak = _center(u8.float(), img_size)
    strong = _flip_where(weak, d["flips"])
    pi = torch.cat([d["pi"], d["tops"][:, None].to(torch.int32),
                    d["lefts"][:, None].to(torch.int32)], dim=1)
    strong = randaugment_mc_plain(strong, pi, d["pf"], crop_size=img_size,
                                  pad=int(img_size * 0.125))
    return normalize(weak), normalize(strong)
