"""Batch views (subset of ``endoscopy_tpu/aug/views.py``).

All take a canonical uint8 NHWC batch and return normalized NHWC tensors
at IMG_SIZE in ``dtype``, on ``device`` (``cuda`` unless the caller asks
for ``cpu``). Every random draw can be passed in; what is not passed comes
from the caller's ``torch.Generator``.

The strong view's RandomCrop is fused into the RandAugment kernel, as the
JAX package's Pallas path does: the view emits the reflect-padded batch and
the crop offsets, and the kernel cuts each window. On the card the strong
view always runs the CUDA kernel; the plain version runs only for tensors
on the CPU.
"""

from __future__ import annotations

import torch

from endoscopy_tpu_torch.aug import ops
from endoscopy_tpu_torch.aug.randaugment import sample_randaugment_params
from endoscopy_tpu_torch.device import resolve_device
from endoscopy_tpu_torch.ops.randaugment_kernel import randaugment_mc

# ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """ToTensor + Normalize(mean, std) on [0, 255] input, in img's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return ((img / 255.0 - mean) / std).to(dtype)


def _to_float(batch_u8, dtype, device) -> torch.Tensor:
    x = torch.as_tensor(batch_u8)
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"expected a uint8 (B, S, S, 3) batch, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.to(resolve_device(device)).to(dtype)


def _center(x: torch.Tensor, img_size: int) -> torch.Tensor:
    if x.shape[1] == img_size:
        return x
    return ops.center_crop(x, img_size)


def eval_view(batch_u8, img_size: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Deterministic center crop + normalize."""
    x = _to_float(batch_u8, dtype, device)
    return normalize(_center(x, img_size), dtype)


def fixmatch_views(batch_u8, img_size: int, dtype=torch.float32,
                   generator: torch.Generator | None = None, *, device=None,
                   flips=None, tops=None, lefts=None, pi=None, pf=None):
    """(weak, strong) from one canonical batch.

    weak = center crop. strong = center crop → hflip (p=0.5) → reflect-pad
    RandomCrop(img_size, padding=img_size/8) → RandAugmentMC(2, 10) →
    CutoutAbs(16). ``flips`` (B,) bool, ``tops``/``lefts`` (B,) int in
    [0, 2*padding] and ``pi``/``pf`` (see ``sample_randaugment_params``)
    override the generator's draws.
    """
    x = _to_float(batch_u8, dtype, device)
    b = x.shape[0]
    padding = int(img_size * 0.125)
    if (tops is None) != (lefts is None) or (pi is None) != (pf is None):
        raise ValueError("pass tops with lefts and pi with pf")
    if generator is None and any(v is None for v in (flips, tops, pi)):
        raise ValueError("pass a torch.Generator or every draw explicitly")
    if flips is None:
        flips = torch.rand(b, generator=generator,
                           device=generator.device) < 0.5
    if tops is None:
        tops, lefts = ops.sample_crop_offsets(generator, b, 2 * padding)
    if pi is None:
        pi, pf = sample_randaugment_params(generator, b, img_size, img_size)

    weak = _center(x, img_size)
    flips = torch.as_tensor(flips, device=x.device).view(b, 1, 1, 1)
    strong = torch.where(flips, ops.hflip(weak), weak)
    padded = ops.reflect_pad(strong, padding)
    tops = torch.as_tensor(tops, device=x.device).to(torch.int32)
    lefts = torch.as_tensor(lefts, device=x.device).to(torch.int32)
    pi = torch.cat([torch.as_tensor(pi, device=x.device).to(torch.int32),
                    tops[:, None], lefts[:, None]], dim=1)
    pf = torch.as_tensor(pf, device=x.device).to(torch.float32)
    strong = randaugment_mc(padded, pi, pf, crop_size=img_size)
    return normalize(weak, dtype), normalize(strong, dtype)
