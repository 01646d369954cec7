"""Batch views (subset of ``endoscopy_tpu/aug/views.py``).

All take a canonical uint8 NHWC batch and return normalized NHWC tensors
at IMG_SIZE in ``dtype``, on ``device`` (``cuda`` unless the caller asks
for ``cpu``). Every random draw can be passed in; what is not passed comes
from the caller's ``torch.Generator``, drawn by :func:`fixmatch_draws`,
:func:`labeled_draws` or :func:`comatch_draws` in the one order each
view draws in. A trainer in a process group draws there for the global
batch and passes its rows' draws in, so each image gets the pixels of the
1-process run.

FixMatch's strong view fuses its reflect-pad RandomCrop into the
RandAugment kernel: the view hands it the un-padded flipped image, the crop
offsets and the padding, and the kernel reads each window through mirrored
indices, so no padded batch is made. CoMatch's strong-0 view launches the
kernel in plain mode (no crop). On the card these views always run the
CUDA kernel; the plain version runs only for tensors on the CPU. The
labeled train view, CoMatch's colour-jitter view and the paper-reproduction
views (``DATA.IS_REPROD``) are plain PyTorch: the reference computes them
with XLA, outside any Pallas kernel.

Every view takes its rows through :func:`rows_on_device` (the span
``views/copy_in``). Host rows bound for a card are copied into page-locked
memory and sent on a copy stream of the calling thread's own, which the
current stream waits for, so the host does not wait for the card's queue
to drain (the counter ``views/staged``, one a batch). Rows already on the
card (the JPEG route's) bypass it, and on the CPU the rows are used where
they lie. Nothing else in a view waits for the card: :func:`normalize`
makes its constants once per dtype and device.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from endoscopy_tpu_torch.aug import ops
from endoscopy_tpu_torch.aug.randaugment import sample_randaugment_params
from endoscopy_tpu_torch.device import resolve_device
from endoscopy_tpu_torch.ops.randaugment_kernel import randaugment_mc
from endoscopy_tpu_torch.utils import trace

# ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _mean_std(dtype: torch.dtype, device: torch.device):
    """ImageNet's mean and std in ``dtype`` on ``device``, made once: a
    tensor made from a list on a card waits for the card's queue."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """ToTensor + Normalize(mean, std) on [0, 255] input, in img's dtype."""
    mean, std = _mean_std(img.dtype, img.device)
    return ((img / 255.0 - mean) / std).to(dtype)


_copy = threading.local()  # .streams: this thread's copy stream per card


def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """This thread's copy stream on the card ``dev``, made at first use."""
    streams = _copy.__dict__.setdefault("streams", {})
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in streams:
        streams[index] = torch.cuda.Stream(index)
    return streams[index]


def _staged(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Host rows ``x`` on the card ``dev`` without waiting for the card
    (a pageable copy of a batch returns only once the current stream
    reaches it).

    The rows are copied on the host into a page-locked buffer before this
    returns, so the caller may reuse its array at once; the buffer goes to
    the card on this thread's copy stream, which the current stream waits
    for. PyTorch's host allocator hands the buffer out again only once the
    copy recorded on it has finished, and the result is recorded on the
    current stream, so the card's allocator keeps it until the work queued
    there has read it."""
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    pinned.copy_(x)
    copy = _copy_stream(dev)
    with torch.cuda.stream(copy):
        out = pinned.to(dev, non_blocking=True)
    current = torch.cuda.current_stream(dev)
    current.wait_stream(copy)
    out.record_stream(current)
    trace.count("views/staged")
    return out


def rows_on_device(batch_u8, device) -> torch.Tensor:
    """The uint8 batch on ``device``, in the span ``views/copy_in``.

    Host rows (a numpy array or a CPU tensor) bound for a card go through
    :func:`_staged`, one ``views/staged`` count each. A tensor already on
    the card (the JPEG route's rows) is returned as it is, and on the CPU
    the batch is the host's own tensor."""
    x = torch.as_tensor(batch_u8)
    if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"expected a uint8 (B, S, S, 3) batch, got "
                         f"{x.dtype} {tuple(x.shape)}")
    dev = resolve_device(device)
    with trace.span("views/copy_in"):
        if dev.type == "cuda" and x.device.type == "cpu":
            return _staged(x, dev)
        return x.to(dev, non_blocking=True)


def _center(x: torch.Tensor, img_size: int) -> torch.Tensor:
    """Canonical → IMG_SIZE center crop (none when they are equal)."""
    return x if x.shape[1] == img_size else ops.center_crop(x, img_size)


def _center_float(batch_u8, img_size: int, dtype, device) -> torch.Tensor:
    """The center crop of the uint8 batch on ``device``, cast to ``dtype``
    (the crop first, so only the kept pixels are cast)."""
    return _center(rows_on_device(batch_u8, device), img_size).to(dtype)


def _flip_where(x: torch.Tensor, flips, flip=ops.hflip) -> torch.Tensor:
    """``flip(x)`` on the images whose ``flips`` (B,) entry is true."""
    flips = torch.as_tensor(flips, device=x.device).view(-1, 1, 1, 1)
    return torch.where(flips, flip(x), x)


def eval_view(batch_u8, img_size: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Deterministic center crop + normalize."""
    return normalize(_center_float(batch_u8, img_size, dtype, device), dtype)


def _fill_draws(given: dict, generator, draw) -> dict:
    """``given`` with each ``None`` replaced by ``draw(generator)``'s
    value; raises without a generator when one is missing."""
    if all(v is not None for v in given.values()):
        return given
    if generator is None:
        raise ValueError("pass a torch.Generator or every draw explicitly")
    drawn = draw(generator)
    return {k: drawn[k] if v is None else v for k, v in given.items()}


def fixmatch_draws(generator: torch.Generator, b: int, img_size: int):
    """:func:`fixmatch_views`' draws for ``b`` images: ``flips``, ``tops``,
    ``lefts``, ``pi``, ``pf``."""
    g = generator
    flips = torch.rand(b, generator=g, device=g.device) < 0.5
    tops, lefts = ops.sample_crop_offsets(g, b, 2 * int(img_size * 0.125))
    pi, pf = sample_randaugment_params(g, b, img_size, img_size)
    return {"flips": flips, "tops": tops, "lefts": lefts, "pi": pi,
            "pf": pf}


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
    weak = _center_float(batch_u8, img_size, dtype, device)
    b = weak.shape[0]
    padding = int(img_size * 0.125)
    if (tops is None) != (lefts is None) or (pi is None) != (pf is None):
        raise ValueError("pass tops with lefts and pi with pf")
    given = {"flips": flips, "tops": tops, "lefts": lefts, "pi": pi,
             "pf": pf}
    flips, tops, lefts, pi, pf = _fill_draws(
        given, generator, lambda g: fixmatch_draws(g, b, img_size)).values()

    dev = weak.device
    strong = _flip_where(weak, flips)
    tops = torch.as_tensor(tops, device=dev).to(torch.int32)
    lefts = torch.as_tensor(lefts, device=dev).to(torch.int32)
    pi = torch.cat([torch.as_tensor(pi, device=dev).to(torch.int32),
                    tops[:, None], lefts[:, None]], dim=1)
    pf = torch.as_tensor(pf, device=dev).to(torch.float32)
    strong = randaugment_mc(strong, pi, pf, crop_size=img_size, pad=padding)
    return normalize(weak, dtype), normalize(strong, dtype)


# ColorJitter's slots in the order ``orders`` indexes them: brightness,
# contrast, saturation, hue
_JITTER_OPS = (ops.brightness, ops.contrast, ops.color, ops.adjust_hue)


def _color_jitter(x: torch.Tensor, factors: torch.Tensor,
                  orders: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter per image: ``factors`` (B, 3) brightness,
    contrast, saturation, or (B, 4) with the hue shift last; ``orders``
    (B, 4) a permutation of 0..3, the slot applied at each of the four
    steps. Without a hue column slot 3 is the identity (hue 0)."""
    ops_here = _JITTER_OPS[:factors.shape[1]]
    for i in range(4):
        for op_id, op in enumerate(ops_here):
            take = (orders[:, i] == op_id).view(-1, 1, 1, 1)
            x = torch.where(take, op(x, factors[:, op_id]), x)
    return x


def labeled_draws(generator: torch.Generator, b: int):
    """:func:`labeled_train_view`'s draws for ``b`` images: ``hflips``,
    ``vflips``, ``angles``, ``factors``, ``orders``."""
    g, gdev = generator, generator.device
    hflips = torch.rand(b, generator=g, device=gdev) < 0.3
    vflips = torch.rand(b, generator=g, device=gdev) < 0.3
    angles = torch.rand(b, generator=g, device=gdev) * 40.0 - 20.0
    factors = 0.8 + 0.4 * torch.rand((b, 3), generator=g, device=gdev)
    orders = torch.argsort(torch.rand((b, 4), generator=g, device=gdev),
                           dim=1)
    return {"hflips": hflips, "vflips": vflips, "angles": angles,
            "factors": factors, "orders": orders}


def labeled_train_view(batch_u8, img_size: int, dtype=torch.float32,
                       generator: torch.Generator | None = None, *,
                       device=None, hflips=None, vflips=None, angles=None,
                       factors=None, orders=None) -> torch.Tensor:
    """The supervised train view of a canonical batch: hflip and vflip
    (each p=0.3) → rotate by U(-20, 20)° on the canonical image → center
    crop → ColorJitter(brightness 0.2, contrast 0.2, saturation 0.2, hue 0)
    in a random op order per image → normalize.

    ``hflips``/``vflips`` (B,) bool, ``angles`` (B,) float32 degrees,
    ``factors`` (B, 3) and ``orders`` (B, 4) (see :func:`_color_jitter`)
    override the generator's draws. The factors act in ``dtype``, as the
    reference draws them in the image dtype.
    """
    x = rows_on_device(batch_u8, device)
    b = x.shape[0]
    given = {"hflips": hflips, "vflips": vflips, "angles": angles,
             "factors": factors, "orders": orders}
    d = _fill_draws(given, generator, lambda g: labeled_draws(g, b))
    hflips, vflips, angles, factors, orders = d.values()

    return normalize(_labeled_pixels(x.to(dtype), img_size, hflips, vflips,
                                     angles, factors, orders), dtype)


def _labeled_pixels(x: torch.Tensor, img_size: int, hflips, vflips, angles,
                    factors, orders) -> torch.Tensor:
    """The labeled train view before its normalize, in [0, 255]."""
    dev = x.device
    x = _flip_where(x, hflips)
    x = _flip_where(x, vflips, ops.vflip)
    x = _center(ops.rotate(x, torch.as_tensor(angles)), img_size)
    return _color_jitter(x, torch.as_tensor(factors).to(dev, x.dtype),
                         torch.as_tensor(orders, device=dev))


def comatch_draws(generator: torch.Generator, b: int, img_size: int):
    """:func:`comatch_views`' draws for ``b`` images, in its order."""
    g, gdev = generator, generator.device
    d = {"weak_flips": torch.rand(b, generator=g, device=gdev) < 0.5,
         "strong0_flips": torch.rand(b, generator=g, device=gdev) < 0.5}
    d["pi"], d["pf"] = sample_randaugment_params(g, b, img_size, img_size)
    d["jitters"] = torch.rand(b, generator=g, device=gdev) < 0.8
    u = torch.rand((b, 4), generator=g, device=gdev)
    d["factors"] = torch.cat([0.6 + 0.8 * u[:, :3], 0.2 * u[:, 3:] - 0.1], 1)
    d["orders"] = torch.argsort(torch.rand((b, 4), generator=g, device=gdev),
                                dim=1)
    d["grays"] = torch.rand(b, generator=g, device=gdev) < 0.2
    d["strong1_flips"] = torch.rand(b, generator=g, device=gdev) < 0.5
    return d


def comatch_views(batch_u8, img_size: int, dtype=torch.float32,
                  generator: torch.Generator | None = None, *, device=None,
                  weak_flips=None, strong0_flips=None, pi=None, pf=None,
                  jitters=None, factors=None, orders=None, grays=None,
                  strong1_flips=None):
    """(weak, strong-0, strong-1) from one canonical batch (TransformCoMatch).

    weak = center crop → hflip (p=0.5). strong-0 = center crop → hflip
    (p=0.5) → RandAugmentMC(2, 10) + CutoutAbs(16), the kernel in plain
    mode. strong-1 = center crop → ColorJitter(0.4, 0.4, 0.4, 0.1) in a
    random op order, applied with p=0.8 → grayscale (p=0.2) → hflip
    (p=0.5).

    ``weak_flips``, ``strong0_flips``, ``jitters``, ``grays``,
    ``strong1_flips`` (B,) bool; ``pi``/``pf`` (see
    ``sample_randaugment_params``); ``factors`` (B, 4) brightness,
    contrast and saturation in [0.6, 1.4] and the hue shift in [-0.1,
    0.1]; ``orders`` (B, 4) override the generator's draws. The jitter's
    factors act in ``dtype``, as the reference draws them in the image
    dtype.
    """
    x = _center_float(batch_u8, img_size, dtype, device)
    b, dev = x.shape[0], x.device
    if (pi is None) != (pf is None):
        raise ValueError("pass pi with pf")
    given = {"weak_flips": weak_flips, "strong0_flips": strong0_flips,
             "pi": pi, "pf": pf, "jitters": jitters, "factors": factors,
             "orders": orders, "grays": grays,
             "strong1_flips": strong1_flips}
    d = _fill_draws(given, generator,
                    lambda g: comatch_draws(g, b, img_size))
    (weak_flips, strong0_flips, pi, pf, jitters, factors, orders, grays,
     strong1_flips) = d.values()

    weak = _flip_where(x, weak_flips)
    strong0 = randaugment_mc(
        _flip_where(x, strong0_flips),
        torch.as_tensor(pi, device=dev).to(torch.int32),
        torch.as_tensor(pf, device=dev).to(torch.float32))
    jittered = _color_jitter(x, torch.as_tensor(factors).to(dev, x.dtype),
                             torch.as_tensor(orders, device=dev))
    strong1 = torch.where(
        torch.as_tensor(jitters, device=dev).view(-1, 1, 1, 1), jittered, x)
    strong1 = torch.where(
        torch.as_tensor(grays, device=dev).view(-1, 1, 1, 1),
        ops.grayscale(strong1), strong1)
    strong1 = _flip_where(strong1, strong1_flips)
    return (normalize(weak, dtype), normalize(strong0, dtype),
            normalize(strong1, dtype))


# The paper-reproduction views (``DATA.IS_REPROD``; the supervised trainer
# alone). The reference's Resize(256) → CenterCrop(256) → Resize(224)
# collapses to one bilinear resize of the square canonical batch; train
# adds hflip and vflip (p=0.5 each) and a uniform ±90° rotation; the
# normalization is mean = std = 0.5, not ImageNet's.


@functools.lru_cache(maxsize=16)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize``'s 'linear' weights along one axis, ``(n_in,
    n_out)`` float32: the triangle kernel, widened by the scale when
    shrinking (antialiased), each column normalized, columns whose sample
    lies outside the input zero. Read-only."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = np.abs(sample[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    w.flags.writeable = False
    return w


def _resize_square(x: torch.Tensor, img_size: int) -> torch.Tensor:
    """NHWC ``x`` resized to ``img_size`` square as ``jax.image.resize(...,
    'linear')`` does it (an axis of equal size is left alone)."""
    for axis in (1, 2):
        if x.shape[axis] != img_size:
            w = torch.tensor(_resize_matrix(x.shape[axis], img_size),
                             dtype=x.dtype, device=x.device)
            x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x


def _normalize_half(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[0, 255] → [-1, 1]: Normalize(mean=0.5, std=0.5) after ToTensor."""
    return (img / 255.0 * 2.0 - 1.0).to(dtype)


def reproduce_draws(generator: torch.Generator, b: int):
    """:func:`reproduce_train_view`'s draws for ``b`` images: ``hflips``,
    ``vflips`` (p=0.5 each), ``angles`` in [-90, 90) degrees."""
    g, gdev = generator, generator.device
    return {"hflips": torch.rand(b, generator=g, device=gdev) < 0.5,
            "vflips": torch.rand(b, generator=g, device=gdev) < 0.5,
            "angles": torch.rand(b, generator=g, device=gdev) * 180.0 - 90.0}


def reproduce_train_view(batch_u8, img_size: int, dtype=torch.float32,
                         generator: torch.Generator | None = None, *,
                         device=None, hflips=None, vflips=None, angles=None
                         ) -> torch.Tensor:
    """The paper-reproduction train view: resize to ``img_size`` → hflip
    and vflip (each p=0.5) → rotate by U(-90, 90)° → normalize with mean =
    std = 0.5. ``hflips``/``vflips`` (B,) bool and ``angles`` (B,) float32
    degrees override the generator's draws."""
    x = rows_on_device(batch_u8, device)
    b = x.shape[0]
    given = {"hflips": hflips, "vflips": vflips, "angles": angles}
    hflips, vflips, angles = _fill_draws(
        given, generator, lambda g: reproduce_draws(g, b)).values()
    x = _resize_square(x.to(dtype), img_size)
    x = _flip_where(x, hflips)
    x = _flip_where(x, vflips, ops.vflip)
    return _normalize_half(ops.rotate(x, torch.as_tensor(angles)), dtype)


def reproduce_eval_view(batch_u8, img_size: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """The paper-reproduction eval view: resize to ``img_size`` →
    normalize with mean = std = 0.5."""
    x = rows_on_device(batch_u8, device).to(dtype)
    return _normalize_half(_resize_square(x, img_size), dtype)
