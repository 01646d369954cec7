"""Image primitives on batched NHWC tensors (subset of ``endoscopy_tpu/aug/ops.py``).

The JAX module works on one HWC image under ``vmap``; here the batch
dimension is written out. Only what the eval view, the FixMatch views and
the plain RandAugment need is ported. Random draws come from the caller's
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Static center crop of an NHWC batch (transforms.CenterCrop)."""
    h, w = x.shape[1], x.shape[2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[:, top:top + size, left:left + size, :]


def hflip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(2)


def reflect_pad(x: torch.Tensor, padding: int) -> torch.Tensor:
    """NHWC reflect padding (``jnp.pad(mode="reflect")``, no edge repeat)."""
    padded = F.pad(x.permute(0, 3, 1, 2), (padding,) * 4, mode="reflect")
    return padded.permute(0, 2, 3, 1)


def sample_crop_offsets(generator: torch.Generator, batch: int, max_off: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (top, left) ~ U{0..max_off} for RandomCrop, int32 on the
    generator's device."""
    dev = generator.device
    top = torch.randint(0, max_off + 1, (batch,), generator=generator,
                        device=dev, dtype=torch.int32)
    left = torch.randint(0, max_off + 1, (batch,), generator=generator,
                         device=dev, dtype=torch.int32)
    return top, left


def crop_at(padded: torch.Tensor, size: int, tops: torch.Tensor,
            lefts: torch.Tensor) -> torch.Tensor:
    """``padded[b, top_b:top_b+size, left_b:left_b+size]`` for every b."""
    ar = torch.arange(size, device=padded.device)
    rows = (tops.to(padded.device).long()[:, None] + ar)[:, :, None]
    cols = (lefts.to(padded.device).long()[:, None] + ar)[:, None, :]
    bidx = torch.arange(padded.shape[0], device=padded.device)[:, None, None]
    return padded[bidx, rows, cols]


def pil_fix_coeffs(coef: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pillow's 16.16 fixed-point coefficients of a shear row (1, coef, 0):
    ``(FIX(coef), FIX(0.5 + 0.5*coef))``, in float32 arithmetic."""
    coef = coef.float()
    a1 = torch.floor(coef * 65536.0 + 0.5).to(torch.int32)
    a2 = torch.floor((0.5 + 0.5 * coef) * 65536.0 + 0.5).to(torch.int32)
    return a1, a2


def shift_rows(plane: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``out[c, y, x] = plane[c, y, x + shifts[y]]`` with zero fill, for a
    (C, H, W) plane stack."""
    c, h, w = plane.shape
    src = torch.arange(w, device=plane.device)[None, :] + shifts.long()[:, None]
    valid = (src >= 0) & (src < w)
    out = torch.gather(plane, 2, src.clamp(0, w - 1).expand(c, h, w))
    return torch.where(valid, out, torch.zeros((), dtype=plane.dtype,
                                               device=plane.device))


def shift_cols(plane: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``out[c, y, x] = plane[c, y + shifts[x], x]`` with zero fill."""
    return shift_rows(plane.transpose(1, 2), shifts).transpose(1, 2)
