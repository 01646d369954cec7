"""Image primitives on batched NHWC tensors (subset of ``endoscopy_tpu/aug/ops.py``).

The JAX module works on one HWC image under ``vmap``; here the batch
dimension is written out. Only what the eval view, the FixMatch views, the
labeled train view and the plain RandAugment need is ported. Random draws
come from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
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
    """``out[..., y, x] = plane[..., y, x + shifts[..., y]]`` with zero
    fill, for a (..., H, W) plane stack; ``shifts`` (..., H) broadcasts
    against the leading dimensions (one (H,) vector for every plane, or
    (B, 1, H) for per-image shifts of a (B, C, H, W) batch)."""
    w = plane.shape[-1]
    src = (torch.arange(w, device=plane.device)
           + shifts.to(plane.device).long()[..., None])
    valid = (src >= 0) & (src < w)
    out = torch.gather(plane, -1, src.clamp(0, w - 1).expand(plane.shape))
    return torch.where(valid, out, torch.zeros((), dtype=plane.dtype,
                                               device=plane.device))


def shift_cols(plane: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``out[..., y, x] = plane[..., y + shifts[..., x], x]`` with zero
    fill."""
    return shift_rows(plane.transpose(-1, -2), shifts).transpose(-1, -2)


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding (by way of float64), the
    fused multiply-add the reference's XLA arithmetic contracts to."""
    def f64(t):
        return t.double() if isinstance(t, torch.Tensor) else float(t)
    out = f64(a) * f64(b) + f64(c)
    if isinstance(out, torch.Tensor):
        return out.float()
    return float(np.float32(out))


def vflip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(1)


def rotate(x: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """PIL ``Image.rotate(angle)`` per image of an NHWC batch (CCW about the
    center, nearest, black fill), by Paeth's three shears: rows by
    ``-tan(θ/2)``, columns by ``sin θ``, rows by ``-tan(θ/2)`` again, each
    shifting by ``floor(coef * yc + 0.5)`` about the center.

    ``degrees`` (B,) float32. ``θ = degrees * f32(π/180)``; ``tan``/``sin``
    of the float32 angle are taken in float64 and rounded to float32, and
    ``coef * yc + 0.5`` is one fused multiply-add, as the reference's XLA
    arithmetic does it.
    """
    theta = degrees.to(x.device, torch.float32) * float(
        np.float32(np.pi / 180))
    a = (-torch.tan((theta / 2.0).double())).float()
    b = torch.sin(theta.double()).float()
    rows, cols = paeth_shifts(a, b, x.shape[1], x.shape[2])
    out = shift_rows(x.permute(0, 3, 1, 2), rows[:, None])
    out = shift_cols(out, cols[:, None])
    return shift_rows(out, rows[:, None]).permute(0, 2, 3, 1)


def paeth_shifts(a: torch.Tensor, b: torch.Tensor, h: int, w: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image shifts of a Paeth rotation with float32 shear coefficients
    ``a = -tan(θ/2)``, ``b = sin θ`` (each (B,)): rows ``floor(fma(a, yc,
    0.5))`` (B, H) and columns ``floor(fma(b, xc, 0.5))`` (B, W), int32,
    ``yc``/``xc`` the pixel centres' offsets from the image centre."""
    dev = a.device
    yc = torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - h / 2.0
    xc = torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - w / 2.0
    return (torch.floor(fma(a[:, None], yc, 0.5)).to(torch.int32),
            torch.floor(fma(b[:, None], xc, 0.5)).to(torch.int32))


def _per_image(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B,) → (B, 1, 1, 1) in ``x``'s dtype and device."""
    return torch.as_tensor(v).to(x.device, x.dtype).view(-1, 1, 1, 1)


def _blend(deg: torch.Tensor, x: torch.Tensor, factor: torch.Tensor
           ) -> torch.Tensor:
    """ImageEnhance's ``clip(deg + factor * (x - deg), 0, 255)``, one
    rounding, per image."""
    f = _per_image(factor, x)
    return torch.clamp(fma(f, x - deg, deg), 0.0, 255.0).to(x.dtype)


def luminance(x: torch.Tensor) -> torch.Tensor:
    """PIL 'L' of an NHWC batch, (B, H, W) in ``x``'s dtype:
    ``fma(B, 0.114, fma(G, 0.587, R * 0.299))``, the reference's order."""
    w = [float(np.float32(v)) for v in (0.299, 0.587, 0.114)]
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return fma(b, w[2], fma(g, w[1], r * w[0])).to(x.dtype)


def brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Brightness: blend with black."""
    return torch.clamp(x * _per_image(factor, x), 0.0, 255.0)


def color(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Color: blend with the image's L."""
    return _blend(luminance(x)[..., None], x, factor)


def contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Contrast: blend with the solid gray
    ``floor(mean(L) + 0.5)``, L in ``x``'s dtype, the mean in float32 (its
    sum taken in float64 and rounded once)."""
    lum = luminance(x)
    total = lum.double().sum(dim=(1, 2)).float()
    inv = float(np.float32(1.0) / np.float32(lum.shape[1] * lum.shape[2]))
    gray = torch.floor(fma(total, inv, 0.5))
    return _blend(_per_image(gray, x), x, factor)


def grayscale(x: torch.Tensor) -> torch.Tensor:
    """transforms.RandomGrayscale's op: PIL 'L' in all three channels."""
    return luminance(x)[..., None].expand(x.shape).contiguous()


_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_6 = float(np.float32(1.0) / np.float32(6.0))


def _floor_mod1(v: torch.Tensor) -> torch.Tensor:
    """``jnp.remainder(v, 1.0)``: ``fmod``, then ``+ 1`` where negative."""
    r = torch.fmod(v, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def adjust_hue(x: torch.Tensor, hue_factor: torch.Tensor) -> torch.Tensor:
    """torchvision ``adjust_hue`` per image of an NHWC batch: RGB → HSV,
    the hue shifted by ``hue_factor`` (B,) turns, HSV → RGB, in ``x``'s
    dtype.

    The reference's XLA arithmetic, written out: ``/255`` and ``/6`` are
    products by the float32 reciprocals; ``1 - s * f`` and ``1 - s * (1 -
    f)`` are fused multiply-adds, ``f = h * 6 - i`` is not (the product
    also feeds the floor); ``%`` is floor-mod; the sector select takes the
    first true branch.
    """
    dt = x.dtype
    v3 = x * _INV_255
    r, g, b = v3[..., 0], v3[..., 1], v3[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    d = maxc - minc
    zero = torch.zeros((), dtype=dt, device=x.device)
    s = torch.where(maxc > 0, d / torch.clamp(maxc, min=1e-8), zero)
    dn = torch.clamp(d, min=1e-8)
    rc, gc, bc = (maxc - r) / dn, (maxc - g) / dn, (maxc - b) / dn
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = _floor_mod1(h * _INV_6)
    h = torch.where(d == 0, zero, h)
    h = _floor_mod1(h + _per_image(hue_factor, x)[..., 0])

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * fma(-s, f, 1.0).to(dt)
    t = v * fma(-s, 1.0 - f, 1.0).to(dt)
    sector = torch.remainder(i.to(torch.int32), 6)
    r2 = torch.stack([v, q, p, p, t, v])
    g2 = torch.stack([t, v, v, q, p, p])
    b2 = torch.stack([p, p, t, v, v, q])
    idx = sector[None].long()
    out = torch.stack([c.gather(0, idx)[0] for c in (r2, g2, b2)], dim=-1)
    return torch.clamp(out * 255.0, 0.0, 255.0).to(dt)
