"""RandAugmentMC(2, 10) + CutoutAbs(16), plain PyTorch: a frozen copy of
the port's plain version (``endoscopy_tpu_torch/aug/randaugment.py``,
``apply_slot`` to ``sample_randaugment_params``), which follows the
reference repository's per-image semantics with the JAX kernel's float32
arithmetic. The benchmark's reference computes the strong view with it
and holds the card's kernel to it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import imgops as ops

OP_AUTOCONTRAST = 0
OP_BRIGHTNESS = 1
OP_COLOR = 2
OP_CONTRAST = 3
OP_EQUALIZE = 4
OP_IDENTITY = 5
OP_POSTERIZE = 6
OP_ROTATE = 7
OP_SHARPNESS = 8
OP_SHEAR_X = 9
OP_SHEAR_Y = 10
OP_SOLARIZE = 11
OP_TRANSLATE_X = 12
OP_TRANSLATE_Y = 13
NUM_OPS = 14
GEOMETRY_OPS = (OP_ROTATE, OP_SHEAR_X, OP_SHEAR_Y, OP_TRANSLATE_X,
                OP_TRANSLATE_Y)
CUTOUT = 16
CUTOUT_FILL = 127.0

_F = np.float32
_fma = ops.fma


def _factor(v: float) -> float:
    """Enhance factor ``v * 0.9 / 10 + 0.05`` = fma(v, f32(0.09), 0.05)."""
    return _fma(_F(v), _F(0.9) / _F(10.0), _F(0.05))


def _blend(deg: torch.Tensor, img: torch.Tensor, factor: float
           ) -> torch.Tensor:
    """ImageEnhance blend clip(deg + factor * (img - deg)), one rounding."""
    return torch.clamp(_fma(factor, img - deg, deg), 0.0, 255.0)


def _luminance(r, g, b):
    """0.299 R + 0.587 G + 0.114 B as the reference evaluates it:
    fma(0.114, B, fma(0.299, R, 0.587 G))."""
    return _fma(_F(0.114), b, _fma(_F(0.299), r, _F(0.587) * g))


def geometry_shifts(op: int, v: float, sign: float, h: int, w: int,
                    device=None):
    """(s1 over rows, s2 over columns, s3 over rows) int32 shift vectors of
    a geometric op; ``out[y, x] = in[y, x + s[y]]`` for a row pass."""
    v32, s32 = _F(v), _F(sign)
    deg = s32 * np.trunc(v32 * (_F(30.0) / _F(10.0)))
    theta = _F(deg * _F(np.pi / 180))
    a = _F(-np.tan(np.float64(theta / _F(2.0))))
    b = _F(np.sin(np.float64(theta)))
    mag = v32 * (_F(0.3) / _F(10.0))
    shear = s32 * mag
    trans_x = int(np.trunc(s32 * mag * _F(w)))
    trans_y = int(np.trunc(s32 * mag * _F(h)))

    yi = torch.arange(h, dtype=torch.int32, device=device)
    xi = torch.arange(w, dtype=torch.int32, device=device)
    zeros_h = torch.zeros(h, dtype=torch.int32, device=device)
    zeros_w = torch.zeros(w, dtype=torch.int32, device=device)
    sa1, sa2 = ops.pil_fix_coeffs(torch.tensor(shear, device=device))
    if op == OP_ROTATE:
        rows, cols = ops.paeth_shifts(torch.tensor([a], device=device),
                                      torch.tensor([b], device=device), h, w)
        return rows[0], cols[0], rows[0]
    if op == OP_SHEAR_X:
        return (sa1 * yi + sa2) >> 16, zeros_w, zeros_h
    if op == OP_SHEAR_Y:
        return zeros_h, (sa1 * xi + sa2) >> 16, zeros_h
    if op == OP_TRANSLATE_X:
        return torch.full_like(zeros_h, trans_x), zeros_w, zeros_h
    if op == OP_TRANSLATE_Y:
        return zeros_h, torch.full_like(zeros_w, trans_y), zeros_h
    raise ValueError(f"op {op} is not geometric")


def _equalize_plane(plane: torch.Tensor) -> torch.Tensor:
    """PIL equalize of one (H, W) plane through its 256-bin LUT."""
    n = plane.numel()
    q = torch.clamp(torch.round(plane), 0.0, 255.0)
    qi = q.to(torch.int64)
    hist = torch.bincount(qi.flatten(), minlength=256)
    last_val = int(qi.max())
    step = (n - int(hist[last_val])) // 255
    if int(qi.min()) == last_val or step == 0:
        return q
    cdf = torch.cumsum(hist, 0) - hist  # pixels strictly below each bin
    lut = torch.clamp((step // 2 + cdf) // step, 0, 255).to(plane.dtype)
    return lut[qi]


def _sharpness(img: torch.Tensor, factor: float) -> torch.Tensor:
    """PIL SMOOTH (3x3, centre 5, /13) on the interior, border unfiltered,
    then the blend; the nine taps are summed in the kernel's order, the
    centre tap by a fused multiply-add, and /13 is a product with
    f32(1/13)."""
    def sh(dy, dx):  # sh(dy, dx)[y, x] = img[y + dy, x + dx]
        return torch.roll(img, shifts=(-dy, -dx), dims=(1, 2))

    s = sh(-1, -1) + sh(-1, 0) + sh(-1, 1) + sh(0, -1)
    s = _fma(5.0, sh(0, 0), s)
    s = s + sh(0, 1) + sh(1, -1) + sh(1, 0) + sh(1, 1)
    smooth = torch.clamp(s * float(_F(1.0) / _F(13.0)), 0.0, 255.0)
    inner = smooth[:, 1:-1, 1:-1]
    smooth = img.clone()
    smooth[:, 1:-1, 1:-1] = inner
    return _blend(smooth, img, factor)


def _shift3(img: torch.Tensor, s1, s2, s3) -> torch.Tensor:
    """The rows, columns, rows shift passes of a geometric op."""
    return ops.shift_rows(ops.shift_cols(ops.shift_rows(img, s1), s2), s3)


def apply_slot(img: torch.Tensor, op: int, v: float, sign: float,
               apply: bool, factor: float | None = None) -> torch.Tensor:
    """One sampled op slot on one float32 (3, H, W) image in [0, 255];
    ``factor`` overrides the enhance ops' ``_factor(v)`` (RandAugmentPC's
    pool scales them otherwise)."""
    if not apply or op == OP_IDENTITY:
        return img
    h, w = img.shape[1], img.shape[2]
    if op in GEOMETRY_OPS:
        return _shift3(img, *geometry_shifts(op, v, sign, h, w, img.device))
    if factor is None:
        factor = _factor(v)
    if op == OP_AUTOCONTRAST:
        lo = img.amin(dim=(1, 2), keepdim=True)
        hi = img.amax(dim=(1, 2), keepdim=True)
        # a true division: ``255.0 / t`` would be 255 * reciprocal(t)
        scale = torch.div(torch.full_like(hi, 255.0),
                          torch.clamp(hi - lo, min=1e-6))
        out = torch.clamp((img - lo) * scale, 0.0, 255.0)
        return torch.where(hi > lo, out, img)
    if op == OP_BRIGHTNESS:
        return torch.clamp(img * factor, 0.0, 255.0)
    if op in (OP_COLOR, OP_CONTRAST):
        lum = _luminance(img[0], img[1], img[2])
        if op == OP_COLOR:
            deg = lum
        else:
            total = _F(lum.double().sum().item())
            mean = np.floor(_fma(total, _F(1.0) / _F(h * w), _F(0.5)))
            deg = torch.full_like(lum, float(mean))
        return _blend(deg[None], img, factor)
    if op == OP_EQUALIZE:
        return torch.stack([_equalize_plane(p) for p in img])
    if op == OP_POSTERIZE:
        bits = np.trunc(_F(v) * (_F(4.0) / _F(10.0))) + _F(4.0)
        keep = float(2.0 ** (8.0 - float(bits)))
        return torch.floor(img / keep) * keep
    if op == OP_SHARPNESS:
        return _sharpness(img, factor)
    if op == OP_SOLARIZE:
        threshold = float(_F(256.0) - np.trunc(_F(v) * (_F(256.0) / _F(10.0))))
        return torch.where(img >= threshold, 255.0 - img, img)
    raise ValueError(f"unknown RandAugment op {op}")


def cutout(img: torch.Tensor, cx: int, cy: int) -> torch.Tensor:
    """CutoutAbs(16) at (cx, cy), filled with 127; the box bounds are
    inclusive on both ends (17 px), as PIL's rectangle and the kernel."""
    h, w = img.shape[1], img.shape[2]
    x0, y0 = max(0, cx - CUTOUT // 2), max(0, cy - CUTOUT // 2)
    x1, y1 = min(w, x0 + CUTOUT), min(h, y0 + CUTOUT)
    out = img.clone()
    out[:, y0:y1 + 1, x0:x1 + 1] = CUTOUT_FILL
    return out


def randaugment_mc_plain(x: torch.Tensor, pi: torch.Tensor, pf: torch.Tensor,
                         crop_size: int | None = None, pad: int = 0
                         ) -> torch.Tensor:
    """Batch RandAugmentMC + CutoutAbs over NHWC ``x`` with explicit
    per-sample parameters; returns NHWC in ``x``'s dtype.

    ``pi`` (B, 2+2n[+2]) int32: ``cx, cy, (op, apply)*n, [top, left]``;
    ``pf`` (B, 2n) float32: ``(v, sign)*n``. With ``crop_size`` each
    sample's ``crop_size``² window at (top, left) of ``x`` reflect-padded by
    ``pad`` is cut first.
    """
    if pad:
        x = ops.reflect_pad(x, pad)
    n = pf.shape[1] // 2
    pis, pfs = pi.tolist(), pf.tolist()
    outs = []
    for i in range(x.shape[0]):
        img = x[i].permute(2, 0, 1).float()
        if crop_size is not None:
            top, left = pis[i][2 + 2 * n], pis[i][3 + 2 * n]
            img = img[:, top:top + crop_size, left:left + crop_size]
        for s in range(n):
            img = apply_slot(img, pis[i][2 + 2 * s], pfs[i][2 * s],
                             pfs[i][2 * s + 1], pis[i][3 + 2 * s] == 1)
        img = cutout(img, pis[i][0], pis[i][1])
        outs.append(img.permute(1, 2, 0).to(x.dtype))
    return torch.stack(outs)


def sample_randaugment_params(generator: torch.Generator, batch: int, h: int,
                              w: int, n: int = 2, m: int = 10):
    """Per-sample ``(pi, pf)`` with the Pallas sampler's layout and
    distribution: op ~ U{0..13}, v ~ U{1..m-1}, sign = ±1 and apply each
    with probability 1/2, cutout centre ~ U{0..w-1} x U{0..h-1}. Drawn on
    the generator's device."""
    g, dev = generator, generator.device
    op = torch.randint(0, NUM_OPS, (batch, n), generator=g, device=dev)
    v = torch.randint(1, m, (batch, n), generator=g, device=dev).float()
    sign = torch.where(torch.rand((batch, n), generator=g, device=dev) < 0.5,
                       -1.0, 1.0)
    apply = torch.rand((batch, n), generator=g, device=dev) < 0.5
    cx = torch.randint(0, w, (batch, 1), generator=g, device=dev)
    cy = torch.randint(0, h, (batch, 1), generator=g, device=dev)
    slots = torch.stack([op, apply.long()], dim=2).reshape(batch, 2 * n)
    pi = torch.cat([cx, cy, slots], dim=1).to(torch.int32)
    pf = torch.stack([v, sign], dim=2).reshape(batch, 2 * n)
    return pi, pf.to(torch.float32)

