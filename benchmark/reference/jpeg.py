"""The JPEG route's reference: which files a native loader hands out, and
their canonical pixels, with no code of the port.

- :class:`MT19937_64` is C++'s ``std::mt19937_64`` (the standard's
  recurrence and tempering), and :func:`index_stream` the loader core's
  shuffle with it: a Fisher-Yates pass ``j = rng() % i`` from the end,
  again at every pass (``data/csrc/loader.cpp::reshuffle``).
- :func:`decode` is Pillow's (libjpeg) decode to RGB, independent of
  nvJPEG; :func:`resize` the core's bilinear resize to the canonical side
  in its float32 arithmetic (``resize_bilinear`` of the same file):
  half-pixel centres, the tap clamped to ``side - 2``, ``uint8(v + 0.5)``.
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 64) - 1


class MT19937_64:
    def __init__(self, seed: int):
        self.mt = [0] * 312
        self.mt[0] = seed & _MASK
        for i in range(1, 312):
            prev = self.mt[i - 1]
            self.mt[i] = (6364136223846793005 * (prev ^ (prev >> 62))
                          + i) & _MASK
        self.index = 312

    def _twist(self) -> None:
        mt = self.mt
        for i in range(312):
            x = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % 312]
                                                & 0x7FFFFFFF)
            xa = x >> 1
            if x & 1:
                xa ^= 0xB5026F5AA96619E9
            mt[i] = mt[(i + 156) % 312] ^ xa
        self.index = 0

    def __call__(self) -> int:
        if self.index >= 312:
            self._twist()
        x = self.mt[self.index]
        self.index += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x & _MASK


def index_stream(n: int, seed: int, count: int) -> np.ndarray:
    """The first ``count`` indices the core's workers take."""
    rng = MT19937_64(seed)
    order = list(range(n))
    out = []
    while len(out) < count:
        for i in range(n, 1, -1):
            j = rng() % i
            order[i - 1], order[j] = order[j], order[i - 1]
        out.extend(order)
    return np.asarray(out[:count], np.int64)


def decode(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _axis(n_src: int, size: int):
    s = np.float32(n_src) / np.float32(size)
    f = (np.arange(size, dtype=np.float32) + np.float32(0.5)) * s \
        - np.float32(0.5)
    i0 = np.where(f < 0, 0, f.astype(np.int64))
    i0 = np.minimum(i0, n_src - 2)
    w = np.maximum(f - i0.astype(np.float32), np.float32(0.0))
    return i0, w.astype(np.float32)


def resize(src: np.ndarray, size: int) -> np.ndarray:
    """``(h, w, 3)`` uint8 → ``(size, size, 3)`` uint8."""
    y0, wy = _axis(src.shape[0], size)
    x0, wx = _axis(src.shape[1], size)
    s = src.astype(np.float32)
    one = np.float32(1.0)
    wx3, wy3 = wx[None, :, None], wy[:, None, None]
    rows0, rows1 = s[y0], s[y0 + 1]
    top = rows0[:, x0] * (one - wx3) + rows0[:, x0 + 1] * wx3
    bot = rows1[:, x0] * (one - wx3) + rows1[:, x0 + 1] * wx3
    v = top * (one - wy3) + bot * wy3
    return (v + np.float32(0.5)).astype(np.uint8)


def taps(n_src: int, size: int) -> int:
    """Source rows (or columns) the bilinear taps reach."""
    i0, _ = _axis(n_src, size)
    return len(np.union1d(i0, i0 + 1))
