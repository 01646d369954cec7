"""Stand-alone self-attention (port of ``endoscopy_tpu/models/attention.py::
SASALayer``), the 3x3 convolution's replacement in ``resnet50sasa``.

Local attention over ``ks x ks`` windows (``ks = min(7, side)``) with the
reference's quirks, which the JAX module keeps and so does this one:

- ``k`` and ``v`` are 1x1 convolutions with bias applied to the
  zero-padded input, so the padding holds the bias; an even window pads
  one more at the end (``(ks - 1) // 2`` before);
- the head split is a raw row-major reshape of the ``(B, C, H, W, ks,
  ks)`` unfold (and of ``q``'s ``(B, C, H, W)``), which interleaves depth
  with the spatial axes whenever a head holds more than one channel;
- the relative encodings are summed over channels and multiplied by ``q``
  summed over depth, broadcast over the window;
- ``q·k`` and the value product are taken in float32 (float64 for a
  float64 input) and the softmax too, its weights cast to the input's
  dtype before the product.

The encodings are parameters of shape ``(C/2, ks, 1)`` and ``(C/2, 1,
ks)``, drawn from a standard normal as flax's ``normal(1.0)`` draws them;
``side`` fixes ``ks`` when the layer is built, as flax fixes it at init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.resnet import conv2d


class SASALayer(nn.Module):
    """``q_conv``/``k_conv``/``v_conv`` and ``rel_encoding_h/w``, the
    reference's names."""

    def __init__(self, channels: int, side: int, kernel_size: int = 7,
                 num_heads: int = 8):
        super().__init__()
        self.kernel_size, self.num_heads = kernel_size, num_heads
        self.ks = min(kernel_size, side)
        half = channels // num_heads * num_heads // 2
        self.q_conv = conv2d(channels, channels, 1, bias=True)
        self.k_conv = conv2d(channels, channels, 1, bias=True)
        self.v_conv = conv2d(channels, channels, 1, bias=True)
        self.rel_encoding_h = nn.Parameter(torch.randn(half, self.ks, 1))
        self.rel_encoding_w = nn.Parameter(torch.randn(half, 1, self.ks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        ks, heads = self.ks, self.num_heads
        if min(self.kernel_size, h, w) != ks:
            raise ValueError(f"SASALayer built for a {ks}x{ks} window gets "
                             f"{h}x{w} inputs (build the model for this "
                             "image size)")
        dh = c // heads
        lo = (ks - 1) // 2
        hi = ks - 1 - lo
        q = self.q_conv(x)
        padded = F.pad(x, (lo, hi, lo, hi))
        k, v = self.k_conv(padded), self.v_conv(padded)

        def unfold(t):  # (B, C, H, W, ks, ks), then the raw head split
            return t.unfold(2, ks, 1).unfold(3, ks, 1).reshape(
                b, heads, h, w, dh, ks * ks)

        dtype = q.dtype
        ct = torch.promote_types(dtype, torch.float32)
        with torch.autocast(device_type=x.device.type, enabled=False):
            qh = q.reshape(b, heads, h, w, dh).to(ct)
            qk = torch.einsum("bhxyd,bhxydk->bhxyk", qh, unfold(k).to(ct))
            q_sum = qh.sum(-1)[..., None, None]
            qk = (qk.reshape(b, heads, h, w, ks, ks)
                  + q_sum * self.rel_encoding_h.sum(0)
                  + q_sum * self.rel_encoding_w.sum(0))
            weights = torch.softmax(qk.reshape(b, heads, h, w, ks * ks), -1)
            out = torch.einsum("bhxyk,bhxydk->bhxyd",
                               weights.to(dtype).to(ct), unfold(v).to(ct))
        return out.reshape(b, c, h, w).to(dtype)
