"""SwinMLP in PyTorch (port of ``endoscopy_tpu/models/swin_mlp.py``).

Swin's topology (``models/swin.py``: patch embedding, stages, patch
merging, the final LayerNorm and pooling) with a per-head spatial MLP in
place of window attention. The JAX module's numerics are kept:

- :class:`SpatialMLP` mixes each window's ``ws²`` tokens per head with a
  ``(heads, ws², ws²)`` weight and a ``(heads, ws²)`` bias: the einsum
  ``bnhd,hmn->bmhd`` on the bf16 values summed in float32 (autocast off),
  plus the float32 bias, cast back. The weight starts from flax's
  ``lecun_normal`` with flax's fan-in for a 3-D parameter, ``ws² ·
  heads`` (the input axis times the leading one), the bias at 0. The
  reference's grouped ``Conv1d`` holds the same elements as ``(heads ·
  ws², ws², 1)``, which ``ckpt/transfer.py`` reshapes;
- a shifted block pads with zeros (``ws - shift`` before, ``shift``
  after) in place of the roll, takes the windows of the padded map and
  crops the padding off again: no mask.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.layers import wide
from endoscopy_tpu_torch.models.resnet import _TRUNC_STD
from endoscopy_tpu_torch.models.swin import (SwinTransformer, _Block,
                                             window_partition, window_reverse)


class SpatialMLP(nn.Module):
    def __init__(self, num_heads: int, window_tokens: int):
        super().__init__()
        n = window_tokens
        std = (1.0 / (n * num_heads)) ** 0.5 / _TRUNC_STD
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(num_heads, n, n), 0.0, std, -2.0 * std, 2.0 * std))
        self.bias = nn.Parameter(torch.zeros(num_heads, n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bnw, n, c = x.shape
        heads = self.weight.shape[0]
        xh = x.reshape(bnw, n, heads, c // heads)
        with torch.autocast(x.device.type, enabled=False):
            out = torch.einsum("bnhd,hmn->bmhd", wide(xh),
                               wide(self.weight.to(x.dtype)))
            out = out + self.bias.t()[None, :, :, None]
        return out.to(x.dtype).reshape(bnw, n, c)


class SwinMLPBlock(_Block):
    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int],
                 window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__(dim, resolution, window_size, shift_size, mlp_ratio)
        self.spatial_mlp = SpatialMLP(num_heads, self.ws * self.ws)

    def mix(self, y: torch.Tensor) -> torch.Tensor:
        s, ws = self.shift, self.ws
        if s:  # zero padding in place of the roll
            y = F.pad(y, (0, 0, ws - s, s, ws - s, s))
        hp, wp = y.shape[1], y.shape[2]
        y = window_reverse(self.spatial_mlp(window_partition(y, ws)), ws,
                           hp, wp)
        return y[:, ws - s:hp - s, ws - s:wp - s] if s else y


class SwinMLP(SwinTransformer):
    block = SwinMLPBlock


def swin_mlp_tiny(img_size: int = 224) -> SwinMLP:
    return SwinMLP(img_size, embed_dim=96, depths=(2, 2, 6, 2),
                   num_heads=(3, 6, 12, 24))
