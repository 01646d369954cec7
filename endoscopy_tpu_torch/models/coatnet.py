"""CoAtNet-0 in PyTorch (port of ``endoscopy_tpu/models/coatnet.py``).

A convolutional stem (``s0``: two 3x3 convolutions, the first with stride
2, BN and exact GELU), two MBConv stages and two relative-attention
stages (C-C-T-T), every stage's first block halving the side, then the
mean over the pixels. The JAX module's numerics are kept:

- MBConv: a pre-BN, 1x1 expansion (x4, the stride), BN, GELU, a depthwise
  3x3, BN, GELU, squeeze-excite (dense layers without bias, ``in / 4``
  from the block's input channels, GELU, sigmoid), a 1x1 projection and
  BN; a downsampling block adds a max-pooled 1x1 projection of its input,
  the others their input;
- transformer block: a downsampling one max-pools its input and projects
  it for the residual; attention over the (pooled) tokens after a float32
  LayerNorm (eps 1e-5), ``q·kᵀ`` in float32 scaled after the product,
  plus the bias gathered from a zero-initialized ``((2h-1)(2w-1),
  heads)`` table sized by the stage's resolution; then a float32
  LayerNorm and a feed-forward block whose hidden width is four times the
  block's *input* channels (the reference's quirk);
- BN eps 1e-5, flax momentum 0.9 and flax's biased running variance;
  flax's module names (``s0_conv0``, ``s1_block0.pw``, ``s3_block0.attn.
  relative_bias_table``) and initializer.

The bias tables are sized when the model is built for ``img_size`` px, as
flax sizes them from the (pooled) tokens at init.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.layers import attention, norm32, wide
from endoscopy_tpu_torch.models.resnet import (BatchNorm2d, _flax_running_var,
                                               conv2d, dense)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def _rel_index(hh: int, ww: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(hh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel[0] += hh - 1
    rel[1] += ww - 1
    return (rel[0] * (2 * ww - 1) + rel[1]).astype(np.int64)


class MBConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, downsample: bool = False,
                 expansion: int = 4):
        super().__init__()
        hidden = in_ch * expansion
        self.downsample = downsample
        self.pre_bn = _bn(in_ch)
        self.pw = conv2d(in_ch, hidden, 1, stride=2 if downsample else 1)
        self.bn1 = _bn(hidden)
        self.dw = conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.bn2 = _bn(hidden)
        se_ch = max(1, in_ch // 4)
        self.se_fc1 = dense(hidden, se_ch, bias=False)
        self.se_fc2 = dense(se_ch, hidden, bias=False)
        self.pw_linear = conv2d(hidden, out_ch, 1)
        self.bn3 = _bn(out_ch)
        if downsample:
            self.pool = nn.MaxPool2d(3, stride=2, padding=1)
            self.proj = conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.bn1(self.pw(self.pre_bn(x))))
        y = F.gelu(self.bn2(self.dw(y)))
        s = self.se_fc2(F.gelu(self.se_fc1(y.mean((2, 3)))))
        y = self.bn3(self.pw_linear(y * torch.sigmoid(s)[:, :, None, None]))
        if self.downsample:
            return self.proj(self.pool(x)) + y
        return x + y


class RelAttention(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, resolution: Tuple[int, int],
                 heads: int = 8, dim_head: int = 32):
        super().__init__()
        hh, ww = resolution
        self.heads, self.dim_head = heads, dim_head
        self.relative_bias_table = nn.Parameter(
            torch.zeros((2 * hh - 1) * (2 * ww - 1), heads))
        self.register_buffer("relative_index",
                             torch.from_numpy(_rel_index(hh, ww)),
                             persistent=False)
        self.to_qkv = dense(in_ch, 3 * heads * dim_head, bias=False)
        self.to_out = dense(heads * dim_head, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        heads, dh = self.heads, self.dim_head
        if n != self.relative_index.shape[0]:
            raise ValueError(f"RelAttention built for "
                             f"{self.relative_index.shape[0]} tokens gets {n} "
                             "(build the model for this image size)")
        bias = self.relative_bias_table[self.relative_index.reshape(-1)]
        bias = bias.reshape(n, n, heads).permute(2, 0, 1)
        q, k, v = self.to_qkv(x).reshape(b, n, 3, heads, dh).permute(
            2, 0, 3, 1, 4)
        out = attention(q, k, v, lambda a: a * dh ** -0.5 + wide(bias))
        return self.to_out(out.transpose(1, 2).reshape(b, n, heads * dh))


class TransformerBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, resolution: Tuple[int, int],
                 downsample: bool = False, heads: int = 8, dim_head: int = 32):
        super().__init__()
        self.downsample = downsample
        if downsample:
            self.pool = nn.MaxPool2d(3, stride=2, padding=1)
            self.proj = conv2d(in_ch, out_ch, 1)
        self.attn_norm = nn.LayerNorm(in_ch, eps=1e-5)
        self.attn = RelAttention(in_ch, out_ch, resolution, heads, dim_head)
        self.ff_norm = nn.LayerNorm(out_ch, eps=1e-5)
        self.ff1 = dense(out_ch, 4 * in_ch)
        self.ff2 = dense(4 * in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = self.pool(x)
            res = self.proj(x)
        else:
            res = x
        b, _, h, w = x.shape
        att = self.attn(norm32(self.attn_norm, x.flatten(2).transpose(1, 2)))
        x = res + att.transpose(1, 2).reshape(b, -1, h, w)
        y = norm32(self.ff_norm, x.flatten(2).transpose(1, 2))
        y = self.ff2(F.gelu(self.ff1(y)))
        return x + y.transpose(1, 2).reshape(b, -1, h, w)


class CoAtNet(nn.Module):
    """Pooled float32 ``(B, channels[-1])`` features for ``img_size`` px
    inputs."""

    def __init__(self, img_size: int = 224,
                 num_blocks: Sequence[int] = (2, 2, 3, 5, 2),
                 channels: Sequence[int] = (64, 96, 192, 384, 768),
                 block_types: Sequence[str] = ("C", "C", "T", "T")):
        super().__init__()
        self.names = []
        in_ch = 3
        for i in range(num_blocks[0]):
            self.add_module(f"s0_conv{i}", conv2d(
                in_ch, channels[0], 3, stride=2 if i == 0 else 1, padding=1))
            self.add_module(f"s0_bn{i}", _bn(channels[0]))
            in_ch = channels[0]
        self.stem_blocks = num_blocks[0]
        side = -(-int(img_size) // 2)
        for stage in range(4):
            ch = channels[stage + 1]
            for i in range(num_blocks[stage + 1]):
                down = i == 0
                name = f"s{stage + 1}_block{i}"
                if down:  # a stride-2 1x1 or a padded 3x3 max-pool
                    side = -(-side // 2)
                if block_types[stage] == "C":
                    block = MBConvBlock(in_ch, ch, downsample=down)
                else:
                    block = TransformerBlock(in_ch, ch, (side, side),
                                             downsample=down)
                self.add_module(name, block)
                self.names.append(name)
                in_ch = ch
        self.num_features = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _flax_running_var(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.stem_blocks):
            x = F.gelu(getattr(self, f"s0_bn{i}")(
                getattr(self, f"s0_conv{i}")(x)))
        for name in self.names:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()


def coatnet_0(img_size: int = 224) -> CoAtNet:
    return CoAtNet(img_size)
