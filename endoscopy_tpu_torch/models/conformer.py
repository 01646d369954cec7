"""Conformer, the dual-branch CNN + ViT backbone of SemiFormer (port of
``endoscopy_tpu/models/conformer.py``).

A ResNet-style stem feeds a bottleneck CNN trunk and a ViT trunk; in every
coupled block ``FCUDown`` projects the CNN's features into the token
sequence and ``FCUUp`` projects the tokens back onto the feature map. The
model returns ``(conv_cls, trans_cls)``, both float32. Conformer-Ti is the
default: patch 16, ``channel_ratio`` 1, embed 384, depth 12, 6 heads,
``mlp_ratio`` 4, ``qkv_bias``.

The flax module's numerics are kept:

- every BN and LN has ``eps=1e-6``; BN is ``models/resnet.py``'s, whose
  train-mode running variance moves as flax's does (``_flax_running_var``);
- GELU is exact (erf);
- LayerNorm runs in float32 and its output is cast back to the dtype of
  its input (the compute dtype: bf16 under the card's autocast); the trans
  head reads the float32 norm of the cls token;
- attention takes ``q·kᵀ`` in float32 (autocast off), scales it by
  ``head_dim ** -0.5`` after the product, takes the softmax in float32 and
  casts the probabilities to ``v``'s dtype before the product with ``v``;
- ``FCUUp`` upsamples by nearest-neighbour repetition.

Where flax computes in float32, the port computes in float32 or, for a
model cast to float64 (the precision reference of the card checks), in
float64 (``models/layers.py``).

Fresh weights follow flax's initializer: ``lecun_normal`` kernels and zero
biases for every convolution and dense layer (``conv_project`` and
``trans_patch_conv`` have biases, as flax's ``nn.Conv`` default does), LN
scale 1 and offset 0, and ``cls_token`` a standard normal truncated at ±2
times 0.02 (std 0.0176). Attribute names are flax's module names
(``conv_trans_7.squeeze_block.conv_project.weight``), which are also the
reference's PyTorch names: a reference ``.pth`` maps by identity, and the
tree has no ``backbone.`` prefix, so ``TRAIN.IS_FREEZE`` freezes nothing
(the reference's behaviour).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.layers import attention, norm32, wide
from endoscopy_tpu_torch.models.resnet import (BatchNorm2d, _flax_running_var,
                                               conv2d, dense)

EPS = 1e-6


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=EPS, momentum=0.1)


def _ln(ch: int) -> nn.LayerNorm:
    return nn.LayerNorm(ch, eps=EPS)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = dense(dim, hidden)
        self.fc2 = dense(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (b, heads, n, head_dim)
        out = attention(q, k, v, lambda a: a * self.head_dim ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class TransBlock(nn.Module):
    """Pre-norm ViT block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(norm32(self.norm1, x))
        return x + self.mlp(norm32(self.norm2, x))


class ConvBlock(nn.Module):
    """Bottleneck 1x1 → 3x3 (stride) → 1x1, with an optional residual
    convolution and an optional token map added before the 3x3. Returns
    ``(out, x2)``, ``x2`` the 3x3's activation."""

    def __init__(self, inplanes: int, outplanes: int, stride: int = 1,
                 res_conv: bool = False):
        super().__init__()
        med = outplanes // 4
        self.conv1 = conv2d(inplanes, med, 1)
        self.bn1 = _bn(med)
        self.conv2 = conv2d(med, med, 3, stride=stride, padding=1)
        self.bn2 = _bn(med)
        self.conv3 = conv2d(med, outplanes, 1)
        self.bn3 = _bn(outplanes)
        self.res_conv = res_conv
        if res_conv:
            self.residual_conv = conv2d(inplanes, outplanes, 1, stride=stride)
            self.residual_bn = _bn(outplanes)

    def forward(self, x: torch.Tensor, x_t: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        if x_t is not None:
            y = y + x_t
        x2 = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(x2))
        residual = (self.residual_bn(self.residual_conv(x)) if self.res_conv
                    else x)
        return F.relu(y + residual), x2


class FCUDown(nn.Module):
    """Feature map → tokens: 1x1 conv, average pool by ``dw_stride``, LN,
    GELU, the running cls token prepended."""

    def __init__(self, inplanes: int, embed_dim: int, dw_stride: int):
        super().__init__()
        self.conv_project = conv2d(inplanes, embed_dim, 1, bias=True)
        self.ln = _ln(embed_dim)
        self.dw_stride = dw_stride

    def forward(self, x: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        y = self.conv_project(x)
        if self.dw_stride > 1:
            y = F.avg_pool2d(y, self.dw_stride)
        y = F.gelu(norm32(self.ln, y.flatten(2).transpose(1, 2)))
        return torch.cat([x_t[:, :1], y], dim=1)


class FCUUp(nn.Module):
    """Tokens → feature map: drop the cls token, 1x1 conv, BN, ReLU,
    nearest upsample by ``up_stride``."""

    def __init__(self, embed_dim: int, outplanes: int, up_stride: int):
        super().__init__()
        self.conv_project = conv2d(embed_dim, outplanes, 1, bias=True)
        self.bn = _bn(outplanes)
        self.up_stride = up_stride

    def forward(self, x_t: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x_t.shape
        y = x_t[:, 1:].transpose(1, 2).reshape(b, c, h, w)
        y = F.relu(self.bn(self.conv_project(y)))
        if self.up_stride > 1:
            y = F.interpolate(y, size=(h * self.up_stride, w * self.up_stride),
                              mode="nearest")
        return y


class ConvTransBlock(nn.Module):
    """One coupled block: the CNN block, the tokens it feeds, the ViT
    block, and the fusion block that takes the tokens back."""

    def __init__(self, inplanes: int, outplanes: int, res_conv: bool,
                 stride: int, dw_stride: int, embed_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 last_fusion: bool = False):
        super().__init__()
        self.cnn_block = ConvBlock(inplanes, outplanes, stride, res_conv)
        self.squeeze_block = FCUDown(outplanes // 4, embed_dim, dw_stride)
        self.trans_block = TransBlock(embed_dim, num_heads, mlp_ratio,
                                      qkv_bias)
        self.expand_block = FCUUp(embed_dim, outplanes // 4, dw_stride)
        self.fusion_block = ConvBlock(outplanes, outplanes,
                                      2 if last_fusion else 1,
                                      res_conv=last_fusion)
        self.dw_stride = dw_stride

    def forward(self, x: torch.Tensor, x_t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, x2 = self.cnn_block(x)
        h, w = x2.shape[2:]
        x_t = self.trans_block(self.squeeze_block(x2, x_t) + x_t)
        x_t_r = self.expand_block(x_t, h // self.dw_stride,
                                  w // self.dw_stride)
        x, _ = self.fusion_block(x, x_t_r)
        return x, x_t


class Conformer(nn.Module):
    """The dual-head Conformer: ``(conv_cls, trans_cls)``, float32."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 base_channel: int = 64, channel_ratio: int = 1,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
        if depth % 3:
            raise ValueError(f"Conformer depth {depth} is not a multiple of 3")
        self.depth = depth
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        with torch.no_grad():
            nn.init.trunc_normal_(self.cls_token, 0.0, 1.0, -2.0, 2.0)
            self.cls_token.mul_(0.02)
        # stem: 7x7/2 conv → BN → ReLU → 3x3/2 max-pool
        self.conv1 = conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

        stage_1 = base_channel * channel_ratio
        dw = patch_size // 4
        # stage 1: a conv block, the patch projection, the first ViT block
        self.conv_1 = ConvBlock(64, stage_1, 1, res_conv=True)
        self.trans_patch_conv = conv2d(64, embed_dim, dw, stride=dw,
                                       bias=True)
        self.trans_1 = TransBlock(embed_dim, num_heads, mlp_ratio, qkv_bias)
        # blocks 2..depth/3 continue stage 1; the first block of stages 2
        # and 3 downsamples with a residual conv; the last block's fusion
        # block downsamples too
        third = depth // 3
        inplanes = stage_1
        for i in range(2, depth + 1):
            if i <= third:
                planes, stride, res_conv, dw_i = stage_1, 1, False, dw
            else:
                stage = 2 if i <= 2 * third else 3
                first = i == (stage - 1) * third + 1
                planes = stage_1 * 2 ** (stage - 1)
                stride, res_conv = (2 if first else 1), first
                dw_i = dw // 2 ** (stage - 1)
            self.add_module(f"conv_trans_{i}", ConvTransBlock(
                inplanes, planes, res_conv, stride, dw_i, embed_dim,
                num_heads, mlp_ratio, qkv_bias, last_fusion=(i == depth)))
            inplanes = planes
        self.conv_cls_head = dense(inplanes, num_classes)
        self.trans_norm = _ln(embed_dim)
        self.trans_cls_head = dense(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            return _flax_running_var(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x_base = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        xc, _ = self.conv_1(x_base)
        xt = self.trans_patch_conv(x_base).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(xt.dtype)
        xt = self.trans_1(torch.cat([cls, xt], dim=1))
        for i in range(2, self.depth + 1):
            xc, xt = getattr(self, f"conv_trans_{i}")(xc, xt)
        with torch.autocast(x.device.type, enabled=False):
            conv_cls = self.conv_cls_head(wide(xc.mean(dim=(2, 3))))
            trans_cls = self.trans_cls_head(self.trans_norm(wide(xt[:, 0])))
        return conv_cls, trans_cls


def conformer_tiny(num_classes: int = 1000) -> Conformer:
    """Conformer-Ti."""
    return Conformer(num_classes=num_classes, patch_size=16, channel_ratio=1,
                     embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0,
                     qkv_bias=True)
