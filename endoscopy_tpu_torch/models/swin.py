"""Swin Transformer in PyTorch (port of ``endoscopy_tpu/models/swin.py``).

The reference trains timm's ``swin_tiny_patch4_window7_224`` (registered as
``swin_tiny``, ``swin`` and that name); ``swin_small`` has 18 blocks in its
third stage. A 4x4 patch embedding (a convolution with bias) and its
LayerNorm, four stages of window-attention blocks, each stage but the last
followed by patch merging, a final LayerNorm and the mean over the tokens.
The JAX module's numerics are kept:

- tokens are ``(B, H·W, C)`` in row-major pixel order; a window is a
  ``ws x ws`` tile (:func:`window_partition`, :func:`window_reverse`);
  every odd block shifts by ``-ws/2`` (``torch.roll``) before its windows
  and back after them, and adds :func:`shift_attn_mask` (-100 between
  pixels of different regions) to each window's logits before the
  softmax;
- a stage whose side is at most the window takes one window of its whole
  side and no shift (``min(h, w) <= ws``); every stage side must be even
  for the merge (224 px works, 112 does not, in both packages);
- attention: ``q·kᵀ`` in float32 with autocast off, the scale
  ``head_dim ** -0.5`` after the product, then the relative-position bias
  gathered from a ``((2 ws - 1)², heads)`` float32 table (drawn from
  ``truncated_normal(0.02)``), then the mask, the softmax in float32 and
  the probabilities cast back (``models/layers.py``);
- LayerNorms in float32, eps 1e-5, cast back to the input's dtype (the
  last one stays float32 for the pooling); exact GELU;
- patch merging concatenates ``[0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
  [1::2, 1::2]`` before its LayerNorm and a bias-free halving dense layer;
- flax's module names (``patch_embed``, ``stage{s}_block{b}.attn.qkv``,
  ``mlp_fc1``, ``merge{s}.reduction``, ``norm``) and its initializer
  (``lecun_normal`` kernels, zero biases).

The window sizes, the masks and the bias index are fixed when the model is
built for ``img_size`` px (non-persistent buffers), as flax fixes them from
the input at init: a model built for one side refuses another.

Each :class:`WindowAttention` forward runs in the span
``model/window_attention`` (the host's enqueue of the bias gather, the
attention and the projection). From the ``qkv`` projection's output to the
projection's input the attention is ``ops/window_attention.py``: on the
card in bf16 a hand-written kernel, forward and backward, that keeps each
window's logits on chip (counter ``window_attention/fused``); elsewhere
the plain path above, which adds to the counter ``swin/window_logit_bytes``
the bytes of the float32 logits it materialises, ``B·nW · heads · n² · 4``
(``utils/trace.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.layers import (norm32, truncated_normal,
                                               wide)
from endoscopy_tpu_torch.models.resnet import conv2d, dense
from endoscopy_tpu_torch.ops import window_attention as wa
from endoscopy_tpu_torch.utils import trace


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, H, W, C)."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + ws - 1
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask of the shifted windows: -100 between
    pixels of the nine regions the roll brings together, else 0."""
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def stage_window(h: int, w: int, ws: int, shift: int) -> Tuple[int, int]:
    """The window and shift a block at ``h x w`` takes: one window of the
    whole side, unshifted, once the side is at most the window."""
    if min(h, w) <= ws:
        return min(h, w), 0
    return ws, shift


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(
            truncated_normal(((2 * ws - 1) ** 2, num_heads), 0.02))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(ws)), persistent=False)
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = dense(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        with trace.span("model/window_attention"):
            return self._forward(x, mask)

    def _forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        bnw, n, c = x.shape
        heads = self.num_heads
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(n, n, heads)
        qkv = self.qkv(x).reshape(bnw, n, 3, heads, c // heads)
        return self.proj(wa.window_attention(qkv, bias.permute(2, 0, 1),
                                             mask))


class _Block(nn.Module):
    """A Swin block's frame: pre-norm token mixing over (shifted) windows,
    then the pre-norm MLP; :meth:`mix` is the block's own."""

    def __init__(self, dim: int, resolution: Tuple[int, int],
                 window_size: int, shift_size: int, mlp_ratio: float):
        super().__init__()
        self.h, self.w = resolution
        self.ws, self.shift = stage_window(self.h, self.w, window_size,
                                           shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        if l != self.h * self.w:
            raise ValueError(f"a Swin block built for {self.h}x{self.w} "
                             f"tokens gets {l} (build the model for this "
                             "image size)")
        y = self.mix(norm32(self.norm1, x).reshape(b, self.h, self.w, c))
        x = x + y.reshape(b, l, c)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(norm32(self.norm2, x))))


class SwinBlock(_Block):
    def __init__(self, dim: int, num_heads: int, resolution: Tuple[int, int],
                 window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__(dim, resolution, window_size, shift_size, mlp_ratio)
        self.attn = WindowAttention(dim, num_heads, self.ws)
        mask = (torch.from_numpy(shift_attn_mask(self.h, self.w, self.ws,
                                                 self.shift))
                if self.shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def mix(self, y: torch.Tensor) -> torch.Tensor:
        s, ws = self.shift, self.ws
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask),
                           ws, self.h, self.w)
        return torch.roll(y, (s, s), (1, 2)) if s else y


class PatchMerging(nn.Module):
    def __init__(self, resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.h, self.w = resolution
        if self.h % 2 or self.w % 2:
            raise ValueError(f"patch merging needs an even side, not "
                             f"{self.h}x{self.w} (Swin at 112 px fails in "
                             "the JAX package too; 224 px works)")
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, self.h, self.w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(norm32(self.norm, x.reshape(b, -1, 4 * c)))


class SwinTransformer(nn.Module):
    """Pooled float32 ``(B, C)`` features of the hierarchical Swin for
    ``img_size`` px inputs; ``block`` is the stages' block class."""

    block = SwinBlock

    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_embed = conv2d(3, embed_dim, patch_size, stride=patch_size,
                                  bias=True)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        h = w = int(img_size) // patch_size
        dim, self.names = embed_dim, []
        for stage, depth in enumerate(depths):
            for blk in range(depth):
                name = f"stage{stage}_block{blk}"
                self.add_module(name, self.block(
                    dim, num_heads[stage], (h, w), window_size,
                    0 if blk % 2 == 0 else window_size // 2, mlp_ratio))
                self.names.append(name)
            if stage < len(depths) - 1:
                name = f"merge{stage}"
                self.add_module(name, PatchMerging((h, w), dim))
                self.names.append(name)
                h, w, dim = h // 2, w // 2, dim * 2
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.num_features = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x).flatten(2).transpose(1, 2)
        x = norm32(self.patch_norm, x)
        for name in self.names:
            x = getattr(self, name)(x)
        x = F.layer_norm(wide(x), self.norm.normalized_shape,
                         self.norm.weight, self.norm.bias, self.norm.eps)
        return x.mean(1).float()


def swin_tiny(img_size: int = 224) -> SwinTransformer:
    """swin_tiny_patch4_window7_224."""
    return SwinTransformer(img_size, embed_dim=96, depths=(2, 2, 6, 2),
                           num_heads=(3, 6, 12, 24))


def swin_small(img_size: int = 224) -> SwinTransformer:
    return SwinTransformer(img_size, embed_dim=96, depths=(2, 2, 18, 2),
                           num_heads=(3, 6, 12, 24))
