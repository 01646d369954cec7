"""A plain float32 Swin-T for the check that decides ``correct``.

Swin Transformer (Liu et al., arXiv:2103.14030), as timm's
``swin_tiny_patch4_window7_224`` trains it: a 4x4 patch embedding (a
convolution with bias) and its LayerNorm; four stages of (2, 2, 6, 2)
blocks of widths (96, 192, 384, 768) and (3, 6, 12, 24) heads, each stage
but the last followed by patch merging; a final LayerNorm, the mean over
the tokens and a linear head. Written from the paper in plain ``torch``;
it imports nothing of the port. Its parameter names are the port's
state-dict names (``backbone.stage{s}_block{b}.attn.qkv``,
``backbone.merge{s}.reduction``, ``head.fc``), so the benchmark's seeded
weights load into both by name.

A block is pre-norm: ``x + W-MSA(LN(x))``, then ``x + MLP(LN(x))`` with
an exact GELU and an MLP ratio of 4. Its attention runs over ``ws x ws``
windows (``ws`` 7), ``softmax(q kᵀ · d^-1/2 + B + M) v``: ``B`` gathered
from a ``((2 ws - 1)², heads)`` table of relative positions, ``M`` -100
between the regions a cyclic shift brings together, added in the odd
blocks, which roll the map by ``-ws/2`` before their windows and back
after. A stage whose side is at most the window takes one window of its
whole side and no shift (stage 4 at 224 px: 7 x 7). Patch merging
concatenates the four pixels of each 2 x 2 block (``[0::2, 0::2]``,
``[1::2, 0::2]``, ``[0::2, 1::2]``, ``[1::2, 1::2]``) before a
LayerNorm and a bias-free halving linear layer. LayerNorm eps 1e-5.

Departures from the paper and from timm: float32 throughout, the scale
applied to ``q kᵀ`` rather than to ``q`` (the same up to rounding); no
stochastic depth (timm's default drop path of 0.1 is a training draw the
check could not repeat); the bias tables are drawn by the benchmark's
weights (``harness/weights.py``) as 2-D dense kernels, normal of std
``heads^-1/2``, where timm draws a truncated normal of std 0.02.

The window attention subclasses ``reference.models.Attention``, so the
control's float8 (``set_fp8``) and ``flops.py``'s count of the products
(``2 · b · n² · c`` on each ``(B·nW, ws², C)`` input) reach it. The index
and mask buffers are made by torch ops that follow the device context,
so the model also builds on the ``meta`` device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .models import Attention, Conv2d, Linear, _Head, fp8, fp8_grad

EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws², C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws², C) → (B, H, W, C)."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_index(ws: int) -> torch.Tensor:
    """(ws², ws²): for each pair of a window's pixels, the row of the bias
    table that holds their offset ``(dy + ws - 1) · (2 ws - 1) + dx + ws -
    1``."""
    yy, xx = torch.meshgrid(torch.arange(ws), torch.arange(ws),
                            indexing="ij")
    y, x = yy.reshape(-1), xx.reshape(-1)
    dy = y[:, None] - y[None, :] + ws - 1
    dx = x[:, None] - x[None, :] + ws - 1
    return dy * (2 * ws - 1) + dx


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws², ws²): -100 between pixels of a window that lie in
    different regions of the rolled map, else 0."""
    region = torch.zeros(h, w)
    bands = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    label = 0
    for rows in bands:
        for cols in bands:
            region[rows, cols] = label
            label += 1
    r = window_partition(region[None, :, :, None], ws)[..., 0]
    return torch.where(r[:, None, :] != r[:, :, None], -100.0, 0.0)


class WindowAttention(Attention):
    """Multi-head self-attention inside each window, with the relative
    position bias and, for a shifted block, the mask."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__(dim, heads)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("index", relative_index(ws), persistent=False)

    def forward(self, x, mask=None):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).view(b, n, 3, self.heads,
                                   hd).permute(2, 0, 3, 1, 4)
        if self.fp8:
            q, k, v = fp8(q), fp8(k), fp8(v)
        logits = q @ k.transpose(-2, -1)
        if self.fp8:
            logits = fp8_grad(logits)
        bias = self.relative_position_bias_table[self.index.reshape(-1)]
        logits = logits * hd ** -0.5 + bias.view(n, n, -1).permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.view(b // nw, nw, self.heads, n, n)
                      + mask[None, :, None]).view(b, self.heads, n, n)
        a = torch.softmax(logits, dim=-1)
        out = fp8(a) @ v if self.fp8 else a @ v
        if self.fp8:
            out = fp8_grad(out)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, side: int, ws: int,
                 shift: int, mlp_ratio: float):
        super().__init__()
        if side <= ws:  # one window of the whole side, unshifted
            ws, shift = side, 0
        self.side, self.ws, self.shift = side, ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)
        self.register_buffer(
            "attn_mask", shift_mask(side, side, ws, shift) if shift else None,
            persistent=False)

    def forward(self, x):
        b, n, c = x.shape
        s, ws, side = self.shift, self.ws, self.side
        y = self.norm1(x).view(b, side, side, c)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask),
                           ws, side, side)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, side: int, dim: int):
        super().__init__()
        self.side = side
        self.norm = nn.LayerNorm(4 * dim, eps=EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        x = x.view(b, self.side, self.side, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinTransformer(nn.Module):
    """Pooled ``(B, C)`` features of ``img_size`` px images."""

    def __init__(self, img_size: int = 224, patch: int = 4, dim: int = 96,
                 depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window: int = 7,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_embed = Conv2d(3, dim, patch, patch)
        self.patch_norm = nn.LayerNorm(dim, eps=EPS)
        side, self.names = img_size // patch, []
        for stage, depth in enumerate(depths):
            for i in range(depth):
                name = f"stage{stage}_block{i}"
                self.add_module(name, SwinBlock(
                    dim, heads[stage], side, window,
                    0 if i % 2 == 0 else window // 2, mlp_ratio))
                self.names.append(name)
            if stage < len(depths) - 1:
                name = f"merge{stage}"
                self.add_module(name, PatchMerging(side, dim))
                self.names.append(name)
                side, dim = side // 2, dim * 2
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.num_features = dim

    def forward(self, x):
        x = self.patch_norm(self.patch_embed(x).flatten(2).transpose(1, 2))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.norm(x).mean(1)


class SwinClassifier(nn.Module):
    """backbone → pooled features → linear head → logits."""

    def __init__(self, classes: int, **sizes):
        super().__init__()
        self.backbone = SwinTransformer(**sizes)
        self.head = _Head(self.backbone.num_features, classes)

    def forward(self, x):
        return self.head(self.backbone(x))


def build(name: str, classes: int, **sizes) -> nn.Module:
    """``swin_tiny_patch4_window7_224`` (also ``swin_tiny``) at
    ``img_size`` (224 by default). ``sizes`` (``img_size``, ``patch``,
    ``dim``, ``depths``, ``heads``, ``window``, ``mlp_ratio``) give a
    smaller Swin for the CPU tests; a size given as None (the Conformer's
    ``MODEL`` keys that ``harness/cell.py`` passes, unset) is left out."""
    if name not in ("swin_tiny_patch4_window7_224", "swin_tiny"):
        raise ValueError(f"no reference model {name!r}")
    return SwinClassifier(classes, **{k: v for k, v in sizes.items()
                                      if v is not None and v != "None"})
