"""ViT for small datasets in PyTorch (port of ``endoscopy_tpu/models/vit_lsa.py``).

Shifted Patch Tokenization and Locality Self-Attention; ``vit_lsa`` is the
small model: patch 16, dim 384, depth 8, 8 heads of 64, MLP 1536, the
``cls`` pool. The JAX module's numerics are kept:

- :class:`SPT`: the image (in the compute dtype, as flax casts it) and its
  four one-pixel shifts (right, left, down, up; zeros shifted in)
  concatenated along the channels, cut into patches flattened in
  ``(row, column, channel)`` order, a float32 LayerNorm and a dense
  projection;
- :class:`LSA`: ``q·kᵀ`` in float32 (autocast off) times
  ``exp(temperature)``, a learnable scalar that starts at
  ``log(dim_head ** -0.5)``, the diagonal filled with float32's lowest
  value, the softmax in float32 and the probabilities cast back
  (``models/layers.py``);
- the cls token prepended and the position embedding added in the compute
  dtype, both drawn from ``normal(1.0)``; pre-norm blocks with float32
  LayerNorms (eps 1e-5) and exact GELU; no final norm; the cls token's
  features come back in float32.

The position embedding has ``n + 1`` rows for the ``n`` patches of an
``img_size`` px image, sized when the model is built, as flax sizes it at
init.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from endoscopy_tpu_torch.models.layers import attention, norm32
from endoscopy_tpu_torch.models.resnet import dense


def _compute_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` in autocast's dtype where autocast is on (flax casts the
    image to the model's dtype before the tokenization)."""
    device = x.device.type
    if torch.is_autocast_enabled(device):
        return x.to(torch.get_autocast_dtype(device))
    return x


class LSA(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.temperature = nn.Parameter(
            torch.tensor(math.log(dim_head ** -0.5)))
        self.to_qkv = dense(dim, 3 * heads * dim_head, bias=False)
        self.to_out = dense(heads * dim_head, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.to_qkv(x).reshape(b, n, 3, self.heads,
                                         self.dim_head).permute(2, 0, 3, 1, 4)
        eye = torch.eye(n, dtype=torch.bool, device=x.device)

        def logits(a):
            return (a * torch.exp(self.temperature)).masked_fill(
                eye, torch.finfo(torch.float32).min)

        out = attention(q, k, v, logits).transpose(1, 2)
        return self.to_out(out.reshape(b, n, self.heads * self.dim_head))


class SPT(nn.Module):
    """Shifted Patch Tokenization: ``norm`` and ``proj``."""

    def __init__(self, dim: int, patch_size: int, channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        width = patch_size * patch_size * 5 * channels
        self.norm = nn.LayerNorm(width, eps=1e-5)
        self.proj = dense(width, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape

        def shift(dx, dy):
            pad = (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0))
            return F.pad(x, pad)[:, :, max(-dy, 0):h + max(-dy, 0),
                                 max(-dx, 0):w + max(-dx, 0)]

        cat = torch.cat([x, shift(1, 0), shift(-1, 0), shift(0, 1),
                         shift(0, -1)], 1).permute(0, 2, 3, 1)
        p, c = self.patch_size, cat.shape[-1]
        cat = cat.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        cat = cat.reshape(b, (h // p) * (w // p), p * p * c)
        return self.proj(norm32(self.norm, cat))


class ViTLSA(nn.Module):
    """Pooled float32 ``(B, dim)`` features for ``img_size`` px inputs."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 dim: int = 384, depth: int = 8, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 1536, pool: str = "cls"):
        super().__init__()
        self.depth, self.pool = depth, pool
        self.to_patch_embedding = SPT(dim, patch_size)
        n = (int(img_size) // patch_size) ** 2
        self.pos_embedding = nn.Parameter(torch.randn(1, n + 1, dim))
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim))
        for i in range(depth):
            self.add_module(f"norm1_{i}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"attn_{i}", LSA(dim, heads, dim_head))
            self.add_module(f"norm2_{i}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"mlp1_{i}", dense(dim, mlp_dim))
            self.add_module(f"mlp2_{i}", dense(mlp_dim, dim))
        self.num_features = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.to_patch_embedding(_compute_dtype(x))
        b, n, _ = x.shape
        if n + 1 != self.pos_embedding.shape[1]:
            raise ValueError(f"ViT-LSA built for "
                             f"{self.pos_embedding.shape[1] - 1} patches gets "
                             f"{n} (build the model for this image size)")
        x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x], 1)
        x = x + self.pos_embedding.to(x.dtype)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(
                norm32(getattr(self, f"norm1_{i}"), x))
            y = norm32(getattr(self, f"norm2_{i}"), x)
            x = x + getattr(self, f"mlp2_{i}")(
                F.gelu(getattr(self, f"mlp1_{i}")(y)))
        out = x.mean(1) if self.pool == "mean" else x[:, 0]
        return out.float()


def vit_lsa_small(img_size: int = 224) -> ViTLSA:
    return ViTLSA(img_size, dim=384, depth=8, heads=8, mlp_dim=1536)
