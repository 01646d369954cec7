"""Attention gates and layers of the ResNet zoo (port of
``endoscopy_tpu/models/attention.py``).

- :class:`CBAM` (``resnet50cbam``): a channel gate, sigmoid of a shared
  MLP (dense layers with biases, ``C/16``) over the mean- and max-pooled
  pixel, then a spatial gate, sigmoid of a 7x7 convolution (no bias) and
  BN over the per-pixel ``[max, mean]`` of the channels;
- :class:`ShuffleAttention` (``resnet50sa``): ``groups`` groups of ``2 ·
  half`` channels; the first half gated by its pooled mean
  (``cweight · mean + cbias``), the second by its GroupNorm (one channel
  per norm group: per-(sample, group, channel) statistics over the
  pixels, in float32, eps 1e-5; ``sweight · gn + sbias``); the halves
  concatenated, then shuffled with 2 groups. ``cweight``/``sweight``
  start at 0 and ``cbias``/``sbias`` at 1, shape ``(half,)`` (the
  reference's ``(1, half, 1, 1)``, reshaped by ``ckpt/transfer.py``). As
  in flax, the float32 gate makes the block's output float32;
- :class:`HaloAttention`, which no registered backbone uses: blocked local
  attention, queries from ``block x block`` blocks, keys and values from
  their ``block + 2 halo`` neighbourhoods (``F.unfold``, channel-major
  like ``conv_general_dilated_patches``), a factorized relative position
  embedding added to the float32 logits, and the padding keys masked out:
  the polarity-corrected mask the JAX module keeps (the reference fills
  the valid keys instead);
- :class:`SASALayer`, below.

Stand-alone self-attention, the 3x3 convolution's replacement in
``resnet50sasa``: local attention over ``ks x ks`` windows (``ks = min(7, side)``) with the
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

from endoscopy_tpu_torch.models.layers import wide
from endoscopy_tpu_torch.models.resnet import BatchNorm2d, conv2d, dense


class CBAM(nn.Module):
    """``mlp_fc1``/``mlp_fc2``, ``spatial_conv`` and ``spatial_bn``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.mlp_fc1 = dense(channels, channels // reduction)
        self.mlp_fc2 = dense(channels // reduction, channels)
        self.spatial_conv = conv2d(2, 1, 7, padding=3)
        self.spatial_bn = BatchNorm2d(1, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(v):
            return self.mlp_fc2(torch.relu(self.mlp_fc1(v)))

        att = mlp(x.mean((2, 3))) + mlp(x.amax((2, 3)))
        x = x * torch.sigmoid(att)[:, :, None, None]
        pooled = torch.stack([x.amax(1), x.mean(1)], 1)
        return x * torch.sigmoid(self.spatial_bn(self.spatial_conv(pooled)))


class ShuffleAttention(nn.Module):
    """``cweight``, ``cbias``, ``sweight``, ``sbias`` and ``gn``."""

    def __init__(self, channels: int, groups: int = 64):
        super().__init__()
        self.groups = groups
        half = channels // (2 * groups)
        self.cweight = nn.Parameter(torch.zeros(half))
        self.cbias = nn.Parameter(torch.ones(half))
        self.sweight = nn.Parameter(torch.zeros(half))
        self.sbias = nn.Parameter(torch.ones(half))
        self.gn = nn.GroupNorm(half, half, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g, half = self.groups, self.cweight.shape[0]
        xg = x.reshape(b, g, 2 * half, h, w)
        x0, x1 = xg[:, :, :half], xg[:, :, half:]
        per = (half, 1, 1)
        xn = x0.mean((3, 4), keepdim=True)
        x0 = x0 * torch.sigmoid(self.cweight.view(per) * xn
                                + self.cbias.view(per))
        with torch.autocast(x.device.type, enabled=False):
            xs = F.group_norm(wide(x1).reshape(b * g, half, h, w), half,
                              self.gn.weight, self.gn.bias, self.gn.eps)
        xs = xs.reshape(b, g, half, h, w)
        x1 = x1 * torch.sigmoid(self.sweight.view(per) * xs
                                + self.sbias.view(per))
        out = torch.cat([x0, x1], 2).reshape(b, c, h, w)
        # channel shuffle with 2 groups
        return out.reshape(b, 2, c // 2, h, w).transpose(1, 2).reshape(
            b, c, h, w)


class HaloAttention(nn.Module):
    """``to_q``, ``to_kv`` (dense, no bias), ``to_out`` and the
    ``rel_height``/``rel_width`` tables ``(2 win - 1, dim_head)``, drawn
    from ``normal(0.02)``. Takes and returns NCHW."""

    def __init__(self, dim: int, block_size: int = 8, halo_size: int = 4,
                 dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.block, self.halo = block_size, halo_size
        self.dim_head, self.heads = dim_head, heads
        inner, win = dim_head * heads, block_size + 2 * halo_size
        self.to_q = dense(dim, inner, bias=False)
        self.to_kv = dense(dim, 2 * inner, bias=False)
        self.to_out = dense(inner, dim)
        self.rel_height = nn.Parameter(torch.randn(2 * win - 1, dim_head)
                                       * 0.02)
        self.rel_width = nn.Parameter(torch.randn(2 * win - 1, dim_head)
                                      * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        blk, halo, heads, dh = self.block, self.halo, self.heads, self.dim_head
        inner, win = dh * heads, blk + 2 * halo
        nb_h, nb_w = h // blk, w // blk
        n = nb_h * nb_w
        x = x.permute(0, 2, 3, 1)  # NHWC, as the JAX module computes
        q = self.to_q(x)
        kv = self.to_kv(F.pad(x, (0, 0, halo, halo, halo, halo)))
        qb = q.reshape(b, nb_h, blk, nb_w, blk, inner).permute(
            0, 1, 3, 2, 4, 5).reshape(b, n, blk * blk, inner)
        # the halo'd windows, channel-major [c, ki, kj] like
        # conv_general_dilated_patches
        kvp = F.unfold(kv.permute(0, 3, 1, 2), win, stride=blk).reshape(
            b, 2 * inner, win * win, n).permute(0, 3, 2, 1)
        kb, vb = kvp[..., :inner], kvp[..., inner:]

        def heads_split(t, m):  # (b, heads, blocks, m, dh)
            return t.reshape(b, n, m, heads, dh).permute(0, 3, 1, 2, 4)

        qh = heads_split(qb, blk * blk) * dh ** -0.5
        kh, vh = heads_split(kb, win * win), heads_split(vb, win * win)
        qr = qh.reshape(b, heads, n, blk, blk, dh)
        # the relative offset of key i to query x: i - x + win - 1
        idx = (torch.arange(win, device=x.device)[None, :]
               - torch.arange(blk, device=x.device)[:, None] + win - 1)
        full = (b, heads, n, blk, blk, win)
        with torch.autocast(x.device.type, enabled=False):
            logits = torch.matmul(wide(qh), wide(kh).transpose(-2, -1))

            def rel(table, at):  # q · table[offset], gathered per key
                e = torch.einsum("bhnxyd,rd->bhnxyr", wide(qr),
                                 wide(table.to(qr.dtype)))
                return torch.gather(e, -1, idx.view(at).expand(full))

            lh = rel(self.rel_height, (1, 1, 1, blk, 1, win))
            lw = rel(self.rel_width, (1, 1, 1, 1, blk, win))
            att = (logits.reshape(*full[:5], win, win)
                   + lh[..., :, None] + lw[..., None, :])
            att = att.reshape(b, heads, n, blk * blk, win * win)
            # the zero-padding keys of edge blocks masked out
            r = torch.arange(win, device=x.device) - halo
            row = torch.arange(nb_h, device=x.device)[:, None] * blk + r
            col = torch.arange(nb_w, device=x.device)[:, None] * blk + r
            valid = (((row >= 0) & (row < h))[:, None, :, None]
                     & ((col >= 0) & (col < w))[None, :, None, :])
            att = att.masked_fill(~valid.reshape(1, 1, n, 1, win * win),
                                  torch.finfo(torch.float32).min)
            att = torch.softmax(att, dim=-1)
        out = torch.matmul(att.to(vh.dtype), vh)
        out = out.permute(0, 2, 3, 1, 4).reshape(b, nb_h, nb_w, blk, blk,
                                                 inner)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, inner)
        return self.to_out(out).permute(0, 3, 1, 2)


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
