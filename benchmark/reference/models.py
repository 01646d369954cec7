"""Plain float32 PyTorch models for the check that decides ``correct``.

ResNet-50 (He et al., arXiv:1512.03385; v1 with the stride on the 3x3, a
downsample wherever the channels or the stride change) under a linear
head, and Conformer-Ti (Peng et al., arXiv:2105.03889: patch 16, embed
384, depth 12, 6 heads, MLP ratio 4, a conv head and a trans head). They
are written from the papers' equations in plain ``torch`` and import
nothing of the port; their parameter names are the port's state-dict
names, so the benchmark's seeded weights load into both by name.

Numerics: BN eps 1e-5 (ResNet) and 1e-6 (Conformer, its LN too), exact
GELU, attention ``softmax(q kᵀ · d^-1/2) v``, nearest upsampling in the
Conformer's FCU-up. ``set_fp8(model, True)`` trains as float8 training does: the operands of
every convolution, dense layer and attention product rounded to float8
e4m3 and the gradient arriving at its output to e5m2, each with a
per-tensor scale (the products still sum in float32): the precision one
step below the configuration's bf16, which the benchmark's control runs.
``ConformerRef(checkpoint=True)`` recomputes each coupled block in the
backward, so that a float32 step over 416 images fits beside nothing
else on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0  # the largest float8 e4m3 value
E5M2_MAX = 57344.0  # the largest float8 e5m2 value


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _RoundFP8(torch.autograd.Function):
    """e4m3 rounding of an operand; its gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return _round(t.detach(), torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundGradFP8(torch.autograd.Function):
    """The identity; e5m2 rounding of the gradient that arrives."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(t)


def fp8_grad(t: torch.Tensor) -> torch.Tensor:
    return _RoundGradFP8.apply(t)


class Conv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return fp8_grad(self._conv_forward(fp8(x), fp8(self.weight),
                                               self.bias))
        return super().forward(x)


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return fp8_grad(F.linear(fp8(x), fp8(self.weight), self.bias))
        return super().forward(x)


def set_fp8(model: nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear, Attention)):
            m.fp8 = on


# -- ResNet-50 ------------------------------------------------------------


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters, eps=1e-5)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters, eps=1e-5)
        self.conv3 = Conv2d(filters, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride, bias=False),
                nn.BatchNorm2d(out, eps=1e-5))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, stage_sizes=(3, 4, 6, 3), num_filters: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, num_filters, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(num_filters, eps=1e-5)
        cin = num_filters
        for stage, blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            layers = []
            for i in range(blocks):
                layers.append(Bottleneck(cin, filters,
                                         2 if stage > 0 and i == 0 else 1))
                cin = filters * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))
        self.stages = len(stage_sizes)
        self.num_features = cin

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in range(self.stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))


class _Head(nn.Module):
    def __init__(self, cin: int, classes: int):
        super().__init__()
        self.fc = Linear(cin, classes)

    def forward(self, x):
        return self.fc(x)


class ResNetClassifier(nn.Module):
    """backbone → pooled features → linear head → logits."""

    def __init__(self, classes: int, stage_sizes=(3, 4, 6, 3),
                 num_filters: int = 64):
        super().__init__()
        self.backbone = ResNet(stage_sizes, num_filters)
        self.head = _Head(self.backbone.num_features, classes)

    def forward(self, x):
        return self.head(self.backbone(x))


# -- Conformer --------------------------------------------------------------

EPS = 1e-6


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    fp8 = False

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads,
                                   c // self.heads).permute(2, 0, 3, 1, 4)
        if self.fp8:
            q, k, v = fp8(q), fp8(k), fp8(v)
        logits = q @ k.transpose(-2, -1)
        if self.fp8:
            logits = fp8_grad(logits)
        a = torch.softmax(logits * (c // self.heads) ** -0.5, dim=-1)
        out = fp8(a) @ v if self.fp8 else a @ v
        if self.fp8:
            out = fp8_grad(out)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class TransBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 res_conv: bool = False):
        super().__init__()
        med = cout // 4
        self.conv1 = Conv2d(cin, med, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(med, eps=EPS)
        self.conv2 = Conv2d(med, med, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(med, eps=EPS)
        self.conv3 = Conv2d(med, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout, eps=EPS)
        self.res_conv = res_conv
        if res_conv:
            self.residual_conv = Conv2d(cin, cout, 1, stride, bias=False)
            self.residual_bn = nn.BatchNorm2d(cout, eps=EPS)

    def forward(self, x, x_t=None):
        y = F.relu(self.bn1(self.conv1(x)))
        if x_t is not None:
            y = y + x_t
        x2 = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(x2))
        res = self.residual_bn(self.residual_conv(x)) if self.res_conv else x
        return F.relu(y + res), x2


class FCUDown(nn.Module):
    def __init__(self, cin: int, dim: int, stride: int):
        super().__init__()
        self.conv_project = Conv2d(cin, dim, 1)
        self.ln = nn.LayerNorm(dim, eps=EPS)
        self.stride = stride

    def forward(self, x, x_t):
        y = self.conv_project(x)
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = F.gelu(self.ln(y.flatten(2).transpose(1, 2)))
        return torch.cat([x_t[:, :1], y], dim=1)


class FCUUp(nn.Module):
    def __init__(self, dim: int, cout: int, stride: int):
        super().__init__()
        self.conv_project = Conv2d(dim, cout, 1)
        self.bn = nn.BatchNorm2d(cout, eps=EPS)
        self.stride = stride

    def forward(self, x_t, h: int, w: int):
        b, _, c = x_t.shape
        y = x_t[:, 1:].transpose(1, 2).reshape(b, c, h, w)
        y = F.relu(self.bn(self.conv_project(y)))
        if self.stride > 1:
            y = F.interpolate(y, scale_factor=self.stride, mode="nearest")
        return y


class ConvTransBlock(nn.Module):
    def __init__(self, cin, cout, res_conv, stride, dw, dim, heads,
                 mlp_ratio, last_fusion):
        super().__init__()
        self.cnn_block = ConvBlock(cin, cout, stride, res_conv)
        self.squeeze_block = FCUDown(cout // 4, dim, dw)
        self.trans_block = TransBlock(dim, heads, mlp_ratio)
        self.expand_block = FCUUp(dim, cout // 4, dw)
        self.fusion_block = ConvBlock(cout, cout, 2 if last_fusion else 1,
                                      res_conv=last_fusion)
        self.dw = dw

    def forward(self, x, x_t):
        x, x2 = self.cnn_block(x)
        h, w = x2.shape[2:]
        x_t = self.trans_block(self.squeeze_block(x2, x_t) + x_t)
        x, _ = self.fusion_block(
            x, self.expand_block(x_t, h // self.dw, w // self.dw))
        return x, x_t


class ConformerRef(nn.Module):
    """``(conv logits, trans logits)``."""

    def __init__(self, classes: int, patch: int = 16, base: int = 64,
                 channel_ratio: int = 1, dim: int = 384, depth: int = 12,
                 heads: int = 6, mlp_ratio: float = 4.0,
                 checkpoint: bool = False):
        super().__init__()
        self.depth, self.checkpoint = depth, checkpoint
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=EPS)
        stage1 = base * channel_ratio
        dw = patch // 4
        self.conv_1 = ConvBlock(64, stage1, 1, res_conv=True)
        self.trans_patch_conv = Conv2d(64, dim, dw, dw)
        self.trans_1 = TransBlock(dim, heads, mlp_ratio)
        third, cin = depth // 3, stage1
        for i in range(2, depth + 1):
            if i <= third:
                cout, stride, res, dwi = stage1, 1, False, dw
            else:
                stage = 2 if i <= 2 * third else 3
                first = i == (stage - 1) * third + 1
                cout = stage1 * 2 ** (stage - 1)
                stride, res = (2 if first else 1), first
                dwi = dw // 2 ** (stage - 1)
            self.add_module(f"conv_trans_{i}", ConvTransBlock(
                cin, cout, res, stride, dwi, dim, heads, mlp_ratio,
                last_fusion=i == depth))
            cin = cout
        self.conv_cls_head = Linear(cin, classes)
        self.trans_norm = nn.LayerNorm(dim, eps=EPS)
        self.trans_cls_head = Linear(dim, classes)

    def forward(self, x):
        base = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        xc, _ = self.conv_1(base)
        xt = self.trans_patch_conv(base).flatten(2).transpose(1, 2)
        xt = self.trans_1(torch.cat(
            [self.cls_token.expand(x.shape[0], -1, -1), xt], dim=1))
        for i in range(2, self.depth + 1):
            block = getattr(self, f"conv_trans_{i}")
            if self.checkpoint and torch.is_grad_enabled():
                xc, xt = checkpoint(block, xc, xt, use_reentrant=False)
            else:
                xc, xt = block(xc, xt)
        return (self.conv_cls_head(xc.mean(dim=(2, 3))),
                self.trans_cls_head(self.trans_norm(xt[:, 0])))


def build(name: str, classes: int, **kw) -> nn.Module:
    """``resnet50``, ``resnet_tiny`` (1, 1, 1, 1 blocks of 8 filters, for
    the CPU tests), ``conformer_tiny``, or ``conformer`` with the sizes
    in ``kw``."""
    if name == "resnet50":
        return ResNetClassifier(classes)
    if name == "resnet_tiny":
        return ResNetClassifier(classes, (1, 1, 1, 1), 8)
    if name == "conformer_tiny":
        return ConformerRef(classes, **kw)
    if name == "conformer":
        return ConformerRef(classes, **kw)
    raise ValueError(f"no reference model {name!r}")
