"""ResNet backbone in PyTorch (port of ``endoscopy_tpu/models/resnet.py``).

The plain ResNet-v1 form only (no SE, attention or SASA variants yet). The
JAX module's conventions are kept so weights carry across unchanged:

- the stage stride sits on the 3x3 ``conv2``;
- a downsample (1x1 conv with the stride, then BN) is built whenever the
  channels or the stride change, ``layer1.0`` included;
- the stem max-pool pads by 1;
- flax BN ``momentum=0.9`` is torch ``momentum=0.1``, ``eps=1e-5``, and
  the train-mode running variance follows the biased batch variance, as
  flax's does (:func:`_flax_running_var`, for 2-D and 1-D BN alike);
- fresh weights are drawn as flax draws them: every convolution and dense
  kernel from ``lecun_normal`` (a normal truncated at two standard
  deviations, scaled to variance 1 / fan_in), biases zero, BN scale 1 and
  offset 0 (:func:`conv2d`, :func:`dense`, which the heads use too);
- the pooled features come back in float32.

Torch is NCHW; on the card the caller moves the model and its input to
``channels_last``, the layout the JAX package (NHWC) computes in.
State-dict keys follow torchvision (``layer1.0.downsample.0``), which is
what ``ckpt/convert.py`` maps the flax tree onto.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# the standard deviation of a standard normal truncated to [-2, 2], which
# flax's truncated ``variance_scaling`` divides by
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's ``lecun_normal`` in place, for torch's ``(out, in, ...)``
    layouts: fan_in is one output's element count, the draw a normal of
    std ``sqrt(1 / fan_in) / 0.8796`` truncated at two of its std."""
    std = (1.0 / weight[0].numel()) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
           padding: int = 0) -> nn.Conv2d:
    """A bias-free convolution with flax's initial kernel."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     bias=False)
    lecun_normal_(conv.weight)
    return conv


def dense(in_features: int, out_features: int, bias: bool = True
          ) -> nn.Linear:
    """``nn.Linear`` with flax ``nn.Dense``'s initial kernel and zero bias."""
    fc = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(fc.weight)
    if bias:
        nn.init.zeros_(fc.bias)
    return fc


class _NotesCount:
    """A BN that notes, in train mode, its input's count per channel (``n =
    N·H·W``, or ``N`` for 1-D), for :func:`_flax_running_var`."""

    count = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.count = x.numel() // x.shape[1]
        return super().forward(x)


class BatchNorm2d(_NotesCount, nn.BatchNorm2d):
    pass


class BatchNorm1d(_NotesCount, nn.BatchNorm1d):
    pass


def _flax_running_var(model: nn.Module, forward, x: torch.Tensor):
    """``forward(x)`` with the running variance of every train-mode BN of
    ``model`` (2-D or 1-D) moved as flax moves it.

    flax moves ``var`` toward the *biased* batch variance, torch toward the
    unbiased one (a factor n / (n - 1)). torch's fused BN runs as it is;
    one multi-tensor pass before it keeps ``(1 - m) rv_old`` of every BN,
    one after it writes ``rv = rv_new + (end - rv_new) / n``, flax's
    value. The second pass writes through ``.data``: autograd saved the
    buffers for the backward, which in train mode does not read them.
    """
    bns = [m for m in model.modules() if isinstance(m, _NotesCount)
           and m.training and m.track_running_stats]
    if not bns:
        return forward(x)
    ends = torch._foreach_mul([bn.running_var for bn in bns],
                              [1.0 - bn.momentum for bn in bns])
    y = forward(x)
    torch._foreach_lerp_([bn.running_var.data for bn in bns], ends,
                         [1.0 / bn.count for bn in bns])
    return y


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 reduce → 3x3 (stride) → 1x1 expand(x4) → +identity → ReLU."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = conv2d(in_ch, filters, 1)
        self.bn1 = _bn(filters)
        self.conv2 = conv2d(filters, filters, 3, stride=stride, padding=1)
        self.bn2 = _bn(filters)
        self.conv3 = conv2d(filters, out_ch, 1)
        self.bn3 = _bn(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                conv2d(in_ch, out_ch, 1, stride=stride),
                _bn(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """ResNet backbone producing pooled float32 ``(B, C)`` features;
    ``stage_sizes=(3, 4, 6, 3)`` is ResNet-50."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_filters: int = 64):
        super().__init__()
        self.stage_sizes = tuple(int(s) for s in stage_sizes)
        self.conv1 = conv2d(3, num_filters, 7, stride=2, padding=3)
        self.bn1 = _bn(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = num_filters
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = num_filters * (2 ** stage)
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(in_ch, filters, stride))
                in_ch = filters * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_features = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return _flax_running_var(self, self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3)).float()


def resnet50() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3))


def resnet_tiny() -> ResNet:
    """4-block, 8-filter ResNet for tests — not in the reference."""
    return ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8)
