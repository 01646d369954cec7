"""ResNet backbone in PyTorch (port of ``endoscopy_tpu/models/resnet.py``).

The plain ResNet-v1 form (``resnet50``, ``resnet101``); SE-ResNets
(``resnet50se``, ``resnet101se``, ``resnet152se``: a squeeze-excite gate
after ``bn3`` whose two 1x1 convolutions have biases) and SE-ResNeXt-50
32x4d (``seresnext50``: the grouped ``conv2``, ``width =
int(filters · base_width / 64) · groups``); the gated ResNet-50s
(``resnet50cbam``, ``resnet50sa``: ``models/attention.py``'s CBAM or
shuffle attention after ``bn3``); and the SASA variant (``resnet50sasa``:
the 3x3 ``conv2`` of the last two stages replaced by
``models/attention.py::SASALayer``). The JAX module's conventions are
kept so weights carry across unchanged:

- the stage stride sits on the 3x3 ``conv2``; the SASA variant puts it on
  the 1x1 ``conv1`` of every block, SASA or not (the reference's
  ResNetSASA), so attention runs at the strided side;
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
what ``ckpt/convert.py`` maps the flax tree onto; a gate keeps flax's
names under the block (``layer1.0.se.fc_down``, ``layer1.0.cbam.
spatial_bn``, ``layer1.0.sa.gn``).
"""

from __future__ import annotations

from typing import Optional, Sequence

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
           padding: int = 0, bias: bool = False, groups: int = 1
           ) -> nn.Conv2d:
    """A convolution with flax's initial kernel (and zero bias); a grouped
    one's fan-in is its group's, ``k·k·in/groups``, as flax's."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     bias=bias, groups=groups)
    lecun_normal_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
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


class SEModule(nn.Module):
    """Squeeze-and-excitation: mean over the pixels → 1x1 down (C / 16) →
    ReLU → 1x1 up → sigmoid gate; both convolutions have biases."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc_down = conv2d(channels, channels // reduction, 1, bias=True)
        self.fc_up = conv2d(channels // reduction, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc_up(torch.relu(self.fc_down(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class Bottleneck(nn.Module):
    """1x1 reduce → 3x3 (stride, ``groups``) → 1x1 expand(x4) → [gate] →
    +identity → ReLU. ``stride_on_conv1`` moves the stride to the 1x1;
    ``sasa_side`` (the side the block computes at) makes ``conv2`` a SASA
    layer, which takes the stride on the 1x1 too. The gate is SE
    (``use_se``) or ``attn`` ('cbam' or 'sa': the shuffle attention's
    groups clamped to ``min(64, C / 4)`` for narrow models)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 stride_on_conv1: bool = False,
                 sasa_side: Optional[int] = None, use_se: bool = False,
                 groups: int = 1, base_width: int = 64,
                 attn: Optional[str] = None):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out_ch = filters * self.expansion
        first = stride_on_conv1 or sasa_side is not None
        self.conv1 = conv2d(in_ch, width, 1, stride=stride if first else 1)
        self.bn1 = _bn(width)
        if sasa_side is None:
            self.conv2 = conv2d(width, width, 3,
                                stride=1 if first else stride, padding=1,
                                groups=groups)
        else:  # named conv2 as the reference's, so .pth keys carry over
            from endoscopy_tpu_torch.models.attention import SASALayer
            self.conv2 = SASALayer(width, side=sasa_side)
        self.bn2 = _bn(width)
        self.conv3 = conv2d(width, out_ch, 1)
        self.bn3 = _bn(out_ch)
        # the gate's attribute name, flax's module name
        self.gate = "se" if use_se else attn
        if use_se:
            self.se = SEModule(out_ch)
        elif attn == "cbam":
            from endoscopy_tpu_torch.models.attention import CBAM
            self.cbam = CBAM(out_ch)
        elif attn == "sa":
            from endoscopy_tpu_torch.models.attention import ShuffleAttention
            self.sa = ShuffleAttention(out_ch, groups=min(64, out_ch // 4))
        elif attn is not None:
            raise ValueError(f"unknown ResNet gate {attn!r}")
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
        if self.gate is not None:
            y = getattr(self, self.gate)(y)
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """ResNet backbone producing pooled float32 ``(B, C)`` features;
    ``stage_sizes=(3, 4, 6, 3)`` is ResNet-50. ``use_se``, ``groups``,
    ``base_width`` and ``attn`` are :class:`Bottleneck`'s, for every block.
    ``sasa_stages`` (0-based) get SASA layers sized for ``img_size`` px
    inputs: their relative encodings' window is ``min(7, side)``, as flax
    fixes it at init."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_filters: int = 64, sasa_stages: Sequence[int] = (),
                 img_size: int = 224, use_se: bool = False, groups: int = 1,
                 base_width: int = 64, attn: Optional[str] = None):
        super().__init__()
        self.stage_sizes = tuple(int(s) for s in stage_sizes)
        self.conv1 = conv2d(3, num_filters, 7, stride=2, padding=3)
        self.bn1 = _bn(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = num_filters
        side = -(-int(img_size) // 4)  # after the stem's two halvings
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = num_filters * (2 ** stage)
            if stage > 0:
                side = -(-side // 2)
            sasa_side = side if stage in tuple(sasa_stages) else None
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(in_ch, filters, stride,
                                         stride_on_conv1=bool(sasa_stages),
                                         sasa_side=sasa_side, use_se=use_se,
                                         groups=groups, base_width=base_width,
                                         attn=attn))
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


def resnet101() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3))


def resnet50se() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), use_se=True)


def resnet101se() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), use_se=True)


def resnet152se() -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), use_se=True)


def seresnext50() -> ResNet:
    """SE-ResNeXt-50 32x4d."""
    return ResNet(stage_sizes=(3, 4, 6, 3), use_se=True, groups=32,
                  base_width=4)


def resnet50cbam() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), attn="cbam")


def resnet50sa() -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), attn="sa")


def resnet50sasa(img_size: int = 224) -> ResNet:
    """ResNet-50 with SASA in place of the 3x3 convolutions of the last two
    stages, for ``img_size`` px inputs."""
    return ResNet(stage_sizes=(3, 4, 6, 3), sasa_stages=(2, 3),
                  img_size=img_size)


def resnet_tiny() -> ResNet:
    """4-block, 8-filter ResNet for tests — not in the reference."""
    return ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8)
