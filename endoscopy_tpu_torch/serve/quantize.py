"""Weight-only int8 post-training quantization for the serving export (port
of ``endoscopy_tpu/serve/quantize.py``).

Every convolution and dense kernel becomes int8 with a float32 scale per
output channel, ``scale = max|w| / 127`` and ``q = clip(round(w / scale),
-127, 127)`` (round half to even, as ``jnp.round``); an all-zero channel
gets scale 1. Activations keep the model's dtype (W8A16): no calibration
data is needed, and the model code is untouched.

The kernels are chosen by module type (``nn.Conv2d``, ``nn.Linear``), so
``ModelwEmb``'s projection and MLP head are covered as flax's ``kernel``
leaves are. torch keeps the output channel on axis 0 (``(O, I, kh, kw)``
and ``(out, in)``; flax on the last axis), so the maximum runs over every
other axis. Everything else (biases, BN scales and offsets, running
statistics) passes through bit-identical.

A quantized entry of the state dict is ``{"int8": q, "scale": s}``, a
plain dict of tensors that ``torch.load(weights_only=True)`` reads back.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

Q, S = "int8", "scale"


def _is_qnode(node) -> bool:
    return isinstance(node, Mapping) and Q in node and S in node


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One kernel → ``{int8 q, float32 scale}``, the scale shaped ``(O, 1,
    ...)`` to broadcast against ``q``."""
    w = w.detach().float()
    axes = tuple(range(1, w.ndim))
    scale = torch.amax(w.abs(), dim=axes, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {Q: q, S: scale}


def quantize_state_dict(model: nn.Module) -> Dict[str, object]:
    """``model.state_dict()`` on the CPU with the ``weight`` of every
    ``nn.Conv2d`` and ``nn.Linear`` (``ndim >= 2``) as a q-node."""
    out: Dict[str, object] = {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.weight.ndim >= 2:
            out[f"{name}.weight"] = quantize_weight(m.weight.cpu())
    return out


def dequantize_state_dict(qsd: Mapping[str, object], dtype: torch.dtype
                          ) -> Dict[str, torch.Tensor]:
    """q-nodes → ``q.to(dtype) * scale.to(dtype)``; every other entry as
    it is."""
    return {k: (v[Q].to(dtype) * v[S].to(dtype) if _is_qnode(v) else v)
            for k, v in qsd.items()}


def quantized_fraction(qsd: Mapping[str, object], model: nn.Module) -> float:
    """Fraction of ``model``'s parameter scalars stored as int8."""
    total = quant = 0
    for name, _ in model.named_parameters():
        node = qsd[name]
        if _is_qnode(node):
            quant += node[Q].numel()
            total += node[Q].numel()
        else:
            total += node.numel()
    return quant / total if total else 0.0
