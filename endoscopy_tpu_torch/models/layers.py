"""Numerics shared by the port's transformer-style models.

Where the flax modules compute in float32 while the model runs in bf16,
the port computes in float32, or in float64 for a model cast to float64
(the precision reference of the card checks):

- :func:`norm32`: ``nn.LayerNorm(dtype=float32)``, its output cast back to
  the dtype of its input (the compute dtype: bf16 under the card's
  autocast);
- :func:`attention`: ``q·kᵀ`` in float32 with autocast off (the product of
  the bf16 values, summed in float32, as ``preferred_element_type``
  does), the logits adjusted there (the scale after the product, a bias,
  a mask), the softmax in float32, and the probabilities cast to ``v``'s
  dtype before the product with ``v``;
- :func:`truncated_normal`: flax's ``truncated_normal(std)``, a standard
  normal truncated at ±2, times ``std``.

None of this becomes ``scaled_dot_product_attention``: it does not keep
the float32 logits, the bias and the mask in the order the JAX code adds
them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 if it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def norm32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``, cast back to ``x``'s dtype."""
    return F.layer_norm(wide(x), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logits: Callable[[torch.Tensor], torch.Tensor] = lambda a: a
              ) -> torch.Tensor:
    """``softmax(logits(q·kᵀ)) · v`` over the last two axes, with the
    float32 logits and softmax of the flax modules."""
    with torch.autocast(q.device.type, enabled=False):
        a = logits(torch.matmul(wide(q), wide(k).transpose(-2, -1)))
        a = torch.softmax(a, dim=-1)
    return torch.matmul(a.to(v.dtype), v)


def truncated_normal(shape, std: float) -> torch.Tensor:
    """A draw of flax's ``truncated_normal(std)``."""
    t = torch.empty(shape)
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0)
    return t.mul_(std)
