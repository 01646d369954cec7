"""Angular-penalty softmax losses: arcface / sphereface / cosface / acloss
(port of ``endoscopy_tpu/losses/margin.py``).

As in the reference:

- the input features are L2-normalized, but the fc weights enter the dot
  product unnormalized (the reference's normalization loop rebinds a local
  and writes nothing back); ``normalize_weights=True`` is the
  mathematically-correct variant;
- the fc is bias-free (``models/registry.py``'s margin head);
- per-sample class weights index ``cls_weight[target]``; an optional mask
  multiplies L before the negative mean.

Inside a process group the negative mean is this rank's share of the
global batch's (``parallel/sharding.py::batch_mean``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.parallel.sharding import batch_mean

_DEFAULTS = {
    # loss_type: (s, m)
    "arcface": (30.0, 0.3),
    "sphereface": (30.0, 1.35),
    "cosface": (30.0, 0.4),
    "acloss": (30.0, 0.3),
}


def g_theta(arccos: torch.Tensor, k: float = 0.3) -> torch.Tensor:
    """The sigmoid-shaped angular function of 'acloss'."""
    sigmoid1 = ((1 + math.exp(-math.pi / 2.0 / k))
                / (1 - math.exp(-math.pi / 2.0 / k)))
    e = torch.exp(arccos / k - math.pi / 2.0 / k)
    return sigmoid1 * ((1 - e) / (1 + e))


def angular_penalty_loss(features: torch.Tensor, targets: torch.Tensor,
                         fc_weight: torch.Tensor, loss_type: str = "arcface",
                         s: Optional[float] = None, m: Optional[float] = None,
                         eps: float = 1e-7,
                         cls_weight: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         normalize_weights: bool = False) -> torch.Tensor:
    """Angular-penalty softmax loss on backbone features.

    ``features`` (B, D); ``fc_weight`` (C, D), torch's ``Linear.weight``
    (the transpose of flax's kernel).
    """
    if loss_type not in _DEFAULTS:
        raise ValueError(f"unknown margin loss '{loss_type}'")
    s_def, m_def = _DEFAULTS[loss_type]
    s = s_def if s is None else s
    m = m_def if m is None else m

    x = features / torch.linalg.vector_norm(features, dim=1, keepdim=True)
    weight = fc_weight
    if normalize_weights:
        weight = weight / torch.linalg.vector_norm(weight, dim=1,
                                                   keepdim=True)
    logits = x @ weight.t()  # (B, C) cosine-like scores

    t = targets.long()
    target_logit = logits.gather(-1, t[:, None])[:, 0]
    clamped = torch.clamp(target_logit, -1.0 + eps, 1.0 - eps)

    if loss_type == "cosface":
        numerator = s * (target_logit - m)
    elif loss_type == "arcface":
        numerator = s * torch.cos(torch.arccos(clamped) + m)
    elif loss_type == "sphereface":
        numerator = s * torch.cos(m * torch.arccos(clamped))
    else:  # acloss
        numerator = s * g_theta(torch.arccos(clamped) + m)

    # the denominator sums exp(s * logit_j) over j != target
    onehot = F.one_hot(t, logits.shape[-1]).bool()
    excl = torch.where(onehot, torch.full_like(logits, -torch.inf),
                       s * logits)
    denominator = torch.exp(numerator) + torch.sum(torch.exp(excl), dim=-1)

    L = numerator - torch.log(denominator)
    if cls_weight is not None:
        L = cls_weight[t] * L
    if mask is not None:
        L = L * mask
    return -batch_mean(L)
