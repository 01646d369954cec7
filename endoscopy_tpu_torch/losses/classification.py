"""Cross-entropy-family losses (port of ``endoscopy_tpu/losses/classification.py``).

``cross_entropy`` with torch's *weighted-mean* convention (sum of weighted
per-sample losses over the sum of the selected weights), ``soft_ce_loss``,
``poly_loss``, ``focal_loss``, ``ldam_loss``, ``label_smoothing_loss``,
``poly_bce_loss`` and the ``ce_loss`` dispatcher (``type_loss`` 'none',
'focal', 'poly' or 'ldam'), plus the host-side class weights
(``balanced_class_weights``, and ``rdw_weights`` with its
``effective_number_weights`` for ``TRAIN_RULE: 'RDW'``).

The focal loss keeps the reference's behaviour: its inner CE is the
*batch-mean* CE, so the focal term modulates that mean and the result is
a scalar whatever ``reduction`` says.

Inside a process group a mean over the batch is this rank's share of the
global batch's mean (``parallel/sharding.py::batch_mean``): its rows' sum
over the global count, or for the weighted mean over the global sum of the
selected weights (constant: no gradient flows through it). The ranks'
shares add up to the 1-process mean over the global batch. The focal
term, not linear in the mean, is taken of the global mean and shared out
equally.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.parallel.mesh import group_size
from endoscopy_tpu_torch.parallel.sharding import all_reduce_sum, batch_mean


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  reduction: str = "mean") -> torch.Tensor:
    """F.cross_entropy for integer targets.

    'none' -> per-sample ``w[y_i] * ce_i`` (w = 1 without ``weight``);
    'mean' -> ``sum_i w[y_i] ce_i / sum_i w[y_i]``; 'sum' -> the sum.
    """
    nll = -F.log_softmax(logits, dim=-1).gather(
        -1, targets.long()[:, None])[:, 0]
    if weight is not None:
        w = weight[targets.long()]
        nll = nll * w
    else:
        w = torch.ones_like(nll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return nll.sum() / all_reduce_sum(w.sum().detach())


def soft_ce_loss(logits: torch.Tensor, soft_targets: torch.Tensor
                 ) -> torch.Tensor:
    """Per-sample ``-sum(t * log_softmax(z))``."""
    return torch.sum(-soft_targets * F.log_softmax(logits, dim=-1), dim=-1)


def poly_loss(logits: torch.Tensor, targets: torch.Tensor,
              epsilon: float = 1.0, ce_weight: Optional[torch.Tensor] = None,
              reduction: str = "mean") -> torch.Tensor:
    """PolyLoss: ``poly_i = w[y_i] ce_i + eps (1 - p_{y_i})``.

    The inner CE is the *unnormalized* weighted per-sample CE and 'mean' is
    a plain batch mean, not the weighted-mean convention.
    """
    ce = cross_entropy(logits, targets, weight=ce_weight, reduction="none")
    pt = F.softmax(logits, dim=-1).gather(-1, targets.long()[:, None])[:, 0]
    poly = ce + epsilon * (1.0 - pt)
    if reduction == "mean":
        return batch_mean(poly)
    if reduction == "sum":
        return poly.sum()
    return poly


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 1.0,
               class_weights: Optional[torch.Tensor] = None,
               reduction: str = "none") -> torch.Tensor:
    """FocalLoss: ``(1 - p)^gamma * logp`` of the batch-mean weighted CE
    ``logp``, ``p = exp(-logp)``; a scalar whatever ``reduction`` says (the
    module docstring)."""
    logp = all_reduce_sum(cross_entropy(logits, targets,
                                        weight=class_weights,
                                        reduction="mean"))
    p = torch.exp(-logp)
    return (1.0 - p) ** gamma * logp / group_size()


def ldam_loss(logits: torch.Tensor, targets: torch.Tensor, cls_num_list,
              max_m: float = 0.5, s: float = 30.0,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LDAM: the target logit less its class's margin ``m_c ∝ n_c^(-1/4)``
    (the largest ``max_m``), then the weighted-mean CE of ``s`` times the
    logits."""
    m_list = 1.0 / np.sqrt(np.sqrt(np.asarray(cls_num_list,
                                               dtype=np.float64)))
    m_list = m_list * (max_m / np.max(m_list))
    t = targets.long()
    m = torch.as_tensor(m_list, dtype=logits.dtype, device=logits.device)[t]
    onehot = F.one_hot(t, logits.shape[-1]).to(logits.dtype)
    adjusted = logits - onehot * m[:, None]
    return cross_entropy(s * adjusted, t, weight=weight, reduction="mean")


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         epsilon: float = 0.1,
                         weight: Optional[torch.Tensor] = None,
                         reduction: str = "mean") -> torch.Tensor:
    """LabelSmoothingLoss: ``(1 - eps) * NLL + eps * smooth / C``, with
    ``smooth = -sum(log_softmax)`` per sample (reduced as ``reduction``
    says) and ``NLL`` the weighted CE under ``reduction``."""
    smooth = -torch.sum(F.log_softmax(logits, dim=-1), dim=-1)
    if reduction == "mean":
        smooth = batch_mean(smooth)
    elif reduction == "sum":
        smooth = smooth.sum()
    nll = cross_entropy(logits, targets, weight=weight, reduction=reduction)
    return (1.0 - epsilon) * nll + epsilon * smooth / logits.shape[-1]


def poly_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                  epsilon: float = 1.0, reduction: str = "mean"
                  ) -> torch.Tensor:
    """PolyBCELoss: the stable BCE with logits plus ``eps * (1 - pt)``,
    ``pt`` the sigmoid's probability of the target (``targets`` 0/1, the
    logits' shape)."""
    bce = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    p = torch.sigmoid(logits)
    pt = torch.where(targets == 1, p, 1.0 - p)
    poly = bce + epsilon * (1.0 - pt)
    if reduction == "mean":
        return batch_mean(poly)
    if reduction == "sum":
        return poly.sum()
    return poly


def ce_loss(logits: torch.Tensor, targets: torch.Tensor,
            class_weights: Optional[torch.Tensor] = None,
            use_hard_labels: bool = True, reduction: str = "none",
            type_loss: str = "none", cls_num_list=None) -> torch.Tensor:
    """Dispatcher: 'none' (weighted CE), 'focal' (gamma 1), 'poly' (eps 2)
    or 'ldam' (max_m 0.5, s 30; with ``cls_num_list``, else the weighted
    CE); with ``use_hard_labels=False`` the targets are probability rows
    and the per-sample soft CE is returned (``reduction`` ignored)."""
    if not use_hard_labels:
        return soft_ce_loss(logits, targets)
    if type_loss == "focal":
        return focal_loss(logits, targets, gamma=1.0,
                          class_weights=class_weights, reduction=reduction)
    if type_loss == "poly":
        return poly_loss(logits, targets, epsilon=2.0,
                         ce_weight=class_weights, reduction=reduction)
    if type_loss == "ldam" and cls_num_list is not None:
        return ldam_loss(logits, targets, cls_num_list, max_m=0.5, s=30.0,
                         weight=class_weights)
    return cross_entropy(logits, targets, weight=class_weights,
                         reduction=reduction)


def balanced_class_weights(targets, num_classes: Optional[int] = None
                           ) -> np.ndarray:
    """sklearn 'balanced' weights ``n / (n_classes * bincount)`` over the
    classes present; an absent class gets 0 when ``num_classes`` is given."""
    targets = np.asarray(targets, dtype=np.int64)
    classes = np.unique(targets)
    counts = np.array([(targets == c).sum() for c in classes],
                      dtype=np.float64)
    weights = len(targets) / (len(classes) * counts)
    if num_classes is None:
        return weights
    full = np.zeros(num_classes, dtype=np.float64)
    full[classes] = weights
    return full


def effective_number_weights(cls_num_list, beta: float = 0.9999
                             ) -> np.ndarray:
    """Effective-number class weights ``(1 - beta) / (1 - beta^n_c)``,
    normalized to sum to the number of classes."""
    counts = np.asarray(cls_num_list, dtype=np.float64)
    eff = 1.0 - np.power(beta, counts)
    w = (1.0 - beta) / eff
    return w / np.sum(w) * len(counts)


def rdw_weights(epoch: int, cls_num_list) -> np.ndarray:
    """Deferred re-weighting (``TRAIN_RULE: 'RDW'``): uniform weights
    (beta 0) before epoch 25, effective-number weights with beta 0.9999
    from then on."""
    betas = [0.0, 0.9999]
    idx = min(epoch // 25, 1)
    return effective_number_weights(cls_num_list, beta=betas[idx])
