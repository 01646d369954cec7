"""Cross-entropy-family losses (port of ``endoscopy_tpu/losses/classification.py``).

The subset the FixMatch and supervised steps need: ``cross_entropy`` with
torch's *weighted-mean* convention (sum of weighted per-sample losses over
the sum of the selected weights), ``soft_ce_loss``, ``poly_loss`` and the
``ce_loss`` dispatcher, plus the host-side class weights
(``balanced_class_weights``, and ``rdw_weights`` with its
``effective_number_weights`` for ``TRAIN_RULE: 'RDW'``). The focal and
LDAM branches raise until their slice (ROADMAP.md).

Inside a process group a mean over the batch is this rank's share of the
global batch's mean (``parallel/sharding.py::batch_mean``): its rows' sum
over the global count, or for the weighted mean over the global sum of the
selected weights (constant: no gradient flows through it). The ranks'
shares add up to the 1-process mean over the global batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.parallel.sharding import all_reduce_sum, batch_mean


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to endoscopy_tpu_torch yet; see the port "
        "queue in ROADMAP.md")


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


def ce_loss(logits: torch.Tensor, targets: torch.Tensor,
            class_weights: Optional[torch.Tensor] = None,
            use_hard_labels: bool = True, reduction: str = "none",
            type_loss: str = "none", cls_num_list=None) -> torch.Tensor:
    """Dispatcher: 'none' (weighted CE) or 'poly' (eps = 2); with
    ``use_hard_labels=False`` the targets are probability rows and the
    per-sample soft CE is returned (``reduction`` ignored)."""
    if not use_hard_labels:
        return soft_ce_loss(logits, targets)
    if type_loss == "focal":
        raise _not_ported("the focal loss")
    if type_loss == "poly":
        return poly_loss(logits, targets, epsilon=2.0,
                         ce_weight=class_weights, reduction=reduction)
    if type_loss == "ldam" and cls_num_list is not None:
        raise _not_ported("the LDAM loss (losses/margin.py)")
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
