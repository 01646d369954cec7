"""FixMatch consistency loss (port of ``endoscopy_tpu/losses/consistency.py``).

Pseudo-labels come from the weak view's softmax, detached; the confidence
mask is ``max_prob >= p_cutoff`` as a float; the strong view is trained
with the masked CE on the argmax pseudo-label, averaged over *all*
unlabeled rows; with ``margin_loss_fn`` (the angular-margin path) the
strong "logits" are backbone features, and ``margin_loss_fn(features,
pseudo_label, mask)`` is the loss. Returns ``(loss, mask_mean)``; inside a
process group, this rank's shares of both
(``parallel/sharding.py::batch_mean``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.losses.classification import ce_loss, soft_ce_loss
from endoscopy_tpu_torch.parallel.sharding import batch_mean


def consistency_loss(logits_w: torch.Tensor, logits_s: torch.Tensor,
                     name: str = "ce", T: float = 1.0, p_cutoff: float = 0.0,
                     use_hard_labels: bool = True,
                     margin_loss_fn: Optional[Callable] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked consistency loss between the weak and the strong view; with
    ``use_hard_labels=False`` the target is ``softmax(logits_w / T)``."""
    if name not in ("ce", "L2"):
        raise ValueError(f"unknown consistency loss {name!r}")
    logits_w = logits_w.detach()
    if margin_loss_fn is not None:
        max_probs, max_idx = F.softmax(logits_w, dim=-1).max(dim=-1)
        mask = (max_probs >= p_cutoff).to(logits_w.dtype)
        return margin_loss_fn(logits_s, max_idx, mask), batch_mean(mask)
    if name == "L2":
        return batch_mean((logits_s - logits_w) ** 2), logits_w.new_ones(())

    max_probs, max_idx = F.softmax(logits_w, dim=-1).max(dim=-1)
    mask = (max_probs >= p_cutoff).to(logits_w.dtype)
    if use_hard_labels:
        masked = ce_loss(logits_s, max_idx, use_hard_labels=True,
                         reduction="none") * mask
    else:
        sharpened = F.softmax(logits_w / T, dim=-1)
        masked = soft_ce_loss(logits_s, sharpened) * mask
    return batch_mean(masked), batch_mean(mask)
