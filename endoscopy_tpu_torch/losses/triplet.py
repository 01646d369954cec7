"""Triplet embedding loss (port of ``endoscopy_tpu/losses/triplet.py``).

Inside a process group the means are this rank's shares of the global
batch's (``parallel/sharding.py::batch_mean``)."""

from __future__ import annotations

from typing import Tuple

import torch

from endoscopy_tpu_torch.parallel.sharding import batch_mean


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, alpha: float = 0.7,
                 average_loss: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``max(||a - p|| - ||a - n|| + alpha, 0)`` with L2 norms over the
    feature axis; returns ``(loss, mean ||a - p||, mean ||a - n||)``."""
    d_p = torch.linalg.vector_norm(anchor - positive, dim=1)
    d_n = torch.linalg.vector_norm(anchor - negative, dim=1)
    losses = torch.clamp_min(d_p - d_n + alpha, 0.0)
    loss = batch_mean(losses) if average_loss else losses.sum()
    return loss, batch_mean(d_p), batch_mean(d_n)
