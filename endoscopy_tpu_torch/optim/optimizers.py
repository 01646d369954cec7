"""Optimizer factory (port of ``endoscopy_tpu/optim/optimizers.py``).

``torch.optim`` with two parameter groups: weight decay on parameters with
``ndim > 1`` (conv kernels, dense matrices), none on the rest (biases, BN
scales and offsets). The constants are the reference's:

- Adam: b1 0.9, b2 0.999, eps 1e-8, no decay;
- AdamW: the same with decoupled decay 0.05;
- SGD: momentum 0.9, nesterov, decay 0.05 added to the gradient before the
  momentum (optax's ``add_decayed_weights`` ahead of ``sgd``, which is what
  torch's ``weight_decay`` does).

The learning rate is set from the schedule before every step
(:func:`set_lr`); the optimizer is built with the schedule's ``lr(0)``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn


def param_groups(named_params: Iterable[Tuple[str, nn.Parameter]],
                 weight_decay: float) -> list:
    """``[decayed (ndim > 1), not decayed]`` parameter groups."""
    decay, no_decay = [], []
    for _, p in named_params:
        (decay if p.ndim > 1 else no_decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def build_optimizer(named_params, opt_func: str = "Adam", lr: float = 1e-3
                    ) -> torch.optim.Optimizer:
    """The reference's optimizer for ``named_params`` (an iterable of
    ``(name, parameter)``, e.g. ``model.named_parameters()``)."""
    named_params = list(named_params)
    opt_lower = opt_func.lower()
    if opt_lower == "sgd":
        return torch.optim.SGD(param_groups(named_params, 0.05), lr=lr,
                               momentum=0.9, nesterov=True)
    if opt_lower == "adamw":
        return torch.optim.AdamW(param_groups(named_params, 0.05), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    if opt_lower == "adam":
        return torch.optim.Adam(param_groups(named_params, 0.0), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer '{opt_func}'")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate, for the next step."""
    for group in optimizer.param_groups:
        group["lr"] = lr
