"""EMA teacher (port of ``endoscopy_tpu/ssl_state/ema.py``).

``ema = decay * ema + (1 - decay) * model`` over the parameters *and* the
floating-point buffers (the BN running statistics), as the reference sweeps
its whole state dict. torch's integer ``num_batches_tracked`` is skipped:
the flax tree has no such leaf. The update is two multi-tensor passes.
"""

from __future__ import annotations

import copy
from typing import List

import torch
from torch import nn


def ema_tensors(module: nn.Module) -> List[torch.Tensor]:
    """The tensors the EMA covers, in a fixed order: parameters, then the
    floating-point buffers."""
    return ([p for p in module.parameters()]
            + [b for b in module.buffers() if b.is_floating_point()])


def ema_init(model: nn.Module) -> nn.Module:
    """A detached deep copy of ``model``."""
    ema = copy.deepcopy(model)
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """In place: ``ema = decay * ema + (1 - decay) * model``."""
    dst, src = ema_tensors(ema), ema_tensors(model)
    torch._foreach_mul_(dst, decay)
    torch._foreach_add_(dst, src, alpha=1.0 - decay)
