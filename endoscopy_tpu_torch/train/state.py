"""Carried training state (port of ``endoscopy_tpu/train/state.py``).

A plain container. The flax ``TrainState`` carries parameters, BN
statistics, optimizer state and the EMA trees through each jitted step;
here the model module holds parameters and BN statistics, the optimizer
its own state, and the step count is the number of optimizer updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[nn.Module] = None
