"""Carried training state (port of ``endoscopy_tpu/train/state.py``).

A plain container. The flax ``TrainState`` carries parameters, BN
statistics, optimizer state and the EMA trees through each jitted step;
here the model module holds parameters and BN statistics, the optimizer
its own state, and the step count is the number of optimizer updates.

:meth:`TrainState.state_dict` is what a checkpoint holds: ``step``, the
model's and the EMA's state dicts, and the optimizer's per-parameter state
keyed by parameter name (torch numbers parameters by their place in the
groups; names make a checkpoint independent of that order, and let
``ckpt/convert.py::train_state_from_npz`` write one from a JAX state).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[nn.Module] = None

    def _param_names(self):
        """The optimizer's parameters in torch's numbering, by name."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def state_dict(self) -> Dict:
        opt = self.optimizer.state_dict()
        names = self._param_names()
        return {
            "step": int(self.step),
            "model": self.model.state_dict(),
            "optimizer": {names[i]: s for i, s in opt["state"].items()},
            "ema": None if self.ema is None else self.ema.state_dict(),
        }

    def load_state_dict(self, state: Dict) -> None:
        """Copy ``state`` into the model, the EMA and the optimizer in
        place (strict: every tensor present, every shape equal)."""
        self.model.load_state_dict(state["model"], strict=True)
        if self.ema is not None:
            if state.get("ema") is None:
                raise KeyError("the checkpoint has no EMA state")
            self.ema.load_state_dict(state["ema"], strict=True)
        names = self._param_names()
        unknown = set(state["optimizer"]) - set(names)
        if unknown:
            raise KeyError(f"optimizer state for unknown parameters "
                           f"{sorted(unknown)[:4]}")
        opt = self.optimizer.state_dict()
        # torch keeps a non-capturable optimizer's step count on the host
        opt["state"] = {i: {k: v.cpu() if k == "step" else v
                            for k, v in state["optimizer"][n].items()}
                        for i, n in enumerate(names)
                        if n in state["optimizer"]}
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])
