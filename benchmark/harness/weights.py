"""Seeded weights, drawn on the device in one call, by parameter name.

The names and shapes are the reference model's (the port's state-dict
names). One ``torch.randn`` of every drawn element, sliced and scaled:

- a convolution's kernel: normal, std ``sqrt(2 / fan_out)`` ("he") or
  ``sqrt(1 / fan_in)`` ("lecun");
- a dense kernel: normal, std ``dense_std`` or "lecun";
- ``cls_token``: normal, std 0.02;
- BN and LN scales 1, biases and offsets 0;
- ``residual_bn_scale`` on every ``.bn3.weight`` (each residual branch's
  last BN), and ``head_scale`` on the kernels named in ``heads``: a random
  network at scale 1 is chaotic, where float32 rounding alone moves a
  step by percents, and the check compares two precisions.
"""

from __future__ import annotations

import torch
from torch import nn


def _std(name: str, p: torch.Tensor, init: dict) -> float:
    if name.endswith("cls_token"):
        return 0.02
    if p.ndim == 4:
        if init["conv"] == "he":
            return (2.0 / (p.shape[0] * p.shape[2] * p.shape[3])) ** 0.5
        return (1.0 / p[0].numel()) ** 0.5
    dense = init["dense_std"]
    return (1.0 / p.shape[1]) ** 0.5 if dense == "lecun" else float(dense)


def draw(model: nn.Module, init: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for every parameter of ``model``, on ``device``."""
    params = list(model.named_parameters())
    drawn = [(n, p) for n, p in params
             if p.ndim > 1 or n.endswith("cls_token")]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(p.numel() for _, p in drawn), generator=g,
                       device=device)
    out, at = {}, 0
    heads = set(init.get("heads", ()))
    for name, p in drawn:
        t = flat[at:at + p.numel()].view(p.shape) * _std(name, p, init)
        if name in heads:
            t = t * float(init.get("head_scale", 1.0))
        out[name] = t
        at += p.numel()
    for name, p in params:
        if name in out:
            continue
        if name.endswith(".weight"):  # a BN or LN scale
            scale = (init.get("residual_bn_scale", 1.0)
                     if name.endswith(".bn3.weight") else 1.0)
            out[name] = torch.full(p.shape, float(scale), device=device)
        else:
            out[name] = torch.zeros(p.shape, device=device)
    return out


@torch.no_grad()
def load(model: nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters by name; raises unless
    the names and shapes are exactly the model's."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"weights and model differ: {sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if p.shape != weights[name].shape:
            raise ValueError(f"{name}: {tuple(p.shape)} vs "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
