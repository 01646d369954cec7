"""Device and dtype resolution for the port's entry points.

The default device is ``cuda``. The CPU is used only when the caller asks
for it (``device="cpu"``, ``--device cpu``); without a card and without
that explicit choice an entry point raises instead of silently running on
the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default, ``cpu`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(device: torch.device, requested: str = "bfloat16"
                  ) -> torch.dtype:
    """Compute dtype: the config's (bf16 autocast by default) on CUDA,
    always float32 on the CPU."""
    if device.type == "cpu":
        return torch.float32
    if requested not in ("bfloat16", "float32"):
        raise ValueError(f"unknown dtype {requested!r}")
    return torch.bfloat16 if requested == "bfloat16" else torch.float32
