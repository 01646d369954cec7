"""The process group (counterpart of ``endoscopy_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ('data', 'model') mesh and jits
each step over the global batch. The port runs one process per card and
joins them in the default ``torch.distributed`` group: the 'data' axis is
the group's ranks. Its 'model' axis only places the head MLPs' kernel
columns (``endoscopy_tpu/parallel/sharding.py``) and changes no number, so
the port keeps the heads replicated and says so.

A process belongs to a group once :func:`init_from_env` has formed one
(``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``), even a
group of one: then every collective is issued. Without ``WORLD_SIZE`` no
group is formed and the port runs the code it runs in one process.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from endoscopy_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place: ``rank`` of ``world`` processes, on
    ``device``."""

    rank: int
    world: int
    device: torch.device


def in_group() -> bool:
    """True once a process group is formed (a group of one included)."""
    return dist.is_available() and dist.is_initialized()


def group_rank() -> int:
    """This process's rank; 0 outside a group."""
    return dist.get_rank() if in_group() else 0


def group_size() -> int:
    """The number of processes in the group; 1 outside a group."""
    return dist.get_world_size() if in_group() else 1


def current_group(device=None) -> Group:
    """The default group's rank and size, or rank 0 of 1 outside a
    group."""
    return Group(group_rank(), group_size(), resolve_device(device))


def init_from_env(device=None) -> Group:
    """Join the group ``torchrun`` describes in the environment: NCCL on
    ``cuda:LOCAL_RANK`` (the default device), gloo on the CPU when the
    caller asks for ``device='cpu'``. Without ``WORLD_SIZE`` it forms no
    group and returns rank 0 of 1 on ``device``. There is no fallback: a
    group that cannot form raises."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return Group(0, 1, dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not in_group():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=rank, world_size=world)
    return Group(dist.get_rank(), dist.get_world_size(), dev)


def leave_group() -> None:
    """Destroy the process group, if this process joined one."""
    if in_group():
        dist.destroy_process_group()


def mesh_from_config(config, group: Group) -> Group:
    """Check the config's mesh against the group: ``TRAIN.MESH_DATA`` is -1
    (every rank) or the world size, as ``make_mesh`` refuses a mesh that
    does not fit its devices; ``MESH_MODEL`` > 1 warns that the heads stay
    replicated."""
    data = int(config.TRAIN.get("MESH_DATA", -1))
    model = int(config.TRAIN.get("MESH_MODEL", 1))
    if model < 1:
        raise ValueError(f"TRAIN.MESH_MODEL={model} must be at least 1")
    if data not in (-1, group.world):
        raise ValueError(
            f"TRAIN.MESH_DATA={data} does not fit a group of {group.world} "
            "process(es): set it to -1 or to the number of processes")
    if model > 1:
        warnings.warn(
            f"TRAIN.MESH_MODEL={model}: the port keeps the head MLPs "
            "replicated on every rank; in the JAX package that axis only "
            "places their kernels' columns and changes no number",
            stacklevel=2)
    return group
