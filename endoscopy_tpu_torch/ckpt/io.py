"""Checkpoints with the resume contract of ``endoscopy_tpu/ckpt/orbax_io.py``.

Layout: ``<save_dir>/<name>/`` (``name`` is ``epoch_<N>``) holds
``state.pt``, the trainer's ``TrainState.state_dict()`` written with
``torch.save``, and ``meta.json`` (``epoch``, ``best_valid_perf``,
``trainer``, ``img_size``). ``state.pt`` marks a complete checkpoint.

Durability: each file is written under a temporary name, flushed to disk
and moved into place with ``os.replace``, so a crash leaves either the old
file or the new one, never a torn one, and a re-save at the same epoch
(a resume restarts at the saved epoch) never removes the old state before
the new one is durable. ``meta.json`` goes first and ``state.pt`` last:
a directory with ``meta.json`` and no ``state.pt`` is a save that did not
finish, and :func:`latest_checkpoint` skips it.

Saves are synchronous (the caller's tensors are written before the call
returns); restores read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from endoscopy_tpu_torch.device import resolve_device

STATE, META = "state.pt", "meta.json"


def _durable_replace(path: str, write) -> None:
    """``write(file)`` into ``path + '.tmp'``, fsync, then rename over
    ``path``."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(save_dir: str, name: str, state: Dict,
                    metadata: Dict) -> str:
    """Write ``state`` (a state dict of tensors) and ``metadata`` to
    ``<save_dir>/<name>/``; returns that directory's absolute path."""
    path = os.path.abspath(os.path.join(save_dir, name))
    os.makedirs(path, exist_ok=True)
    _durable_replace(os.path.join(path, META),
                     lambda f: f.write(json.dumps(metadata).encode()))
    _durable_replace(os.path.join(path, STATE),
                     lambda f: torch.save(state, f))
    return path


def restore_checkpoint(path: str, device=None) -> Tuple[Dict, Dict]:
    """``(state, metadata)`` of a checkpoint directory, the tensors on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    state_file = os.path.join(path, STATE)
    if not os.path.isfile(state_file):
        raise FileNotFoundError(
            f"checkpoint '{path}' has no {STATE} (a save that did not "
            "finish?); use latest_checkpoint() to find a complete one")
    state = torch.load(state_file, map_location=dev, weights_only=True)
    metadata = {}
    meta_file = os.path.join(path, META)
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            metadata = json.load(f)
    return state, metadata


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The highest complete ``epoch_<N>`` directory under ``save_dir``, or
    None."""
    if not os.path.isdir(save_dir):
        return None
    best, best_n = None, -1
    for d in os.listdir(save_dir):
        m = re.fullmatch(r"epoch_(\d+)", d)
        if (m and int(m.group(1)) > best_n
                and os.path.isfile(os.path.join(save_dir, d, STATE))):
            best, best_n = os.path.join(save_dir, d), int(m.group(1))
    return best
