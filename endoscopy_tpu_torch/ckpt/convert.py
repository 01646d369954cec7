"""Carry weights from the JAX package's flax trees to the port.

``from_jax_params(params, batch_stats)`` takes the flax ``ClassifierHead``
trees (nested dicts of numpy arrays) and returns the port's ``state_dict``.
It keeps its own copy of the key map behind the JAX package's
``export_resnet_torch_state``:

- conv kernels go HWIO → OIHW;
- the head's dense kernel is transposed;
- BN ``scale``/``bias`` become ``weight``/``bias`` and the ``mean``/``var``
  batch statistics become running statistics.

``write_npz``/``read_npz`` store the two trees as one flat ``.npz`` (keys
like ``params/backbone/conv1/kernel``), so a dump made beside the JAX
package reaches the port without JAX.

``train_state_from_npz`` reads a whole JAX train state, as
``tools/torch_port/orbax_to_npz.py`` dumps it from an orbax checkpoint,
into the port's ``TrainState.state_dict()``: the parameters and BN
statistics, the EMA copies, optax Adam's ``mu``/``nu``/``count`` as torch
Adam's ``exp_avg``/``exp_avg_sq``/``step`` (mapped like the parameters),
and ``step``. Its keys: ``step``, ``meta`` (the checkpoint's ``meta.json``
as a string) and the trees ``params``, ``batch_stats``, ``ema_params``,
``ema_batch_stats``, ``adam/mu`` and ``adam/nu``, with ``adam/count``.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _stage_sizes(backbone: Mapping) -> Tuple[int, ...]:
    """Blocks per stage, read off the flax ``layer{s}_{b}`` names."""
    counts: Dict[int, int] = {}
    for name in backbone:
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            counts[s] = max(counts.get(s, 0), b + 1)
    return tuple(counts[s] for s in sorted(counts))


def _key_map(stage_sizes) -> Dict[str, Tuple[str, ...]]:
    """torch module prefix → flax module path, for the plain ResNet."""
    m: Dict[str, Tuple[str, ...]] = {"conv1": ("conv1",), "bn1": ("bn1",)}
    for s, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            tp, fp = f"layer{s + 1}.{b}", f"layer{s + 1}_{b}"
            for name in ("conv1", "conv2", "conv3", "bn1", "bn2", "bn3"):
                m[f"{tp}.{name}"] = (fp, name)
            m[f"{tp}.downsample.0"] = (fp, "downsample_conv")
            m[f"{tp}.downsample.1"] = (fp, "downsample_bn")
    return m


def _walk(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return node


def _port_items(params: Mapping, batch_stats: Optional[Mapping]):
    """``(port key, value)`` for a flax ``ClassifierHead``-shaped tree;
    the BN running statistics too when ``batch_stats`` is given."""
    p_bb = params["backbone"]
    b_bb = None if batch_stats is None else batch_stats.get("backbone", {})
    for tkey, path in _key_map(_stage_sizes(p_bb)).items():
        node = _walk(p_bb, path)
        if node is None:  # a block without a downsample
            continue
        if "kernel" in node:
            yield (f"backbone.{tkey}.weight",
                   np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
            continue
        yield f"backbone.{tkey}.weight", node["scale"]
        yield f"backbone.{tkey}.bias", node["bias"]
        if b_bb is not None:
            stats = _walk(b_bb, path)
            if stats is None:
                raise KeyError(f"batch_stats has no entry for {path}")
            yield f"backbone.{tkey}.running_mean", stats["mean"]
            yield f"backbone.{tkey}.running_var", stats["var"]
    fc = params["head"]["fc"]
    yield "head.fc.weight", np.asarray(fc["kernel"]).T
    yield "head.fc.bias", fc["bias"]


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, np.float32))


def from_jax_params(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """flax ``ClassifierHead`` trees → the port's ``ClassifierHead`` state."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in _port_items(params, batch_stats):
        out[key] = _tensor(value)
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return out


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, Mapping):
            _flatten(value, name, out)
        else:
            out[name] = np.asarray(value)


def write_npz(path: str, params: Mapping, batch_stats: Mapping) -> None:
    """Write the flax trees as one flat ``.npz``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(batch_stats, "batch_stats", flat)
    np.savez(path, **flat)


def _read_trees(path: str) -> Dict[str, dict]:
    """A flat ``.npz`` → ``{root: tree}``; a key without ``/`` is a leaf
    at the top."""
    trees: Dict[str, dict] = {}
    with np.load(path, allow_pickle=False) as data:
        for name in data.files:
            *keys, leaf = name.split("/")
            node = trees
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = data[name]
    return trees


def read_npz(path: str) -> Tuple[dict, dict]:
    """Read a flat ``.npz`` back into ``(params, batch_stats)`` trees."""
    trees = _read_trees(path)
    unexpected = set(trees) - {"params", "batch_stats"}
    if unexpected or "params" not in trees:
        raise ValueError(f"{path} is not a .npz of params and batch_stats "
                         f"(roots {sorted(trees)})")
    return trees["params"], trees.get("batch_stats", {})


def train_state_from_npz(path: str) -> Tuple[Dict, Dict]:
    """A JAX train state ``.npz`` → ``(TrainState.state_dict(), meta)``."""
    trees = _read_trees(path)
    missing = {"step", "meta", "params", "batch_stats", "adam"} - set(trees)
    if missing:
        raise ValueError(f"{path} is not a train state .npz (missing "
                         f"{sorted(missing)}; only Adam/AdamW states map)")
    adam = trees["adam"]
    count = torch.tensor(float(adam["count"]))
    mu = dict(_port_items(adam["mu"], None))
    nu = dict(_port_items(adam["nu"], None))
    state = {
        "step": int(trees["step"]),
        "model": from_jax_params(trees["params"], trees["batch_stats"]),
        "optimizer": {k: {"step": count.clone(), "exp_avg": _tensor(m),
                          "exp_avg_sq": _tensor(nu[k])}
                      for k, m in mu.items()},
        "ema": (from_jax_params(trees["ema_params"], trees["ema_batch_stats"])
                if "ema_params" in trees else None),
    }
    return state, json.loads(str(trees["meta"]))
