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
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

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


def from_jax_params(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """flax ``ClassifierHead`` trees → the port's ``ClassifierHead`` state."""
    p_bb, b_bb = params["backbone"], batch_stats.get("backbone", {})
    out: Dict[str, torch.Tensor] = {}

    def put(key, value):
        out[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    for tkey, path in _key_map(_stage_sizes(p_bb)).items():
        node = _walk(p_bb, path)
        if node is None:  # a block without a downsample
            continue
        if "kernel" in node:
            put(f"backbone.{tkey}.weight",
                np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
        else:
            stats = _walk(b_bb, path)
            if stats is None:
                raise KeyError(f"batch_stats has no entry for {path}")
            put(f"backbone.{tkey}.weight", node["scale"])
            put(f"backbone.{tkey}.bias", node["bias"])
            put(f"backbone.{tkey}.running_mean", stats["mean"])
            put(f"backbone.{tkey}.running_var", stats["var"])
            out[f"backbone.{tkey}.num_batches_tracked"] = torch.tensor(0)
    fc = params["head"]["fc"]
    put("head.fc.weight", np.asarray(fc["kernel"]).T)
    put("head.fc.bias", fc["bias"])
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


def read_npz(path: str) -> Tuple[dict, dict]:
    """Read a flat ``.npz`` back into ``(params, batch_stats)`` trees."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    with np.load(path, allow_pickle=False) as data:
        for name in data.files:
            root, *keys = name.split("/")
            if root not in trees or not keys:
                raise ValueError(f"unexpected key {name!r} in {path}")
            node = trees[root]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[name]
    return trees["params"], trees["batch_stats"]
