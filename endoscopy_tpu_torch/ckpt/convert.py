"""Carry weights from the JAX package's flax trees to the port.

``from_jax_params(params, batch_stats)`` takes the flax ``ClassifierHead``
or ``ModelwEmb`` trees, or the bare ``Conformer`` tree (no ``backbone``
scope; nested dicts of numpy arrays), and returns the port's
``state_dict``. For the ResNet it keeps its own copy of the key map behind
the JAX package's ``export_resnet_torch_state`` (a SASA layer in
``conv2``'s place keeps its flax names: ``conv2.q_conv``, ...,
``conv2.rel_encoding_h``); the Conformer's and the EfficientNet's port
names are their flax module paths joined by dots. In all:

- conv kernels go HWIO → OIHW;
- dense kernels are transposed: the linear head's ``head.fc``, and
  ``ModelwEmb``'s MLP head ``fc.{fc1,fc2}`` and projection
  ``head_emb.{proj1,proj2}``;
- BN ``scale``/``bias`` become ``weight``/``bias`` and the ``mean``/``var``
  batch statistics become running statistics (the MLP head's ``fc.bn``
  too); a LayerNorm's ``scale``/``bias`` (no statistics) become
  ``weight``/``bias``;
- the dense kernels include the attention layers' ``qkv``, whose output
  order ``(3, heads, head_dim)`` is kept; bare parameters (``cls_token``,
  SASA's relative encodings, Swin's and CoAtNet's bias tables, SwinMLP's
  per-head ``weight``/``bias``, the shuffle gate's weights, LSA's
  ``temperature``, the position embedding) are copied as they are; a
  depthwise kernel ``(k, k, 1, C)`` becomes ``(C, 1, k, k)`` like any
  other, and a GroupNorm's ``scale``/``bias`` (no statistics) become
  ``weight``/``bias``.

``write_npz``/``read_npz`` store the two trees as one flat ``.npz`` (keys
like ``params/backbone/conv1/kernel``), so a dump made beside the JAX
package reaches the port without JAX.

``train_state_from_npz`` reads a whole JAX train state, as
``tools/torch_port/orbax_to_npz.py`` dumps it from an orbax checkpoint,
into the port's ``TrainState.state_dict()``: the parameters and BN
statistics, the EMA copies, optax Adam's ``mu``/``nu``/``count`` as torch
Adam's ``exp_avg``/``exp_avg_sq``/``step``, or optax SGD's Nesterov
``trace`` as torch SGD's ``momentum_buffer`` (both mapped like the
parameters), and ``step``. Its keys: ``step``, ``meta`` (the checkpoint's
``meta.json`` as a string), the trees ``params``, ``batch_stats``,
``ema_params`` and ``ema_batch_stats``, and either ``adam/mu`` and
``adam/nu`` with ``adam/count``, or ``sgd/trace``.
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
            for gate in ("se", "cbam", "sa"):
                m[f"{tp}.{gate}"] = (fp, gate)
    return m


def _walk(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return node


def _bare_items(params: Mapping, batch_stats: Optional[Mapping],
                path: Tuple[str, ...] = ()):
    """``(port key, value)`` for a tree whose port names are its flax paths
    joined by dots (under ``path``); ``batch_stats`` is the statistics tree
    at the same place."""
    for name, node in params.items():
        at = path + (name,)
        key = ".".join(at)
        stats = (batch_stats.get(name) if isinstance(batch_stats, Mapping)
                 else None)
        if not isinstance(node, Mapping):  # a bare parameter: cls_token
            yield key, node
        elif "kernel" in node:
            kernel = np.asarray(node["kernel"])
            yield f"{key}.weight", (np.transpose(kernel, (3, 2, 0, 1))
                                    if kernel.ndim == 4 else kernel.T)
            if "bias" in node:
                yield f"{key}.bias", node["bias"]
        elif "scale" in node:
            yield f"{key}.weight", node["scale"]
            yield f"{key}.bias", node["bias"]
            if stats is not None:  # BatchNorm; a Layer/GroupNorm has none
                yield f"{key}.running_mean", stats["mean"]
                yield f"{key}.running_var", stats["var"]
        else:
            yield from _bare_items(node, stats, at)


def _resnet_items(p_bb: Mapping, b_bb: Optional[Mapping]):
    """``(port key, value)`` of a flax ResNet trunk, through the key map."""
    for tkey, path in _key_map(_stage_sizes(p_bb)).items():
        node = _walk(p_bb, path)
        if node is None:  # a block without a downsample or a gate
            continue
        if "kernel" in node:
            yield (f"backbone.{tkey}.weight",
                   np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
            continue
        stats = None if b_bb is None else _walk(b_bb, path)
        if "scale" not in node:  # a gate, or a SASA layer in conv2's place
            yield from _bare_items(node, stats, (f"backbone.{tkey}",))
            continue
        yield f"backbone.{tkey}.weight", node["scale"]
        yield f"backbone.{tkey}.bias", node["bias"]
        if b_bb is not None:
            if stats is None:
                raise KeyError(f"batch_stats has no entry for {path}")
            yield f"backbone.{tkey}.running_mean", stats["mean"]
            yield f"backbone.{tkey}.running_var", stats["var"]


def _port_items(params: Mapping, batch_stats: Optional[Mapping]):
    """``(port key, value)`` for a flax ``ClassifierHead``- or
    ``ModelwEmb``-shaped tree, or a bare one (the Conformer); the BN
    running statistics too when ``batch_stats`` is given."""
    if "backbone" not in params:
        yield from _bare_items(params, batch_stats)
        return
    p_bb = params["backbone"]
    b_bb = None if batch_stats is None else batch_stats.get("backbone", {})
    if _stage_sizes(p_bb):
        yield from _resnet_items(p_bb, b_bb)
    else:  # every other backbone
        yield from _bare_items(p_bb, b_bb, ("backbone",))
    heads = ((("head", "fc"),) if "head" in params else
             (("fc", "fc1"), ("fc", "bn"), ("fc", "fc2"),
              ("head_emb", "proj1"), ("head_emb", "proj2")))
    for path in heads:
        node, name = _walk(params, path), ".".join(path)
        if "kernel" in node:
            yield f"{name}.weight", np.asarray(node["kernel"]).T
            if "bias" in node:  # the margin head has none
                yield f"{name}.bias", node["bias"]
            continue
        yield f"{name}.weight", node["scale"]
        yield f"{name}.bias", node["bias"]
        if batch_stats is not None:
            stats = _walk(batch_stats, path)
            yield f"{name}.running_mean", stats["mean"]
            yield f"{name}.running_var", stats["var"]


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, np.float32))


def from_jax_params(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """flax ``ClassifierHead``/``ModelwEmb``/``Conformer`` trees → the
    port model's state."""
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


def _optimizer_state(trees: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's per-parameter state by port name: optax Adam's
    ``mu``/``nu``/``count`` as torch Adam's ``exp_avg``/``exp_avg_sq``/
    ``step``, or SGD's Nesterov ``trace`` as its ``momentum_buffer``."""
    if "adam" in trees:
        adam = trees["adam"]
        count = torch.tensor(float(adam["count"]))
        nu = dict(_port_items(adam["nu"], None))
        return {k: {"step": count.clone(), "exp_avg": _tensor(m),
                    "exp_avg_sq": _tensor(nu[k])}
                for k, m in _port_items(adam["mu"], None)}
    return {k: {"momentum_buffer": _tensor(t)}
            for k, t in _port_items(trees["sgd"]["trace"], None)}


def train_state_from_npz(path: str) -> Tuple[Dict, Dict]:
    """A JAX train state ``.npz`` → ``(TrainState.state_dict(), meta)``."""
    trees = _read_trees(path)
    missing = {"step", "meta", "params", "batch_stats"} - set(trees)
    if missing or not {"adam", "sgd"} & set(trees):
        raise ValueError(f"{path} is not a train state .npz (missing "
                         f"{sorted(missing) or 'adam/ or sgd/'}; only Adam, "
                         "AdamW and SGD states map)")
    state = {
        "step": int(trees["step"]),
        "model": from_jax_params(trees["params"], trees["batch_stats"]),
        "optimizer": _optimizer_state(trees),
        "ema": (from_jax_params(trees["ema_params"], trees["ema_batch_stats"])
                if "ema_params" in trees else None),
    }
    return state, json.loads(str(trees["meta"]))
