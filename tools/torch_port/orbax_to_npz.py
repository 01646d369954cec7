"""Dump a JAX package checkpoint (orbax) to a ``.npz`` the port can read.

    python tools/torch_port/orbax_to_npz.py <checkpoint dir> <out.npz>

``<checkpoint dir>`` is one ``epoch_<N>`` directory that
``endoscopy_tpu/ckpt/orbax_io.py`` wrote (its ``state/`` and
``meta.json``). The ``.npz`` holds the whole train state as flat keys:
``step``; the trees ``params``, ``batch_stats``, ``ema_params`` and
``ema_batch_stats`` (when the run kept an EMA); optax Adam's state as
``adam/mu``, ``adam/nu`` and ``adam/count``; and ``meta``, the
``meta.json`` text. The port reads it with
``endoscopy_tpu_torch/ckpt/convert.py::train_state_from_npz``, and
``BaseTrainer.load_checkpoint`` and ``MODEL.PRE_TRAIN_RESUME`` take it in
place of a checkpoint directory. Only Adam and AdamW states map onto the
port's optimizer; another optimizer's state raises.

The one file of the port's tooling that imports JAX (and orbax): it runs
beside the JAX package, never on the card's machine. The state is read
into host numpy arrays, whatever devices it was saved from.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _restore_numpy(state_dir: str):
    """The orbax tree at ``state_dir`` as nested dicts/lists of numpy
    arrays, without a target structure or the saving run's devices."""
    import jax
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        meta = ckptr.metadata(state_dir)
        tree = getattr(meta, "item_metadata", meta)
        tree = getattr(tree, "tree", tree)
        args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray),
                            tree)
        return ckptr.restore(state_dir,
                             args=ocp.args.PyTreeRestore(restore_args=args))


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` node (``count``, ``mu``, ``nu``) of an optax
    chain, however orbax laid the chain out."""
    if isinstance(opt_state, dict):
        if {"mu", "nu", "count"} <= set(opt_state):
            return opt_state
        opt_state = opt_state.values()
    for node in opt_state:
        if isinstance(node, (dict, list, tuple)):
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def _flatten(tree, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            _flatten(value, name, out)
        else:
            out[name] = np.asarray(value)


def orbax_to_npz(ckpt_dir: str, out_path: str) -> dict:
    """Write ``out_path``; returns the checkpoint's meta fields."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    state = _restore_numpy(os.path.join(ckpt_dir, "state"))
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError(f"{ckpt_dir}: the optimizer state has no Adam "
                         "moments (only Adam/AdamW map onto the port)")
    flat = {"step": np.asarray(state["step"]),
            "meta": np.asarray(json.dumps(meta)),
            "adam/count": np.asarray(adam["count"])}
    for root in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        if state.get(root) is not None:
            _flatten(state[root], root, flat)
    _flatten(adam["mu"], "adam/mu", flat)
    _flatten(adam["nu"], "adam/nu", flat)
    np.savez(out_path, **flat)
    return meta


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkpoint", help="an epoch_<N> directory")
    parser.add_argument("out", help="the .npz to write")
    args = parser.parse_args(argv)
    meta = orbax_to_npz(args.checkpoint, args.out)
    print(f"wrote {args.out} (meta {json.dumps(meta)})")


if __name__ == "__main__":
    main()
