"""Export weights to the port's serving artifact.

Usage::

    python -m endoscopy_tpu_torch.cli.export_model --config <yaml> \
        (--weights <params.npz | state.pt> | --checkpoint <dir | latest>) \
        --out model.pt [--batch N] [--device cuda|cpu]

``--weights`` takes either a flat ``.npz`` of the JAX package's flax trees
(``ckpt/convert.py::write_npz``) or a ``.pt`` holding the port's
``state_dict``. ``--checkpoint`` takes a checkpoint directory of the port
(``ckpt/io.py``), or ``latest`` for the newest complete one under the
config's ``TRAIN.SAVE_CP``; its weights are the EMA teacher's when
``TRAIN.USE_EMA`` and the checkpoint has one, the weights evaluation
reads. An orbax checkpoint of
the JAX package goes through ``tools/torch_port/orbax_to_npz.py`` first.
int8 PTQ (``--quantize``) is a later slice, refused with a pointer to
ROADMAP.md. ``--platforms`` has no counterpart: one artifact
serves on the card or the CPU. After writing, the artifact is loaded on
``--device`` and run once, so a broken export fails here rather than at
serving time. Serve it with ``endoscopy_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt.convert import from_jax_params, read_npz
from endoscopy_tpu_torch.config.loader import get_config
from endoscopy_tpu_torch.serve.export import export_model, load_exported


def load_weights(path: str) -> dict:
    """``.npz`` of flax trees → port state; ``.pt`` → the state as saved."""
    if path.endswith(".npz"):
        return from_jax_params(*read_npz(path))
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise ValueError(f"--weights must be a .npz or .pt file, got {path}")


def load_checkpoint_weights(config, checkpoint: str) -> dict:
    """The weights a checkpoint directory evaluates with: the EMA
    teacher's under ``TRAIN.USE_EMA`` when it has one, else the model's."""
    if checkpoint == "latest":
        checkpoint = ckpt_io.latest_checkpoint(config.TRAIN.SAVE_CP)
        if checkpoint is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {config.TRAIN.SAVE_CP}")
    state, _ = ckpt_io.restore_checkpoint(checkpoint, "cpu")
    if config.TRAIN.USE_EMA and state.get("ema") is not None:
        return state["ema"]
    return state["model"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help=".npz (flax trees) or .pt (state_dict)")
    src.add_argument("--checkpoint",
                     help="checkpoint dir of the port, or 'latest' under "
                          "TRAIN.SAVE_CP")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=None,
                        help="pin the batch dim (default: any size)")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="weight-only int8 PTQ (not ported yet)")
    parser.add_argument("--device", default=None,
                        help="where the exported artifact is checked "
                             "(default cuda)")
    args = parser.parse_args(argv)

    if args.quantize is not None:
        parser.error("int8 PTQ is not ported yet (ROADMAP.md)")
    config = get_config(args.config)
    weights = (load_weights(args.weights) if args.weights is not None
               else load_checkpoint_weights(config, args.checkpoint))
    size, n_classes = export_model(config, weights, args.out,
                                   batch=args.batch)
    infer = load_exported(args.out, device=args.device)
    probs = infer(np.zeros((args.batch or 1, size, size, 3), np.uint8))
    print(f"exported {args.weights or args.checkpoint} -> {args.out} "
          f"(input uint8 [b,{size},{size},3], output f32 [b,{n_classes}]; "
          f"checked: probs {tuple(probs.shape)})")


if __name__ == "__main__":
    main()
