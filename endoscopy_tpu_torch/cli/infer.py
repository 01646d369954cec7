"""Predictions from an exported artifact (port of ``endoscopy_tpu/cli/infer.py``).

No model code or checkpoint: the artifact (``cli/export_model.py``, int8 or
not) is loaded on ``--device``, a CSV of image paths is decoded (on the
card by nvJPEG and the resize kernel, ``data/jpeg_card.py``, the batch
staying there; on the CPU through the canonical pipeline, cv2 BGR → RGB,
bilinear, as the JAX package does), and one row is written per image.
With ``--thres`` the output follows the reference's thresholded
pseudo-label rule ``pred = argmax · [max_prob > THRES]``; without it,
``pred = argmax`` and ``max_prob``. The ragged last batch is zero-padded
to ``--batch`` and the pad rows dropped, so a pinned-batch artifact takes
it.

Usage::

    python -m endoscopy_tpu_torch.cli.infer --model model.pt \
        --images in.csv --root <image_root> --out preds.csv \
        [--size 134] [--column image] [--batch 32] [--thres 0.9] \
        [--device cuda|cpu]

``--size``/``--batch`` default to the artifact's contract (its canonical
edge and pinned batch, else 32); a value that contradicts it fails fast.
:func:`predict` does the batching and the prediction on a loader of
canonical images; pandas and cv2 are imported by :func:`main` only.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from endoscopy_tpu_torch.device import resolve_device
from endoscopy_tpu_torch.serve.export import load_exported


def predict(infer, load: Callable[[int, int], np.ndarray], n: int,
            batch: int, thres: Optional[float] = None
            ) -> Dict[str, np.ndarray]:
    """Predictions of ``n`` images, ``load(lo, hi)`` giving rows ``lo..hi``
    as canonical uint8 ``(hi - lo, S, S, 3)`` (numpy, or a tensor on the
    card), through ``infer`` in batches of ``batch`` (the last one
    zero-padded). Returns the output's columns: ``pred`` (and ``max_prob``
    without ``thres``)."""
    preds, maxp = [], []
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        chunk = load(lo, hi)
        if hi - lo < batch:
            shape = (batch - (hi - lo),) + tuple(chunk.shape[1:])
            if isinstance(chunk, torch.Tensor):
                chunk = torch.cat([chunk, chunk.new_zeros(shape)])
            else:
                chunk = np.concatenate([chunk, np.zeros(shape, chunk.dtype)])
        probs = infer(chunk)[:hi - lo]
        preds.append(np.argmax(probs, axis=-1))
        maxp.append(np.max(probs, axis=-1))
    pred = np.concatenate(preds) if preds else np.zeros(0, np.int64)
    max_prob = np.concatenate(maxp) if maxp else np.zeros(0, np.float32)
    if thres is not None:
        return {"pred": pred * (max_prob > thres)}
    return {"pred": pred, "max_prob": max_prob}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True)
    parser.add_argument("--images", required=True,
                        help="CSV with an image-path column")
    parser.add_argument("--root", default="",
                        help="prefix joined to each image path")
    parser.add_argument("--out", required=True)
    parser.add_argument("--size", type=int, default=None,
                        help="canonical input edge; defaults to the size "
                             "recorded in the artifact itself")
    parser.add_argument("--column", default="image")
    parser.add_argument("--batch", type=int, default=None,
                        help="serving batch; defaults to the artifact's "
                             "pinned batch, else 32")
    parser.add_argument("--thres", type=float, default=None,
                        help="emit pred = argmax * [max_prob > thres]")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)  # before any file is read
    import pandas as pd

    infer = load_exported(args.model, device=device)
    if args.size is None:
        args.size = infer.input_size
    elif args.size != infer.input_size:
        raise SystemExit(
            f"--size {args.size} does not match the artifact's input edge "
            f"{infer.input_size}")
    if args.batch is None:
        args.batch = infer.batch or 32
    elif infer.batch is not None and args.batch != infer.batch:
        raise SystemExit(
            f"--batch {args.batch} does not match the artifact's pinned "
            f"batch {infer.batch}")
    df = pd.read_csv(args.images)
    paths = [os.path.join(args.root, p) if args.root else p
             for p in df[args.column].astype(str)]

    if device.type == "cuda":
        from endoscopy_tpu_torch.data import jpeg_card

        def load(lo: int, hi: int):
            return jpeg_card.decode_files(paths[lo:hi], args.size, device)
    else:
        from endoscopy_tpu_torch.data.pipeline import decode_canonical

        def load(lo: int, hi: int):
            return np.stack([decode_canonical(p, args.size)
                             for p in paths[lo:hi]])

    out = df.copy()
    for column, values in predict(infer, load, len(paths), args.batch,
                                  args.thres).items():
        out[column] = values
    out.to_csv(args.out, index=False)
    print(f"wrote {len(out)} predictions to {args.out}")


if __name__ == "__main__":
    main()
