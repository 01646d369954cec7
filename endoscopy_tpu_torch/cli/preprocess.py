"""Offline dataset preprocessing CLI (port of ``endoscopy_tpu/cli/preprocess.py``;
reference L1: Preprocess.ipynb).

Mirrors the reference's notebook pipeline as a command: contour-crop the
endoscope view to a square (cell 31), optionally un-distort the elliptical
lens view (cell 29), resize so the minimum edge is 336 px (cell 42 via
utils.py:136-152), fanned over a worker pool (cell 38 ``mp.Pool(8)``) while
mirroring the source directory layout.

Usage::

    python -m endoscopy_tpu_torch.cli.preprocess --src raw/ --dst processed/ \
        [--min-edge 336] [--no-crop] [--deform 0.15] [--workers 8]

Host cv2 on the CPU, as in the JAX package: no ``--device``.
"""

from __future__ import annotations

import argparse

from endoscopy_tpu_torch.data.preprocess import preprocess_tree


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True, help="raw image tree root")
    parser.add_argument("--dst", required=True, help="output tree root")
    parser.add_argument("--min-edge", type=int, default=336,
                        help="resize so min(h, w) == this (default 336)")
    parser.add_argument("--no-crop", action="store_true",
                        help="skip the contour square crop")
    parser.add_argument("--deform", type=float, default=None,
                        help="elliptical deformation strength (e.g. 0.15); "
                             "omitted = no deformation")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--quality", type=int, default=95,
                        help="JPEG output quality")
    args = parser.parse_args(argv)

    n = preprocess_tree(args.src, args.dst, min_edge=args.min_edge,
                        do_crop=not args.no_crop, deform=args.deform,
                        num_workers=args.workers, quality=args.quality)
    print(f"wrote {n} images to {args.dst}")


if __name__ == "__main__":
    main()
