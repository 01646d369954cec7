"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``endoscopy_tpu_torch``, on a machine with an NVIDIA card. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the check compared with
its limit; the same numbers close standard error. Without a card, or
with ``sys.modules`` holding JAX or the JAX package once the window has
closed, it prints no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "endoscopy_tpu"})


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` (whole names: the part before
    the first dot) that belong to JAX or to the JAX package."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from harness import cell, spec

    entry = spec.cell(args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T0)
    bad = forbidden_modules()
    if bad:
        print(f"JAX-side modules loaded in the benchmark's process: {bad}",
              file=sys.stderr)
        return 3
    print(f"host: {json.dumps(result.pop('host'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
