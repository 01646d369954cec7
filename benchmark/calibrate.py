"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control 3] [--half 3] [--seconds 1] [--out <file.json>]

Runs the cell's set-up and check (``harness/cell.py``) on each seed as
the program (the lower readings), then on the first ``--control`` seeds
with the reference in float8 put in the program's place, and on the
first ``--half`` seeds with half of each batch left out of the program's
step (the upper readings). A state left unchanged reads 1 on
``update_gap`` and ``ema_gap`` by definition and needs no run. Each
run's numbers are printed as one JSON line and, with ``--out``, written
there. Not run by ``run.py``: the limits in ``limits/<cell>.json`` come
from these readings (PERF.md says which).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def main() -> int:
    import torch

    from harness import cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--half", type=int, default=3)
    p.add_argument("--alter", type=int, default=0,
                   help="seeds with the loaders' rows inverted")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    p.add_argument("--detail", action="store_true",
                   help="add each gap's worst parameters to every row")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    runs = [("program", s, {}) for s in args.seeds]
    runs += [("control", s, {"control": True})
             for s in args.seeds[:args.control]]
    runs += [("half", s, {"fault": cell.HALF_BATCH})
             for s in args.seeds[:args.half]]
    runs += [("alter", s, {"fault": cell.ALTER_ROWS})
             for s in args.seeds[:args.alter]]
    rows = []
    for kind, seed, kw in runs:
        t = time.perf_counter()
        r = cell.run(args.workload, seed, args.seconds, False,
                     time.perf_counter(), detail=args.detail, **kw)
        row = {"kind": kind, "seed": seed, "correct": r["correct"],
               "numbers": r["detail"]["numbers"] if args.detail else
               {k: v["value"] for k, v in r["checks"].items()},
               "seconds": time.perf_counter() - t,
               "peak": r["device"]["memory_peak_bytes"]}
        if args.detail:
            row["detail"] = r["detail"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
