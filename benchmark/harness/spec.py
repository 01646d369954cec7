"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic; ``configs/<name>.json``, ``traffic/<name>.json``
and ``limits/<cell>.json`` beside this package hold them, and
``metrics/<name>.py`` holds each per-layer metric's reader. A later cell,
configuration, traffic mix or metric is one more file of that kind and
one more entry in ``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry of ``workloads``, with its ``config`` and
    ``traffic`` files read in, its ``limits`` and the metrics it
    reports (``end_to_end`` and ``per_layer`` entries that apply)."""
    bench = bench or manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = dict(found[0])

    def applies(metric):
        return name in metric.get("workloads", [name])

    entry["config_spec"] = _json(BENCH_DIR / "configs"
                                 / f"{entry['config']}.json")
    entry["traffic_spec"] = _json(BENCH_DIR / "traffic"
                                  / f"{entry['traffic']}.json")
    entry["limits"] = _json(BENCH_DIR / "limits" / f"{name}.json")
    entry["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    entry["per_layer"] = [m for m in bench["per_layer"] if applies(m)]
    return entry


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s entries, nested mappings merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def seeds(seed: int) -> dict:
    """Independent streams from ``--seed`` (any whole number), each a
    32-bit value: the pool's rows, the weights, the two loaders' index
    streams and the trainer's view generator."""
    names = ("pool", "weights", "labeled", "unlabeled", "views")
    state = np.random.SeedSequence(abs(int(seed))).generate_state(len(names))
    return {k: int(v) for k, v in zip(names, state)}
