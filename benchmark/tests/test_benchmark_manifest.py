"""``BENCHMARK.json`` against the contract's shape, and every name it
uses found as a file of its own."""

import json
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = spec.manifest()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_are_unique_and_well_formed():
    names = ([c["name"] for c in BENCH["configs"]] + list(CELLS)
             + list(E2E) + [m["name"] for m in BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in BENCH["configs"])) == \
        len(BENCH["configs"])
    metrics = list(E2E) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_the_contract_keys(section):
    optional = {"workloads"} if section in ("end_to_end", "per_layer") \
        else set()
    for entry in BENCH[section]:
        assert KEYS[section] <= set(entry) <= KEYS[section] | optional, \
            entry["name"]


def test_setup_s_is_reported_in_every_cell():
    # No ``workloads`` list: every cell, a later one too, reports it.
    assert "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    assert (spec.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in E2E
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_files_and_metrics(name):
    cell = spec.cell(name)
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    e2e = [m["name"] for m in cell["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:  # the end-to-end metric it moves is here
        assert m["moves"] in e2e
    assert cell["limits"]


def test_configs_are_used_and_their_files_hold_them():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"] == data["source"] and len(c["source"]) <= 200
