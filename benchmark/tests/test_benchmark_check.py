"""Each cell driven on the CPU at a tiny size, as ``run.py`` drives it on
the card but past its look for a chip: the sound program comes out
correct, and ``correct`` comes out false with the timed path broken
underneath (a step that leaves the state unchanged; half of each batch
left out, the mean over the rest; the loaders' rows altered where they
are made) and with the control in the program's place (the reference one
precision below bf16). The last line's shape is checked through
``run.main``."""

import functools
import io
import json
import time
from contextlib import redirect_stdout

import pytest

from harness import cell

TINY = {
    "r50_fixmatch.cached": {
        "config_spec": {"config": {"DATA": {"IMG_SIZE": 32, "BATCH_SIZE": 4,
                                            "MU": 2},
                                   "MODEL": {"NAME": "resnet_tiny"}},
                        "reference": {"model": "resnet_tiny"},
                        "warmup_steps": 2},
        "traffic_spec": {"labeled": 40, "unlabeled": 80}},
    "conformer_semiformer.cached": {
        "config_spec": {"config": {"DATA": {"IMG_SIZE": 32, "BATCH_SIZE": 4,
                                            "MU": 2},
                                   "MODEL": {"EMBED_DIM": 24, "DEPTH": 3,
                                             "NUM_HEADS": 2,
                                             "MLP_RATIO": 2.0}},
                        "reference": {"model": "conformer"},
                        "warmup_steps": 2},
        "traffic_spec": {"labeled": 40, "unlabeled": 80}},
    "r50_fixmatch.jpeg336": {
        "config_spec": {"config": {"DATA": {"IMG_SIZE": 32, "BATCH_SIZE": 4,
                                            "MU": 2},
                                   "MODEL": {"NAME": "resnet_tiny"}},
                        "reference": {"model": "resnet_tiny"},
                        "warmup_steps": 2},
        "traffic_spec": {"labeled": 40, "unlabeled": 80,
                         "files": {"side": 48}}},
}
CASES = [(w, kind) for w in TINY for kind in ("sound", cell.ZERO_STEP,
                                               cell.HALF_BATCH, "control")]
CASES.append(("r50_fixmatch.jpeg336", cell.ALTER_ROWS))


def _run(workload, kind, seed=2 ** 33 + 5):
    kw = {}
    if kind in (cell.ZERO_STEP, cell.HALF_BATCH, cell.ALTER_ROWS):
        kw["fault"] = kind
    elif kind == "control":
        kw["control"] = True
    return cell.run(workload, seed, 0.2, False, time.perf_counter(),
                    device="cpu", overrides=TINY[workload], **kw)


@pytest.mark.parametrize("workload,kind", CASES)
def test_correct_only_for_the_sound_program(workload, kind):
    result = _run(workload, kind)
    assert result["correct"] is (kind == "sound"), result["checks"]


def test_last_line_shape(monkeypatch):
    import torch

    import run

    workload = "r50_fixmatch.cached"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cell, "run", functools.partial(
        cell.run, device="cpu", overrides=TINY[workload]))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "7", "--seconds",
                       "0.2", "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
