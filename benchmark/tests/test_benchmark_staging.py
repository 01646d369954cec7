"""The reader of the views' staged copies (``copy_in_staged_per_step``), on
hand-built records of a window, and its manifest entry."""

from types import SimpleNamespace

import pytest

from harness import spec

MS = 1_000_000  # ns
STEPS = 4
SPANS = {"train/step": (160 * MS, 4 * MS, STEPS),
         "views/copy_in": (12 * MS, 12 * MS, 2 * STEPS)}


@pytest.fixture
def window(monkeypatch):
    from endoscopy_tpu_torch.utils import trace

    def use(record):
        monkeypatch.setattr(trace, "_last", record)
    return use


def test_staged_reader(window):
    read = spec.metric_reader("copy_in_staged_per_step")
    ctx = SimpleNamespace(steps=STEPS)
    window({"spans": SPANS, "counters": {"views/staged": 2 * STEPS}})
    assert read(ctx) == pytest.approx(2.0)
    window({"spans": SPANS, "counters": {"views/staged": STEPS + 1}})
    assert read(ctx) == pytest.approx(1.25)
    # rows already on the card, or a program without the counter
    window({"spans": SPANS, "counters": {"randaugment/launches": STEPS}})
    assert read(ctx) is None
    window(None)
    assert read(ctx) is None


def test_staged_metric_is_read_in_the_cached_cells():
    entry, = [m for m in spec.manifest()["per_layer"]
              if m["name"] == "copy_in_staged_per_step"]
    cached = [w["name"] for w in spec.manifest()["workloads"]
              if w["traffic"] == "cached"]
    assert sorted(entry["workloads"]) == sorted(cached)
    assert (entry["source"], entry["layer"], entry["moves"]) == (
        "program_counter", "views", "train_images_per_s")
