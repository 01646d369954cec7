"""The reader of the fused window-attention passes
(``window_attention_fused_per_step``), on hand-built records of a window,
and its manifest entry."""

from types import SimpleNamespace

import pytest

from harness import spec

MS = 1_000_000  # ns
STEPS = 4
SPANS = {"train/step": (160 * MS, 4 * MS, STEPS),
         "model/window_attention": (12 * MS, 12 * MS, 12 * STEPS)}


@pytest.fixture
def window(monkeypatch):
    from endoscopy_tpu_torch.utils import trace

    def use(record):
        monkeypatch.setattr(trace, "_last", record)
    return use


def test_fused_reader(window):
    read = spec.metric_reader("window_attention_fused_per_step")
    ctx = SimpleNamespace(steps=STEPS)
    # Swin-T's 12 blocks, a forward and a backward each, every step
    window({"spans": SPANS, "counters": {"window_attention/fused": 24 * STEPS}})
    assert read(ctx) == pytest.approx(24.0)
    one = SimpleNamespace(steps=1)
    window({"spans": {**SPANS, "train/step": (40 * MS, 1 * MS, 1)},
            "counters": {"window_attention/fused": 24}})
    assert read(one) == pytest.approx(24.0)
    # the plain path (the parent's program, or a float32 model) moves only
    # the logits' bytes
    window({"spans": SPANS,
            "counters": {"swin/window_logit_bytes": STEPS * 480 * 8_758_848}})
    assert read(ctx) is None
    window(None)
    assert read(ctx) is None


def test_fused_metric_is_read_in_the_swin_cell_alone():
    entry, = [m for m in spec.manifest()["per_layer"]
              if m["name"] == "window_attention_fused_per_step"]
    assert entry["workloads"] == ["swin_fixmatch.cached"]
    assert (entry["source"], entry["layer"], entry["moves"]) == (
        "program_counter", "window attention", "train_images_per_s")
