"""The yardstick's arithmetic: the device-interval union, the idle gaps,
the kernels' byte counts, the FLOP count and the metric readers."""

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import spec, trace
from reference import flops, models


def test_union_merges_overlaps_across_streams():
    events = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35)]
    assert trace.union_s(events) == pytest.approx(30e-6)


def test_idle_gaps_named_by_the_next_operation():
    events = [("a", 0, 10), ("b", 15, 20), ("a", 25, 30), ("b", 40, 41)]
    gaps = trace.idle_gaps_s(events)
    assert gaps == {"before b": pytest.approx(15e-6),
                    "before a": pytest.approx(5e-6)}


def test_span_runs_from_the_first_operation_to_the_last():
    events = [("b", 5, 20), ("a", 2, 10), ("c", 30, 41)]
    assert trace.span_s(events) == pytest.approx(39e-6)


def test_breakdown_lists_at_most_ten_of_each():
    events = [(f"k{i}", 2 * i, 2 * i + 1) for i in range(30)]
    out = trace.breakdown(events)
    assert len(out["device_ops"]) == 10 and len(out["idle_gaps"]) == 10


def _reader(name):
    return spec.metric_reader(name)


def test_randaugment_bytes_match_the_chip_smoke_count():
    # chip_smoke.py's path C bound: 33,729,024 B for (224, 112, 112, 3)
    mod = importlib.util.spec_from_file_location(
        "ra", spec.BENCH_DIR / "metrics" / "randaugment_roofline.py")
    ra = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(ra)
    config = SimpleNamespace(DATA=SimpleNamespace(BATCH_SIZE=32, MU=7,
                                                  IMG_SIZE=112))
    assert ra.strong_view_bytes(config) == 33_729_024


def test_resnet50_forward_macs_are_the_published_4_1_g():
    with torch.device("meta"):
        model = models.build("resnet50", 1000)
    macs = sum(flops.forward_macs(model, 224).values())
    assert 4.0e9 < macs < 4.2e9  # He et al.: 3.8 GFLOPs (multiply-adds)


def test_train_flops_are_three_forwards_less_the_stem_input_gradient():
    with torch.device("meta"):
        model = models.build("resnet50", 6)
    macs = flops.forward_macs(model, 112)
    stem = macs["backbone.conv1"]
    assert flops.train_flops_per_image(model, 112) == \
        2 * (3 * sum(macs.values()) - stem)


def test_conformer_counts_its_attention_products():
    with torch.device("meta"):
        model = models.build("conformer_tiny", 6)
    macs = flops.forward_macs(model, 224)
    products = [k for k in macs if k.endswith(".products")]
    assert len(products) == 12  # one attention a transformer block
    # 197 tokens of 384 channels: q kᵀ and a v
    assert macs[products[0]] == 2 * 197 * 197 * 384


def _ctx(**kw):
    clock = SimpleNamespace(wait_s=0.5, enqueue_s=4.0, enqueue_n=99)
    base = dict(steps=100, window_s=5.0, images_per_step=256,
                view_images_per_step=480, clock=clock, setup_s=12.5,
                intervals_ms=np.arange(1, 101, dtype=float), events=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_end_to_end_readers():
    ctx = _ctx()
    assert _reader("train_images_per_s")(ctx) == pytest.approx(5120.0)
    assert _reader("train_step_p95_ms")(ctx) == pytest.approx(95.05)
    assert _reader("setup_s")(ctx) == 12.5


def test_host_span_readers():
    ctx = _ctx()
    assert _reader("loader_wait_ms")(ctx) == pytest.approx(5.0)
    assert _reader("step_enqueue_ms")(ctx) == pytest.approx(4000 / 99)


def test_trace_readers_return_nothing_without_a_trace():
    ctx = _ctx()
    for name in ("randaugment_roofline", "device_idle_share"):
        assert _reader(name)(ctx) is None
    assert _reader("train_step_p95_ms")(_ctx(intervals_ms=None)) is None


def test_idle_share_and_roofline_from_a_trace():
    config = SimpleNamespace(DATA=SimpleNamespace(BATCH_SIZE=32, MU=7,
                                                  IMG_SIZE=112))
    bound_s = 33_729_024 / 3.35e12
    events = [("randaugment_kernel<bf16>", 0, 2 * bound_s * 1e6),
              ("gemm", 1e6, 3e6)]
    ctx = _ctx(events=events, config=config, hbm_bytes_per_s=3.35e12,
               window_s=4.0)
    assert _reader("randaugment_roofline")(ctx) == pytest.approx(50.0)
    busy = 2 * bound_s + 2.0
    assert _reader("device_idle_share")(ctx) == pytest.approx(
        100 * (1 - busy / 3.0))  # over the span of the ops, not window_s


def test_host_window_summary():
    from harness import host

    w = host.Window()
    w.start()
    w.stop()
    out = w.summary(4, [0.0, 0.05, 0.1, 0.2], np.array([50.0, 50, 50, 200]))
    assert out["host_step_ms"]["max"] == pytest.approx(100.0)
    assert out["device_step_ms"]["over_1.5x_median"] == 1
    assert out["device_step_ms"]["longest_steps"][0] == [3, 200.0]
