"""The readers of the program's spans and counters
(``harness/program.py``), on a hand-built record of a window."""

import sys
from types import SimpleNamespace

import pytest

from harness import spec

MS = 1_000_000  # ns
STEPS = 4
RECORD = {
    "spans": {
        "train/epoch": (200 * MS, 8 * MS, 1),
        "train/step": (160 * MS, 4 * MS, STEPS),
        "loader/next": (32 * MS, 20 * MS, 2 * STEPS),
        "loader/prefetch_wait": (12 * MS, 12 * MS, 2 * STEPS),
        "step/views": (40 * MS, 28 * MS, STEPS),
        "views/copy_in": (12 * MS, 12 * MS, 2 * STEPS),
        "step/forward_backward": (64 * MS, 24 * MS, STEPS),
        "step/backward": (40 * MS, 40 * MS, STEPS),
        "step/update": (36 * MS, 36 * MS, 2 * STEPS),
        "step/drain": (16 * MS, 16 * MS, STEPS),
        "jpeg/decode": (48 * MS, 48 * MS, 2 * STEPS),
    },
    "counters": {"randaugment/launches": STEPS, "jpeg/payloads": 1000,
                 "jpeg/redecodes": 5},
}
EXPECTED = {
    "views_host_ms": 7.0, "copy_in_host_ms": 3.0, "forward_host_ms": 6.0,
    "backward_host_ms": 10.0, "update_host_ms": 9.0, "drain_wait_ms": 4.0,
    "prefetch_wait_ms": 3.0, "jpeg_decode_host_ms": 12.0,
    "randaugment_launches_per_step": 1.0, "jpeg_redecode_share": 0.5,
}
SOURCES = ("program_span", "program_counter")
NEW = [m["name"] for m in spec.manifest()["per_layer"]
       if m["source"] in SOURCES]


@pytest.fixture
def window(monkeypatch):
    from endoscopy_tpu_torch.utils import trace

    def use(record):
        monkeypatch.setattr(trace, "_last", record)
    return use


def test_every_program_metric_has_a_case():
    assert sorted(NEW) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_record(window, name):
    window(RECORD)
    got = spec.metric_reader(name)(SimpleNamespace(steps=STEPS))
    assert got == pytest.approx(EXPECTED[name])


def test_readers_give_nothing_without_the_tracer(monkeypatch, window):
    import endoscopy_tpu_torch.utils

    window(None)  # no train_one ended yet
    ctx = SimpleNamespace(steps=STEPS)
    assert all(spec.metric_reader(n)(ctx) is None for n in EXPECTED)
    window(RECORD)  # a program without the module: an older commit
    monkeypatch.delattr(endoscopy_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "endoscopy_tpu_torch.utils.trace", None)
    assert all(spec.metric_reader(n)(ctx) is None for n in EXPECTED)


def test_readers_give_nothing_where_the_record_lacks_the_span(window):
    window({"spans": {"train/step": (1, 1, STEPS)}, "counters": {}})
    ctx = SimpleNamespace(steps=STEPS)
    assert all(spec.metric_reader(n)(ctx) is None for n in EXPECTED)
    window({"spans": {"train/step": (1, 1, STEPS)},
            "counters": {"jpeg/payloads": 10}})
    assert spec.metric_reader("jpeg_redecode_share")(ctx) == 0.0


def test_a_record_of_other_steps_is_refused(window):
    window(RECORD)
    with pytest.raises(ValueError, match="train/step"):
        spec.metric_reader("drain_wait_ms")(SimpleNamespace(steps=STEPS + 1))


def test_device_events_leave_out_the_spans_annotations():
    """Under the benchmark's CUDA-only profiler a span's
    ``record_function`` shows up as a ``gpu_user_annotation`` on the
    device's rows: the device's events leave it out, so it adds no busy
    time, no roofline time and no gap."""
    from torch.autograd import DeviceType

    from harness.trace import device_events

    def event(name, device, start, annotation=False):
        return SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=start, end=start + 5))

    kernels = [event("randaugment_mc", DeviceType.CUDA, 0),
               event("Memcpy HtoD", DeviceType.CUDA, 10)]
    spans = [event("step/views", DeviceType.CUDA, 0, annotation=True),
             event("step/views", DeviceType.CPU, 0, annotation=True),
             event("aten::add", DeviceType.CPU, 3)]
    prof = SimpleNamespace(events=lambda: kernels + spans)
    assert device_events(prof) == [(e.name, e.time_range.start,
                                    e.time_range.end) for e in kernels]
