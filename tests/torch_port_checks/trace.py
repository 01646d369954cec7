"""The port's tracer (``endoscopy_tpu_torch/utils/trace.py``): self time
under nesting, the threads' totals, the epoch records, the profiler's
annotations, the spans of a tiny FixMatch epoch and its run log, every
trainer loop's deferred losses (``BaseTrainer._run_steps``), the copy-in
of the supervised and EZBM steps, and the views' rows left on the
CPU."""

import contextlib
import functools
import json
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data.manifest import Manifest
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.train import ezbm as ezbm_mod
from endoscopy_tpu_torch.train import supervised as sup_mod
from endoscopy_tpu_torch.train.comatch import CoMatch
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from endoscopy_tpu_torch.train.semiformer import SemiFormer
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.logging import MetricLogger
from endoscopy_tpu_torch.utils.meters import AverageMeter
from torch_port_checks import comatch, ezbm, semiformer, supervised, train


def check_self_time_is_the_span_less_its_children():
    clock = iter([0, 10, 40, 45, 65, 100])
    before = trace.totals()
    with mock.patch.object(trace, "perf_counter_ns", lambda: next(clock)):
        with trace.span("t1/outer"):
            with trace.span("t1/inner"):
                pass
            with trace.span("t1/inner"):
                pass
    got = trace.since(before)["spans"]
    assert got["t1/outer"] == (100, 100 - 30 - 20, 1)
    assert got["t1/inner"] == (50, 50, 2)


def check_threads_keep_their_own_stacks_and_their_totals_add():
    """Worker threads count and time spans while this thread reads the
    totals, with the interpreter switching threads often: no update is
    lost, and no thread's span nests under another's."""
    workers, rounds = 8, 500
    before = trace.totals()

    def worker():
        for _ in range(rounds):
            with trace.span("t2/worker"):
                trace.count("t2/items")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.span("t2/main"):
            threads = [threading.Thread(target=worker)
                       for _ in range(workers)]
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads):
                trace.totals()  # reads while the workers write
                time.sleep(0.001)
            for t in threads:
                t.join(timeout=60)
            trace.count("t2/items", 5)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = trace.since(before)
    main_total, main_self, _ = got["spans"]["t2/main"]
    assert main_self == main_total  # the workers' spans are not its children
    assert got["spans"]["t2/worker"][2] == workers * rounds
    assert got["counters"]["t2/items"] == workers * rounds + 5
    assert trace.counter("t2/items") >= workers * rounds + 5


def check_only_the_outermost_epoch_keeps_a_record():
    with trace.span("t3/before"):
        pass
    with trace.epoch():
        with trace.span("train/step"):
            trace.count("t3/launches")
        outer = trace.last_epoch()
        with trace.epoch():
            with trace.span("train/step"):
                trace.count("t3/launches")
        assert trace.last_epoch() is outer  # the inner scope kept nothing
    rec = trace.last_epoch()
    assert rec is not outer
    assert "t3/before" not in rec["spans"]
    assert rec["spans"]["train/epoch"][2] == 1
    assert rec["spans"]["train/step"][2] == 2
    assert rec["counters"] == {"t3/launches": 2}
    fields = trace.per_step(rec)
    assert fields["count/t3/launches_per_step"] == 1.0
    assert fields["time/train/step_ms_per_step"] == pytest.approx(
        rec["spans"]["train/step"][0] / 2e6)
    assert trace.per_step({"spans": {}, "counters": {"x": 1}}) == {}


def check_spans_annotate_a_running_profiler_and_only_then():
    made = []
    real = torch.profiler.record_function

    def counted(name):
        made.append(name)
        return real(name)

    with mock.patch.object(torch.profiler, "record_function", counted):
        with trace.span("step/forward_backward"):
            pass
        assert made == []
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            with trace.span("step/forward_backward"):
                torch.ones(4).sum()
    assert made == ["step/forward_backward"]
    names = {e.name for e in prof.events() if e.is_user_annotation}
    assert "step/forward_backward" in names


def _tiny_fixmatch(steps: int):
    config = default_config({
        "DATA": {"IMG_SIZE": 32, "BATCH_SIZE": 4, "MU": 2, "IS_CROP": True},
        "MODEL": {"NUM_CLASSES": 3, "NAME": "resnet_tiny"},
        "TRAIN": {"IS_SSL": True, "EVAL_STEP": steps, "DTYPE": "float32",
                  "EPOCHS": 1, "FREQ_EVAL": 1, "SAVE_CP": ""}})
    torch.manual_seed(0)
    trainer = FixMatch(build_model(config), "Adam", device="cpu")
    rng = np.random.default_rng(0)
    side = int(32 * float(config.DATA.CANONICAL_SCALE))

    def loader(b):
        while True:
            yield (rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8),
                   rng.integers(0, 3, b))

    trainer.get_dataloader((loader(4), loader(8)), None)
    trainer.get_config(config, labeled_targets=np.arange(12) % 3)
    return trainer


def check_fixmatch_epoch_records_every_step_span():
    trainer = _tiny_fixmatch(steps=3)
    with tempfile.TemporaryDirectory() as tmp:
        logger = MetricLogger(tmp, run_name="t")
        trainer._train_epoch(1, logger)
        logger.close()
        log = (Path(tmp) / "t.jsonl").read_text()
    rec = trace.last_epoch()
    spans = rec["spans"]
    assert spans["train/step"][2] == 3
    assert spans["loader/next"][2] == 6
    assert spans["train/epoch"][2] == 1
    for name in ("step/views", "views/copy_in", "step/forward_backward",
                 "step/backward", "step/update", "step/drain"):
        assert spans[name][2] >= 3, name
    assert spans["views/copy_in"][2] == 6  # the labeled and unlabeled rows
    assert spans["train/drain"][2] == 1
    step_total, step_self, _ = spans["train/step"]
    children = sum(spans[n][0] for n in ("step/views", "step/update",
                                         "step/forward_backward",
                                         "step/drain"))
    assert step_total - step_self == children
    fb_total, fb_self, _ = spans["step/forward_backward"]
    assert fb_total - fb_self == spans["step/backward"][0]
    line = json.loads(log.splitlines()[-1])
    assert line["time/step/backward_ms_per_step"] == pytest.approx(
        spans["step/backward"][0] / 3e6)
    assert line["time/epoch_s"] == pytest.approx(spans["train/epoch"][0] / 1e9)
    assert line["throughput/images_per_sec"] > 0


STEPS = 3  # steps of each loop's epoch
LOOP_B = 4  # rows of a labeled batch


class _Rows:
    """A train loader of random canonical rows over a manifest of
    ``STEPS`` batches: ``(uint8 rows, targets)`` batches, and ``sample``
    and ``rng`` for the triplet batch."""

    def __init__(self, b: int, classes: int, side: int):
        n = STEPS * LOOP_B
        self.manifest = Manifest(paths=[f"{i}.png" for i in range(n)],
                                 targets=np.arange(n) % classes)
        self.rng = np.random.default_rng(0)
        self.b, self.side = b, side

    def sample(self, idx) -> np.ndarray:
        return self.rng.integers(0, 256, (len(idx), self.side, self.side, 3),
                                 dtype=np.uint8)

    def __iter__(self):
        while True:
            idx = self.rng.integers(0, len(self.manifest), self.b)
            yield self.sample(idx), self.manifest.targets[idx]


def _loop_trainer(cls, over, *extra):
    """A ``cls`` on ``over``'s tiny configuration at ``LOOP_B`` rows a batch
    and ``MU`` 1, from torch's fresh weights, fed :class:`_Rows` (a labeled
    and an unlabeled loader for the semi-supervised trainers); ``extra``:
    ``get_config``'s arguments before the labeled targets."""
    cfg = default_config(over)
    cfg.DATA.update(BATCH_SIZE=LOOP_B, MU=1)
    cfg.TRAIN.EVAL_STEP = STEPS
    classes = int(cfg.MODEL.NUM_CLASSES)
    side = int(int(cfg.DATA.IMG_SIZE) * float(cfg.DATA.CANONICAL_SCALE))
    torch.manual_seed(0)
    trainer = cls(build_model(cfg), "SGD", device="cpu")
    labeled = _Rows(LOOP_B, classes, side)
    trainer.get_dataloader((labeled, _Rows(LOOP_B, classes, side))
                           if issubclass(cls, (FixMatch, CoMatch))
                           else labeled, None)
    trainer.get_config(cfg, *extra, labeled_targets=labeled.manifest.targets)
    return trainer


def _loops():
    """``(name, trainer, run, rows a loss, the module whose rows_on_device
    the step calls)`` of every trainer loop, in the order they run."""
    fm = _loop_trainer(FixMatch, train.OVERRIDES)
    yield "fixmatch", fm, lambda: fm.train_one(1), LOOP_B, None
    sf = _loop_trainer(SemiFormer, semiformer._overrides())
    yield "semiformer warmup", sf, lambda: sf.train_one(0), LOOP_B, None
    yield "semiformer fixmatch", sf, lambda: sf.train_one(1), LOOP_B, None
    # queue_batch 1: the gate opens at the third step of epoch 0, and each
    # step's rows fill the queue
    co = _loop_trainer(type("CoMatchQ", (CoMatch,), {"queue_batch": 1}),
                       comatch._overrides())
    yield "comatch", co, lambda: co.train_one(0), LOOP_B, None
    for triplet in (False, True):
        st = _loop_trainer(sup_mod.SupLearning,
                           supervised._sup_overrides(triplet), ezbm.CLS_NUM)
        yield (f"supervised {'triplet' if triplet else 'plain'}", st,
               lambda st=st: st.train_one(1), LOOP_B, sup_mod)
    ez = _loop_trainer(ezbm_mod.EZBM, ezbm._overrides(), ezbm.CLS_NUM)
    yield "ezbm stage 1", ez, lambda: ez.train_one_stage_1(1), LOOP_B, ezbm_mod

    def stage_2():
        ez._new_stage2_optimizer()
        return ez.train_one_stage_2(1)
    yield "ezbm stage 2", ez, stage_2, LOOP_B, None


@functools.cache
def _loop_runs() -> dict:
    """name → what one tiny epoch of each loop did: the losses its steps
    handed to ``_defer`` (``deferred``), the meter's reads, the pending
    count after each drain (``left``), the meter, the epoch's record, the
    rows the step handed to ``rows_on_device`` (``copied``) and the rows a
    loss, and CoMatch's gates."""
    runs = {}
    update = AverageMeter.update
    for name, trainer, run, rows, module in _loops():
        got = {"deferred": [], "reads": [], "left": [], "copied": [],
               "rows": rows}
        defer, drain = type(trainer)._defer, type(trainer)._drain_pending

        def recorded_defer(pending, loss):
            got["deferred"].append(float(loss))
            defer(pending, loss)

        def watched_drain(pending, summary_loss, batch_size, keep=2):
            assert all(host.device.type == "cpu" and arrived is None
                       for host, arrived in pending)
            drain(pending, summary_loss, batch_size, keep)
            got["left"].append(len(pending))

        def recorded_update(meter, val, n=1):
            got["reads"].append((val, n))
            update(meter, val, n)

        trainer._defer, trainer._drain_pending = recorded_defer, watched_drain
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(AverageMeter, "update",
                                                  recorded_update))
            if module is not None:
                real = module.rows_on_device

                def copy_in(batch_u8, device, real=real):
                    got["copied"].append(type(batch_u8))
                    return real(batch_u8, device)
                stack.enter_context(mock.patch.object(
                    module, "rows_on_device", copy_in))
            if name == "comatch":
                step = trainer._train_step
                got["gates"] = []

                def gated(*args, step=step):
                    got["gates"].append(args[4])
                    return step(*args)
                trainer._train_step = gated
            got["meter"] = run()
        got["record"] = trace.last_epoch()
        runs[name] = got
    return runs


def check_every_loop_reads_every_loss_once_in_step_order():
    """One tiny epoch of each trainer loop (FixMatch, SemiFormer's warmup
    and FixMatch phase, CoMatch, the supervised trainer plain and
    triplet, EZBM's stages 1 and 2), all through
    ``BaseTrainer._run_steps``: the meter reads each step's loss once, in
    step order; at most two stay pending after any step and none after
    the epoch; ``train/step`` and ``drain/fetches`` count the steps,
    ``loader/next`` a batch of each loader a step, and no drain waits for
    an event on the CPU. CoMatch's gate opens after ``queue_batch``."""
    runs = _loop_runs()
    assert list(runs) == ["fixmatch", "semiformer warmup",
                          "semiformer fixmatch", "comatch",
                          "supervised plain", "supervised triplet",
                          "ezbm stage 1", "ezbm stage 2"]
    loaders = {"fixmatch": 2, "semiformer fixmatch": 2, "comatch": 2,
               "ezbm stage 2": 0}
    for name, got in runs.items():
        deferred, rows = got["deferred"], got["rows"]
        assert len(deferred) == STEPS, name
        assert got["reads"] == [(loss, rows) for loss in deferred], name
        assert np.all(np.isfinite(deferred)), name
        assert got["meter"].count == STEPS * rows, name
        assert got["left"] == [1, 2, 2, 0], name
        spans, counters = got["record"]["spans"], got["record"]["counters"]
        assert spans["train/step"][2] == STEPS, name
        assert spans["train/drain"][2] == 1, name
        assert spans.get("loader/next", (0, 0, 0))[2] == STEPS * loaders.get(
            name, 1), name
        assert counters["drain/fetches"] == STEPS, name
        assert "drain/waited" not in counters, name
    assert runs["comatch"]["gates"] == [False, False, True]


def check_supervised_and_ezbm_steps_copy_rows_in_through_the_views():
    """The supervised steps and EZBM's stage 1 hand their host rows to
    ``aug/views.py::rows_on_device`` once a step (their view's own copy-in
    finds the rows in place: two ``views/copy_in`` spans a step a
    microbatch), and on the CPU nothing is staged (``views/staged``
    unset)."""
    runs = _loop_runs()
    for name in ("supervised plain", "supervised triplet", "ezbm stage 1"):
        got = runs[name]
        assert got["copied"] == [np.ndarray] * STEPS, name
        rec = got["record"]
        assert rec["spans"]["views/copy_in"][2] == 2 * STEPS, name
        assert "views/staged" not in rec["counters"], name


def check_fixmatch_epoch_on_the_cpu_stages_nothing():
    """A tiny FixMatch epoch on the CPU: no batch goes through the card's
    staging (``views/staged`` unset), each step's views equal those of a
    plain ``.to(device)`` of the rows from the same draws, and the rows
    are the loader's own array."""
    from endoscopy_tpu_torch.aug import views

    def plain_copy(batch_u8, device):
        with trace.span("views/copy_in"):
            return torch.as_tensor(batch_u8).to(views.resolve_device(device),
                                                non_blocking=True)

    trainer = _tiny_fixmatch(steps=3)
    take_views, g = trainer._views, trainer.generator
    compared = []

    def both_views(x_lb_u8, u_u8):
        start = g.get_state()
        with mock.patch.object(views, "rows_on_device", plain_copy):
            want = take_views(x_lb_u8, u_u8)
        g.set_state(start)
        got = take_views(x_lb_u8, u_u8)
        compared.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        return got

    trainer._views = both_views
    trainer.train_one(1)
    assert compared == [True] * 3
    assert "views/staged" not in trace.last_epoch()["counters"]
    rows = np.zeros((2, 8, 8, 3), np.uint8)
    assert views.rows_on_device(rows, "cpu").data_ptr() == rows.ctypes.data


def check_swin_window_attention_span_and_logit_bytes():
    """A tiny Swin's forward inside an epoch: one ``model/window_attention``
    span per block, and ``swin/window_logit_bytes`` the float32 logits
    every block materialises, ``B·nW · heads · n² · 4`` summed."""
    from endoscopy_tpu_torch.models import swin

    model = swin.SwinTransformer(32, patch_size=4, embed_dim=16,
                                 depths=(2, 2), num_heads=(2, 4),
                                 window_size=4)
    b = 3
    # two blocks of 8x8 tokens in 4 windows of 4x4 (2 heads), then two of
    # one 4x4 window (4 heads)
    expected = 2 * (b * 4 * 2 * 16 ** 2 * 4) + 2 * (b * 1 * 4 * 16 ** 2 * 4)
    with torch.no_grad(), trace.epoch():
        model(torch.randn(b, 3, 32, 32))
    rec = trace.last_epoch()
    assert rec["spans"]["model/window_attention"][2] == 4
    assert rec["counters"]["swin/window_logit_bytes"] == expected
