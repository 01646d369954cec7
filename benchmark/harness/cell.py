"""One run of one cell: set-up, the window, the metrics, the check.

1. Build the trainer as ``cli/learn.py::prepare_trainer`` builds it, with
   the port's ``build_model`` given the benchmark's seeded weights
   (``weights.py``), the traffic's loaders wrapped by ``feed.py``, and
   ``MODEL.PRE_TRAIN`` off.
2. Drive the trainer through its first three steps with one
   ``train_one`` call (``check.Capture`` records what they produce), then
   warm up with a second call; its step time sets ``TRAIN.EVAL_STEP`` so
   that the window lasts about ``seconds``.
3. The window: one ``train_one`` call, ended by its own drain and a
   ``torch.cuda.synchronize()``; under ``trace`` the profiler records the
   device. Evaluation and checkpoints stay outside it, and the set-up's
   garbage is collected before it. ``host.Window`` reads what the host
   did in it, for standard error.
4. Read the metrics, free the program, and run the reference
   (``check.py``) over the captured steps.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, feed, host, spec, trace, traffic, weights

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
ZERO_STEP = "step"  # a fault: the optimizer step does nothing
HALF_BATCH = "half"  # a fault: half of each batch left out
ALTER_ROWS = "alter"  # a fault: every loader's rows inverted where made


def _invert(batch):
    return (255 - batch[0],) + tuple(batch[1:])


def _port_config(cfgspec: dict, seeds: dict):
    from endoscopy_tpu_torch.config.loader import default_config

    config = default_config(cfgspec["config"])
    config.TRAIN.SEED = seeds["views"]
    config.MODEL.PRE_TRAIN = False
    config.MODEL.PRE_TRAIN_PATH = "None"
    config.MODEL.PRE_TRAIN_RESUME = "None"
    config.TRAIN.SAVE_CP = ""
    config.TRAIN.LOG_DIR = ""
    return config


def _reference_model(cfgspec: dict, config, device):
    """The configuration's reference model: ``build`` of the module its
    ``reference.module`` names (``reference.models`` by default)."""
    ref = dict(cfgspec["reference"])
    ref.pop("train", None)
    build = importlib.import_module(ref.pop("module",
                                            "reference.models")).build
    name = ref.pop("model")
    kw = {k: config.MODEL[key] for key, k in (
        ("EMBED_DIM", "dim"), ("DEPTH", "depth"), ("NUM_HEADS", "heads"),
        ("MLP_RATIO", "mlp_ratio")) if key in config.MODEL}
    with torch.device(device):
        return build(name, int(config.MODEL.NUM_CLASSES), **kw, **ref)


def _install_fault(trainer, fault: str | None, batch_args=(0, 1, 2)) -> None:
    """``batch_args``: the positions of the step's arguments that carry
    a batch (the configuration's ``check.batch_args``; FixMatch's and
    SemiFormer's ``_train_step(x, targets, u, class_weights)`` by
    default)."""
    if fault in (None, ALTER_ROWS):
        return
    if fault == ZERO_STEP:
        trainer.state.optimizer.step = lambda *a, **k: None
    elif fault == HALF_BATCH:
        step = trainer._train_step

        def half(*args):
            return step(*(a[:len(a) // 2] if i in batch_args else a
                          for i, a in enumerate(args)))
        trainer._train_step = half
    else:
        raise ValueError(f"unknown fault {fault!r}")


def run(workload: str, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", overrides: dict | None = None,
        fault: str | None = None, control: bool = False,
        detail: bool = False) -> dict:
    """The result's fields, ``checks`` last. ``device``, ``overrides``
    (``{"config_spec": ..., "traffic_spec": ...}`` merged over the
    cell's files), ``fault`` and ``control`` (the reference put in the
    program's place one precision below the configuration's bf16: its
    views in float8 e4m3, and float8 training, ``reference/models.py``)
    serve the tests and the readings that set the limits."""
    from endoscopy_tpu_torch.cli.learn import prepare_trainer
    from endoscopy_tpu_torch.data.manifest import Manifest, get_cls_num_list
    from endoscopy_tpu_torch.data.pipeline import EvalLoader, canonical_size
    from endoscopy_tpu_torch.models import build_model

    cell = spec.cell(workload)
    overrides = overrides or {}
    cfgspec = spec.merge(cell["config_spec"], overrides.get("config_spec", {}))
    tspec = spec.merge(cell["traffic_spec"], overrides.get("traffic_spec", {}))
    sd = spec.seeds(seed)
    config = _port_config(cfgspec, sd)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    b, mu = int(config.DATA.BATCH_SIZE), int(config.DATA.MU)
    classes = int(config.MODEL.NUM_CLASSES)

    names = _reference_model(cfgspec, config, "meta")
    w = weights.draw(names, cfgspec["init"], sd["weights"], dev)
    canon = canonical_size(config)
    pool = traffic.make_pool(tspec, canon, sd["pool"], dev)
    if hasattr(pool, "bytes_per_file"):
        print(f"pool: {len(pool.labeled)} + {len(pool.unlabeled)} files of "
              f"{pool.side} px, {pool.bytes_per_file:.0f} B each on average",
              file=sys.stderr)
    lab, unl = traffic.loaders(tspec, pool, b, mu, sd,
                               int(config.DATA.NUM_WORKERS), canon, dev)
    fd = feed.Feed(lab, unl, events=on_card,
                   alter=_invert if fault == ALTER_ROWS else None)
    model = build_model(config).to(dev)
    weights.load(model, w)
    empty = Manifest(paths=np.array([], dtype=object),
                     targets=np.array([], np.int64))
    data = (fd.loaders, EvalLoader(empty, b, canon),
            get_cls_num_list(pool.targets, classes), pool.targets)
    trainer = prepare_trainer(config, model=model, device=dev, data=data)
    _install_fault(trainer, fault,
                   tuple(cfgspec.get("check", {}).get("batch_args", (0, 1, 2))))
    epoch = int(cfgspec["window_epoch"])

    cap = check.Capture(trainer, fd.clock)
    config.TRAIN.EVAL_STEP = check.STEPS
    trainer.train_one(epoch)
    prog = cap.finish()

    clock = fd.clock
    clock.reset()
    config.TRAIN.EVAL_STEP = int(cfgspec["warmup_steps"])
    t_w = time.perf_counter()
    trainer.train_one(epoch)
    _sync(on_card)
    warm_s = time.perf_counter() - t_w
    steps = max(1, round(float(seconds) / (warm_s / clock.steps)))

    clock.reset()
    config.TRAIN.EVAL_STEP = steps
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    traced = traced and on_card
    # the set-up's garbage (the capture, the pool's files) is the
    # harness's: none of it is left for a collection inside the window
    gc.collect()
    hw = host.Window()
    with trace.profiler() if traced else contextlib.nullcontext() as prof:
        _sync(on_card)
        t_start = time.perf_counter()
        hw.start()
        meter = trainer.train_one(epoch)
        end_event = None
        if on_card:
            end_event = torch.cuda.Event(enable_timing=True)
            end_event.record()
        _sync(on_card)
        t_end = time.perf_counter()
        hw.stop()
    events = trace.device_events(prof) if traced else None
    del prof
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ref_model_spec = _reference_model(cfgspec, config, "meta")
    ctx = SimpleNamespace(
        config=config, steps=steps, window_s=t_end - t_start,
        setup_s=t_start - t0, images_per_step=b + b * mu,
        view_images_per_step=b * (1 + 2 * mu), clock=clock,
        intervals_ms=(clock.intervals_ms(end_event) if on_card else None),
        events=events, peak_flops=PEAK_BF16_FLOPS,
        hbm_bytes_per_s=HBM_BYTES_PER_S, reference_model=ref_model_spec,
        traffic=tspec, canonical_size=canon)
    reported = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for m in reported:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loss_ok = math.isfinite(meter.avg)
    result = {"correct": False, "attempted": steps,
              "failed": 0 if loss_ok else steps, "metrics": metrics,
              "device": _device(dev, peak)}
    if events is not None:
        result["device"]["busy_s"] = trace.union_s(events)
        result["device"]["window_s"] = trace.span_s(events)
        result["breakdown"] = trace.breakdown(events)
    result["host"] = hw.summary(steps, clock.marks, ctx.intervals_ms)

    for loader in (lab, unl):
        if hasattr(loader, "close"):
            loader.close()
    del trainer, model, fd, lab, unl, data, cap, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref_batches, numbers = traffic.check_batches(
        tspec, pool, prog["batches"], b, mu, sd, check.STEPS, canon)
    ref = _reference(cfgspec, config, pool, ref_batches, w, dev)
    if control:  # the reference in float8 in the program's place
        prog = _reference(cfgspec, config, pool, ref_batches, w, dev,
                          fp8=True)
    numbers.update(check.compare(
        prog, ref, cfgspec.get("check", {}).get("head_leaves", ())))
    correct, checks = check.judge(numbers, cell["limits"])
    result["correct"] = bool(correct and loss_ok)
    if detail:
        result["detail"] = check.worst_leaves(prog, ref)
        result["detail"]["losses"] = [prog["losses"], ref["losses"]]
        result["detail"]["numbers"] = numbers
    result["checks"] = checks
    return result


def _reference(cfgspec, config, pool, ref_batches, w, dev,
               fp8: bool = False) -> dict:
    from reference.models import set_fp8

    steps = importlib.import_module(cfgspec["reference"].get(
        "train", "reference.train"))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = _reference_model(cfgspec, config, dev)
        weights.load(model, w)
        set_fp8(model, fp8)
        batches = [tuple(torch.as_tensor(a).to(dev) for a in batch)
                   for batch in ref_batches]
        fields = {"DATA": dict(config.DATA), "MODEL": dict(config.MODEL),
                  "TRAIN": dict(config.TRAIN)}
        fields["TRAIN"]["EVAL_STEP"] = int(cfgspec["config"]["TRAIN"]
                                           ["EVAL_STEP"])
        run = steps.run_steps(model, batches,
                              steps.class_weights(
                                  pool.targets,
                                  int(config.MODEL.NUM_CLASSES)),
                              fields, check.STEPS,
                              torch.float8_e4m3fn if fp8 else None)
        return check.reference_readings(run, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def _device(dev, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
