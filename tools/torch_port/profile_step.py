"""Where a training step's time goes on the card: torch.profiler over full-width steps.

    python tools/torch_port/profile_step.py [--path C|F|G|O] [--steps 5]
        [--out chiprun_out/profile]

Builds one of ``chip_smoke.py``'s full-width training paths, with the
weights and uint8 batches of its default seed, on the card:

- C: FixMatch, ``kaggle_semisupervised_real_3_1.yaml`` (ResNet-50, 112 px,
  480 images a step);
- F: CoMatch, ``kaggle_semisupervised_real_1.yaml`` (ResNet-50 under
  ``ModelwEmb``, 112 px, 512 images a step);
- G: SemiFormer in its FixMatch phase, ``kaggle_semisupervised_real_2.yaml``
  (Conformer-Ti, 224 px, 416 images a step);
- O: the ``fit`` step of path O3, ``synthetic_tpu_e2e.yaml`` (FixMatch,
  ResNet-50, 112 px, 480 images a step) on the JPEG files path O2's
  generator writes (928 files at 160 px, made on the card), read by the
  native loader and decoded on the card (``data/jpeg_card.py``): each
  step takes its two batches from the loaders, as ``train_one`` does,
  while their prefetch threads decode the next ones.

After 3 warm-up steps it times ``--steps`` steps of ``_train_step`` (the
views, the RandAugment kernel, forward+backward, optimizer+EMA) with CUDA
events, unprofiled, then runs as many again under ``torch.profiler`` with
CPU and CUDA activities. It prints the card's name and power limit, the
step's ms, the device's busy ms a step (the sum of the device events' self
times: one stream, so they do not overlap), the device's idle share (1 -
busy / step), the host's time to enqueue a step, and the ops with the
most device time; it writes the whole table under ``--out``. Needs a
card.

The host's side comes from the port's own spans (``utils/trace.py``): the
unprofiled steps' spans in ms a step (whole and self time), and, from the
profiled steps, where the card sat idle: every gap between the device's
busy stretches (the union of kernels and copies on every stream) is
charged to the innermost port span open on the main thread when the gap
starts (``(no span)`` outside them), since under a profiler with CPU
activity the spans are annotations on the kernels' clock. Under
``torchrun --standalone --nproc_per_node=1`` the step runs in
a process group of one over NCCL (``parallel/mesh.py::init_from_env``):
every collective of data parallelism is issued, and the table is written
as ``path_<P>_group_ops.txt``.

Path O times its steps with the host clock (two streams run: the step's
and the decode's), and prints the device's busy time as the union of the
intervals of every kernel and copy on any stream, the kernels with the
most device time (nvJPEG's and the resize kernel among them), and the
host's CPU time a step: the main thread's and the other threads' (the
loaders' prefetch threads and the core's readers). Each of its windows
(the warm-up, the timed and the profiled steps) is one
``FixMatch.train_one`` of that many steps, as ``fit`` runs an epoch: the
loaders' iterators start anew and the window ends with the drain of its
last losses.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from endoscopy_tpu_torch.parallel import (in_group, init_from_env,  # noqa: E402
                                          leave_group)
from endoscopy_tpu_torch.utils import trace  # noqa: E402
from torch_port_checks import path_c, path_f, path_g, path_o  # noqa: E402

WARMUP = 3
SEED = 0  # chip_smoke.py's default --seed


def build(path: str, seed: int = SEED):
    """(trainer, one step's call) for the path, at full width."""
    if path == "C":
        from endoscopy_tpu_torch.train.fixmatch import FixMatch as cls
        config = path_c.train_config(path_c.REAL_3_1)
        model = path_c.seeded_model(config, seed, path_c.HEAD_STD)
    elif path == "F":
        from endoscopy_tpu_torch.train.comatch import CoMatch as cls
        config = path_c.train_config(path_f.REAL_1)
        model = path_c.seeded_model(config, seed, path_c.HEAD_STD)
    else:
        from endoscopy_tpu_torch.train.semiformer import SemiFormer as cls
        config = path_c.train_config(path_g.REAL_2)
        model = path_g.seeded_model(config, seed)
    trainer = cls(model, config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_config(config,
                       labeled_targets=path_c.labeled_targets(config, seed))
    x, t, u = (torch.from_numpy(a).cuda()
               for a in path_c.canonical_batches(config, seed, 1)[0])
    w = trainer._step_weights()
    extra = (True,) if path == "F" else ()  # CoMatch's smoothing gate
    return trainer, lambda: trainer._train_step(x, t, u, w, *extra)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", choices=("C", "F", "G", "O"), default="G")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    init_from_env()
    try:
        return profile_o(args, card) if args.path == "O" else profile(args,
                                                                       card)
    finally:
        leave_group()


def profile(args, card: str) -> int:
    """Time, then profile, ``args.steps`` steps of the path."""
    trainer, step = build(args.path)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    before = trace.totals()
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.steps):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    record = trace.since(before)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return e.self_device_time_total

    # the device's own events (kernels, copies) are counted once; the ops
    # that launched them carry the same time as their self device time
    busy_ms = sum(device_us(e) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3 / args.steps
    where = " in a group of 1" if in_group() else ""
    print(f"path {args.path}{where}: {args.steps} steps after {WARMUP} warm-up "
          f"steps: step {step_ms:.3f} ms (CUDA events, unprofiled), host "
          f"enqueue {enqueue_ms:.3f} ms a step; device busy {busy_ms:.3f} ms "
          f"a step (profiled), idle share {1 - busy_ms / step_ms:.4f}",
          flush=True)
    print_spans(record, args.steps)
    print_idle_by_span(prof, args.steps)
    top = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=device_us, reverse=True)
    print("ops by self device time a step (ms, share of busy, calls a "
          "step):", flush=True)
    for e in top[:25]:
        ms = device_us(e) / 1e3 / args.steps
        if ms <= 0:
            break
        print(f"  {ms:9.3f}  {ms / busy_ms:6.3f}  "
              f"{e.count / args.steps:7.1f}  {e.key[:90]}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"path_{args.path}{'_group' if in_group() else ''}_ops.txt"
     ).write_text(
        f"{card}\n" + events.table(sort_by="self_device_time_total",
                                    row_limit=200))
    return 0


def print_spans(record: dict, steps: int) -> None:
    """The port's spans of ``record`` (a ``trace.since``), ms a step."""
    print("port spans a step (ms, self ms, count a step), every thread:",
          flush=True)
    for name, (total, own, n) in sorted(record["spans"].items(),
                                        key=lambda kv: -kv[1][0]):
        print(f"  {total / 1e6 / steps:9.3f}  {own / 1e6 / steps:9.3f}  "
              f"{n / steps:7.2f}  {name}", flush=True)
    for name, n in sorted(record["counters"].items()):
        print(f"  counter {name}: {n / steps:.2f} a step", flush=True)


def _device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def idle_by_span(prof) -> dict:
    """``{span: (idle µs, gaps)}``: each gap between the union's busy
    stretches of the device events charged to the innermost port span
    (a ``/`` in its name) open on the main thread, the thread of the
    ``step/forward_backward`` spans, when the gap starts."""
    spans = [e for e in prof.events() if e.is_user_annotation
             and e.device_type == DeviceType.CPU and "/" in e.name]
    main = Counter(e.thread for e in spans
                   if e.name == "step/forward_backward").most_common(1)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in spans if main and e.thread == main[0][0])
    out = defaultdict(lambda: [0.0, 0])
    end = None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in _device_events(prof)):
        if end is not None and s > end:
            # the latest-opened span still open: spans of one thread nest
            name = "(no span)"
            for a, b, n in spans:
                if a > end:
                    break
                if b > end:
                    name = n
            out[name][0] += s - end
            out[name][1] += 1
        end = e if end is None else max(end, e)
    return {k: tuple(v) for k, v in out.items()}


def print_idle_by_span(prof, steps: int) -> None:
    idle = idle_by_span(prof)
    total = sum(v[0] for v in idle.values()) or 1.0
    print("device idle by the innermost port span open on the main thread "
          "(ms a step, share of idle, gaps a step):", flush=True)
    for name, (us, gaps) in sorted(idle.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3 / steps:9.3f}  {us / total:6.3f}  "
              f"{gaps / steps:7.1f}  {name}", flush=True)


def build_o(seed: int = SEED):
    """(``fit``'s steps, close) for path O: the generator's files made on
    the card, the trainer as ``run_config`` prepares it; ``steps(n)`` is
    one ``train_one`` of ``n`` steps."""
    import shutil

    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.data.synthetic import make_synthetic_dataset

    root = ROOT / "build" / "profile_step" / "synth"
    shutil.rmtree(root, ignore_errors=True)
    make_synthetic_dataset(str(root), seed=seed, **path_o.GENERATOR)
    torch.manual_seed(seed)
    trainer = learn.prepare_trainer(path_o.config(str(root)), device="cuda")

    def steps(n: int) -> None:
        trainer.config.TRAIN.EVAL_STEP = n
        trainer.train_one(1)

    def close():
        for dl in (*trainer.train_dl, trainer.valid_dl):
            dl.close()
        shutil.rmtree(root, ignore_errors=True)

    return steps, close


def _union_ms(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals (µs), in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def profile_o(args, card: str) -> int:
    """Path O: time, then profile, ``args.steps`` ``fit`` steps on JPEG
    files, the loaders running."""
    steps, close = build_o()
    try:
        steps(WARMUP)
        torch.cuda.synchronize()
        n = args.steps
        before = trace.totals()
        t0, c0 = time.perf_counter(), time.process_time()
        m0 = time.thread_time()
        steps(n)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        main_ms = (time.thread_time() - m0) * 1e3 / n
        cpu_ms = (time.process_time() - c0) * 1e3 / n
        record = trace.since(before)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            steps(n)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        close()
    device = _device_events(prof)
    busy_ms = _union_ms((e.time_range.start, e.time_range.end)
                        for e in device)
    idle = (f"{1 - busy_ms / n / step_ms:.4f} of the unprofiled step, "
            f"{1 - busy_ms / window_ms:.4f} of the profiled window" if device
            else "not measured (no device events in the trace)")
    print(f"path O: {n} fit steps after {WARMUP} warm-up steps: step "
          f"{step_ms:.3f} ms (host clock, unprofiled); host CPU a step: the "
          f"main thread {main_ms:.3f} ms, the other threads (prefetch, the "
          f"core's readers) {cpu_ms - main_ms:.3f} ms; profiled window "
          f"{window_ms / n:.3f} ms a step, device busy (union of kernels "
          f"and copies on every stream) {busy_ms / n:.3f} ms a step, idle "
          f"share {idle}", flush=True)
    print_spans(record, n)
    print_idle_by_span(prof, n)
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           count + 1)
    print("device kernels and copies by time a step (ms, share of busy, "
          "calls a step):", flush=True)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    for name, (ms, count) in top[:25]:
        print(f"  {ms / n:9.3f}  {ms / busy_ms:6.3f}  {count / n:7.1f}  "
              f"{name[:90]}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "path_O_ops.txt").write_text(
        f"{card}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
