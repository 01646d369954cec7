"""Where a training step's time goes on the card: torch.profiler over full-width steps.

    python tools/torch_port/profile_step.py [--path C|F|G] [--steps 5]
        [--out chiprun_out/profile]

Builds one of ``chip_smoke.py``'s full-width training paths, with the
weights and uint8 batches of its default seed, on the card:

- C: FixMatch, ``kaggle_semisupervised_real_3_1.yaml`` (ResNet-50, 112 px,
  480 images a step);
- F: CoMatch, ``kaggle_semisupervised_real_1.yaml`` (ResNet-50 under
  ``ModelwEmb``, 112 px, 512 images a step);
- G: SemiFormer in its FixMatch phase, ``kaggle_semisupervised_real_2.yaml``
  (Conformer-Ti, 224 px, 416 images a step).

After 3 warm-up steps it times ``--steps`` steps of ``_train_step`` (the
views, the RandAugment kernel, forward+backward, optimizer+EMA) with CUDA
events, unprofiled, then runs as many again under ``torch.profiler`` with
CPU and CUDA activities. It prints the card's name and power limit, the
step's ms, the device's busy ms a step (the sum of the device events' self
times: one stream, so they do not overlap), the device's idle share (1 -
busy / step), the host's time to enqueue a step, and the ops with the
most device time; it writes the whole table under ``--out``. Needs a
card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from torch_port_checks import path_c, path_f, path_g  # noqa: E402

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
    w = trainer.class_weights
    extra = (True,) if path == "F" else ()  # CoMatch's smoothing gate
    return trainer, lambda: trainer._train_step(x, t, u, w, *extra)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", choices=("C", "F", "G"), default="G")
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
    trainer, step = build(args.path)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.steps):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps

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
    print(f"path {args.path}: {args.steps} steps after {WARMUP} warm-up "
          f"steps: step {step_ms:.3f} ms (CUDA events, unprofiled), host "
          f"enqueue {enqueue_ms:.3f} ms a step; device busy {busy_ms:.3f} ms "
          f"a step (profiled), idle share {1 - busy_ms / step_ms:.4f}",
          flush=True)
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
    (out / f"path_{args.path}_ops.txt").write_text(
        f"{card}\n" + events.table(sort_by="self_device_time_total",
                                    row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
