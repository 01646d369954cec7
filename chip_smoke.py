#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``endoscopy_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device check: no CUDA means exit 1; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. builds the RandAugment kernel's extension (``endoscopy_tpu_torch/ops/
   csrc``) and prints the build, nvcc's register and shared-memory report
   included, then the launch's cluster size, shared memory per block,
   registers and ``cudaOccupancyMaxActiveClusters``, at 224 and 112 px;
3. holds the kernel against its plain PyTorch version on the card at 224 px
   and at 112 px (path C's side: clusters of 2), 224 images each, in
   float32 and bf16 I/O, in plain mode, crop mode on a padded input
   (``pad=0``) and crop mode with the reflect pad resolved in the load
   (``pad`` = side / 8): every op forced into slot 1 and fully sampled ``(pi,
   pf)``; the crop-fused launch against crop-then-launch and the
   pad-fused launch against reflect-pad-then-launch, both exact.
   Tolerance 0, except images that ran sharpness (0.51 in float32, the JAX
   package's own bar; 1.0 in bf16, one bf16 step at 128..255) or contrast
   (1.0 in float32: a contrast mean that rounds the other way at a near-tie
   moves a pixel by at most 1 - factor < 1; 2.0 in bf16);
4. path B: ``fixmatch_views`` on the flagship unlabeled batch, B*MU = 32*7
   = 224 canonical 268 px uint8 images in bf16, with ``reflect_pad`` made
   to fail (the card path must not pad); checks the strong view against
   the plain version on the same draws, and times the kernel's launch as
   ``fixmatch_views`` makes it with CUDA events, and per op;
5. path A: exports ResNet-50 (``configs/kaggle_semisupervised_real_3.yaml``:
   224 px, 268 px canonical, 6 classes, bf16) with seeded random weights,
   serves it with ``make_server`` on a localhost port, sends 64 concurrent
   raw requests from a client process, and checks every probability row
   against a direct batched forward (bf16, atol 0.02) and two rows against
   a float32 CPU forward of the same artifact (atol 0.05); then times the
   same requests through the same HTTP front with a 0 ms model, and one
   bucket-32 call outside the server;
6. path C: the FixMatch trainer (``endoscopy_tpu_torch/train/fixmatch.py``)
   on ``configs/kaggle_semisupervised_real_3_1.yaml``'s fields (ResNet-50,
   112 px, B=32, MU=7, bf16, Adam, EMA; seeded random weights and seeded
   uint8 batches in pinned host memory): (1) for three seeds, one SGD step
   at B=4, MU=1 from one seeded state (each block's last BN scale 0.1) and
   the same draws on the card (float32 without TF32, then bf16) against
   the CPU's float32 step, THRES set in the widest gap between the weak
   max-probabilities that float32 and bf16 agree on (mask mean 0.25, 0.5
   or 0.75), and a bf16 control step without the strong view
   that the check must refuse; (2) ``train_one`` at full width, 480 images
   a step, 3 warm-up and 12 timed steps: step ms from CUDA events,
   images/s, peak memory, the model-FLOP share of the bf16 peak, the
   kernel launched once a step, the kernel against its plain version on
   the step's own input, and a CUDA-event split (labeled view,
   ``fixmatch_views`` and the kernel alone, forward+backward with and
   without the flax BN running variance and that repair alone,
   optimizer+EMA, and the host's enqueue time of each); (3) GRAD_ACCUM=2:
   two launches and one update a step; (4) two steps of
   ``kaggle_semisupervised_real_3.yaml`` (224 px, IS_FREEZE): the backbone
   bit-identical, every BN running statistic and the head moved.

The last lines are the card's name and power limit, one ``{"kernels": ...}``
JSON line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_port_checks import path_c  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)

IMG, CANON, PAD = 224, int(224 * 1.2), int(224 * 0.125)
BATCH = 32 * 7  # DATA.BATCH_SIZE * DATA.MU of the flagship config
N_REQUESTS = 64
TOL = {"float32": {"sharpness": 0.51, "contrast": 1.0},
       "bfloat16": {"sharpness": 1.0, "contrast": 2.0}}
SERVE_ATOL = 0.02  # probabilities, bucketed bf16 vs one batched bf16 forward
F32_ATOL = 0.05  # probabilities, bf16 on the card vs float32 on the CPU

IMG_C = path_c.REAL_3_1["DATA"]["IMG_SIZE"]  # path C's full-width side
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 3, 12
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# path C part 1: one step at B=4, MU=1 on the card against the CPU's
# float32 step, from seeded states whose blocks' last BN scale is 0.1 (at
# 1 the random ResNet-50 is chaotic: its float32 step is 2.4e-2 from its
# float64 step, 7.5e-4 at 0.1), for three seeds. float32 without TF32
# sums in another order: 1e-4 on the losses; the updates' bound is
# measured in the run (three times the CPU float32 step's distance from
# its float64 step, plus 1e-3). bf16: the CPU's bf16 autocast step sat at
# 1.8e-3..2.7e-3 on the losses and 0.22..0.23 on the updates, its strong
# view replaced by the weak one (the kernel skipped) at 3.1e-2..0.41 and
# 0.86..0.92 (seeds 0-2); each run checks that this control fails.
PART1_SEEDS, PART1_RESIDUAL_GAMMA = 3, 0.1
TRAIN_TOL_F32_LOSS = 1e-4
TRAIN_TOL_BF16_LOSS, TRAIN_TOL_BF16_UPDATE = 0.02, 0.5


# 64 concurrent raw requests from one client process: argv = port, .npy
CLIENT = """
import json, sys, time, urllib.request
from concurrent.futures import ThreadPoolExecutor
import numpy as np
port, imgs = int(sys.argv[1]), np.load(sys.argv[2])
def post(img):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=img.tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    return body["probs"], (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
with ThreadPoolExecutor(len(imgs)) as pool:
    replies = list(pool.map(post, imgs))
json.dump({"probs": [p for p, _ in replies], "ms": [m for _, m in replies],
           "wall_s": time.perf_counter() - t0}, sys.stdout)
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 3) -> float:
    """The host's time to enqueue one call, without waiting for the card:
    close to the call's CUDA-event time, the host sets the pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def ops_ran(pi, n_slots: int = 2):
    """Per image, the set of ops its applied slots ran."""
    pi = pi.tolist()
    return [{row[2 + 2 * s] for s in range(n_slots) if row[3 + 2 * s] == 1}
            for row in pi]


def image_tolerances(pi, dtype_name: str):
    import torch
    tol = TOL[dtype_name]
    return torch.tensor([max([0.0] + [tol["sharpness"] for o in ops if o == 8]
                             + [tol["contrast"] for o in ops if o == 3])
                         for ops in ops_ran(pi)])


def phase_compare(gen, img: int):
    """Kernel against plain version at ``img`` px (224 images, pad img/8)
    in the three modes; returns the max abs error."""
    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        NUM_OPS, randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.ops.randaugment_kernel import randaugment_mc

    reflect = int(img * 0.125)
    worst = 0.0
    side = img + 2 * reflect
    base = torch.randint(0, 256, (BATCH, side, side, 3), generator=gen)
    pi, pf = sample_randaugment_params(gen, BATCH, img, img)
    forced = pi.clone()
    forced[:, 2] = torch.arange(BATCH) % NUM_OPS
    forced[:, 3] = 1
    offs = torch.randint(0, 2 * reflect + 1, (BATCH, 2), generator=gen,
                         dtype=torch.int32)
    offs[:2] = torch.tensor([[0, 2 * reflect],
                             [2 * reflect, 0]])  # both mirrors
    pf = pf.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        padded = base.to(dtype).cuda()
        center = padded[:, reflect:reflect + img, reflect:reflect + img]
        for mode in ("crop", "pad", "plain"):
            # plain: a strided view (element loads); crop: the padded
            # input, pad 0; pad: the contiguous un-padded image, as
            # fixmatch_views hands it over (16-byte vector loads)
            crop = None if mode == "plain" else img
            pad = reflect if mode == "pad" else 0
            x = {"crop": padded, "pad": center.contiguous(),
                 "plain": center}[mode]
            for label, p in (("forced", forced), ("sampled", pi)):
                p = (torch.cat([p, offs], 1) if crop else p).cuda()
                got = randaugment_mc(x, p, pf, crop, pad)
                ref = randaugment_mc_plain(x, p, pf, crop, pad)
                torch.cuda.synchronize()
                if got.shape != (BATCH, img, img, 3) or got.dtype != dtype:
                    fail(f"kernel output {got.dtype} {tuple(got.shape)}")
                err = (got.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
                tol = image_tolerances(p, dname)
                worst = max(worst, float(err.max()))
                if label == "forced":
                    for op in range(NUM_OPS):
                        e, t = err[op::NUM_OPS], tol[op::NUM_OPS]
                        print(f"kernel-vs-plain {img} px {dname:8s} {mode:5s} "
                              f"op{op:<2d} max_abs_err={float(e.max())} "
                              f"tol={float(t.max())}", flush=True)
                else:
                    print(f"kernel-vs-plain {img} px {dname:8s} {mode:5s} "
                          f"sampled max_abs_err={float(err.max())} "
                          f"tol={float(tol.max())}", flush=True)
                bad = (err > tol).nonzero().flatten().tolist()
                if bad:
                    fail(f"{img} px {dname} {mode} {label}: images "
                         f"{bad[:8]} exceed their tolerance (errors {err[bad[:8]].tolist()})")
            p = torch.cat([pi, offs], 1).cuda()
            if mode == "crop":  # crop-fused == crop, then a plain launch
                fused = randaugment_mc(padded, p, pf, img)
                cropped = ops.crop_at(padded, img, offs[:, 0], offs[:, 1])
                unfused = randaugment_mc(cropped, pi.cuda(), pf)
                what = "crop-fused-vs-crop-then-kernel"
            elif mode == "pad":  # pad-fused == reflect pad, then pad 0
                fused = randaugment_mc(x, p, pf, img, reflect)
                unfused = randaugment_mc(ops.reflect_pad(x, reflect), p, pf, img)
                what = "pad-fused-vs-reflect-pad-then-kernel"
            else:
                continue
            torch.cuda.synchronize()
            e = float((fused.float() - unfused.float()).abs().max())
            print(f"{what} {img} px {dname} max_abs_err={e} tol=0.0",
                  flush=True)
            if e != 0.0:
                fail(f"{what}: the launches differ ({e})")
    return worst


def phase_views(gen, seed: int):
    """Path B: fixmatch_views on the flagship unlabeled batch."""
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.aug.views import eval_view, fixmatch_views, normalize
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    u8 = torch.randint(0, 256, (BATCH, CANON, CANON, 3), generator=gen,
                       dtype=torch.uint8).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    flips = torch.rand(BATCH, generator=g, device="cuda") < 0.5
    tops, lefts = ops.sample_crop_offsets(g, BATCH, 2 * PAD)
    pi, pf = sample_randaugment_params(g, BATCH, IMG, IMG)
    draws = dict(flips=flips, tops=tops, lefts=lefts, pi=pi, pf=pf)

    def no_pad(*_):
        raise AssertionError("fixmatch_views made a reflect-padded batch")

    torch.cuda.synchronize()
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(ops, "reflect_pad", no_pad):
        weak, strong = fixmatch_views(u8, IMG, torch.bfloat16, **draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    print(f"path B: fixmatch_views on {tuple(u8.shape)} uint8 -> weak/strong "
          f"{tuple(strong.shape)} {strong.dtype} in {first_s:.4f} s (first "
          f"call); randaugment_mc launches {launches}", flush=True)
    if launches < 1:
        fail("path B did not launch the RandAugment kernel")
    for name, v in (("weak", weak), ("strong", strong)):
        if v.shape != (BATCH, IMG, IMG, 3) or v.dtype != torch.bfloat16:
            fail(f"{name} view is {v.dtype} {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            fail(f"{name} view has non-finite values")
    if not torch.equal(weak, eval_view(u8, IMG, torch.bfloat16)):
        fail("weak view differs from the eval view (center crop + normalize)")

    # the same draws through the plain version; x is the kernel's input as
    # fixmatch_views makes it: the flipped 224 px image, not padded
    x = ops.center_crop(u8, IMG).to(torch.bfloat16)
    x = torch.where(flips.view(-1, 1, 1, 1), ops.hflip(x), x)
    pi_c = torch.cat([pi, tops[:, None], lefts[:, None]], 1)
    ref = normalize(randaugment_mc_plain(x, pi_c, pf, IMG, PAD),
                    torch.bfloat16)
    err = (strong.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
    # the pixel tolerances in normalized units (std >= 0.224), plus one
    # bf16 step of a normalized value (|v| < 4) where they are not 0
    tol = image_tolerances(pi_c, "bfloat16") / 255.0 / 0.224
    tol = torch.where(tol > 0, tol + 2.0 ** -6, tol)
    bad = (err > tol).nonzero().flatten().tolist()
    print(f"path B: strong view vs plain version on the same draws: "
          f"max_abs_err={float(err.max())} (normalized units)", flush=True)
    if bad:
        fail(f"strong view differs from the plain version on images {bad[:8]}")

    views_ms = cuda_ms(lambda: fixmatch_views(u8, IMG, torch.bfloat16,
                                              **draws), iters=10)
    ms = cuda_ms(lambda: rk.randaugment_mc(x, pi_c, pf, IMG, PAD), iters=50,
                 warmup=3)
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(x, pi_c, pf, IMG, PAD),
                       iters=2, warmup=1)
    per_op = []
    for op in [None] + list(range(14)):  # None: no op applied
        p = pi_c.clone()
        p[:, 3] = p[:, 5] = 0
        if op is not None:
            p[:, 2], p[:, 3] = op, 1
        per_op.append(cuda_ms(lambda: rk.randaugment_mc(x, p, pf, IMG, PAD),
                              iters=20))
    print("path B: randaugment_mc ms with every image running one op in "
          f"slot 1 (none, op0..op13): {[round(t, 4) for t in per_op]}",
          flush=True)
    # the bytes the kernel must move: each image's window read once, the
    # output written once, and the (pi, pf) rows
    window = BATCH * IMG * IMG * 3 * x.element_size()
    bytes_moved = 2 * window + pi_c.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"path B timing: fixmatch_views {views_ms:.4f} ms; randaugment_mc "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} "
          f"ms ({bytes_moved} B at {HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def seeded_resnet50(seed: int):
    """``kaggle_semisupervised_real_3``'s ResNet-50 for serving."""
    from endoscopy_tpu_torch.config.loader import default_config

    config = default_config({
        "DATA": {"IMG_SIZE": IMG, "IS_CROP": True},
        "MODEL": {"NAME": "resnet50", "NUM_CLASSES": 6},
        "TRAIN": {"DTYPE": "bfloat16"}})
    return config, path_c.seeded_model(config, seed)


def phase_serve(seed: int, out_dir: Path):
    """Path A: export, serve 64 concurrent raw requests, check them."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.serve.export import export_model, load_exported
    from endoscopy_tpu_torch.serve.server import ModelServer, make_server

    config, model = seeded_resnet50(seed)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "resnet50_seeded.pt")
    size, n_classes = export_model(config, model.state_dict(), path)
    imgs = np.random.default_rng(seed).integers(
        0, 256, (N_REQUESTS, size, size, 3)).astype(np.uint8)

    rk.randaugment_mc.launches = 0
    server = make_server(path, host="127.0.0.1", port=0, device="cuda",
                         log=lambda m: print(f"path A {m}", flush=True))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    npy = str(out_dir / "requests.npy")
    np.save(npy, imgs)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        # the clients run in a process of their own, as real clients do
        client = subprocess.run([sys.executable, "-c", CLIENT, str(port), npy],
                                capture_output=True, text=True, timeout=600)
        if client.returncode != 0:
            fail(f"client process failed:\n{client.stderr[-3000:]}")
        replies = json.loads(client.stdout)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.close()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("server thread did not stop")
    launches = rk.randaugment_mc.launches

    probs = np.asarray(replies["probs"])
    lat = np.sort(replies["ms"])
    print(f"path A: healthz {json.dumps(health)}", flush=True)
    print(f"path A: {N_REQUESTS} concurrent requests in "
          f"{replies['wall_s']:.3f} s; "
          f"latency p50 {lat[len(lat) // 2]:.2f} ms p99 "
          f"{lat[int(len(lat) * 0.99)]:.2f} ms; randaugment_mc launches "
          f"{launches} (none expected)", flush=True)
    print(f"path A: /stats {json.dumps(stats)}", flush=True)
    if probs.shape != (N_REQUESTS, n_classes) or not np.isfinite(probs).all():
        fail(f"served probabilities {probs.shape} are not finite "
             f"({N_REQUESTS}, {n_classes})")
    sums = np.abs(probs.sum(1) - 1.0).max()
    infer_dev = load_exported(path, device="cuda")
    direct = infer_dev(imgs)
    err = float(np.abs(probs - direct).max())
    cpu = load_exported(path, device="cpu")(imgs[:2])
    err32 = float(np.abs(probs[:2] - cpu).max())
    print(f"path A: |sum(probs) - 1| <= {sums:.2e}; served vs batched "
          f"forward max_abs_err={err} (atol {SERVE_ATOL}); vs float32 CPU "
          f"max_abs_err={err32} (atol {F32_ATOL}); probs[0]="
          f"{np.round(probs[0], 4).tolist()}", flush=True)
    if sums > 1e-4:
        fail(f"probability rows do not sum to 1 ({sums})")
    if err > SERVE_ATOL:
        fail(f"served probabilities differ from the batched forward ({err})")
    if err32 > F32_ATOL:
        fail(f"bf16 probabilities differ from the float32 forward ({err32})")
    if stats["requests"] != N_REQUESTS or stats["errors"]:
        fail(f"server stats {stats}")

    # the same requests through the same HTTP front with a 0 ms model:
    # what the host side alone costs
    stub = ModelServer(("127.0.0.1", 0),
                       lambda b: np.full((b.shape[0], n_classes),
                                         1.0 / n_classes, np.float32),
                       input_size=size, num_classes=n_classes,
                       buckets=health["buckets"], max_wait_ms=5.0,
                       backend="none")
    thread = threading.Thread(target=stub.serve_forever, daemon=True)
    thread.start()
    try:
        client = subprocess.run(
            [sys.executable, "-c", CLIENT, str(stub.server_address[1]), npy],
            capture_output=True, text=True, timeout=600)
    finally:
        stub.close()
        thread.join(timeout=60)
    if client.returncode != 0 or thread.is_alive():
        fail(f"0 ms model server run failed:\n{client.stderr[-3000:]}")
    host = json.loads(client.stdout)
    hl = np.sort(host["ms"])
    print(f"path A: the same {N_REQUESTS} requests, same HTTP front, 0 ms "
          f"model: {host['wall_s']:.3f} s; latency p50 "
          f"{hl[len(hl) // 2]:.2f} ms p99 {hl[int(len(hl) * 0.99)]:.2f} ms",
          flush=True)

    # where a bucket-32 call's time goes, outside the server
    batch = imgs[:32]
    t0 = time.perf_counter()
    for _ in range(10):
        infer_dev(batch)
    infer_ms = (time.perf_counter() - t0) * 100
    model = model.cuda().eval().to(memory_format=torch.channels_last)
    x = torch.zeros(32, 3, IMG, IMG, device="cuda").to(
        memory_format=torch.channels_last)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        fwd_ms = cuda_ms(lambda: model(x), iters=20, warmup=3)
    print(f"path A: batch of 32 outside the server: infer (upload, view, "
          f"forward, softmax, download) {infer_ms:.2f} ms host clock; "
          f"ResNet-50 forward alone {fwd_ms:.2f} ms CUDA events", flush=True)


def step_loaders(config, seed: int, marks: list, n: int = 4):
    """(labeled, unlabeled) loaders cycling over ``n`` seeded canonical
    batches in pinned host memory, as a DataLoader with ``pin_memory``
    hands them over. The labeled one records a CUDA event into ``marks``
    each time a step takes its batch, so the events split the stream into
    steps."""
    import itertools

    import torch

    pinned = [(torch.from_numpy(x).pin_memory(), torch.from_numpy(t),
               torch.from_numpy(u).pin_memory())
              for x, t, u in path_c.canonical_batches(config, seed, n)]

    def labeled():
        for i in itertools.count():
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            marks.append(mark)
            yield pinned[i % n][0], pinned[i % n][1]

    def unlabeled():
        for i in itertools.count():
            yield pinned[i % n][2], pinned[i % n][1]

    return labeled(), unlabeled()


def _bf16_views(x, w, u):
    return tuple(v.bfloat16().to(v.dtype) for v in (x, w, u))


def _weak_as_strong(x, w, u):
    return x, w, w  # as if the kernel had left the strong view undone


def _step_errors(got, ref):
    """(mask mean equal, worst relative error of loss, lx, lu, relative L2
    error of the updates, worst tensor)."""
    (stats, upd), (ref_stats, ref_upd) = got, ref
    rel = max(abs(a - b) / abs(b) for a, b in zip(stats[:3], ref_stats[:3]))
    return (stats[3] == ref_stats[3], rel, *path_c.update_errors(upd, ref_upd))


def weak_max_probs(config, model, batch, device: str, seed: int):
    """The max softmax probability of each weak row of the step that
    ``path_c.step_once`` takes with these arguments, from the same
    train-mode forward over all the step's views, in the config's dtype."""
    import copy

    import torch

    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    trainer = FixMatch(copy.deepcopy(model), "SGD", device=device)
    trainer.get_config(config)
    trainer.generator = torch.Generator().manual_seed(seed)
    x, w, u = trainer._views(batch[0], batch[2])
    with torch.no_grad(), torch.autocast(
            device, torch.bfloat16, enabled=trainer.dtype == torch.bfloat16):
        logits = trainer.state.model.train()(
            torch.cat([x, w, u]).permute(0, 3, 1, 2)).float()
    b = x.shape[0]
    return torch.softmax(logits[b:b + w.shape[0]], -1).amax(-1).cpu()


def train_step_matches_cpu(seed: int):
    """Path C, part 1, for one seed: one step of ResNet-50 at 112 px, B=4,
    MU=1, from one seeded state and the same draws, on the card against the
    CPU's float32 step."""
    small = {"DATA": {"BATCH_SIZE": 4, "MU": 1}, "TRAIN": {"DTYPE": "float32"}}
    config = path_c.train_config(path_c.REAL_3_1, **small)
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD,
                                PART1_RESIDUAL_GAMMA)
    batch = path_c.canonical_batches(config, seed, 1)[0]

    # THRES in the gap between two of the four weak max-probabilities that
    # leaves the same rows above it in the CPU's float32 forward and in
    # the card's bf16 forward, the widest such gap: the mask mean is 0.25,
    # 0.5 or 0.75, and no precision moves a row across it
    p32 = weak_max_probs(config, model, batch, "cpu", seed)
    config.TRAIN.DTYPE = "bfloat16"
    p16 = weak_max_probs(config, model, batch, "cuda", seed)
    config.TRAIN.DTYPE = "float32"
    order = p32.sort(descending=True).values
    thres, margin = None, 0.0
    for k in (1, 2, 3):  # rows at or above THRES
        t = float(order[k - 1] + order[k]) / 2
        m = min(float((p32 - t).abs().min()), float((p16 - t).abs().min()))
        if int((p16 >= t).sum()) == k and m > margin:
            thres, margin = t, m
    print(f"path C part 1, seed {seed}: weak max-probabilities, float32 on "
          f"the CPU {p32.tolist()}, bf16 on the card {p16.tolist()}; THRES "
          f"{thres}, margin {margin:.3e}", flush=True)
    if thres is None:
        fail("path C part 1: no THRES splits the weak rows alike in float32 "
             "and bf16")
    config.TRAIN.THRES = thres

    def step(device, alter=None):
        return path_c.step_once(config, model, batch, device, seed, alter)

    ref = step("cpu")
    upd64 = path_c.step_float64(config, model, batch, seed)
    cpu_l2, cpu_worst = path_c.update_errors(ref[1], upd64)
    _, r_loss, r_l2, _ = _step_errors(step("cpu", _bf16_views), ref)
    print(f"path C part 1, seed {seed}: the CPU's float32 step against its "
          f"float64 step: updates relative L2 error {cpu_l2:.3e}, worst "
          f"tensor {cpu_worst:.3e}; against itself on views rounded to bf16: "
          f"losses {r_loss:.3e}, updates {r_l2:.3e}", flush=True)
    if not 0.2 < ref[0][3] < 0.8:
        fail(f"mask mean {ref[0][3]} is not strictly between 0.2 and 0.8")
    out = {"cpu_f32_vs_f64_l2": cpu_l2, "cpu_bf16_views_loss": r_loss,
           "cpu_bf16_views_l2": r_l2}
    # as close to the CPU's step as float32 allows: three times the CPU
    # float32 step's own distance from float64, and 1e-3
    bounds = {"float32": (TRAIN_TOL_F32_LOSS, 3 * cpu_l2 + 1e-3),
              "bfloat16": (TRAIN_TOL_BF16_LOSS, TRAIN_TOL_BF16_UPDATE)}
    for dtype, alter in (("float32", None), ("bfloat16", None),
                         ("bfloat16", _weak_as_strong)):
        config.TRAIN.DTYPE = dtype
        got = step("cuda", alter)
        same_mask, rel, l2, worst = _step_errors(got, ref)
        l2_64 = path_c.update_errors(got[1], upd64)[0]
        loss_bound, bound = bounds[dtype]
        what = dtype if alter is None else f"{dtype} control (weak as strong)"
        print(f"path C part 1, seed {seed}: {what} on the card vs float32 on "
              f"the CPU: [loss, lx, lu, mask_mean] {got[0]} vs {ref[0]}; "
              f"worst relative loss error {rel:.3e} (bound {loss_bound}); SGD "
              f"updates relative L2 error {l2:.3e} (bound {bound:.3e}), worst "
              f"tensor {worst:.3e}; against the CPU's float64 step "
              f"{l2_64:.3e}", flush=True)
        sound = same_mask and rel <= loss_bound and l2 <= bound
        if alter is not None:
            if sound:
                fail("path C bf16 check passes a step without the strong view")
            out["bfloat16_control"] = {"loss_rel_err": rel, "update_l2_err": l2}
            continue
        if not sound:
            fail(f"path C {dtype} step on the card differs from the CPU's")
        out[dtype] = {"loss_rel_err": rel, "update_l2_err": l2,
                      "update_worst_tensor_err": worst,
                      "update_l2_err_vs_f64": l2_64}
    return out


def phase_train_correctness(seed: int):
    """Path C, part 1, for ``PART1_SEEDS`` seeds from ``seed``."""
    return {s: train_step_matches_cpu(s)
            for s in range(seed, seed + PART1_SEEDS)}


def train_flops_per_image(model, img: int) -> int:
    """Model FLOPs of one training step per image from the convolution and
    linear shapes: the forward, every layer's weight gradient and every
    layer's input gradient but the stem's (its input needs none); 2 FLOPs
    per multiply-add. BN, ReLU, pooling and the loss are not counted."""
    import copy

    import torch
    from torch import nn

    macs = {}

    def count(name):
        def hook(m, inp, out):
            if isinstance(m, nn.Conv2d):
                per = (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
                macs[name] = out[0].numel() * per
            else:
                macs[name] = m.in_features * m.out_features
        return hook

    probe = copy.deepcopy(model).cpu().float().eval()
    for name, m in probe.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.register_forward_hook(count(name))
    with torch.no_grad():
        probe(torch.zeros(1, 3, img, img))
    fwd = sum(macs.values())
    return 2 * (3 * fwd - macs["backbone.conv1"])


def phase_train_full(seed: int):
    """Path C, part 2: ``train_one`` at real_3_1's full width."""
    import contextlib
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.aug.views import (fixmatch_views,
                                               labeled_train_view)
    from endoscopy_tpu_torch.models import resnet
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.ssl_state.ema import ema_update
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(path_c.REAL_3_1)
    img = int(config.DATA.IMG_SIZE)
    b, bu = int(config.DATA.BATCH_SIZE), int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    images = b + 2 * bu
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD)
    flops = train_flops_per_image(model, img) * images
    trainer = FixMatch(model, config.TRAIN.OPT_NAME, device="cuda")
    marks = []
    trainer.get_dataloader(step_loaders(config, seed, marks), None)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))

    config.TRAIN.EVAL_STEP = TRAIN_WARMUP_STEPS
    t0 = time.perf_counter()
    trainer.train_one(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    config.TRAIN.EVAL_STEP = TRAIN_TIMED_STEPS
    marks.clear()
    step0 = trainer.state.step
    torch.cuda.reset_peak_memory_stats()
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    meter = trainer.train_one(1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    peak = torch.cuda.max_memory_allocated()
    steps = trainer.state.step - step0
    step_ms = np.array([a.elapsed_time(z) for a, z in
                        zip(marks, marks[1:TRAIN_TIMED_STEPS] + [end])])
    if steps != TRAIN_TIMED_STEPS or launches != steps:
        fail(f"path C: {steps} steps launched the kernel {launches} times "
             "(once a step expected)")
    if not np.isfinite(meter.avg):
        fail(f"path C: mean loss {meter.avg}")
    med = float(np.median(step_ms))
    print(f"path C part 2: {steps} steps of {images} images (B={b}, B*MU={bu}, "
          f"{img} px, bf16) after {TRAIN_WARMUP_STEPS} warm-up steps "
          f"({warm_s:.2f} s); step ms (CUDA events between steps) median "
          f"{med:.3f}, min {step_ms.min():.3f}, max {step_ms.max():.3f}, all "
          f"{np.round(step_ms, 3).tolist()}; wall {wall_s:.3f} s, "
          f"{images * steps / wall_s:.1f} images/s; mean loss {meter.avg:.4f}; "
          f"randaugment_mc launches {launches}; peak memory {peak} B",
          flush=True)

    # the step's parts, each at the step's shapes, CUDA events
    x_u8, t, u_u8 = path_c.canonical_batches(config, seed, 1)[0]
    x_dev, u_dev = torch.from_numpy(x_u8).cuda(), torch.from_numpy(u_u8).cuda()
    t_dev = torch.from_numpy(t).cuda()
    g = trainer.generator
    def lab_view():
        labeled_train_view(x_dev, img, torch.bfloat16, g, device="cuda")

    lab_ms = cuda_ms(lab_view, iters=10)
    lab_host_ms = host_ms(lab_view)
    views_ms = cuda_ms(lambda: fixmatch_views(
        u_dev, img, torch.bfloat16, g, device="cuda"), iters=10)
    # the kernel's launch as fixmatch_views makes it: the flipped center
    # crop, not padded, the crop offsets in pi
    pad = int(img * 0.125)
    xk = ops.center_crop(u_dev, img).to(torch.bfloat16)
    tops, lefts = ops.sample_crop_offsets(g, bu, 2 * pad)
    pi, pf = sample_randaugment_params(g, bu, img, img)
    pi_c = torch.cat([pi, tops[:, None], lefts[:, None]], 1)
    kern_ms = cuda_ms(lambda: rk.randaugment_mc(xk, pi_c, pf, img, pad),
                      iters=50, warmup=3)
    # the same inputs through the plain version, image by image at the
    # tolerances of phase 3
    got = rk.randaugment_mc(xk, pi_c, pf, img, pad)
    ref = randaugment_mc_plain(xk, pi_c, pf, img, pad)
    err = (got.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
    bad = (err > image_tolerances(pi_c, "bfloat16")).nonzero().flatten()
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(xk, pi_c, pf, img, pad),
                       iters=2, warmup=1)
    print(f"path C part 2: randaugment_mc on the step's {tuple(xk.shape)} "
          f"bf16 input (pad {pad}) vs the plain version: max_abs_err="
          f"{float(err.max())}; plain {plain_ms:.2f} ms", flush=True)
    if len(bad):
        fail(f"path C: the kernel differs from the plain version on images "
             f"{bad[:8].tolist()}")
    views = trainer._views(x_dev, u_dev)
    weights = trainer.class_weights

    def fwd_bwd():
        trainer._forward_backward(*views, t_dev, weights)

    # with flax's running variance and with torch's own BN update, in turns
    # (flax, torch, torch, flax): what the repair costs a step, on the card
    # and in the host's enqueue
    def plain_bn():
        return mock.patch.object(resnet, "_flax_running_var",
                                 lambda model, forward, x: forward(x))

    fb, fb_plain = [], []
    for timings, patch in ((fb, contextlib.nullcontext), (fb_plain, plain_bn),
                           (fb_plain, plain_bn), (fb, contextlib.nullcontext)):
        with patch():
            timings.append((cuda_ms(fwd_bwd, iters=5), host_ms(fwd_bwd)))
    fb_ms, fb_host_ms = (float(v) for v in np.mean(fb, axis=0))
    fb_plain_bn_ms, fb_plain_bn_host_ms = (float(v) for v in
                                           np.mean(fb_plain, axis=0))
    # the repair's own work alone (the module walk, the snapshot and the
    # lerp over every BN, at the counts of the last forward): the turns
    # above differ by less than a host's spread
    backbone = trainer.state.model.backbone

    def repair():
        resnet._flax_running_var(backbone, lambda x: x, None)

    repair_ms, repair_host_ms = cuda_ms(repair, iters=20), host_ms(repair, 20)
    opt_ms = cuda_ms(trainer._apply_grads, iters=5)
    opt_host_ms = host_ms(trainer._apply_grads)
    st = trainer.state
    adam_ms = cuda_ms(st.optimizer.step, iters=5)
    ema_ms = cuda_ms(lambda: ema_update(st.ema, st.model, trainer.ema_decay),
                     iters=5)
    bytes_moved = 2 * xk.numel() * xk.element_size() + pi_c.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    print(f"path C part 2 split (ms, CUDA events): labeled_train_view "
          f"{lab_ms:.4f} (host enqueue {lab_host_ms:.4f}); fixmatch_views "
          f"{views_ms:.4f}, of which "
          f"randaugment_mc {kern_ms:.4f} (bound {bound_ms:.4f}: "
          f"{bytes_moved} B at {HBM_BYTES_PER_S:.3g} B/s); forward+backward "
          f"{fb_ms:.3f}, host enqueue {fb_host_ms:.3f} (with torch's own BN "
          f"update {fb_plain_bn_ms:.3f}, host enqueue "
          f"{fb_plain_bn_host_ms:.3f}: the flax running variance costs "
          f"{fb_ms - fb_plain_bn_ms:.3f} on the card's clock; alone "
          f"{repair_ms:.4f}, host enqueue {repair_host_ms:.4f}); "
          f"optimizer+EMA {opt_ms:.3f} (host enqueue {opt_host_ms:.3f}; "
          f"optimizer.step alone {adam_ms:.3f}, EMA alone {ema_ms:.3f}); sum "
          f"{lab_ms + views_ms + fb_ms + opt_ms:.3f} against the step's "
          f"{med:.3f}", flush=True)
    print(f"path C part 2: model FLOPs per step {flops} ({flops / images:.4e} "
          f"per image: convolutions and the head, forward + both "
          f"gradients); {flops / (med * 1e-3) / 1e12:.2f} TFLOP/s at the "
          f"median step, {share:.4f} of the {H100_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s dense bf16 peak; floor {flops / H100_BF16_FLOPS * 1e3:.3f} "
          "ms", flush=True)
    return {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
            "step_ms_max": float(step_ms.max()),
            "images_per_s": images * steps / wall_s, "peak_bytes": peak,
            "flops_per_step": flops, "flop_share": share,
            "launches_per_step": launches / steps, "kernel_ms": kern_ms,
            "kernel_max_abs_err": float(err.max()), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "labeled_view_ms": lab_ms,
            "views_ms": views_ms, "fwd_bwd_ms": fb_ms,
            "fwd_bwd_plain_bn_ms": fb_plain_bn_ms, "opt_ema_ms": opt_ms,
            "fwd_bwd_host_ms": fb_host_ms,
            "fwd_bwd_plain_bn_host_ms": fb_plain_bn_host_ms,
            "bn_repair_ms": repair_ms, "bn_repair_host_ms": repair_host_ms,
            "labeled_view_host_ms": lab_host_ms, "opt_ema_host_ms": opt_host_ms,
            "adam_ms": adam_ms, "ema_ms": ema_ms}


def phase_train_accum(seed: int):
    """Path C, part 3: GRAD_ACCUM=2, a few steps: two launches and one
    update a step."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(path_c.REAL_3_1, TRAIN={"GRAD_ACCUM": 2})
    trainer = FixMatch(path_c.seeded_model(config, seed, path_c.HEAD_STD),
                       config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_dataloader(step_loaders(config, seed, []), None)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    config.TRAIN.EVAL_STEP = 3
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    meter = trainer.train_one(0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    print(f"path C part 3: GRAD_ACCUM=2, 3 steps in {wall_s:.3f} s (first "
          f"calls included): step count {trainer.state.step}, randaugment_mc "
          f"launches {launches}, mean loss {meter.avg:.4f}", flush=True)
    if trainer.state.step != 3 or launches != 6 or not np.isfinite(meter.avg):
        fail("path C GRAD_ACCUM=2: expected 3 updates, 6 kernel launches "
             "and a finite loss")


def phase_train_freeze(seed: int):
    """Path C, part 4: two steps of real_3's settings (224 px, IS_FREEZE):
    the backbone bit-identical, every BN running statistic and the head
    moved."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(path_c.REAL_3)
    trainer = FixMatch(path_c.seeded_model(config, seed, path_c.HEAD_STD),
                       config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_dataloader(step_loaders(config, seed, []), None)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    config.TRAIN.EVAL_STEP = 2
    model = trainer.state.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rk.randaugment_mc.launches = 0
    torch.cuda.reset_peak_memory_stats()
    meter = trainer.train_one(0)
    torch.cuda.synchronize()
    after = model.state_dict()
    frozen_moved = [k for k, _ in model.named_parameters()
                    if k.startswith("backbone.") and not torch.equal(after[k], before[k])]
    still = [k for k in after if (k.startswith("head.") or k.endswith(
        ("running_mean", "running_var"))) and torch.equal(after[k], before[k])]
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in after)
    print(f"path C part 4: IS_FREEZE at 224 px, 2 steps of 480 images: "
          f"backbone parameters moved {len(frozen_moved)}; BN statistics and "
          f"head tensors that did not move {len(still)} (of {n_stats} BN "
          f"statistics and 2 head tensors); randaugment_mc launches "
          f"{rk.randaugment_mc.launches}; peak memory "
          f"{torch.cuda.max_memory_allocated()} B; mean loss {meter.avg:.4f}",
          flush=True)
    if frozen_moved or still or rk.randaugment_mc.launches != 2:
        fail(f"path C freeze: moved {frozen_moved[:4]}, still {still[:4]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA card")

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; {torch.cuda.device_count()} card(s)",
          flush=True)
    # float32 references compute in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    ext = rk.build(verbose=True)
    print(f"built the RandAugment kernel in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for side in (IMG, IMG_C):  # paths A-B, path C
        cluster, smem, active, regs, local = ext.randaugment_mc_info(side,
                                                                     True)
        print(f"randaugment_mc at {side} px: a cluster of {cluster} blocks "
              f"per image, {smem} B dynamic shared memory per block, {regs} "
              f"registers and {local} local bytes per thread, "
              f"cudaOccupancyMaxActiveClusters {active}", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    max_err = phase_compare(gen, IMG)
    max_err_c = phase_compare(gen, IMG_C)
    row = phase_views(gen, args.seed)
    phase_serve(args.seed, Path(__file__).resolve().parent / "build"
                / "chip_smoke")
    t0 = time.perf_counter()
    correct = phase_train_correctness(args.seed)
    train = phase_train_full(args.seed)
    phase_train_accum(args.seed)
    phase_train_freeze(args.seed)
    print(f"path C took {time.perf_counter() - t0:.1f} s", flush=True)
    print("path C: " + json.dumps({"correctness": correct, "full": train}),
          flush=True)

    kernels = [{
        "name": "randaugment_mc", "route": "cuda",
        "source": "endoscopy_tpu_torch/ops/csrc/randaugment.cu",
        "replaces": "endoscopy_tpu/ops/randaugment_kernel.py:373",
        "launches": row["launches"], "max_abs_err": max_err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "path_c": {"launches_per_step": train["launches_per_step"],
                   "max_abs_err": max(max_err_c,
                                      train["kernel_max_abs_err"]),
                   "ms": train["kernel_ms"], "plain_ms": train["plain_ms"],
                   "bound_ms": train["bound_ms"], "bound_by": "bytes",
                   "side": IMG_C},
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
