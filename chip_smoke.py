#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``endoscopy_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device check: no CUDA means exit 1; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. builds the RandAugment kernel's extension (``endoscopy_tpu_torch/ops/
   csrc``) and prints the build, nvcc's register and shared-memory report
   included;
3. holds the kernel against its plain PyTorch version on the card at 224 px,
   in float32 and bf16 I/O, crop-fused and plain mode: every op forced into
   slot 1 and fully sampled ``(pi, pf)``; and the crop-fused launch against
   crop-then-launch. Tolerance 0, except images that ran sharpness
   (0.51 in float32, the JAX package's own bar; 1.0 in bf16, one bf16 step
   at 128..255) or contrast (1.0 in float32: a contrast mean that rounds
   the other way at a near-tie moves a pixel by at most 1 - factor < 1;
   2.0 in bf16);
4. path B: ``fixmatch_views`` on the flagship unlabeled batch, B*MU = 32*7
   = 224 canonical 268 px uint8 images in bf16; checks the strong view
   against the plain version on the same draws, and times the kernel with
   CUDA events;
5. path A: exports ResNet-50 (``configs/kaggle_semisupervised_real_3.yaml``:
   224 px, 268 px canonical, 6 classes, bf16) with seeded random weights,
   serves it with ``make_server`` on a localhost port, sends 64 concurrent
   raw requests from a client process, and checks every probability row
   against a direct batched forward (bf16, atol 0.02) and two rows against
   a float32 CPU forward of the same artifact (atol 0.05); then times the
   same requests through the same HTTP front with a 0 ms model, and one
   bucket-32 call outside the server.

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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)

IMG, CANON, PAD = 224, int(224 * 1.2), int(224 * 0.125)
BATCH = 32 * 7  # DATA.BATCH_SIZE * DATA.MU of the flagship config
N_REQUESTS = 64
TOL = {"float32": {"sharpness": 0.51, "contrast": 1.0},
       "bfloat16": {"sharpness": 1.0, "contrast": 2.0}}
SERVE_ATOL = 0.02  # probabilities, bucketed bf16 vs one batched bf16 forward
F32_ATOL = 0.05  # probabilities, bf16 on the card vs float32 on the CPU


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


def phase_compare(gen):
    """Kernel against plain version at 224 px; returns the max abs error."""
    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        NUM_OPS, randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.ops.randaugment_kernel import randaugment_mc

    worst = 0.0
    side = IMG + 2 * PAD
    base = torch.randint(0, 256, (BATCH, side, side, 3), generator=gen)
    pi, pf = sample_randaugment_params(gen, BATCH, IMG, IMG)
    forced = pi.clone()
    forced[:, 2] = torch.arange(BATCH) % NUM_OPS
    forced[:, 3] = 1
    offs = torch.randint(0, 2 * PAD + 1, (BATCH, 2), generator=gen,
                         dtype=torch.int32)
    pf = pf.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        padded = base.to(dtype).cuda()
        for mode in ("crop", "plain"):
            crop = IMG if mode == "crop" else None
            x = padded if crop else padded[:, PAD:PAD + IMG, PAD:PAD + IMG]
            for label, p in (("forced", forced), ("sampled", pi)):
                p = (torch.cat([p, offs], 1) if crop else p).cuda()
                got = randaugment_mc(x, p, pf, crop)
                ref = randaugment_mc_plain(x, p, pf, crop)
                torch.cuda.synchronize()
                if got.shape != (BATCH, IMG, IMG, 3) or got.dtype != dtype:
                    fail(f"kernel output {got.dtype} {tuple(got.shape)}")
                err = (got.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
                tol = image_tolerances(p, dname)
                worst = max(worst, float(err.max()))
                if label == "forced":
                    for op in range(NUM_OPS):
                        e, t = err[op::NUM_OPS], tol[op::NUM_OPS]
                        print(f"kernel-vs-plain {dname:8s} {mode:5s} op{op:<2d} "
                              f"max_abs_err={float(e.max())} "
                              f"tol={float(t.max())}", flush=True)
                else:
                    print(f"kernel-vs-plain {dname:8s} {mode:5s} sampled "
                          f"max_abs_err={float(err.max())} "
                          f"tol={float(tol.max())}", flush=True)
                bad = (err > tol).nonzero().flatten().tolist()
                if bad:
                    fail(f"{dname} {mode} {label}: images {bad[:8]} exceed "
                         f"their tolerance (errors {err[bad[:8]].tolist()})")
            if crop:  # crop-fused launch == crop, then a plain-mode launch
                p = torch.cat([pi, offs], 1).cuda()
                fused = randaugment_mc(padded, p, pf, IMG)
                cropped = ops.crop_at(padded, IMG, offs[:, 0], offs[:, 1])
                unfused = randaugment_mc(cropped, pi.cuda(), pf)
                torch.cuda.synchronize()
                e = float((fused.float() - unfused.float()).abs().max())
                print(f"crop-fused-vs-crop-then-kernel {dname} "
                      f"max_abs_err={e} tol=0.0", flush=True)
                if e != 0.0:
                    fail(f"crop-fused launch differs from crop-then-launch ({e})")
    return worst


def phase_views(gen, seed: int):
    """Path B: fixmatch_views on the flagship unlabeled batch."""
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

    torch.cuda.synchronize()
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
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

    # the same draws through the plain version
    x = ops.center_crop(u8.to(torch.bfloat16), IMG)
    x = torch.where(flips.view(-1, 1, 1, 1), ops.hflip(x), x)
    padded = ops.reflect_pad(x, PAD)
    pi_c = torch.cat([pi, tops[:, None], lefts[:, None]], 1)
    ref = normalize(randaugment_mc_plain(padded, pi_c, pf, IMG), torch.bfloat16)
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
    ms = cuda_ms(lambda: rk.randaugment_mc(padded, pi_c, pf, IMG), iters=50,
                 warmup=3)
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(padded, pi_c, pf, IMG),
                       iters=2, warmup=1)
    per_op = []
    for op in [None] + list(range(14)):  # None: no op applied
        p = pi_c.clone()
        p[:, 3] = p[:, 5] = 0
        if op is not None:
            p[:, 2], p[:, 3] = op, 1
        per_op.append(cuda_ms(lambda: rk.randaugment_mc(padded, p, pf, IMG),
                              iters=20))
    print("path B: randaugment_mc ms with every image running one op in "
          f"slot 1 (none, op0..op13): {[round(t, 4) for t in per_op]}",
          flush=True)
    # the bytes the crop-fused kernel must move: each image's window read
    # once, the output written once, and the (pi, pf) rows
    window = BATCH * IMG * IMG * 3 * padded.element_size()
    bytes_moved = 2 * window + pi_c.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"path B timing: fixmatch_views {views_ms:.4f} ms; randaugment_mc "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} "
          f"ms ({bytes_moved} B at {HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def seeded_resnet50(seed: int):
    """ResNet-50 with random weights from ``seed``: He-normal convolutions
    (fan out) and a small head, so the softmax is not saturated."""
    import torch
    from torch import nn

    from endoscopy_tpu_torch.config.loader import default_config
    from endoscopy_tpu_torch.models import build_model

    config = default_config({
        "DATA": {"IMG_SIZE": IMG, "IS_CROP": True},
        "MODEL": {"NAME": "resnet50", "NUM_CLASSES": 6},
        "TRAIN": {"DTYPE": "bfloat16"}})
    model = build_model(config)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=g)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1e-3, generator=g)
                m.bias.zero_()
    return config, model


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
    rk.build(verbose=True)
    print(f"built the RandAugment kernel in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    max_err = phase_compare(gen)
    row = phase_views(gen, args.seed)
    phase_serve(args.seed, Path(__file__).resolve().parent / "build"
                / "chip_smoke")

    kernels = [{
        "name": "randaugment_mc", "route": "cuda",
        "source": "endoscopy_tpu_torch/ops/csrc/randaugment.cu",
        "replaces": "endoscopy_tpu/ops/randaugment_kernel.py:373",
        "launches": row["launches"], "max_abs_err": max_err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
