"""Where the JPEG route's resize kernel spends its time, on the card.

    python tools/torch_port/resize_phases.py [--batch 224] [--side 160]

A measurement tool of the port; nothing of the package uses it. It builds
``data/csrc/jpeg_card.cu`` (which includes no PyTorch header) with plain
``nvcc -shared`` into ``build/kernels/resize_phases/``, once as it is and
once per variant, each a text substitution in a copy (an edit to the
substituted lines makes it fail loudly), with a C entry point around
``jpeg_card_resize_launch`` loaded by ``ctypes``: ``items2`` and
``items8`` give each thread 2 or 8 (column, channel) bytes in place of 4;
``timeline`` stamps ``%globaltimer`` in thread 0 of each block at its
start, after its header loads, after its axis tables, after its first
sub-band's rows arrived, after its rows were computed and after its
stores. On ``--batch`` seeded random ``--side`` x ``--side`` images (path
O2's batch by default) packed as the decode lays them out, it resizes to
134 px (path O3's side), 112 and 224, holds each build's output against
the plain version (bit for bit), and times it with CUDA events over 200
launches and with ``torch.profiler``'s kernel times; from ``timeline`` it
prints the mean µs of each phase of a block and when the blocks started
(deciles), which shows the waves. Needs an NVIDIA card and nvcc; prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from endoscopy_tpu_torch.data import jpeg_card  # noqa: E402

SRC = ROOT / "endoscopy_tpu_torch" / "data" / "csrc"
OUT = ROOT / "build" / "kernels" / "resize_phases"
NVCC = "/usr/local/cuda/bin/nvcc"
SIZES = (134, 112, 224)

ENTRY = """
extern "C" int phases_resize(const uint8_t* s, const int64_t* o,
                             const int32_t* h, uint8_t* d, int n, int size,
                             cudaStream_t st) {
  return static_cast<int>(jpeg_card_resize_launch(s, o, h, d, n, size, st));
}
extern "C" int phases_stamps(unsigned long long* out, int n) {
#ifdef PHASES_TIMELINE
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_stamps, sizeof(unsigned long long) * n));
#else
  return -1;
#endif
}
"""
STAMP = """#define PHASES_TIMELINE
__device__ unsigned long long g_stamps[65536 * 8];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0) {
    unsigned long long v;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
    g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + i] = v;
  }
}
"""
VARIANTS = {
    "kernel": [],
    "items2": [("kItems = 4;", "kItems = 2;")],
    "items8": [("kItems = 4;", "kItems = 8;")],
    "timeline": [
        ("namespace {\n\nstruct Decoder", STAMP + "namespace {\n\nstruct Decoder"),
        ("  const int t = threadIdx.x, nt = blockDim.x;\n",
         "  stamp(0);\n  const int t = threadIdx.x, nt = blockDim.x;\n"),
        ("  const int row_phase = static_cast<int>(row_bytes & 15);\n",
         "  const int row_phase = static_cast<int>(row_bytes & 15);\n  stamp(1);\n"),
        ("      top[i] = bot[i] = 0.0f;\n    }\n",
         "      top[i] = bot[i] = 0.0f;\n    }\n    stamp(2);\n"),
        ("      __syncthreads();\n      const int ja = s * g",
         "      __syncthreads();\n      if (s == 0) stamp(3);\n      const int ja = s * g"),
        ("    if (whole) {\n      store_segment",
         "    stamp(4);\n    if (whole) {\n      store_segment"),
        ("    c0 += k;\n", "    stamp(5);\n    c0 += k;\n"),
    ],
}
PHASES = ("header", "tables", "first rows", "rows", "stores")


def build_all() -> dict:
    """Each variant's library, built side by side: name -> ctypes.CDLL."""
    procs = {}
    for name, subs in VARIANTS.items():
        src = (SRC / "jpeg_card.cu").read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: the kernel no longer has {old!r}")
            src = src.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "jpeg_card.cu").write_text(src + ENTRY)
        (d / "jpeg_card.h").write_text((SRC / "jpeg_card.h").read_text())
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode=arch=compute_90a,code=sm_90a", "-O3",
             "-fmad=false", "-Xptxas=-v", "-std=c++17", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(d / "lib.so"),
             str(d / "jpeg_card.cu"), "-lnvjpeg"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        regs = [x.strip() for x in out.splitlines()
                if "registers" in x or "spill" in x]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.phases_resize.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.phases_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def timeline(lib, blocks: int) -> str:
    buf = (ctypes.c_ulonglong * (blocks * 8))()
    if lib.phases_stamps(buf, blocks * 8):
        raise SystemExit("timeline: the stamps could not be read")
    a = np.frombuffer(buf, np.uint64).reshape(blocks, 8)[:, :6].astype(np.int64)
    d = np.diff(a, axis=1).mean(0) / 1e3
    start = (a[:, 0] - a[:, 0].min()) / 1e3
    deciles = np.percentile(start, [10, 30, 50, 70, 90, 100]).round(2)
    return (f"{blocks} blocks, span {(a[:, 5].max() - a[:, 0].min()) / 1e3:.2f}"
            f" µs; mean µs a block: " + ", ".join(
                f"{p} {v:.3f}" for p, v in zip(PHASES, d))
            + f", total {(a[:, 5] - a[:, 0]).mean() / 1e3:.3f}; block starts "
            f"(µs, deciles 10-90 and last) {deciles.tolist()}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=224)
    parser.add_argument("--side", type=int, default=160)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("resize_phases: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_all()
    gen = torch.Generator().manual_seed(0)
    images = [torch.randint(0, 256, (args.side, args.side, 3), generator=gen,
                            dtype=torch.uint8).cuda() for _ in range(args.batch)]
    flat, offsets, hw = jpeg_card.pack(images)
    n = len(images)
    stream = torch.cuda.current_stream().cuda_stream
    for size in SIZES:
        ref = jpeg_card.resize_bilinear_plain(flat, offsets, hw, size)
        out = torch.empty_like(ref)
        for name, lib in libs.items():
            def call():
                rc = lib.phases_resize(flat.data_ptr(), offsets.data_ptr(),
                                       hw.data_ptr(), out.data_ptr(), n, size,
                                       stream)
                if rc:
                    raise SystemExit(f"{name}: the launch failed ({rc})")
            out.zero_()
            call()
            torch.cuda.synchronize()
            same = torch.equal(out, ref)
            for _ in range(5):
                call()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(200):
                call()
            ev[1].record()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    call()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if "resize" in e.name]
            prof_ms = (sum(e.time_range.end - e.time_range.start
                           for e in kernels) / max(len(kernels), 1) / 1e3)
            print(f"{name} {n} x {args.side} px -> {size} px: equal to the "
                  f"plain version {same}; {ev[0].elapsed_time(ev[1]) / 200:.4f}"
                  f" ms (CUDA events), {prof_ms:.4f} ms (profiler, "
                  f"{len(kernels)} kernels)", flush=True)
            if name == "timeline":
                call()
                torch.cuda.synchronize()
                cols = min(size, 256)
                rows = max(1, min(16, 8192 // (3 * cols)))
                print(f"  {timeline(lib, -(-size // rows) * n)}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
