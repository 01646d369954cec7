"""Where the RandAugment kernel's time goes, on the card.

    python tools/torch_port/randaugment_phases.py [--batch 224] [--side 224]

A measurement tool of the port; nothing of the package uses it. It builds
variants of the kernel's source beside the kernel itself, each by a text
substitution in a copy under ``build/kernels/phases/`` (an edit to the
lines it substitutes makes it fail loudly). Three have a phase cut out: no
store, no load, and neither (the launch, the cluster barriers and the ops
alone); their outputs are wrong, only their times are read. One more,
``cluster8``, takes clusters of 8 blocks at every side, for comparison with
the kernel's own choice (4 at 224 px); its outputs are right. Each of
these and the kernel are timed with CUDA events on a bf16 batch in the
strong view's mode (``pad = side / 8``): every image running no op, the
sampled mix, and every image running one op. The kernel's no-op time is
also taken at a batch of 1 and of one wave. Differences between the
lines give the load, the store and the ops. The last variant,
``timeline``, stamps the device clock at each phase of each image and
gives the mean µs of the load, of each op and of the
store per image, and the gap between images on one cluster slot. Needs
an NVIDIA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root

from endoscopy_tpu_torch.ops import randaugment_kernel as rk  # noqa: E402

_CU, _H = "randaugment.cu", "randaugment.h"

_LOAD = "  {\n    const T* src = in + (size_t)b * sb;"
_STORE = "  // ---- store with CutoutAbs(16)"
_SKIP_LOAD = (_CU, _LOAD, "  if (S < 0) {\n    const T* src = in + (size_t)b * sb;")
_SKIP_STORE = (_CU, _STORE, "  if (S > 0) { cluster.sync(); return; }\n" + _STORE)
# randaugment_cluster_size keeps only its last choice, 8 blocks
_CLUSTER8 = (_H, "randaugment_smem_bytes(side, 2) <= kRandaugmentSmemLimit   ? 2\n"
             "         : randaugment_smem_bytes(side, 4) <= kRandaugmentSmemLimit ? 4\n"
             "         : ", "")
# timeline: block rank k of each image's cluster stamps %globaltimer at its
# start, after the load, at each slot's start, after the slots and at its
# end, and writes the stamps over the first 64 bytes of its image's output
# at 64 k (after the last barrier, so over the stored pixels)
_STAMP = ('  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(stamps[nstamp]));'
          "\n  ++nstamp;\n")
_TIMELINE = [(_CU, old, new) for old, new in [
    ("  if (tid < C) peers[tid] = cluster.map_shared_rank(planes, tid);\n",
     "  if (tid < C) peers[tid] = cluster.map_shared_rank(planes, tid);\n"
     "  unsigned long long stamps[8];\n  int nstamp = 0;\n" + _STAMP),
    ("  // and loaded its rows\n  cluster.sync();\n",
     "  // and loaded its rows\n  cluster.sync();\n" + _STAMP),
    ("  for (int slot = 0; slot < n_slots; ++slot) {\n",
     "  for (int slot = 0; slot < n_slots; ++slot) {\n  " + _STAMP),
    (_STORE, _STAMP + _STORE),
    ("  // no block leaves while a peer may still read its planes or partials\n"
     "  cluster.sync();\n}",
     "  // no block leaves while a peer may still read its planes or partials\n"
     "  cluster.sync();\n" + _STAMP +
     "  if (tid == 0) {\n    unsigned long long* o = reinterpret_cast<"
     "unsigned long long*>(out + (size_t)b * S * S * 3) + 8 * rank;\n"
     "    for (int i = 0; i < nstamp; ++i) o[i] = stamps[i];\n  }\n}"),
]]
VARIANTS = {"no_store": [_SKIP_STORE], "no_load": [_SKIP_LOAD],
            "neither": [_SKIP_LOAD, _SKIP_STORE], "cluster8": [_CLUSTER8],
            "timeline": _TIMELINE}
OPS = {"geometry (rotate)": 7, "sharpness": 8, "equalize": 4,
       "autocontrast": 0, "contrast": 3, "brightness": 1}


def variant_sources(name: str) -> dict[str, str]:
    """The kernel's three source files with the variant's substitutions."""
    text = {f: (rk._CSRC / f).read_text()
            for f in ("randaugment.cpp", _H, _CU)}
    for f, old, new in VARIANTS[name]:
        if text[f].count(old) != 1:
            raise RuntimeError(f"variant {name}: the kernel source changed; "
                               f"{old!r} is not found once in {f}")
        text[f] = text[f].replace(old, new)
    return text


def build_variant(name: str):
    """Builds (or loads the cached build of) one variant's extension."""
    from torch.utils import cpp_extension

    src = rk.BUILD_DIR / "phases" / name
    (src / "build").mkdir(parents=True, exist_ok=True)
    for f, text in variant_sources(name).items():
        (src / f).write_text(text)
    return cpp_extension.load(
        name=f"endoscopy_randaugment_{name}",
        sources=[str(src / "randaugment.cpp"), str(src / "randaugment.cu")],
        extra_cflags=["-O3"], extra_cuda_cflags=list(rk.NVCC_FLAGS),
        build_directory=str(src / "build"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=224)
    parser.add_argument("--side", type=int, default=224)
    parser.add_argument("--variant", help=argparse.SUPPRESS)  # build only
    args = parser.parse_args(argv)
    if args.variant:
        build_variant(args.variant)
        return 0

    import torch

    from endoscopy_tpu_torch.aug.randaugment import sample_randaugment_params

    if not torch.cuda.is_available():
        print("randaugment_phases: needs an NVIDIA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the variants build in parallel, one process each, then load from cache
    procs = [subprocess.Popen([sys.executable, __file__, "--variant", n])
             for n in VARIANTS]
    if any(p.wait() for p in procs):
        print("randaugment_phases: a variant failed to build", file=sys.stderr)
        return 1
    exts = {"kernel": rk.build()} | {n: build_variant(n) for n in VARIANTS}
    timeline = exts.pop("timeline")

    side, pad = args.side, args.side // 8
    g = torch.Generator(device="cuda").manual_seed(0)

    def batch(b, op=None):
        x = torch.randint(0, 256, (b, side, side, 3), device="cuda",
                          generator=g).to(torch.bfloat16)
        pi, pf = sample_randaugment_params(g, b, side, side)
        offs = torch.randint(0, 2 * pad + 1, (b, 2), device="cuda",
                             generator=g, dtype=torch.int32)
        pi = torch.cat([pi, offs], 1)
        if op is not None:  # every image: this op in slot 1, slot 2 off
            pi[:, 3] = pi[:, 5] = 0
            if op >= 0:
                pi[:, 2], pi[:, 3] = op, 1
        return x, pi, pf

    def ms(ext, x, pi, pf, iters=50):
        def run():
            ext.randaugment_mc(x, pi, pf, side, True, pad)
        for _ in range(3):
            run()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for n in ("kernel", "cluster8"):
        cluster, smem, active = exts[n].randaugment_mc_info(side, True)[:3]
        print(f"{n}: clusters of {cluster} blocks, {smem} B shared memory "
              f"per block, {active} clusters resident", flush=True)
    per_wave = exts["kernel"].randaugment_mc_info(side, True)[2]
    for b in (1, per_wave):  # one image; as many images as are resident
        print(f"kernel, no op, batch {b}: {ms(exts['kernel'], *batch(b, -1)):.4f} ms",
              flush=True)
    cases = {"no op": -1, "sampled mix": None} | OPS
    for label, op in cases.items():
        data = batch(args.batch, op)
        print(f"{label:18s} batch {args.batch}: " + ", ".join(
            f"{n} {ms(e, *data):.4f}" for n, e in exts.items()) + " ms",
            flush=True)
    print_timeline(timeline, side, pad, *batch(args.batch))
    return 0


def print_timeline(ext, side, pad, x, pi, pf):
    """Per image, from the timeline variant's stamps (block rank 0, after
    a warm-up launch): the mean µs of the load, of each op by name, of the
    store (with the last barrier), and the gap between consecutive images
    on one cluster slot (launch and start-up)."""
    import torch

    ext.randaugment_mc(x, pi, pf, side, True, pad)
    out = ext.randaugment_mc(x, pi, pf, side, True, pad)
    t = out.reshape(x.shape[0], -1).view(torch.int64)[:, :8].cpu().double() / 1e3
    t = t - t[:, 0].min()
    n = pf.shape[1] // 2
    # stamps: start, loaded, slot 0 .. n-1 start, slots done, end
    load = t[:, 1] - t[:, 0]
    store = t[:, 3 + n] - t[:, 2 + n]
    names = {v: k for k, v in OPS.items()}
    per_op: dict[str, list[float]] = {}
    pil = pi.tolist()
    for s in range(n):
        dur = t[:, 3 + s] - t[:, 2 + s]
        for i, row in enumerate(pil):
            op = row[2 + 2 * s] if row[3 + 2 * s] == 1 and row[2 + 2 * s] != 5 else None
            per_op.setdefault(names.get(op, f"op{op}") if op is not None else "none",
                              []).append(float(dur[i]))
    span = float(t[:, 3 + n].max())
    ends = sorted(t[:, 3 + n].tolist())
    starts = sorted(t[:, 0].tolist())
    per_wave = int((t[:, 0] < 1.0).sum())
    gaps = [s - e for s, e in zip(starts[per_wave:], ends)]
    print(f"timeline, batch {x.shape[0]}: span {span:.1f} us; per image mean "
          f"load {float(load.mean()):.2f} us, store {float(store.mean()):.2f} "
          f"us; images started at once {per_wave}; mean gap from an image's "
          f"end to the next start {sum(gaps) / max(len(gaps), 1):.2f} us",
          flush=True)
    print("timeline, mean us per slot: " + ", ".join(
        f"{k} {sum(v) / len(v):.2f} (x{len(v)})"
        for k, v in sorted(per_op.items())), flush=True)


if __name__ == "__main__":
    sys.exit(main())
