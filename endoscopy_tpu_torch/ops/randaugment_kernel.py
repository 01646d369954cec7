"""RandAugmentMC + CutoutAbs as a hand-written CUDA kernel for Hopper.

Port of the Pallas TPU kernel ``endoscopy_tpu/ops/randaugment_kernel.py``
(``_randaugment_mc_pallas`` → ``_kernel``). The kernel is
``csrc/randaugment.cu`` and its PyTorch binding ``csrc/randaugment.cpp``;
``torch.utils.cpp_extension.load`` builds both for ``sm_90a`` at first use,
into ``build/kernels/`` at the root of the checkout.

:func:`randaugment_mc` is the one entry point. A tensor on the CPU goes to
the plain PyTorch version (``aug/randaugment.py``); a CUDA tensor launches
the kernel, or raises if it cannot be built or launched. Each launch adds
one to ``randaugment_mc.launches``.

The kernel is bound by the card's memory rate: it reads each input byte and
writes each output byte once, with a few operations per pixel in between.
"""

from __future__ import annotations

from pathlib import Path

import torch

from endoscopy_tpu_torch.aug.randaugment import randaugment_mc_plain

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: the source writes out every fused multiply-add the reference
# has, and nvcc must contract nothing else (see randaugment.cu)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-Xptxas=-v")

_ext = None


def build(verbose: bool = False):
    """Build (once per source and flag set) and load the kernel's extension.

    With ``verbose`` the build prints its commands and nvcc's output,
    ``-Xptxas=-v`` register and shared memory counts included.
    """
    global _ext
    if _ext is None:
        from torch.utils import cpp_extension

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _ext = cpp_extension.load(
            name="endoscopy_randaugment",
            sources=[str(_CSRC / "randaugment.cpp"),
                     str(_CSRC / "randaugment.cu")],
            extra_cflags=["-O3"], extra_cuda_cflags=list(NVCC_FLAGS),
            build_directory=str(BUILD_DIR), verbose=verbose)
    return _ext


def _check(x: torch.Tensor, pi: torch.Tensor, pf: torch.Tensor,
           crop_size: int | None) -> int:
    """Validates the arguments; returns the output side."""
    if x.ndim != 4 or x.shape[3] != 3:
        raise ValueError(f"expected an NHWC batch with 3 channels, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected float32 or bfloat16 input, got {x.dtype}")
    b, hp, wp = x.shape[:3]
    size = hp if crop_size is None else int(crop_size)
    if hp != wp or not 0 < size <= hp:
        raise ValueError(f"square images and 0 < crop_size <= {hp} only")
    n = pf.shape[1] // 2 if pf.ndim == 2 else -1
    cols = 2 + 2 * n + (2 if crop_size is not None else 0)
    if pf.shape != (b, 2 * n) or n < 1 or pf.dtype != torch.float32:
        raise ValueError(f"pf must be float32 (B, 2n), got {pf.dtype} {tuple(pf.shape)}")
    if pi.shape != (b, cols) or pi.dtype != torch.int32:
        raise ValueError(f"pi must be int32 ({b}, {cols}), got {pi.dtype} {tuple(pi.shape)}")
    return size


def randaugment_mc(x: torch.Tensor, pi: torch.Tensor, pf: torch.Tensor,
                   crop_size: int | None = None) -> torch.Tensor:
    """Batch RandAugmentMC + CutoutAbs(16) with explicit per-sample params.

    ``x`` (B, Hp, Wp, 3) float32 or bf16 in [0, 255], any strides. ``pi``
    (B, 2+2n[+2]) int32 ``cx, cy, (op, apply)*n, [top, left]`` and ``pf``
    (B, 2n) float32 ``(v, sign)*n``, as ``aug.randaugment.
    sample_randaugment_params`` draws them. With ``crop_size`` the input is
    the reflect-padded batch and each sample's window at (top, left) is cut
    inside the kernel. Returns a contiguous (B, H, W, 3) in ``x``'s dtype.
    """
    size = _check(x, pi, pf, crop_size)
    if x.device.type == "cpu":
        return randaugment_mc_plain(x, pi, pf, crop_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b = x.shape[0]
    if b == 0:
        return torch.empty((0, size, size, 3), dtype=x.dtype, device=x.device)
    out = build().randaugment_mc(x, pi.to(x.device).contiguous(),
                                 pf.to(x.device).contiguous(), size,
                                 crop_size is not None)
    randaugment_mc.launches += 1
    return out


randaugment_mc.launches = 0
