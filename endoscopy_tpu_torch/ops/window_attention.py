"""Swin's window attention as a hand-written CUDA kernel, forward and backward.

It replaces no TPU kernel: the JAX package computes the window attention
in einsums (``endoscopy_tpu/models/swin.py``). On the card the plain path
writes every window's float32 logits to device memory, and reads them
back, at each of the scale, the bias, the mask, the softmax and the cast,
and again in the backward. The kernel (``csrc/window_attention.cu``) keeps
each window's 49 x 49 tile on chip from the product to the probabilities'
product with ``v``, and recomputes it in the backward: it is bound by the
bytes of q, k, v, the output, their gradients and two float32 statistics a
row (:func:`bytes_moved`). Its source says how.

:func:`window_attention` is the one entry point, from the ``qkv``
projection's output ``(B·nW, n, 3, heads, hd)`` to the projection's input
``(B·nW, n, heads·hd)``. The rule, by what the input shows:

- a bf16 ``qkv`` on a CUDA device launches the kernel, through
  :class:`_Fused` (an autograd function whose backward is the kernel's
  backward), or raises where the kernel does not take the shape (a window
  over :data:`TILE` tokens, a head width other than :data:`HEAD_DIM`, rows
  not on 16 bytes);
- every other input (a CPU tensor, float32 or float64 on the card) takes
  :func:`window_attention_plain`, the plain PyTorch version, which adds to
  the counter ``swin/window_logit_bytes`` the bytes of the float32 logits it
  materialises.

Each forward and each backward through the kernel adds one to the counter
``window_attention/fused`` (``utils/trace.py``).

``nvcc`` builds the kernel for ``sm_90a`` at first use into a shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout, named by a hash of its source and flags, and ``ctypes`` loads
it. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from endoscopy_tpu_torch.models.layers import attention, wide
from endoscopy_tpu_torch.utils import trace

SRC = Path(__file__).resolve().parent / "csrc" / "window_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
TILE = 64  # the padded window the kernel holds: n <= TILE
HEAD_DIM = 32  # the one head width it takes
# the source's kTile and kHd are TILE and HEAD_DIM, set here alone
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              f"-DkTile={TILE}", f"-DkHd={HEAD_DIM}")
MAX_PER_BLOCK = 8  # windows a block walks at most
# hd^-0.5 as the plain path's float32 multiply takes it
SCALE = ctypes.c_float(HEAD_DIM ** -0.5)

_lib = None
_lib_lock = threading.Lock()


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: torch.Tensor | None) -> torch.Tensor:
    """``softmax(q·kᵀ · hd^-0.5 + bias + mask[w % nW]) · v`` of each window
    and head, by ``models/layers.py::attention``: ``qkv`` (B·nW, n, 3,
    heads, hd), ``bias`` (heads, n, n), ``mask`` (nW, n, n) or None;
    returns (B·nW, n, heads·hd) in ``qkv``'s dtype."""
    bnw, n, _, heads, hd = qkv.shape
    q, k, v = qkv.permute(2, 0, 3, 1, 4)

    def logits(a):
        a = a * hd ** -0.5 + wide(bias)
        if mask is None:
            return a
        nw = mask.shape[0]
        return (a.reshape(bnw // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(bnw, heads, n, n)

    out = attention(q, k, v, logits).transpose(1, 2).reshape(bnw, n,
                                                             heads * hd)
    trace.count("swin/window_logit_bytes", bnw * heads * n * n * 4)
    return out


def takes_kernel(qkv: torch.Tensor) -> bool:
    """The dispatch rule: a bf16 ``qkv`` on a CUDA device."""
    return qkv.is_cuda and qkv.dtype == torch.bfloat16


def check(qkv: torch.Tensor, bias: torch.Tensor,
          mask: torch.Tensor | None) -> None:
    """Raises ValueError where the kernel does not take the arguments."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B·nW, n, 3, heads, hd), got "
                         f"{tuple(qkv.shape)}")
    bnw, n, _, heads, hd = qkv.shape
    if not 0 < n <= TILE:
        raise ValueError(f"a window of {n} tokens is over the kernel's tile "
                         f"of {TILE}")
    if hd != HEAD_DIM:
        raise ValueError(f"the kernel takes a head width of {HEAD_DIM}, not "
                         f"{hd}")
    if tuple(bias.shape) != (heads, n, n):
        raise ValueError(f"bias must be ({heads}, {n}, {n}), got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (mask.ndim != 3 or tuple(mask.shape[1:]) != (n, n)
                             or bnw % mask.shape[0]):
        raise ValueError(f"mask must be (nW, {n}, {n}) with nW dividing "
                         f"{bnw}, got {tuple(mask.shape)}")
    if qkv.stride(4) != 1 or any(s % 8 for s in qkv.stride()[:4]) or \
            qkv.data_ptr() % 16:
        raise ValueError("the kernel reads qkv's rows by 16 bytes: the head "
                         "axis contiguous, the other strides multiples of 8 "
                         f"elements, the start on 16 bytes; got strides "
                         f"{qkv.stride()}")


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor | None) -> torch.Tensor:
    """The window attention of ``qkv`` (B·nW, n, 3, heads, hd) with the
    dense ``bias`` (heads, n, n) and the shift ``mask`` (nW, n, n) or None,
    window ``w`` taking ``mask[w % nW]``: (B·nW, n, heads·hd) in ``qkv``'s
    dtype, by the kernel or the plain path (the module's rule)."""
    if not takes_kernel(qkv):
        return window_attention_plain(qkv, bias, mask)
    bias = wide(bias).contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    check(qkv, bias, mask)
    return _Fused.apply(qkv, bias, mask)


class _Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, mask):
        out, stats = _forward(qkv, bias, mask)
        ctx.save_for_backward(qkv, bias, mask, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask, stats = ctx.saved_tensors
        dqkv, dbias = _backward(qkv, bias, mask, stats, dout)
        return dqkv, dbias, None


def per_block(bnw: int, period: int) -> int:
    """Windows a block walks, all at one window position: up to
    :data:`MAX_PER_BLOCK`, fewer where the batch has fewer."""
    return max(1, min(MAX_PER_BLOCK, bnw // period))


def _launch_args(qkv, mask):
    bnw, n, _, heads, _ = qkv.shape
    period = 1 if mask is None else mask.shape[0]
    return bnw, n, heads, period, per_block(bnw, period)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"window attention {what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _forward(qkv, bias, mask):
    bnw, n, heads, period, ipb = _launch_args(qkv, mask)
    out = torch.empty((bnw, n, heads * HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    stats = torch.empty((bnw, heads, n, 2), dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = library().window_attention_forward(
            _ptr(qkv), *qkv.stride()[:4], _ptr(bias), _ptr(mask), _ptr(out),
            _ptr(stats), bnw, n, heads, period, ipb, SCALE, _stream(qkv))
    _raise_on(err, "forward")
    trace.count("window_attention/fused")
    return out, stats


def _backward(qkv, bias, mask, stats, dout):
    bnw, n, heads, period, ipb = _launch_args(qkv, mask)
    if not dout.is_contiguous() or dout.data_ptr() % 16:
        dout = dout.clone(memory_format=torch.contiguous_format)
    grid_x = period * -(-(bnw // period) // ipb)
    dqkv = torch.empty((bnw, n, 3, heads, HEAD_DIM), dtype=qkv.dtype,
                       device=qkv.device)
    part = torch.empty((heads, grid_x, n, n), dtype=torch.float32,
                       device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = library().window_attention_backward(
            _ptr(qkv), *qkv.stride()[:4], _ptr(dout), _ptr(bias), _ptr(mask),
            _ptr(stats), _ptr(dqkv), _ptr(part), bnw, n, heads, period, ipb,
            SCALE, _stream(qkv))
    _raise_on(err, "backward")
    trace.count("window_attention/fused")
    return dqkv, part.sum(1)


def bytes_moved(bnw: int, n: int, heads: int) -> int:
    """Device-memory bytes the kernel's forward and backward need at least,
    each read once: the forward's q, k and v in and the output and the
    rows' statistics out; the backward's q, k, v, the output's gradient and
    the statistics in and d(qkv) out. The bias, the mask and the bias
    gradient (under a thousandth at Swin-T's shapes) are left out."""
    tile = bnw * heads * n * HEAD_DIM * 2
    stats = bnw * heads * n * 2 * 4
    return 11 * tile + 2 * stats


# -- the build -----------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the window-attention "
                           "kernel is built with its nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """The built library for the current source, built now if missing."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libwindow_attention-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "window_attention.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, str(SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SRC.name} failed:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The kernel's library, built and loaded once a process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            f = ctypes.c_float
            for name, args in (
                    ("forward", [p, ll, ll, ll, ll] + [p] * 4 + [i] * 5 + [f, p]),
                    ("backward", [p, ll, ll, ll, ll] + [p] * 6 + [i] * 5
                     + [f, p]),
                    ("smem", [i, i, i]), ("regs", [i])):
                fn = getattr(lib, f"window_attention_{name}")
                fn.argtypes, fn.restype = args, i
            _lib = lib
    return _lib
