"""JPEG decode, resize and encode on the card: the JPEG route of the port's
native loader under ``device='cuda'``.

On the CPU the native loader decodes with libjpeg (``data/csrc/loader.cpp``,
bit for bit the JAX package's core). The card's machine has no libjpeg, and
the decoded pixels are wanted on the card anyway, so there the route is:

- **decode**: nvJPEG (the CUDA toolkit's ``libnvjpeg``) decodes a batch
  of files' bytes to interleaved RGB in device memory in one
  ``nvjpegDecodeBatched`` call, on the caller's device and current stream,
  with one fixed backend (:data:`BACKEND`), into one flat buffer whose
  offsets and row pitches are multiples of :data:`ALIGN` bytes
  (:func:`row_pitch`). This is a library call in the place of libjpeg,
  which is host code in the JAX package, not a TPU kernel. Its pixels are
  not libjpeg's (another IDCT and chroma upsampling): they are held to the
  JAX package's own bound for a second decoder, a mean |Δ| below
  :data:`DECODE_MEAN_LSB` per image against libjpeg's decode
  (``tests/test_native_loader.py``);
- **resize**: :func:`resize_bilinear`, a kernel written by hand
  (``data/csrc/jpeg_card.cu``): the core's ``resize_bilinear``, one block
  per image and band of output rows, its axis tables computed once per
  block, its source rows staged in shared memory by 16-byte copies and its
  output written by 16-byte stores, the C++ code's float32 operations in
  their order, so it gives the core's bytes exactly from the same decoded
  pixels. :func:`resize_bilinear_plain` is its plain PyTorch version: the CPU tests
  and ``chip_smoke.py`` hold the kernel against it, and nothing on the
  card's path calls it. Each launch adds one to the counter
  ``jpeg/resize_launches`` and is the span ``jpeg/resize``
  (``utils/trace.py``);
- **encode**: :func:`write_jpeg`, nvJPEG's encoder at quality 92 with 4:2:0
  chroma, the JAX generator's settings, for ``data/synthetic.py``.

``torch.utils.cpp_extension.load`` builds ``data/csrc/jpeg_card.{cpp,cu}``
for ``sm_90a`` at first use into ``build/kernels/jpeg_card/``, linked with
``-lnvjpeg``. There is no fallback: without CUDA every entry point raises,
and a failed build raises with nvcc's output.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from endoscopy_tpu_torch.utils import trace

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels" / "jpeg_card"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-Xptxas=-v")
# nvjpegBackend_t values
BACKENDS = {"default": 0, "hybrid": 1, "gpu_hybrid": 2, "hardware": 3}
# The backend of every decoder, the fastest batched decode of path O0's
# probe (chip_smoke.py: one nvjpegDecodeBatched call on copies of a 160 px
# fixture file; on an NVIDIA H100 80GB HBM3 at 700 W, nvJPEG 12.4). At 224
# images gpu_hybrid 5.5-6.2 ms (Huffman decoding on the card), hybrid
# 33.2-49.4, default 31.7-53.0. At 32 and at 1 no backend leads: 4.8-8.4 ms
# and 0.25-0.40 ms for each of the three (one nvjpegDecode of 1:
# 0.23-0.41). hardware is refused at creation with status 7.
BACKEND = "gpu_hybrid"
# the decoded batch's offsets and row pitches are multiples of ALIGN bytes
ALIGN = 16
JPEG_QUALITY = 92  # the JAX generator's cv2.IMWRITE_JPEG_QUALITY
# the JAX package's bound for a second decoder against libjpeg's pixels
DECODE_MEAN_LSB = 4.0
# nvjpegStatus_t of a payload that is not a JPEG nvJPEG decodes (invalid
# parameter, bad JPEG, not supported, incomplete bitstream): the loaders
# skip or refuse such a file; any other status raises
BAD_INPUT = frozenset({2, 3, 4, 10})

_ext = None
_ext_lock = threading.Lock()


def build(verbose: bool = False):
    """Build (once per source and flag set) and load the extension, with
    the decoders' backend fixed at :data:`BACKEND`."""
    global _ext
    with _ext_lock:
        if _ext is None:
            from torch.utils import cpp_extension

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            ext = cpp_extension.load(
                name="endoscopy_jpeg_card",
                sources=[str(_CSRC / "jpeg_card.cpp"),
                         str(_CSRC / "jpeg_card.cu")],
                extra_cflags=["-O3"], extra_cuda_cflags=list(NVCC_FLAGS),
                extra_ldflags=["-lnvjpeg"],
                build_directory=str(BUILD_DIR), verbose=verbose)
            ext.init(BACKENDS[BACKEND])
            _ext = ext
    return _ext


def _card(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the card's JPEG route runs on a CUDA device, not "
                         f"{dev}; the CPU's is data/native_loader.py (libjpeg)")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the card's JPEG route "
                           "(nvJPEG) needs a card; pass device='cpu' to "
                           "decode with libjpeg on the host")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


# -- the resize kernel and its plain version ---------------------------------


def row_pitch(w: int) -> int:
    """The bytes between two rows of a ``w``-pixel RGB image in a decoded
    batch: ``3 w`` rounded up to :data:`ALIGN`."""
    return -(-3 * int(w) // ALIGN) * ALIGN


def pack(images: Sequence[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(flat, offsets, hw)`` of ``(h, w, 3)`` uint8 images on one device,
    in the decoded batch's layout (the decode returns it; the resize takes
    it): image ``i``'s rows ``row_pitch(w)`` bytes apart from
    ``flat[offsets[i]:]``, every offset a multiple of :data:`ALIGN`, the
    padding zeros."""
    dev = images[0].device if images else torch.device("cpu")
    rows = []
    for im in images:
        h, w = int(im.shape[0]), int(im.shape[1])
        padded = im.new_zeros((h, row_pitch(w)))
        padded[:, :3 * w] = im.reshape(h, 3 * w)
        rows.append(padded.view(-1))
    sizes = [int(r.numel()) for r in rows]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) \
        if images else np.zeros(0, np.int64)
    flat = (torch.cat(rows) if rows else
            torch.zeros(ALIGN, dtype=torch.uint8, device=dev))
    hw = torch.tensor([[im.shape[0], im.shape[1]] for im in images],
                      dtype=torch.int32).view(-1, 2)
    return flat, torch.from_numpy(offsets).to(dev), hw.to(dev)


def _resize_one(img: torch.Tensor, size: int) -> torch.Tensor:
    """``data/csrc/loader.cpp::resize_bilinear`` of one ``(h, w, 3)`` uint8
    image: the same float32 operations in the same order, each rounded on
    its own (PyTorch runs each as its own kernel: nothing is fused)."""
    sh, sw = int(img.shape[0]), int(img.shape[1])
    if sh < 2 or sw < 2:
        return torch.zeros((size, size, 3), dtype=torch.uint8,
                           device=img.device)
    f32 = dict(dtype=torch.float32, device=img.device)

    def axis(n_src: int):
        scale = torch.tensor(float(n_src), **f32) / torch.tensor(float(size),
                                                                  **f32)
        f = (torch.arange(size, **f32) + 0.5) * scale - 0.5
        i0 = torch.where(f < 0, torch.zeros_like(f),
                         f).to(torch.int64).clamp_max(n_src - 2)
        w = f - i0.to(torch.float32)
        return i0, torch.where(w < 0, torch.zeros_like(w), w)

    y0, wy = axis(sh)
    x0, wx = axis(sw)
    src = img.to(torch.float32)
    p00 = src[y0][:, x0]
    p01 = src[y0][:, x0 + 1]
    p10 = src[y0 + 1][:, x0]
    p11 = src[y0 + 1][:, x0 + 1]
    wx3, wy3 = wx.view(1, -1, 1), wy.view(-1, 1, 1)
    top = p00 * (1 - wx3) + p01 * wx3
    bot = p10 * (1 - wx3) + p11 * wx3
    v = top * (1 - wy3) + bot * wy3
    return (v + 0.5).to(torch.int32).to(torch.uint8)


def resize_bilinear_plain(flat: torch.Tensor, offsets: torch.Tensor,
                          hw: torch.Tensor, size: int) -> torch.Tensor:
    """The plain PyTorch version of the resize kernel: ``(N, size, size,
    3)`` uint8, image ``i`` the ``hw[i]`` RGB rows at ``flat[offsets[i]:]``,
    ``row_pitch(w)`` bytes apart (an image with a side below 2 gives
    zeros)."""
    out = []
    for off, (h, w) in zip(offsets.tolist(), hw.tolist()):
        if h >= 2 and w >= 2:
            pitch = row_pitch(w)
            img = flat[off:off + h * pitch].view(h, pitch)[:, :3 * w]
            img = img.reshape(h, w, 3)
        else:
            img = flat.new_zeros((h, w, 3))
        out.append(_resize_one(img, size))
    if not out:
        return flat.new_zeros((0, size, size, 3))
    return torch.stack(out)


def resize_bilinear(flat: torch.Tensor, offsets: torch.Tensor,
                    hw: torch.Tensor, size: int) -> torch.Tensor:
    """The resize of a decoded batch to ``(N, size, size, 3)`` uint8: the
    kernel for CUDA tensors, the plain version for tensors on the CPU."""
    if flat.device.type == "cpu":
        return resize_bilinear_plain(flat, offsets, hw, size)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    with trace.span("jpeg/resize"):
        out = build().resize(
            flat, offsets.to(flat.device, torch.int64).contiguous(),
            hw.to(flat.device, torch.int32).contiguous(), int(size))
    trace.count("jpeg/resize_launches")
    return out


# -- decode and encode --------------------------------------------------------


def decode_raw(payloads, device=None, lengths: Sequence[int] | None = None):
    """nvJPEG's decode of the payloads at their own sizes, on the card, in
    one ``nvjpegDecodeBatched`` call: ``(flat, offsets, hw, statuses)``
    (:func:`pack`'s layout; a payload that does not decode has ``(0, 0)``
    and its ``nvjpegStatus_t``). ``payloads`` is a sequence of bytes or,
    with ``lengths``, one uint8 array holding them one after another. A
    payload whose header does not parse, or that has no scan, is left out
    of the call; if the
    call fails on its input, each of its payloads is decoded again alone on
    the card to find which fail. Raises on a status that no input
    explains. The call is the span ``jpeg/decode``; the counters
    ``jpeg/decode_calls``, ``jpeg/payloads`` and ``jpeg/redecodes`` count
    the calls, their payloads and the payloads decoded again."""
    dev = _card(device)
    with trace.span("jpeg/decode"):
        if lengths is None:
            lengths = [len(p) for p in payloads]
            payloads = np.frombuffer(b"".join(payloads), np.uint8).copy()
        data = torch.from_numpy(np.ascontiguousarray(payloads, np.uint8))
        flat, offsets, hw, status, redecoded = build().decode(
            data, [int(v) for v in lengths], dev.index)
    trace.count("jpeg/decode_calls")
    trace.count("jpeg/payloads", len(lengths))
    trace.count("jpeg/redecodes", redecoded)
    wrong = {s for s in status if s and s not in BAD_INPUT}
    if wrong:
        raise RuntimeError(f"nvJPEG failed with status {sorted(wrong)}, which "
                           "no input file explains")
    return flat, offsets, hw, status


def decode_bytes(payloads: Sequence[bytes], size: int, device=None,
                 names: Sequence[str] | None = None) -> torch.Tensor:
    """``(len(payloads), size, size, 3)`` uint8 on the card: each JPEG
    payload decoded by nvJPEG and resized by the kernel. Raises naming the
    payloads that do not decode (``names`` names them)."""
    out, ok = decode_some(payloads, size, device)
    if not all(ok):
        bad = [i for i, k in enumerate(ok) if not k]
        label = [str(names[i]) if names is not None else f"payload {i}"
                 for i in bad[:4]]
        raise RuntimeError(f"nvJPEG could not decode {len(bad)} of "
                           f"{len(payloads)} image(s): {label}")
    return out


def decode_some(payloads, size: int, device=None,
                lengths: Sequence[int] | None = None
                ) -> Tuple[torch.Tensor, List[bool]]:
    """Like :func:`decode_bytes`, but a payload that does not decode gives
    a row of zeros and ``False`` in the second result. ``payloads`` and
    ``lengths`` as :func:`decode_raw` takes them."""
    size = int(size)
    if not len(payloads if lengths is None else lengths):
        return (torch.zeros((0, size, size, 3), dtype=torch.uint8,
                            device=_card(device)), [])
    flat, offsets, hw, status = decode_raw(payloads, device, lengths)
    return resize_bilinear(flat, offsets, hw, size), [s == 0 for s in status]


def read_files(paths: Sequence[str]) -> List[bytes]:
    """Each file's bytes; an unreadable file gives ``b""``, which does not
    decode."""
    out = []
    for p in paths:
        try:
            out.append(Path(p).read_bytes())
        except OSError:
            out.append(b"")
    return out


def decode_files(paths: Sequence[str], size: int, device=None) -> torch.Tensor:
    """:func:`decode_bytes` of the files at ``paths``, in order. Raises
    naming the files that cannot be read or decoded."""
    return decode_bytes(read_files(paths), size, device,
                        names=[str(p) for p in paths])


def write_jpeg(path: str, rgb, device=None) -> None:
    """Encode an ``(h, w, 3)`` uint8 RGB image (numpy or a tensor) with
    nvJPEG on the card at :data:`JPEG_QUALITY`, 4:2:0, to a file."""
    dev = _card(device)
    x = torch.as_tensor(np.ascontiguousarray(rgb, dtype=np.uint8)
                        if isinstance(rgb, np.ndarray) else rgb)
    if x.dtype != torch.uint8 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"write_jpeg wants (h, w, 3) uint8, got "
                         f"{x.dtype} {tuple(x.shape)}")
    data = build().encode(x.to(dev).contiguous(), JPEG_QUALITY)
    Path(path).write_bytes(data)


def version() -> Tuple[int, int, int]:
    """nvJPEG's (major, minor, patch)."""
    return tuple(build().version())


def probe_backends(payloads: Sequence[bytes], device=None, repeats: int = 3,
                   batched: bool = True) -> dict:
    """For each nvJPEG backend, a decoder of its own decoding ``payloads``
    ``repeats`` times, as one batch in one ``nvjpegDecodeBatched`` call or,
    with ``batched`` false, one ``nvjpegDecode`` call a payload: ``(creation
    status, decode status, seconds of the last repeat)`` (status 0 is
    success)."""
    dev = _card(device)
    ext = build()
    data = [bytes(p) for p in payloads]
    return {name: tuple(ext.probe(code, data, dev.index, int(repeats),
                                  bool(batched)))
            for name, code in BACKENDS.items()}
