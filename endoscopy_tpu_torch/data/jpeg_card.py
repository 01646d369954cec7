"""JPEG decode, resize and encode on the card: the JPEG route of the port's
native loader under ``device='cuda'``.

On the CPU the native loader decodes with libjpeg (``data/csrc/loader.cpp``,
bit for bit the JAX package's core). The card's machine has no libjpeg, and
the decoded pixels are wanted on the card anyway, so there the route is:

- **decode**: nvJPEG (the CUDA toolkit's ``libnvjpeg``) decodes each file's
  bytes to interleaved RGB in device memory, on the caller's device and
  current stream, with one fixed backend (:data:`BACKEND`). This is a
  library call in the place of libjpeg, which is host code in the JAX
  package, not a TPU kernel. Its pixels are not libjpeg's (another IDCT
  and chroma upsampling): they are held to the JAX package's own bound for
  a second decoder, a mean |Δ| below :data:`DECODE_MEAN_LSB` per image
  against libjpeg's decode (``tests/test_native_loader.py``);
- **resize**: :func:`resize_bilinear`, a kernel written by hand
  (``data/csrc/jpeg_card.cu``): the core's ``resize_bilinear`` with one
  thread per output pixel, the C++ code's float32 operations in their
  order, so it gives the core's bytes exactly from the same decoded pixels.
  :func:`resize_bilinear_plain` is its plain PyTorch version: the CPU tests
  and ``chip_smoke.py`` hold the kernel against it, and nothing on the
  card's path calls it. Each launch adds one to
  ``resize_bilinear.launches``;
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

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels" / "jpeg_card"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-Xptxas=-v")
# nvjpegBackend_t values
BACKENDS = {"default": 0, "hybrid": 1, "gpu_hybrid": 2, "hardware": 3}
# The backend of every decoder: host Huffman decoding, the IDCT and colour
# conversion on the card, through nvjpegDecode (the probe of path O0 of
# chip_smoke.py decodes a file with each backend and prints which can).
BACKEND = "hybrid"
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


def pack(images: Sequence[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(flat, offsets, hw)`` of ``(h, w, 3)`` uint8 images on one device:
    the layout the resize takes (the decode returns it)."""
    dev = images[0].device if images else torch.device("cpu")
    sizes = [int(im.numel()) for im in images]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) \
        if images else np.zeros(0, np.int64)
    flat = (torch.cat([im.contiguous().view(-1) for im in images]) if images
            else torch.zeros(1, dtype=torch.uint8, device=dev))
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
    3)`` uint8, image ``i`` the ``hw[i]`` RGB rows at ``flat[offsets[i]:]``
    (an image with a side below 2 gives zeros)."""
    out = []
    for off, (h, w) in zip(offsets.tolist(), hw.tolist()):
        img = flat[off:off + h * w * 3].view(h, w, 3) if h >= 2 and w >= 2 \
            else flat.new_zeros((h, w, 3))
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
    out = build().resize(flat, offsets.to(flat.device, torch.int64).contiguous(),
                         hw.to(flat.device, torch.int32).contiguous(), int(size))
    resize_bilinear.launches += 1
    return out


resize_bilinear.launches = 0


# -- decode and encode --------------------------------------------------------


def decode_raw(payloads: Sequence[bytes], device=None, threads: int = 1):
    """nvJPEG's decode of each payload at its own size, on the card, by
    ``threads`` host threads (nvJPEG's host part, the Huffman decode of
    :data:`BACKEND`, runs on them): ``(flat, offsets, hw, statuses)``
    (:func:`pack`'s layout; a payload that does not decode has ``(0, 0)``
    and its ``nvjpegStatus_t``). Raises on a status that no file can
    cause."""
    dev = _card(device)
    flat, offsets, hw, status = build().decode(
        [bytes(p) for p in payloads], dev.index, int(threads))
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


def decode_some(payloads: Sequence[bytes], size: int, device=None,
                threads: int = 1) -> Tuple[torch.Tensor, List[bool]]:
    """Like :func:`decode_bytes`, but a payload that does not decode gives
    a row of zeros and ``False`` in the second result."""
    size = int(size)
    if not payloads:
        return (torch.zeros((0, size, size, 3), dtype=torch.uint8,
                            device=_card(device)), [])
    flat, offsets, hw, status = decode_raw(payloads, device, threads)
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


def probe_backends(payloads: Sequence[bytes], device=None,
                   repeats: int = 3) -> dict:
    """For each nvJPEG backend, a decoder of its own decoding ``payloads``
    ``repeats`` times on one thread: ``(creation status, decode status,
    seconds of the last pass)`` (status 0 is success)."""
    dev = _card(device)
    ext = build()
    data = [bytes(p) for p in payloads]
    return {name: tuple(ext.probe(code, data, dev.index, int(repeats)))
            for name, code in BACKENDS.items()}
