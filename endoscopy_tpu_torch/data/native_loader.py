"""ctypes bindings for the native C++ loader core (port of
``endoscopy_tpu/data/native_loader.py``).

The core, ``data/csrc/loader.cpp``, is this package's own copy of the JAX
package's: a C++ thread pool (fread → libjpeg decode → bilinear resize)
fills a bounded queue of canonical uint8 images, and Python drains whole
batches through one ctypes call. Shuffle semantics are the reference's
RandomSampler-with-recycling contract: reshuffled epochs, wrap-around
fixed-size batches. The same files and seed give the JAX loader's pixels
and index stream.

Every entry point takes ``device`` (``cuda`` by default; without CUDA it
raises unless ``cpu`` is asked for):

- ``cpu``: the libjpeg core, as above; batches are numpy arrays.
- ``cuda``: the same core built without libjpeg (``-DENDO_BYTES_ONLY``):
  its threads read the files and hand out their bytes in the same index
  stream, and ``data/jpeg_card.py`` decodes them with nvJPEG and resizes
  them with its kernel on the card. Batches are uint8 CUDA tensors of the
  CPU route's shape, order and targets; a prefetch thread decodes the
  next batch on a stream of its own while the caller uses this one. The
  pixels are nvJPEG's (``jpeg_card.DECODE_MEAN_LSB`` from libjpeg's); the
  resize is the core's, bit for bit. libjpeg never runs there.

The core is built at first use with ``g++ -O3 -shared -fPIC -std=c++17
... -ljpeg -lpthread`` (or ``-DENDO_BYTES_ONLY ... -lpthread``) into
``build/native/`` under the repository's root, one library per hash of
the source and the switch (a changed source builds anew). The build
writes a temporary file and renames it, under a file lock, so processes
that build at once (test workers, ``torchrun`` ranks) do not race. A
failed build raises with the compiler's output: there is no fallback to
the cv2 loaders.

Selected by ``DATA.LOADER: 'native'`` (``cli/learn.py::build_data``).
:func:`decode_files` decodes a list of files in order (the core on the
CPU, ``jpeg_card`` on the card), for the validation loader
(``data/pipeline.py``); :func:`write_jpeg` encodes with libjpeg for the
synthetic dataset (``data/synthetic.py``).

Corrupt-input contract (as in the JAX package): the infinite prefetch
stream cannot raise from a C++ worker, so unreadable or undecodable files
are skipped to keep batches fixed-shape, a RuntimeWarning reports the
running skip count, and an all-corrupt manifest raises instead of
blocking. ``sample()`` and :func:`decode_files` always raise on
undecodable rows: specific-row requests cannot be substituted.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from endoscopy_tpu_torch.data.manifest import Manifest
from endoscopy_tpu_torch.device import resolve_device
from endoscopy_tpu_torch.utils import trace

SRC_PATH = Path(__file__).resolve().parent / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
BUILD_CMD = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_LIBS = ("-ljpeg", "-lpthread")
# the bytes-only core of the card's route: no libjpeg
BYTES_ONLY_FLAGS = ("-DENDO_BYTES_ONLY",)
BYTES_ONLY_LIBS = ("-lpthread",)
JPEG_QUALITY = 92  # the JAX generator's cv2.IMWRITE_JPEG_QUALITY

_libs: dict = {}
_lib_lock = threading.Lock()


def library_path(bytes_only: bool = False) -> Path:
    """Where the core for the current source and switch lives (built or
    not)."""
    digest = hashlib.sha256(SRC_PATH.read_bytes()
                            + b"bytes_only" * bytes_only).hexdigest()[:16]
    kind = "bytes-" if bytes_only else ""
    return BUILD_DIR / f"libendoloader-{kind}{digest}.so"


def build_library(bytes_only: bool = False) -> Path:
    """The built core for the current source, built now if it is missing:
    with libjpeg, or with ``bytes_only`` the core that only reads files.
    Raises RuntimeError with the compiler's output when the build fails."""
    so = library_path(bytes_only)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while we waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        flags, libs = ((BYTES_ONLY_FLAGS, BYTES_ONLY_LIBS) if bytes_only
                       else ((), BUILD_LIBS))
        cmd = [*BUILD_CMD, *flags, str(SRC_PATH), "-o", str(tmp), *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(
                f"native loader: the C++ compiler {BUILD_CMD[0]!r} is not "
                "installed; the core needs g++ and libjpeg's headers "
                "(jpeglib.h) and library") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            needs = ("" if bytes_only else " (it needs libjpeg's headers, "
                     "jpeglib.h, and its library)")
            raise RuntimeError(
                f"native loader: building {SRC_PATH} failed{needs}:\n"
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    return so


_P = ctypes.POINTER


def _load_lib(bytes_only: bool = False) -> ctypes.CDLL:
    with _lib_lock:
        if bytes_only in _libs:
            return _libs[bytes_only]
        lib = ctypes.CDLL(str(build_library(bytes_only)))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        lib.loader_next.restype = None
        lib.loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
        lib.loader_dropped.restype = ctypes.c_int64
        lib.loader_dropped.argtypes = [ctypes.c_void_p]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.loader_next_bytes.restype = ctypes.c_int64
        lib.loader_next_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_int, _P(ctypes.c_int64),
            _P(ctypes.c_int64)]
        lib.loader_copy_bytes.restype = None
        lib.loader_copy_bytes.argtypes = [ctypes.c_void_p, _P(ctypes.c_uint8)]
        if not bytes_only:
            lib.jpeg_write_rgb.restype = ctypes.c_int
            lib.jpeg_write_rgb.argtypes = [
                ctypes.c_char_p, _P(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.jpeg_decode_rgb.restype = ctypes.c_int
            lib.jpeg_decode_rgb.argtypes = [
                _P(ctypes.c_uint8), ctypes.c_int64, _P(ctypes.c_uint8),
                ctypes.c_int64, _P(ctypes.c_int), _P(ctypes.c_int)]
        _libs[bytes_only] = lib
        return lib


_WRITE_ERRORS = {1: "cannot open the file", 2: "libjpeg failed",
                 3: "cannot write the whole file"}


def write_jpeg(path: str, rgb: np.ndarray) -> None:
    """Encode an ``(h, w, 3)`` uint8 RGB image to a JPEG file at
    ``JPEG_QUALITY``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_jpeg wants (h, w, 3), got {rgb.shape}")
    rc = _load_lib().jpeg_write_rgb(
        str(path).encode(),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rgb.shape[0], rgb.shape[1], JPEG_QUALITY)
    if rc:
        raise OSError(f"jpeg_write_rgb({path}): "
                      f"{_WRITE_ERRORS.get(rc, f'error {rc}')}")


def decode_rgb(data: bytes) -> np.ndarray:
    """libjpeg's decode of one JPEG at its own size, ``(h, w, 3)`` uint8
    RGB, with no resize (the pixels the core resizes). Raises ValueError
    when libjpeg fails."""
    lib = _load_lib()
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    out = np.empty(0, np.uint8)
    for _ in range(2):  # the first call learns the size
        rc = lib.jpeg_decode_rgb(buf.ctypes.data_as(_P(ctypes.c_uint8)),
                                 len(buf), out.ctypes.data_as(
                                     _P(ctypes.c_uint8)), out.size,
                                 ctypes.byref(h), ctypes.byref(w))
        if rc == 1:
            raise ValueError("libjpeg could not decode the payload")
        if rc == 0:
            return out[:h.value * w.value * 3].reshape(h.value, w.value, 3)
        out = np.empty(h.value * w.value * 3, np.uint8)
    raise RuntimeError(f"jpeg_decode_rgb returned {rc}")


class _Handle:
    """Owns one C++ Loader instance (the bytes-only core with
    ``bytes_only``)."""

    def __init__(self, paths, size: int, num_threads: int, queue_depth: int,
                 seed: int, shuffle: bool, bytes_only: bool = False) -> None:
        self._ptr = None
        self._lib = _load_lib(bytes_only)
        arr = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        self._keepalive = arr  # paths are copied in C++, but keep anyway
        self._ptr = self._lib.loader_create(
            arr, len(paths), size, num_threads, queue_depth,
            ctypes.c_uint64(seed), 1 if shuffle else 0)
        self.size = size

    def next(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        imgs = np.empty((n, self.size, self.size, 3), np.uint8)
        idx = np.empty(n, np.int64)
        self._lib.loader_next(
            self._ptr, n,
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return imgs, idx

    def next_buffer(self, n: int):
        """The bytes-only core's next ``n`` files, one after another in one
        uint8 array: ``(buffer, lengths, indices)`` (index -1: the
        all-unreadable sentinel)."""
        idx = np.empty(n, np.int64)
        lengths = np.empty(n, np.int64)
        total = self._lib.loader_next_bytes(
            self._ptr, n, idx.ctypes.data_as(_P(ctypes.c_int64)),
            lengths.ctypes.data_as(_P(ctypes.c_int64)))
        buf = np.empty(max(int(total), 1), np.uint8)
        self._lib.loader_copy_bytes(self._ptr,
                                    buf.ctypes.data_as(_P(ctypes.c_uint8)))
        return buf, lengths, idx

    def dropped(self) -> int:
        """Files the C++ core skipped as unreadable/undecodable so far."""
        return int(self._lib.loader_dropped(self._ptr))

    def close(self) -> None:
        if self._ptr is not None:
            self._lib.loader_destroy(self._ptr)
            self._ptr = None

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        self.close()


def decode_files(paths: Sequence[str], size: int, device=None):
    """``(len(paths), size, size, 3)`` uint8 canonical images of ``paths``,
    in order. On the CPU a transient single-thread, non-shuffled core
    decodes exactly these files (a numpy array); on the card
    ``jpeg_card.decode_files`` (a CUDA tensor). Raises naming the files it
    could not decode."""
    dev = resolve_device(device)
    paths = list(paths)
    if dev.type == "cuda":
        from endoscopy_tpu_torch.data import jpeg_card
        imgs, ok = jpeg_card.decode_some(jpeg_card.read_files(paths), size,
                                         dev)
        missing = [i for i, k in enumerate(ok) if not k]
        if missing:
            bad = [str(paths[m]) for m in missing[:4]]
            raise RuntimeError(
                f"native loader could not decode {len(missing)}"
                f" of {len(paths)} sampled image(s): {bad}")
        return imgs
    if not paths:
        return np.zeros((0, size, size, 3), np.uint8)
    tmp = _Handle(paths, int(size), 1, len(paths), 0, shuffle=False)
    try:
        imgs, got = tmp.next(len(paths))
        dropped = tmp.dropped()
    finally:
        tmp.close()
    if dropped > 0 or (got < 0).any() or len(np.unique(got)) != len(paths):
        missing = sorted(set(range(len(paths))) -
                         set(g for g in got.tolist() if g >= 0))
        bad = [str(paths[m]) for m in missing[:4]]
        raise RuntimeError(
            f"native loader could not decode {len(missing)}"
            f" of {len(paths)} sampled image(s): {bad}")
    out = np.empty_like(imgs)
    out[got] = imgs
    return out


class _CardStream:
    """The card's batches: the bytes-only core's files in its index
    stream, decoded by nvJPEG in one batched call and resized on the card,
    undecodable files skipped (the next files of the stream take
    their places, as the libjpeg core's workers skip them). Each batch is
    decoded on a CUDA stream of its own by a prefetch thread, one batch
    ahead. Spans: ``jpeg/batch`` on the prefetch thread, with
    ``jpeg/read`` (the core's bytes) and ``jpeg_card``'s ``jpeg/decode``
    and ``jpeg/resize`` inside; ``loader/prefetch_wait`` on the caller's
    thread, waiting for the batch."""

    def __init__(self, handle: "_Handle", n_paths: int, size: int,
                 device: torch.device) -> None:
        self._handle = handle
        self._n_paths = n_paths
        self._size = size
        self._device = device
        self._stream = torch.cuda.Stream(device)
        self._skipped = 0  # undecodable on the card
        self._streak = 0  # failures since the last decoded file
        self._pool = ThreadPoolExecutor(1)
        self._pending = None  # the next batch, decoding

    def _batch(self, n: int):
        from endoscopy_tpu_torch.data import jpeg_card

        with trace.span("jpeg/batch"):
            parts, indices = [], []
            with torch.cuda.stream(self._stream):
                while n:
                    dropped = self._handle.dropped()
                    with trace.span("jpeg/read"):
                        buf, lengths, idx = self._handle.next_buffer(n)
                    if (idx < 0).any():  # a full pass read nothing
                        return None
                    imgs, ok = jpeg_card.decode_some(buf, self._size,
                                                     self._device, lengths)
                    self._streak += self._handle.dropped() - dropped
                    for k in ok:
                        self._streak = 0 if k else self._streak + 1
                    if self._streak >= self._n_paths:
                        return None
                    keep = [i for i, k in enumerate(ok) if k]
                    self._skipped += len(ok) - len(keep)
                    if len(keep) < len(ok):
                        imgs = imgs[torch.tensor(keep, dtype=torch.long,
                                                 device=self._device)]
                    parts.append(imgs)
                    indices.append(idx[keep])
                    n -= len(keep)
                out = parts[0] if len(parts) == 1 else torch.cat(parts)
                done = torch.cuda.Event()
                done.record(self._stream)
            return out, np.concatenate(indices), done

    def batches(self, n: int) -> Iterator:
        """``(imgs, indices)`` forever; None once a full pass decoded
        nothing. The batch in flight belongs to the stream, not to the
        iterator, so a new iterator (a new epoch) takes it next: the
        stream's order is the CPU route's whatever the iterators."""
        while True:
            if self._pending is None:
                self._pending = self._pool.submit(self._batch, n)
            with trace.span("loader/prefetch_wait"):
                got = self._pending.result()
            if got is None:
                yield None
                return
            self._pending = self._pool.submit(self._batch, n)
            imgs, idx, done = got
            current = torch.cuda.current_stream(self._device)
            current.wait_event(done)
            imgs.record_stream(current)
            yield imgs, idx

    def dropped(self) -> int:
        return self._handle.dropped() + self._skipped

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class NativeCanonicalLoader:
    """Drop-in CanonicalLoader with the C++ decode core.

    Same contract as ``data.pipeline.CanonicalLoader``: infinite shuffled
    ``(imgs_u8, targets)`` batches plus ``sample(indices)`` random access.
    On ``device='cpu'`` the images are numpy arrays decoded by libjpeg; on
    the card (the default) uint8 CUDA tensors decoded by nvJPEG
    (module docstring), the targets numpy in both.
    """

    def __init__(self, manifest: Manifest, batch_size: int, size: int,
                 seed: int = 0, num_threads: int = 2, shuffle: bool = True,
                 queue_depth: Optional[int] = None, device=None) -> None:
        self.device = resolve_device(device)
        self.manifest = manifest
        self.batch_size = int(batch_size)
        self.size = int(size)
        self._num_threads = max(1, int(num_threads))
        depth = queue_depth or max(2 * self.batch_size, 64)
        card = self.device.type == "cuda"
        self._handle = _Handle(manifest.paths, self.size, self._num_threads,
                               depth, int(seed), shuffle, bytes_only=card)
        self._card = (_CardStream(self._handle, len(manifest), self.size,
                                  self.device) if card else None)

    def _stream(self):
        """``(imgs, indices)`` batches; None once a full pass decoded
        nothing."""
        if self._card is not None:
            yield from self._card.batches(self.batch_size)
            return
        while True:
            imgs, idx = self._handle.next(self.batch_size)
            if (idx < 0).any():  # C++ sentinel: a full pass decoded nothing
                yield None
                return
            yield imgs, idx

    def _dropped(self) -> int:
        return (self._card or self._handle).dropped()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        targets = self.manifest.targets
        warned_dropped = 0
        for got in self._stream():
            if got is None:
                raise RuntimeError(
                    "native loader: no decodable image in the manifest "
                    f"({self._dropped()} failures)")
            imgs, idx = got
            dropped = self._dropped()
            if dropped > warned_dropped:
                # the stream stays fixed-shape (corrupt files are skipped,
                # valid ones recycle in), but silent data loss must be loud
                warnings.warn(
                    f"native loader skipped {dropped} unreadable/undecodable "
                    "image read(s) so far (the prefetcher may revisit a bad "
                    "file once per epoch pass); affected files will never be "
                    "trained on", RuntimeWarning, stacklevel=2)
                warned_dropped = dropped
            yield imgs, targets[idx]

    def sample(self, indices: np.ndarray):
        """Random-access decode of the requested manifest rows, in order
        (the triplet/EZBM protocol, :func:`decode_files`). Raises on
        unreadable rows."""
        indices = np.asarray(indices, np.int64)
        return decode_files(self.manifest.paths[indices], self.size,
                            self.device)

    def close(self) -> None:
        if self._card is not None:
            self._card.close()
        self._handle.close()
