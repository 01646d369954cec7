"""ctypes bindings for the native C++ loader core (port of
``endoscopy_tpu/data/native_loader.py``).

The core, ``data/csrc/loader.cpp``, is this package's own copy of the JAX
package's: a C++ thread pool (fread → libjpeg decode → bilinear resize)
fills a bounded queue of canonical uint8 images, and Python drains whole
batches through one ctypes call. Shuffle semantics are the reference's
RandomSampler-with-recycling contract: reshuffled epochs, wrap-around
fixed-size batches. The same files and seed give the JAX loader's pixels
and index stream.

It is built at first use with ``g++ -O3 -shared -fPIC -std=c++17 ...
-ljpeg -lpthread`` into ``build/native/`` under the repository's root, one
library per hash of the source (a changed source builds anew). The build
writes a temporary file and renames it, under a file lock, so processes
that build at once (test workers, ``torchrun`` ranks) do not race. A
failed build raises with the compiler's output: there is no fallback to
the cv2 loaders.

Selected by ``DATA.LOADER: 'native'`` (``cli/learn.py::build_data``).
:func:`decode_files` decodes a list of files in order through the same
core, for the validation loader (``data/pipeline.py``); :func:`write_jpeg`
encodes with libjpeg for the synthetic dataset (``data/synthetic.py``).

Corrupt-input contract (as in the JAX package): the infinite prefetch
stream cannot raise from a C++ worker, so unreadable files are skipped to
keep batches fixed-shape, a RuntimeWarning reports the running skip count,
and an all-corrupt manifest raises instead of blocking. ``sample()`` and
:func:`decode_files` always raise on undecodable rows: specific-row
requests cannot be substituted.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from endoscopy_tpu_torch.data.manifest import Manifest

SRC_PATH = Path(__file__).resolve().parent / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
BUILD_CMD = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_LIBS = ("-ljpeg", "-lpthread")
JPEG_QUALITY = 92  # the JAX generator's cv2.IMWRITE_JPEG_QUALITY

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the core for the current source lives (built or not)."""
    digest = hashlib.sha256(SRC_PATH.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libendoloader-{digest}.so"


def build_library() -> Path:
    """The built core for the current source, built now if it is missing.
    Raises RuntimeError with the compiler's output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while we waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [*BUILD_CMD, str(SRC_PATH), "-o", str(tmp), *BUILD_LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(
                f"native loader: the C++ compiler {BUILD_CMD[0]!r} is not "
                "installed; the core needs g++ and libjpeg's headers "
                "(jpeglib.h) and library") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native loader: building {SRC_PATH} failed (it needs "
                "libjpeg's headers, jpeglib.h, and its library):\n"
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
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
        lib.jpeg_write_rgb.restype = ctypes.c_int
        lib.jpeg_write_rgb.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        _lib = lib
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


class _Handle:
    """Owns one C++ Loader instance."""

    def __init__(self, paths, size: int, num_threads: int, queue_depth: int,
                 seed: int, shuffle: bool) -> None:
        self._ptr = None
        self._lib = _load_lib()
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

    def dropped(self) -> int:
        """Files the C++ core skipped as unreadable/undecodable so far."""
        return int(self._lib.loader_dropped(self._ptr))

    def close(self) -> None:
        if self._ptr is not None:
            self._lib.loader_destroy(self._ptr)
            self._ptr = None

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        self.close()


def decode_files(paths: Sequence[str], size: int) -> np.ndarray:
    """``(len(paths), size, size, 3)`` uint8 canonical images of ``paths``,
    in order: a transient single-thread, non-shuffled core decodes exactly
    these files. Raises naming the files it could not decode."""
    paths = list(paths)
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


class NativeCanonicalLoader:
    """Drop-in CanonicalLoader with the C++ decode core.

    Same contract as ``data.pipeline.CanonicalLoader``: infinite shuffled
    ``(imgs_u8, targets)`` batches plus ``sample(indices)`` random access.
    """

    def __init__(self, manifest: Manifest, batch_size: int, size: int,
                 seed: int = 0, num_threads: int = 2, shuffle: bool = True,
                 queue_depth: Optional[int] = None) -> None:
        self.manifest = manifest
        self.batch_size = int(batch_size)
        self.size = int(size)
        self._num_threads = max(1, int(num_threads))
        depth = queue_depth or max(2 * self.batch_size, 64)
        self._handle = _Handle(manifest.paths, self.size, self._num_threads,
                               depth, int(seed), shuffle)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        targets = self.manifest.targets
        warned_dropped = 0
        while True:
            imgs, idx = self._handle.next(self.batch_size)
            if (idx < 0).any():  # C++ sentinel: a full pass decoded nothing
                raise RuntimeError(
                    "native loader: no decodable image in the manifest "
                    f"({self._handle.dropped()} failures)")
            dropped = self._handle.dropped()
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

    def sample(self, indices: np.ndarray) -> np.ndarray:
        """Random-access decode of the requested manifest rows, in order
        (the triplet/EZBM protocol, :func:`decode_files`). Raises on
        unreadable rows."""
        indices = np.asarray(indices, np.int64)
        return decode_files(self.manifest.paths[indices], self.size)

    def close(self) -> None:
        self._handle.close()
