"""Canonical uint8 host loaders (copy of ``endoscopy_tpu/data/pipeline.py``).

The host ships ONE canonical uint8 NHWC batch per role, at
``IMG_SIZE × DATA.CANONICAL_SCALE`` when ``IS_CROP``; every view derives
from it on the device.

- :class:`CanonicalLoader`: infinite shuffled batches ``(imgs_u8,
  targets)`` with wrap-around fixed-size batches, reshuffled each pass, from
  ``np.random.default_rng(seed)``: the JAX package's index stream, so the
  same seed yields the same batches. Random access through ``sample``.
- :class:`EvalLoader`: one deterministic pass; the last batch repeats row
  0 with ``mask=False`` (``(imgs_u8, targets, mask)``).

Both decode through :meth:`decode` over a thread pool, cache the whole
manifest when it fits under the RAM bound and stream otherwise. A file is
decoded by cv2 (:func:`decode_canonical`), imported only then; the
``EvalLoader``'s ``decoder=`` takes a function ``(paths, size) -> uint8
rows`` instead, such as the native core's
``data/native_loader.py::decode_files``, which needs no cv2. Under ``DATA.LOADER: native`` ``cli/learn.py::build_data``
gives it to the validation loader: a convention of the port's, since the
JAX package evaluates with cv2 even under ``native``. On the card that
decoder returns uint8 CUDA tensors, and the loader's rows, chunks and
cache are those tensors (concatenated with ``torch.cat``): they never
pass through the host. The serving path, which takes raw canonical
buffers, needs neither.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from endoscopy_tpu_torch.data.manifest import Manifest

# RAM bound for the decoded cache; above it the loaders stream
DEFAULT_CACHE_LIMIT_BYTES = int(
    os.environ.get("ENDOSCOPY_TPU_CACHE_LIMIT", 2 * 1024 ** 3))


def canonical_size(config) -> int:
    """IMG_SIZE × CANONICAL_SCALE when IS_CROP (the reference's
    ``int(size * 1.2)`` resize before crops), else IMG_SIZE."""
    img_size = int(config.DATA.IMG_SIZE)
    if config.DATA.IS_CROP:
        return int(img_size * float(config.DATA.CANONICAL_SCALE))
    return img_size


def decode_canonical(path: str, size: int) -> np.ndarray:
    """cv2 imread → BGR2RGB → bilinear resize to (size, size) uint8."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read image: {path}")
    return _canonicalize_bgr(img, size)


def decode_canonical_bytes(data: bytes, size: int) -> np.ndarray:
    """Encoded image bytes (JPEG/PNG/...) → canonical uint8 (size, size, 3)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("cv2 could not decode the image payload")
    return _canonicalize_bgr(img, size)


def _canonicalize_bgr(img: np.ndarray, size: int) -> np.ndarray:
    import cv2

    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[0] != size or img.shape[1] != size:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return np.ascontiguousarray(img, dtype=np.uint8)


BatchDecoder = Callable[[Sequence[str], int], np.ndarray]


class _Decoder:
    """Threaded, order-preserving batch decode: cv2 a file at a time
    (``executor.map`` keeps the order), or a batch decoder ``(paths, size)
    -> rows`` on one chunk of the paths a worker."""

    def __init__(self, num_workers: int,
                 decoder: Optional[BatchDecoder] = None) -> None:
        self._workers = num_workers
        self._batch_decoder = decoder
        self._pool = (ThreadPoolExecutor(num_workers) if num_workers > 0
                      else None)

    def decode_batch(self, paths, size: int) -> np.ndarray:
        if self._batch_decoder is not None:
            return self._decode_chunks(list(paths), size)
        if self._pool is None:
            rows = [decode_canonical(p, size) for p in paths]
        else:
            rows = list(self._pool.map(
                lambda p: decode_canonical(p, size), paths))
        return np.stack(rows) if rows else np.zeros((0, size, size, 3), np.uint8)

    def _decode_chunks(self, paths, size: int) -> np.ndarray:
        if self._pool is None or len(paths) < 2:
            return self._batch_decoder(paths, size)
        chunks = np.array_split(np.arange(len(paths)),
                                min(self._workers, len(paths)))
        parts = list(self._pool.map(
            lambda c: self._batch_decoder([paths[i] for i in c], size),
            chunks))
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts)
        return np.concatenate(parts)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)


class _Decoding:
    """What both loaders share: the decoder and the optional cache."""

    def _init_decoding(self, manifest: Manifest, size: int, num_workers: int,
                       cache: bool, cache_limit_bytes: int, name: str,
                       decoder: Optional[BatchDecoder]) -> None:
        self.manifest = manifest
        self.size = int(size)
        self._decoder = _Decoder(int(num_workers), decoder)
        est_bytes = len(manifest) * self.size * self.size * 3
        if cache and est_bytes > cache_limit_bytes:
            print(f"{name}: cache would need {est_bytes / 1e9:.1f} GB "
                  f"(> {cache_limit_bytes / 1e9:.1f} GB bound); streaming instead")
            cache = False
        self._cache: Optional[np.ndarray] = None
        if cache and len(manifest):
            self._cache = self.decode(manifest.paths)

    def decode(self, paths) -> np.ndarray:
        """Canonical uint8 ``(len(paths), size, size, 3)`` rows."""
        return self._decoder.decode_batch(paths, self.size)

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        if self._cache is not None:
            return self._cache[idx]
        return self.decode(self.manifest.paths[idx])

    def close(self) -> None:
        self._decoder.close()


class CanonicalLoader(_Decoding):
    """Infinite shuffled canonical-batch loader with random access.

    ``cache=True`` decodes the whole manifest once into a uint8 array and
    serves batches as numpy slices; above the RAM bound it streams, with
    the next batch decoding on a thread while the caller takes this one.
    """

    def __init__(self, manifest: Manifest, batch_size: int, size: int,
                 cache: bool = True, seed: Optional[int] = None,
                 num_workers: int = 2, shuffle: bool = True,
                 cache_limit_bytes: int = DEFAULT_CACHE_LIMIT_BYTES) -> None:
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.rng = np.random.default_rng(seed)
        self._init_decoding(manifest, size, num_workers, cache,
                            cache_limit_bytes, "CanonicalLoader", None)

    def sample(self, indices: np.ndarray) -> np.ndarray:
        """Decoded canonical rows for arbitrary manifest indices (cached
        and streaming loaders return the same pixels)."""
        return self._rows(np.asarray(indices, np.int64))

    def _index_stream(self) -> Iterator[int]:
        n = len(self.manifest)
        while True:
            order = (self.rng.permutation(n) if self.shuffle
                     else np.arange(n))
            yield from order

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        stream = self._index_stream()
        targets = self.manifest.targets

        def take_batch() -> np.ndarray:
            return np.fromiter(
                (next(stream) for _ in range(self.batch_size)),
                np.int64, count=self.batch_size)

        if self._cache is not None:
            while True:
                idx = take_batch()
                yield self._cache[idx], targets[idx]
        else:
            assembler = ThreadPoolExecutor(1)
            try:
                idx = take_batch()
                fut = assembler.submit(self.decode, self.manifest.paths[idx])
                while True:
                    imgs, cur_idx = fut.result(), idx
                    idx = take_batch()
                    fut = assembler.submit(self.decode,
                                           self.manifest.paths[idx])
                    yield imgs, targets[cur_idx]
            finally:
                assembler.shutdown(wait=False)


class EvalLoader(_Decoding):
    """One deterministic pad-and-mask pass: the last batch repeats row 0
    with ``mask=False``, so every batch has one shape. ``cache=None``
    caches under the RAM bound (the valid set is read every evaluation);
    ``cache=False`` streams."""

    def __init__(self, manifest: Manifest, batch_size: int, size: int,
                 num_workers: int = 2, cache: Optional[bool] = None,
                 cache_limit_bytes: int = DEFAULT_CACHE_LIMIT_BYTES,
                 decoder: Optional[BatchDecoder] = None) -> None:
        self.batch_size = int(batch_size)
        if cache is None:
            cache = len(manifest) * int(size) ** 2 * 3 <= cache_limit_bytes
        self._init_decoding(manifest, size, num_workers, cache,
                            cache_limit_bytes, "EvalLoader", decoder)

    def __len__(self) -> int:
        return -(-len(self.manifest) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        n = len(self.manifest)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n), dtype=np.int64)
            pad = bs - len(idx)
            mask = np.concatenate([np.ones(len(idx), bool), np.zeros(pad, bool)])
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            yield self._rows(idx), self.manifest.targets[idx], mask
