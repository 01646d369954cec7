"""The one generator that every traffic file parameterises.

A traffic file gives the pool (labeled and unlabeled rows, the classes'
shares of the labeled rows), the image pattern and the loader the
trainer reads through:

- ``"loader": "cached"``: the port's ``CanonicalLoader`` with its cache
  filled at set-up from rows made on the card at the canonical side
  ``int(IMG_SIZE · CANONICAL_SCALE)``; the loader's ``decode`` is the one
  thing replaced, by a lookup of the row (its "path" is its row number).
  The rows come from the run's seed.
- ``"loader": "native"``: the port's ``NativeCanonicalLoader``
  (``DATA.LOADER: native``: the bytes-only core's threads read the files,
  nvJPEG decodes a batch, the resize kernel makes the canonical rows) over
  JPEG files at ``files.side`` px that the benchmark writes with Pillow
  (baseline, ``files.quality``, 4:2:0). The files come from the traffic's
  ``data_seed`` and are kept across runs in ``benchmark/pool/`` (one
  directory per set of parameters); the loaders' order still comes from
  the run's seed.

The pattern is the repository's synthetic endoscopy image: a colour field
per class (``palette``), Gaussian noise of ``noise_std``, a radial
vignette that darkens the corners by ``vignette``, clipped to uint8.
The same seed gives the same inputs.

:func:`check_batches` holds the first batches the loaders handed out
against the reference's: for cached rows, byte for byte the rows of the
loaders' index stream; for JPEG files, each row matched to one of the
files the core's index stream takes next (``reference/jpeg.py``), decoded
by Pillow and resized by the core's arithmetic, and compared by its mean
absolute gap.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 512  # images made on the card at a time


def labeled_targets(traffic: dict, seed: int) -> np.ndarray:
    """The labeled rows' classes: the traffic's shares, in seeded order."""
    n = int(traffic["labeled"])
    shares = np.asarray(traffic["class_shares"], np.float64)
    counts = np.floor(shares / shares.sum() * n).astype(np.int64)
    counts[0] += n - counts.sum()
    t = np.repeat(np.arange(len(counts)), counts)
    return np.random.default_rng(seed).permutation(t)


def make_rows(classes: np.ndarray, size: int, pattern: dict,
              generator: torch.Generator, device) -> np.ndarray:
    """uint8 ``(N, size, size, 3)`` rows of ``classes`` on the host, made
    on ``device`` in chunks."""
    palette = torch.tensor(pattern["palette"], dtype=torch.float32,
                           device=device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device),
                            torch.arange(size, device=device), indexing="ij")
    c = (size - 1) / 2.0
    r = torch.sqrt((yy - c) ** 2 + (xx - c) ** 2) / (c * 2.0 ** 0.5)
    shade = (1.0 - float(pattern["vignette"]) * r)[None, :, :, None]
    out = np.empty((len(classes), size, size, 3), np.uint8)
    cls = torch.as_tensor(classes, device=device)
    for i in range(0, len(classes), CHUNK):
        k = cls[i:i + CHUNK]
        img = torch.randn((len(k), size, size, 3), generator=generator,
                          device=device) * float(pattern["noise_std"])
        img += palette[k % len(palette)][:, None, None, :]
        img = (img * shade).clamp_(0, 255).to(torch.uint8)
        out[i:i + len(k)] = img.cpu().numpy()
    return out


class Pool:
    """The rows both sides read: ``labeled`` and ``unlabeled`` uint8
    arrays and the labeled rows' ``targets``."""

    def __init__(self, traffic: dict, size: int, seed: int, device):
        g = torch.Generator(device=device).manual_seed(seed)
        self.targets = labeled_targets(traffic, seed)
        classes = len(traffic["class_shares"])
        unl_classes = torch.randint(0, classes, (int(traffic["unlabeled"]),),
                                    generator=g, device=device).cpu().numpy()
        self.labeled = make_rows(self.targets, size, traffic["pattern"], g,
                                 device)
        self.unlabeled = make_rows(unl_classes, size, traffic["pattern"], g,
                                   device)


def array_loader(rows: np.ndarray, targets: np.ndarray, batch: int,
                 seed: int, workers: int):
    """The port's ``CanonicalLoader`` over ``rows``, its cache filled at
    construction; only ``decode`` is replaced."""
    from endoscopy_tpu_torch.data.manifest import Manifest
    from endoscopy_tpu_torch.data.pipeline import CanonicalLoader

    class RowLoader(CanonicalLoader):
        def decode(self, paths) -> np.ndarray:
            idx = np.asarray(paths, np.int64)
            if len(idx) == len(rows) and (idx == np.arange(len(rows))).all():
                return rows
            return rows[idx]

    manifest = Manifest(paths=np.arange(len(rows)), targets=targets)
    return RowLoader(manifest, batch, rows.shape[1], seed=seed,
                     num_workers=workers)


class FilePool:
    """The traffic's JPEG files: ``labeled`` and ``unlabeled`` paths and
    the labeled files' ``targets``; written on the first use of these
    parameters in a checkout."""

    def __init__(self, traffic: dict, device):
        from harness.spec import BENCH_DIR

        keys = ("labeled", "unlabeled", "class_shares", "pattern", "files",
                "data_seed")
        params = json.dumps({k: traffic[k] for k in keys}, sort_keys=True)
        digest = hashlib.sha256(params.encode()).hexdigest()[:12]
        root = BENCH_DIR / "pool" / f"{traffic['name']}-{digest}"
        seed = int(traffic["data_seed"])
        self.targets = labeled_targets(traffic, seed)
        self.side = int(traffic["files"]["side"])
        if not (root / "done").exists():
            self._write(traffic, root, seed, device)
        self.labeled = np.array([str(root / "labeled" / f"{i:05d}.jpg")
                                 for i in range(len(self.targets))],
                                dtype=object)
        self.unlabeled = np.array(
            [str(root / "unlabeled" / f"{i:05d}.jpg")
             for i in range(int(traffic["unlabeled"]))], dtype=object)
        self.bytes_per_file = float(np.mean(
            [os.path.getsize(p) for p in self.labeled[:64]]))

    def _write(self, traffic, root, seed, device) -> None:
        from PIL import Image

        files = traffic["files"]
        tmp = root.with_name(root.name + ".partial")
        shutil.rmtree(tmp, ignore_errors=True)
        g = torch.Generator(device=device).manual_seed(seed)
        unl = torch.randint(0, len(traffic["class_shares"]),
                            (int(traffic["unlabeled"]),), generator=g,
                            device=device).cpu().numpy()

        def save(args):
            path, rgb = args
            Image.fromarray(rgb).save(path, quality=int(files["quality"]),
                                      subsampling=2)  # 4:2:0

        with ThreadPoolExecutor(4) as pool:
            for part, classes in (("labeled", self.targets),
                                  ("unlabeled", unl)):
                (tmp / part).mkdir(parents=True)
                for i in range(0, len(classes), CHUNK):
                    rows = make_rows(classes[i:i + CHUNK], self.side,
                                     traffic["pattern"], g, device)
                    list(pool.map(save, [
                        (tmp / part / f"{i + k:05d}.jpg", rows[k])
                        for k in range(len(rows))]))
        (tmp / "done").write_text(json.dumps(traffic, sort_keys=True))
        shutil.rmtree(root, ignore_errors=True)
        tmp.rename(root)


def make_pool(traffic: dict, size: int, seed: int, device):
    if traffic["loader"] == "native":
        return FilePool(traffic, device)
    return Pool(traffic, size, seed, device)


def loaders(traffic: dict, pool, batch: int, mu: int, seeds: dict,
            workers: int, size: int, device):
    """``(labeled, unlabeled)`` train loaders of the traffic's kind."""
    unl_targets = np.zeros(len(pool.unlabeled), np.int64)
    if traffic["loader"] == "cached":
        return (array_loader(pool.labeled, pool.targets, batch,
                             seeds["labeled"], workers),
                array_loader(pool.unlabeled, unl_targets, batch * mu,
                             seeds["unlabeled"], workers))
    if traffic["loader"] != "native":
        raise ValueError(f"unknown loader {traffic['loader']!r}")
    from endoscopy_tpu_torch.data.manifest import Manifest
    from endoscopy_tpu_torch.data.native_loader import NativeCanonicalLoader

    return tuple(
        NativeCanonicalLoader(Manifest(paths=paths, targets=targets), bs,
                              size, seed=seeds[name], num_threads=workers,
                              device=device)
        for name, paths, targets, bs in (
            ("labeled", pool.labeled, pool.targets, batch),
            ("unlabeled", pool.unlabeled, unl_targets, batch * mu)))


def check_batches(traffic: dict, pool, got: list, batch: int, mu: int,
                  seeds: dict, steps: int, size: int):
    """``(reference batches, numbers)``: the reference's ``(labeled rows,
    targets, unlabeled rows)`` of the first ``steps`` steps, and how far
    the loaders' batches ``got`` lie from them."""
    from reference.train import index_batches

    if traffic["loader"] == "cached":
        lab = index_batches(len(pool.labeled), batch, seeds["labeled"], steps)
        unl = index_batches(len(pool.unlabeled), batch * mu,
                            seeds["unlabeled"], steps)
        ref = [(pool.labeled[a], pool.targets[a], pool.unlabeled[b])
               for a, b in zip(lab, unl)]
        bad = 0
        for (x, t, u), (rx, rt, ru) in zip(got, ref):
            bad += int(np.count_nonzero(x != rx) + np.count_nonzero(u != ru)
                       + np.count_nonzero(t != rt))
        return ref, {"batch_mismatch": bad if len(got) == steps else -1}
    return _match_files(pool, got, batch, mu, seeds, steps, size)


SLACK = 16  # files beyond the batches' that a worker thread may hand out first


def _fingerprint(rows: torch.Tensor) -> torch.Tensor:
    x = rows.permute(0, 3, 1, 2).float()
    return F.adaptive_avg_pool2d(x, 16).flatten(1)


def _match_files(pool, got, batch, mu, seeds, steps, size):
    from reference import jpeg

    out_rows = {"labeled": [], "unlabeled": []}
    unmatched, worst = 0, 0.0
    for name, paths, bs, k in (("labeled", pool.labeled, batch, 0),
                               ("unlabeled", pool.unlabeled, batch * mu, 2)):
        cand = list(dict.fromkeys(jpeg.index_stream(
            len(paths), seeds[name], steps * bs + SLACK).tolist()))
        rows = torch.as_tensor(np.stack([
            jpeg.resize(jpeg.decode(paths[i]), size) for i in cand]))
        fp = _fingerprint(rows)
        used = set()
        for step in got[:steps]:
            mine = torch.as_tensor(np.asarray(step[k]))
            order = torch.cdist(_fingerprint(mine), fp).argmin(1).tolist()
            picked = []
            for r, c in enumerate(order):
                gap = float((mine[r].float() - rows[c].float()).abs().mean())
                worst = max(worst, gap)
                if c in used:
                    unmatched += 1
                used.add(c)
                if k == 0 and int(step[1][r]) != int(
                        pool.targets[cand[c]]):
                    unmatched += 1
                picked.append(c)
            out_rows[name].append((rows[picked].numpy(),
                                   np.asarray([pool.targets[cand[c]]
                                               for c in picked])
                                   if k == 0 else None))
    ref = [(lab[0], lab[1], unl[0]) for lab, unl in
           zip(out_rows["labeled"], out_rows["unlabeled"])]
    if len(got) != steps:
        unmatched = -1
    return ref, {"batch_unmatched": unmatched, "decode_mean_abs": worst}
