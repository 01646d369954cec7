"""Port checks: the native JPEG loader, the synthetic dataset and the CSV
reader, against the JAX package.

Both packages' generators write the same dataset (4 classes, 24 train, 8
valid and 8 unlabeled images at 48 px). Bounds, and why:

- ``_class_image``'s arrays, the two CSVs, the loaders' batches, indices
  and ``sample()``, the native ``EvalLoader`` against the JAX native
  ``sample()`` and the manifests the CSV reader gives against pandas':
  exact (the same numpy stream, the same C++ core, the same split code);
- the two generators' JPEGs, decoded by the JAX package's native loader:
  exact as well. Both encode with libjpeg at quality 92 with libjpeg's
  defaults, and on this host the files come out byte for byte the same
  (measured: 0 of 40 files differ), so any difference is a fault;
- the native ``EvalLoader`` against the JAX cv2 ``EvalLoader``: mean below
  4 LSB, the JAX package's own bound for its native decode against cv2
  (``tests/test_native_loader.py``): another resampler rounds otherwise.

The port's core is built into ``build/native/``; the JAX package's stays in
``native/``, which the checks leave as git has it. ``cli/learn.py`` runs
``configs/synthetic_smoke.yaml`` with ``DATA.LOADER: native`` in a process
where pandas, cv2 and PIL cannot be imported.
"""

import filecmp
import functools
import glob
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import yaml

from endoscopy_tpu.config.loader import default_config as jax_default_config
from endoscopy_tpu.data import manifest as jmanifest
from endoscopy_tpu.data import pipeline as jpipeline
from endoscopy_tpu.data import synthetic as jsynthetic
from endoscopy_tpu.data.native_loader import \
    NativeCanonicalLoader as JaxNativeLoader
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data import csv_table, manifest, native_loader
from endoscopy_tpu_torch.data import pipeline, synthetic
from endoscopy_tpu_torch.data.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
GEN = dict(num_classes=4, n_train=24, n_valid=8, n_unlabeled=8, img_size=48)
SIZE, BATCH = 40, 8


@functools.cache
def _datasets():
    """``(tmp, port paths, jax paths)``: both generators' datasets, in a
    directory kept for the process."""
    tmp = tempfile.TemporaryDirectory()
    port = synthetic.make_synthetic_dataset(os.path.join(tmp.name, "port"),
                                            **GEN)
    jax = jsynthetic.make_synthetic_dataset(os.path.join(tmp.name, "jax"),
                                            **GEN)
    return tmp, port, jax


def _jpegs(paths):
    img_root, _, unl_root, _ = paths
    return (sorted(glob.glob(os.path.join(img_root, "*.jpg")))
            + sorted(glob.glob(os.path.join(unl_root, "*.jpg"))))


def _indexed(files):
    """A manifest whose targets are the row indices, so a loader's targets
    are the indices it drew."""
    return Manifest(paths=np.array(files, dtype=object),
                    targets=np.arange(len(files), dtype=np.int64))


def _configs(paths, mock_ssl=True):
    img_root, anno, unl_root, unanno = paths
    data = {"PATH": img_root, "ANNO": anno, "UNANNO_PATH": unl_root,
            "UNANNO": unanno, "MOCKUP_SSL": mock_ssl}
    jcfg = jax_default_config()
    for k, v in data.items():
        jcfg.DATA[k] = v
    jcfg.MODEL.NUM_CLASSES = GEN["num_classes"]
    return jcfg, default_config({"DATA": data, "MODEL": {
        "NUM_CLASSES": GEN["num_classes"]}})


def check_generator_matches_jax():
    """``_class_image`` bit for bit, the CSVs byte for byte, and the JPEGs
    decoded by the JAX native loader: exact (module docstring)."""
    for seed, cls, size in ((0, 0, 48), (1, 5, 33), (2, 13, 160)):
        np.testing.assert_array_equal(
            synthetic._class_image(np.random.default_rng(seed), cls, size),
            jsynthetic._class_image(np.random.default_rng(seed), cls, size))
    _, port, jax = _datasets()
    for i in (1, 3):
        assert filecmp.cmp(port[i], jax[i], shallow=False), port[i]
    head = Path(port[1]).read_text().splitlines()[:2]
    assert head == ["image,target,is_valid,is_labeled",
                    "img_00000.jpg,0,False,True"], head
    files, jfiles = _jpegs(port), _jpegs(jax)
    assert [os.path.relpath(f, os.path.dirname(port[1])) for f in files] == \
        [os.path.relpath(f, os.path.dirname(jax[1])) for f in jfiles]
    assert len(files) == GEN["n_train"] + GEN["n_valid"] + GEN["n_unlabeled"]
    rows = np.arange(len(files))
    decoded = []
    for f in (files, jfiles):
        loader = JaxNativeLoader(_indexed(f), 4, GEN["img_size"])
        decoded.append(loader.sample(rows))
        loader.close()
    assert decoded[0].std() > 0
    np.testing.assert_array_equal(*decoded)


def _corrupt_copies(files, tmp, bad):
    """Copies of ``files`` in ``tmp``; the rows in ``bad`` are cut to 100
    bytes (row 0 of them) or to nothing (the others)."""
    out = []
    for i, f in enumerate(files):
        dst = os.path.join(tmp, f"{i:03d}.jpg")
        data = Path(f).read_bytes()
        if i in bad:
            data = data[:100] if i == bad[0] else b""
        Path(dst).write_bytes(data)
        out.append(dst)
    return out


def check_native_loader_matches_jax():
    """One thread and one seed: three batches' images, targets and indices,
    ``sample()``, the warning on a corrupt file and the raise on an
    all-corrupt manifest are the JAX loader's."""
    _, port, _ = _datasets()
    files = _jpegs(port)
    m = _indexed(files)
    got = native_loader.NativeCanonicalLoader(m, BATCH, SIZE, seed=5,
                                              num_threads=1)
    want = JaxNativeLoader(m, BATCH, SIZE, seed=5, num_threads=1)
    seen = set()
    for _, (x, t), (wx, wt) in zip(range(3), got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(t, wt)
        seen.update(t.tolist())
    assert len(seen) > BATCH  # shuffled rows of the whole manifest
    rows = np.array([7, 0, 7, 39])
    np.testing.assert_array_equal(got.sample(rows), want.sample(rows))
    got.close()
    want.close()

    with tempfile.TemporaryDirectory() as tmp:
        bad = (3, 5)
        cm = _indexed(_corrupt_copies(files[:10], tmp, bad))
        for cls in (native_loader.NativeCanonicalLoader, JaxNativeLoader):
            loader = cls(cm, 10, SIZE, num_threads=1)
            with pytest.warns(RuntimeWarning, match=r"skipped \d+ unreadable"):
                _, t = next(iter(loader))
            assert not set(t.tolist()) & set(bad)
            with pytest.raises(RuntimeError, match="could not decode 1 of 2"):
                loader.sample(np.array([0, 3]))
            loader.close()
        for p in cm.paths:
            Path(p).write_bytes(b"")
        for cls in (native_loader.NativeCanonicalLoader, JaxNativeLoader):
            loader = cls(cm, 4, SIZE, num_threads=1)
            with pytest.raises(RuntimeError, match="no decodable image"):
                next(iter(loader))
            loader.close()


def check_native_eval_loader():
    """The validation loader under ``DATA.LOADER: native`` (the core's
    ``decode_files`` on two workers): the JAX native ``sample()`` of the
    same rows bit for bit, its mask and padding the cv2 loader's, and
    within mean 4 LSB of the JAX cv2 ``EvalLoader``."""
    _, port, _ = _datasets()
    jcfg, cfg = _configs(port)
    anno = pd.read_csv(cfg.DATA.ANNO)
    valid = manifest.build_ssl_manifests(cfg, anno)[2]
    jvalid = jmanifest.build_ssl_manifests(jcfg, anno)[2]
    bs = 3  # 8 rows: the last batch is padded
    ref = JaxNativeLoader(valid, bs, SIZE, num_threads=1)
    for cache in (None, False):
        got = pipeline.EvalLoader(valid, bs, SIZE, cache=cache,
                                  decoder=native_loader.decode_files)
        cv2_ref = jpipeline.EvalLoader(jvalid, bs, SIZE, cache=cache)
        batches = list(zip(got, cv2_ref))
        assert len(batches) == len(got) == 3
        for start, ((x, t, mask), (cx, ct, cmask)) in zip(
                range(0, len(valid), bs), batches):
            idx = np.arange(start, start + bs) % len(valid)
            idx[~mask] = 0
            np.testing.assert_array_equal(x, ref.sample(idx))
            np.testing.assert_array_equal(t, ct)
            np.testing.assert_array_equal(mask, cmask)
            diff = np.abs(x.astype(np.int32) - cx.astype(np.int32))
            assert diff.mean() < 4.0, diff.mean()
        got.close()
    ref.close()
    with pytest.raises(RuntimeError, match="could not decode 1 of 2"):
        native_loader.decode_files([valid.paths[0], "/nonexistent.jpg"], SIZE)


def _same_manifest(got, want):
    assert list(got.paths) == list(want.paths)
    np.testing.assert_array_equal(got.targets, want.targets)


def _manifests_agree(paths, mock_ssl):
    jcfg, cfg = _configs(paths, mock_ssl)
    anno, janno = csv_table.read_csv(cfg.DATA.ANNO), pd.read_csv(cfg.DATA.ANNO)
    unanno = janno_u = None
    if not mock_ssl:
        unanno = csv_table.read_csv(cfg.DATA.UNANNO)
        janno_u = pd.read_csv(cfg.DATA.UNANNO)
    for table, frame in ((anno, janno), (unanno, janno_u)):
        if table is not None:
            assert table.columns == list(frame.columns)
            for c in frame.columns:  # pandas' str columns: str or object
                want = ("str" if pd.api.types.is_string_dtype(frame[c])
                        else frame[c].dtype)
                got = "str" if table[c].dtype == object else table[c].dtype
                assert got == want, (c, got, want)
    got = manifest.build_ssl_manifests(cfg, anno, unanno)
    want = jmanifest.build_ssl_manifests(jcfg, janno, janno_u)
    for g, w in zip(got[:3], want[:3]):
        _same_manifest(g, w)
    assert got[3] == want[3]
    for full in (True, False):
        got = manifest.build_supervised_manifests(cfg, anno, full)
        want = jmanifest.build_supervised_manifests(jcfg, janno, full)
        _same_manifest(got[0], want[0])
        _same_manifest(got[1], want[1])
        assert got[2] == want[2]
    return got


def check_csv_reader_matches_pandas():
    """The SSL and supervised manifests and ``cls_num_list`` from
    ``read_csv`` equal those from ``pd.read_csv``, with pandas' column
    types: on the synthetic CSVs (mock and real pools), on a mock split
    whose ``is_valid``/``is_labeled`` are 0/1, and on a real pool whose
    ``pred`` is mixed."""
    _, port, _ = _datasets()
    for mock_ssl in (True, False):
        _manifests_agree(port, mock_ssl)
    with tempfile.TemporaryDirectory() as tmp:
        anno = pd.read_csv(port[1])
        anno["is_valid"] = anno["is_valid"].astype(int)
        anno["is_labeled"] = anno["is_labeled"].astype(int)
        anno["note"] = [f"a, b {i}" for i in range(len(anno))]  # quoted
        anno["score"] = np.linspace(0, 1, len(anno))
        unanno = pd.read_csv(port[3])
        unanno["pred"] = np.arange(len(unanno)) % 3  # 0, 1, 2: a third kept
        paths = (port[0], os.path.join(tmp, "anno.csv"), port[2],
                 os.path.join(tmp, "unanno.csv"))
        anno.to_csv(paths[1], index=False)
        unanno.to_csv(paths[3], index=False)
        _manifests_agree(paths, True)
        _manifests_agree(paths, False)
        table = csv_table.read_csv(paths[1])
        assert table["note"][1] == "a, b 1"
        np.testing.assert_array_equal(table["score"], anno["score"])


def check_native_build_stays_in_build_dir():
    """The port's core is built under ``build/native/`` (named by the
    source's hash) and ``native/`` is as git has it; a source that does
    not compile raises with the compiler's output, and nothing falls
    back."""
    so = native_loader.build_library()
    assert so.parent == ROOT / "build" / "native" and so.is_file(), so
    assert so == native_loader.library_path()
    status = subprocess.run(["git", "status", "--porcelain", "--", "native"],
                            cwd=ROOT, capture_output=True, text=True)
    assert status.returncode == 0 and status.stdout == "", status.stdout
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp, "loader.cpp")
        src.write_text("#include <no_such_header.h>\n")
        with mock.patch.object(native_loader, "SRC_PATH", src), \
                mock.patch.object(native_loader, "BUILD_DIR", Path(tmp, "b")):
            with pytest.raises(RuntimeError, match="no_such_header"):
                native_loader.build_library()
            assert not list(Path(tmp, "b").glob("*.so*"))


_NO_PANDAS_CV2 = """\
import sys
for name in ("pandas", "cv2", "PIL"):
    sys.modules[name] = None  # any import of them raises ImportError
from endoscopy_tpu_torch.cli.learn import main
main(sys.argv[1:])
"""


def check_learn_cli_native_without_pandas_or_cv2():
    """``cli/learn.py --device cpu`` on ``configs/synthetic_smoke.yaml`` with
    ``DATA.LOADER: native``, the port's dataset, and pandas, cv2 and PIL
    blocked in its process: both epochs train and evaluate."""
    _, port, _ = _datasets()
    img_root, anno, unl_root, unanno = port
    cfg = yaml.safe_load(
        (ROOT / "configs" / "synthetic_smoke.yaml").read_text())
    cfg["DATA"].update(PATH=img_root, ANNO=anno, UNANNO_PATH=unl_root,
                       UNANNO=unanno, LOADER="native", NUM_WORKERS=2)
    cfg["TRAIN"].update(EVAL_STEP=2, MESH_DATA=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "native.yaml")
        Path(path).write_text(yaml.safe_dump(cfg))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run(
            [sys.executable, "-c", _NO_PANDAS_CV2, "--config-1", path,
             "--device", "cpu"], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training epoch: 2" in proc.stdout, proc.stdout[-2000:]
    losses = re.findall(r"Train Loss: ([0-9.]+)", proc.stdout)
    assert len(losses) == 2 and all(np.isfinite(float(v)) for v in losses)
    assert len(re.findall(r"Valid Loss: ([0-9.]+)", proc.stdout)) >= 2
