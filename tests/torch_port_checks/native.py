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

The card's route (``data/jpeg_card.py``: nvJPEG and the resize kernel) runs
on the card alone (``chip_smoke.py`` path O). Here: the bytes-only core's
index stream against the libjpeg core's, the resize kernel's plain version
bit for bit against the core's resize, the JPEG fixture's stored pixels
against the JAX package's decoders, path O's config against its YAML, and
``device='cuda'`` raising without CUDA.
"""

import filecmp
import functools
import glob
import importlib.util
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
import torch
import yaml

from endoscopy_tpu.config.loader import default_config as jax_default_config
from endoscopy_tpu.data import manifest as jmanifest
from endoscopy_tpu.data import pipeline as jpipeline
from endoscopy_tpu.data import synthetic as jsynthetic
from endoscopy_tpu.data.native_loader import \
    NativeCanonicalLoader as JaxNativeLoader
from endoscopy_tpu_torch.cli.learn import build_data
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data import (csv_table, jpeg_card, manifest,
                                      native_loader)
from endoscopy_tpu_torch.data import pipeline, synthetic
from endoscopy_tpu_torch.data.manifest import Manifest
from endoscopy_tpu_torch.utils import trace
from torch_port_checks import path_o

ROOT = Path(__file__).resolve().parents[2]
GEN = dict(num_classes=4, n_train=24, n_valid=8, n_unlabeled=8, img_size=48)
SIZE, BATCH = 40, 8


@functools.cache
def _datasets():
    """``(tmp, port paths, jax paths)``: both generators' datasets, in a
    directory kept for the process."""
    tmp = tempfile.TemporaryDirectory()
    port = synthetic.make_synthetic_dataset(os.path.join(tmp.name, "port"),
                                            device="cpu", **GEN)
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


def _cpu_loader(*args, **kwargs):
    return native_loader.NativeCanonicalLoader(*args, device="cpu", **kwargs)


def check_native_loader_matches_jax():
    """One thread and one seed: three batches' images, targets and indices,
    ``sample()``, the warning on a corrupt file and the raise on an
    all-corrupt manifest are the JAX loader's."""
    _, port, _ = _datasets()
    files = _jpegs(port)
    m = _indexed(files)
    got = native_loader.NativeCanonicalLoader(m, BATCH, SIZE, seed=5,
                                              num_threads=1, device="cpu")
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
        for cls in (_cpu_loader, JaxNativeLoader):
            loader = cls(cm, 10, SIZE, num_threads=1)
            with pytest.warns(RuntimeWarning, match=r"skipped \d+ unreadable"):
                _, t = next(iter(loader))
            assert not set(t.tolist()) & set(bad)
            with pytest.raises(RuntimeError, match="could not decode 1 of 2"):
                loader.sample(np.array([0, 3]))
            loader.close()
        for p in cm.paths:
            Path(p).write_bytes(b"")
        for cls in (_cpu_loader, JaxNativeLoader):
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
                                  decoder=functools.partial(
                                      native_loader.decode_files,
                                      device="cpu"))
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
        native_loader.decode_files([valid.paths[0], "/nonexistent.jpg"], SIZE,
                                   device="cpu")


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
    card = native_loader.build_library(bytes_only=True)
    assert card.parent == so.parent and card != so and card.is_file()
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


def check_bytes_only_core_matches_libjpeg_core():
    """The bytes-only core (the card's) hands out each file's bytes in the
    libjpeg core's index stream, for the same paths and seed, across an
    epoch's wrap-around (40 files, batches of 16, one thread each); both
    drop an empty file."""
    _, port, _ = _datasets()
    files = _jpegs(port)
    cpu = native_loader._Handle(files, SIZE, 1, 64, 9, True)
    card = native_loader._Handle(files, SIZE, 1, 64, 9, True,
                                 bytes_only=True)
    for _ in range(5):
        _, want = cpu.next(16)
        buf, lengths, got = card.next_buffer(16)
        np.testing.assert_array_equal(got, want)
        assert buf[:lengths.sum()].tobytes() == b"".join(
            Path(files[i]).read_bytes() for i in got)
        assert lengths.tolist() == [os.path.getsize(files[i]) for i in got]
    cpu.close()
    card.close()
    with tempfile.TemporaryDirectory() as tmp:
        paths = _corrupt_copies(files[:6], tmp, (2, 4))  # 2 cut, 4 empty
        card = native_loader._Handle(paths, SIZE, 1, 8, 0, False,
                                     bytes_only=True)
        _, lengths, got = card.next_buffer(5)
        assert got.tolist() == [0, 1, 2, 3, 5] and lengths[2] == 100
        assert card.dropped() >= 1  # the reader runs ahead, into pass 2
        card.close()


def check_plain_resize_matches_core():
    """``jpeg_card.resize_bilinear_plain`` (the resize kernel's plain
    version) on libjpeg's decode at the file's own size, in the decoded
    batch's padded layout (offsets and row pitches multiples of 16 bytes,
    ``jpeg_card.pack``), equals the core's ``decode_files`` bit for bit at
    134, 112 and 224 px (a 160 → 224 upscale), on the fixture's files (a
    161 x 127 one, whose 381-byte rows are no multiple of 16, among them),
    on a generator file and on 2 x 2, 3 x 7 and 37 x 5 files; decoded at
    its own side, the core gives libjpeg's pixels. An image with a side of
    1, which the core's resize reads outside its rows for, gives zeros, as
    the kernel does."""
    _, port, _ = _datasets()
    files = [str(path_o.FIXTURE / f) for f in path_o.FIXTURE_FILES]
    files.append(_jpegs(port)[0])
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        for h, w in ((2, 2), (3, 7), (37, 5)):
            files.append(os.path.join(tmp, f"{h}x{w}.jpg"))
            native_loader.write_jpeg(files[-1], rng.integers(
                0, 256, (h, w, 3), dtype=np.uint8))
        raws = [torch.from_numpy(native_loader.decode_rgb(
            Path(f).read_bytes())) for f in files]
        want = {size: native_loader.decode_files(files, size, device="cpu")
                for size in (134, 112, 224)}
    assert {tuple(r.shape[:2]) for r in raws} >= {(161, 127), (48, 48),
                                                  (3, 7), (37, 5)}
    square = [(f, r) for f, r in zip(files, raws)
              if r.shape[0] == r.shape[1] and r.shape[0] > 2]
    for f, r in square:
        np.testing.assert_array_equal(
            native_loader.decode_files([f], r.shape[0], device="cpu")[0], r)
    flat, offsets, hw = jpeg_card.pack(raws)
    assert flat.numel() % jpeg_card.ALIGN == 0
    assert all(o % jpeg_card.ALIGN == 0 for o in offsets.tolist())
    assert [jpeg_card.row_pitch(w) for w in (127, 7, 5, 160)] == [
        384, 32, 16, 480]
    for size, core in want.items():
        got = jpeg_card.resize_bilinear(flat, offsets, hw, size)  # the CPU:
        np.testing.assert_array_equal(got.numpy(), core)  # the plain version
    thin = [torch.full((1, 9, 3), 200, dtype=torch.uint8),
            torch.full((9, 1, 3), 200, dtype=torch.uint8), raws[0]]
    got = jpeg_card.resize_bilinear(*jpeg_card.pack(thin), 134)
    assert not got[:2].any()
    np.testing.assert_array_equal(got[2].numpy(), want[134][0])
    assert trace.counter("jpeg/resize_launches") == 0


def _fixture_tool():
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixture", ROOT / "tools" / "torch_port" /
        "make_jpeg_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_jpeg_fixture_matches_jax_decoders():
    """The fixture's stored pixels are what the JAX package's native loader
    (134 px) and its cv2 ``decode_canonical`` (224 px) give for its JPEGs
    today; its files are those path O and the tool that made it name."""
    tool = _fixture_tool()
    assert tuple(tool.FILES) == path_o.FIXTURE_FILES
    assert tool.CV2_FILES == path_o.FIXTURE_CV2_FILES
    assert tool.PNG_NAMED_JPG == path_o.FIXTURE_PNG
    assert (tool.SIDE, tool.SERVE_SIDE) == (path_o.FIXTURE_SIDE,
                                             path_o.FIXTURE_SERVE_SIDE)
    fix = path_o.FIXTURE
    assert sum(p.stat().st_size for p in fix.iterdir()) < 1 << 20
    want = np.load(fix / "expected.npz")
    files = [str(fix / f) for f in path_o.FIXTURE_FILES]
    loader = JaxNativeLoader(_indexed(files), 1, path_o.FIXTURE_SIDE)
    np.testing.assert_array_equal(loader.sample(np.arange(len(files))),
                                  want["libjpeg_134"])
    loader.close()
    np.testing.assert_array_equal(
        np.stack([jpipeline.decode_canonical(str(fix / f),
                                             path_o.FIXTURE_SERVE_SIDE)
                  for f in path_o.FIXTURE_CV2_FILES]), want["cv2_224"])
    with pytest.raises(ValueError, match="libjpeg could not decode"):
        native_loader.decode_rgb((fix / path_o.FIXTURE_PNG).read_bytes())


def check_card_route_needs_cuda():
    """Without CUDA, ``device='cuda'`` (and the default) raises from the
    loader, ``decode_files``, the generator, ``build_data`` under
    ``DATA.LOADER: native`` and ``jpeg_card``: nothing falls back to
    libjpeg."""
    _, port, _ = _datasets()
    files = _jpegs(port)[:4]
    _, cfg = _configs(port)
    cfg.DATA.LOADER = "native"
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(torch.cuda, "is_available", lambda: False):
        calls = {
            "loader": lambda **kw: native_loader.NativeCanonicalLoader(
                _indexed(files), 2, SIZE, num_threads=1, **kw).close(),
            "decode_files": lambda **kw: native_loader.decode_files(
                files, SIZE, **kw),
            "generator": lambda **kw: synthetic.make_synthetic_dataset(
                os.path.join(tmp, "g"), num_classes=2, n_train=2, n_valid=1,
                n_unlabeled=1, img_size=16, **kw),
            "build_data": lambda **kw: build_data(cfg, **kw),
        }
        for name, call in calls.items():
            for kw in ({}, {"device": "cuda"}):
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    call(**kw)
        for fn in (lambda: jpeg_card.decode_files(files, SIZE),
                   lambda: jpeg_card.write_jpeg(os.path.join(tmp, "x.jpg"),
                                                np.zeros((4, 4, 3), np.uint8))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn()
        with pytest.raises(ValueError, match="CUDA device"):
            jpeg_card.decode_files(files, SIZE, device="cpu")


def check_path_o_config_matches_yaml():
    """Path O's fields are ``configs/synthetic_tpu_e2e.yaml``'s, and its
    generator arguments the YAML header's."""
    path = ROOT / "configs" / "synthetic_tpu_e2e.yaml"
    raw = yaml.safe_load(path.read_text())
    for section, fields in path_o.E2E.items():
        assert {k: raw[section][k] for k in fields} == fields, section
    kept = {k: v for section in ("DATA", "MODEL", "TRAIN")
            for k, v in raw[section].items()}
    assert set(kept) - {k for f in path_o.E2E.values() for k in f} == \
        {"PATH", "ANNO"}  # the data paths, which path O sets itself
    call = path.read_text().split("make_synthetic_dataset(")[1].split(")")[0]
    header = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", call)}
    assert header == path_o.GENERATOR, header
    cfg = path_o.config("/data")
    assert cfg.DATA.LOADER == "native" and cfg.TRAIN.FREQ_EVAL == 1
    assert int(cfg.DATA.BATCH_SIZE) * (1 + 2 * int(cfg.DATA.MU)) == 480
