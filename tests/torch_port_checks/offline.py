"""Port checks: the offline tools and the visualize helpers, against the JAX
package on the same inputs.

- ``data/preprocess.py`` (``preprocess_image`` with and without ``deform``,
  ``preprocess_tree`` on a tree of JPEG and PNG files with black borders):
  bit for bit, the written files byte for byte (both are cv2 on the
  host);
- ``cli/split_data.py`` (plain, stratified, with ``labeled_frac``, and the
  CLI): the CSV byte for byte; ``cli/eda.py``: ``describe``'s dict, and
  ``chart`` writes its PNG;
- ``eval/visualize.py``: ``denormalize``, ``show_grid``,
  ``show_cfs_matrix`` and ``show_triplet_dist`` equal, their PNGs written;
  ``preview_views`` for FixMatch, CoMatch and the supervised triplet on
  the JAX preview's own draws (its keys' draws fed to the port's view
  functions), the JAX RandAugment in its Pallas kernel in interpret mode
  (two calls; the three JAX previews run side by side in threads): equal
  images;
- ``cli/learn.py --preview``, ``cli/evaluate.py --confusion`` and the
  triplet trainer's distance histogram write their files on the CPU.
"""

import filecmp
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pandas as pd
import yaml

from endoscopy_tpu.aug import views as jviews
from endoscopy_tpu.cli import eda as jeda
from endoscopy_tpu.cli import split_data as jsplit
from endoscopy_tpu.config.loader import default_config as jax_default_config
from endoscopy_tpu.data import preprocess as jpreprocess
from endoscopy_tpu.eval import visualize as jvisualize
from endoscopy_tpu.ops import randaugment_kernel as rk
from endoscopy_tpu_torch.aug import views
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.cli import eda, evaluate, learn, split_data
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data import preprocess
from endoscopy_tpu_torch.data.synthetic import make_synthetic_dataset
from endoscopy_tpu_torch.eval import visualize
from torch_port_checks.comatch import _comatch_draws
from torch_port_checks.train import _labeled_draws
from torch_port_checks.views import _jax_draws

ROOT = Path(__file__).resolve().parents[2]
IMG = 24
CANON = int(IMG * 1.2)


def _framed(rng, h: int, w: int) -> np.ndarray:
    """An RGB frame: a textured disk inside a black border."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.integers(20, 256, (h, w, 3))
    img *= (np.hypot(yy - h / 2, xx - w / 2) < 0.4 * min(h, w))[..., None]
    return img.astype(np.uint8)


def check_preprocess_matches_jax():
    """``preprocess_image`` (crop, with and without ``deform``, no crop)
    bit for bit; ``preprocess_tree`` writes the same files."""
    import cv2

    rng = np.random.default_rng(0)
    img = _framed(rng, 90, 110)
    for kw in ({}, {"deform": 0.15}, {"do_crop": False, "deform": 0.1}):
        got = preprocess.preprocess_image(img, 48, **kw)
        want = jpreprocess.preprocess_image(img, 48, **kw)
        assert got.shape[:2] != img.shape[:2]
        np.testing.assert_array_equal(got, want)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp, "src")
        (src / "sub").mkdir(parents=True)
        cv2.imwrite(str(src / "a.jpg"), _framed(rng, 70, 60))
        cv2.imwrite(str(src / "sub" / "b.png"), _framed(rng, 50, 80))
        (src / "notes.txt").write_text("not an image")
        counts = [fn(str(src), str(Path(tmp, dst)), min_edge=40,
                     deform=0.1, num_workers=2)
                  for fn, dst in ((preprocess.preprocess_tree, "port"),
                                  (jpreprocess.preprocess_tree, "jax"))]
        assert counts == [2, 2], counts
        for rel in ("a.jpg", "sub/b.png"):
            assert filecmp.cmp(Path(tmp, "port", rel), Path(tmp, "jax", rel),
                               shallow=False), rel


def _labels_frame(n: int = 50) -> pd.DataFrame:
    rng = np.random.default_rng(1)
    return pd.DataFrame({"image": [f"img_{i:03d}.jpg" for i in range(n)],
                         "target": rng.integers(0, 4, n)})


def check_split_data_matches_jax():
    """``split_dataframe`` plain, stratified and with ``labeled_frac``, and
    both CLIs: the CSV byte for byte."""
    df = _labels_frame()
    for kw in ({}, {"stratify": True}, {"labeled_frac": 0.3},
               {"stratify": True, "labeled_frac": 0.1, "seed": 7,
                "valid_frac": 0.25}):
        got = split_data.split_dataframe(df.copy(), **kw)
        want = jsplit.split_dataframe(df.copy(), **kw)
        assert got.to_csv(index=False) == want.to_csv(index=False), kw
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "labels.csv")
        df.to_csv(src, index=False)
        outs = [os.path.join(tmp, f"{name}.csv") for name in ("port", "jax")]
        for main, out in zip((split_data.main, jsplit.main), outs):
            main(["--csv", src, "--out", out, "--stratify",
                  "--labeled-frac", "0.2"])
        assert filecmp.cmp(*outs, shallow=False)


def check_eda_matches_jax():
    """``describe`` gives the JAX dict on a split frame with ``pred``;
    ``chart`` writes its PNG, as the JAX one does."""
    df = jsplit.split_dataframe(_labels_frame(), labeled_frac=0.5)
    df["pred"] = np.arange(len(df)) % 2
    assert eda.describe(df) == jeda.describe(df)
    assert eda.describe(df[["image", "target"]]) == \
        jeda.describe(df[["image", "target"]])
    with tempfile.TemporaryDirectory() as tmp:
        for fn, name in ((eda.chart, "port.png"), (jeda.chart, "jax.png")):
            assert fn(df, "target", os.path.join(tmp, name))
            assert os.path.getsize(os.path.join(tmp, name)) > 0


def check_visualize_helpers_match_jax():
    """``denormalize``, ``show_grid``, ``show_cfs_matrix`` (counts and
    percent) and ``show_triplet_dist``: equal arrays, PNGs written."""
    rng = np.random.default_rng(2)
    imgs = [rng.normal(0, 1, (IMG, IMG, 3)).astype(np.float32)
            for _ in range(2)]
    for kw in ({}, {"mean": 0.5, "std": 0.5}):
        for a, b in zip(visualize.show_grid(imgs, **kw),
                        jvisualize.show_grid(imgs, **kw)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(visualize.denormalize(imgs[0], **kw),
                                      jvisualize.denormalize(imgs[0], **kw))
    targets, preds = rng.integers(0, 4, 40), rng.integers(0, 4, 40)
    d_ap, d_an = rng.random(16), rng.random(16) + 0.5
    with tempfile.TemporaryDirectory() as tmp:
        def png(name):
            return os.path.join(tmp, name)

        for percent in (False, True):
            np.testing.assert_array_equal(
                visualize.show_cfs_matrix(targets, preds, 4, percent,
                                          png(f"cm{percent}.png")),
                jvisualize.show_cfs_matrix(targets, preds, 4, percent))
        for a, b in zip(visualize.show_triplet_dist(d_ap, d_an,
                                                    png("dist.png")),
                        jvisualize.show_triplet_dist(d_ap, d_an)):
            np.testing.assert_array_equal(a, b)
        visualize.show_grid(imgs, png("grid.png"))
        for name in ("cmFalse.png", "cmTrue.png", "dist.png", "grid.png"):
            assert os.path.getsize(png(name)) > 0, name


class _Rows:
    """A loader with the random-access protocol the previews use."""

    def __init__(self, images, targets):
        self.images = images
        self.manifest = SimpleNamespace(targets=np.asarray(targets))

    def sample(self, idx):
        return self.images[np.asarray(idx)]


_LABELED = ("hflips", "vflips", "angles", "factors", "orders")
_FIXMATCH = ("flips", "tops", "lefts", "pi", "pf")


def _configs(fields):
    """The port's and the JAX package's default configs with ``fields``."""
    jcfg = jax_default_config()
    for section, values in fields.items():
        for k, v in values.items():
            jcfg[section][k] = v
    return default_config(fields), jcfg


def _jax_previews(cases):
    """The JAX package's ``preview_views`` of each ``(config, loaders)``,
    side by side in threads (their eager ops and kernels compile there),
    the RandAugment in its Pallas kernel in interpret mode."""
    orig = rk.randaugment_mc_pallas
    with mock.patch.object(jviews, "USE_PALLAS_RANDAUG", True), \
            mock.patch.object(rk, "randaugment_mc_pallas",
                              lambda *a, **k: orig(*a, interpret=True, **k)), \
            ThreadPoolExecutor(len(cases)) as pool:
        return list(pool.map(
            lambda c: jvisualize.preview_views(*c, seed=0), cases))


def check_preview_views_match_jax():
    """FixMatch, CoMatch and the supervised triplet preview: the same
    images as the JAX preview on the same draws (the JAX keys' draws fed
    to the port's patched draw functions)."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (8, CANON, CANON, 3)).astype(np.uint8)
    ssl = (_Rows(u8[:4], [0, 1, 2, 3]), _Rows(u8[4:], [0, 0, 0, 0]))
    trio = _Rows(u8, [0, 1, 0, 1, 2, 2, 3, 0])
    key = jax.random.PRNGKey(0)
    k_lab, k_unl = jax.random.split(key)

    def labeled(k):
        return {"labeled_draws": lambda g, b: dict(zip(
            _LABELED, _labeled_draws(k, b)))}

    cases = {  # name: (fields, loaders, the port's draw functions)
        "FixMatch": ({"TRAIN": {"IS_SSL": True},
                      "MODEL": {"TYPE_SEMI": "FixMatch"}}, ssl,
                     {**labeled(k_lab), "fixmatch_draws": lambda g, b, s:
                      dict(zip(_FIXMATCH, _jax_draws(k_unl, b, s)))}),
        "CoMatch": ({"TRAIN": {"IS_SSL": True},
                     "MODEL": {"TYPE_SEMI": "CoMatch"}}, ssl,
                    {**labeled(k_lab), "comatch_draws": lambda g, b, s:
                     _comatch_draws(k_unl, b, s)}),
        "triplet": ({"TRAIN": {"IS_SSL": False},
                     "MODEL": {"IS_TRIPLET": True}}, trio, labeled(key)),
    }
    got, jax_cases = {}, []
    for name, (fields, loaders, draws) in cases.items():
        cfg, jcfg = _configs({"DATA": {"IMG_SIZE": IMG}, **fields})
        with mock.patch.multiple(views, **draws):
            got[name] = visualize.preview_views(cfg, loaders, seed=0,
                                                device="cpu")
        jax_cases.append((jcfg, loaders))
    for (name, images), want in zip(got.items(), _jax_previews(jax_cases)):
        assert len(images) == len(want) == (4 if name == "CoMatch" else 3)
        for a, b in zip(images, want):
            np.testing.assert_array_equal(a, b, err_msg=name)


def check_clis_write_their_pngs():
    """``cli/learn.py --preview`` on a supervised triplet config (5 epochs
    of one step: the distance histogram at epoch 5), then ``cli/evaluate.py
    --confusion`` on its checkpoint, on the CPU with the native loader."""
    cfg = yaml.safe_load(
        (ROOT / "configs" / "synthetic_smoke.yaml").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        img_root, anno, unl_root, unanno = make_synthetic_dataset(
            os.path.join(tmp, "synth"), num_classes=4, n_train=16, n_valid=8,
            n_unlabeled=4, img_size=40, device="cpu")
        cfg["DATA"].update(PATH=img_root, ANNO=anno, LOADER="native",
                           BATCH_SIZE=4)
        cfg["MODEL"]["IS_TRIPLET"] = True
        cfg["TRAIN"].update(IS_SSL=False, EPOCHS=5, EVAL_STEP=1, FREQ_EVAL=5,
                            SAVE_CP=os.path.join(tmp, "ck"),
                            LOG_DIR=os.path.join(tmp, "log"))
        path = os.path.join(tmp, "sup.yaml")
        Path(path).write_text(yaml.safe_dump(cfg))
        preview = os.path.join(tmp, "preview.png")
        with mock.patch.object(learn.preempt, "install", lambda: None):
            learn.main(["--config", path, "--preview", preview, "--device",
                        "cpu"])
        assert os.path.getsize(preview) > 0
        assert os.path.getsize(os.path.join(tmp, "log",
                                            "triplet_dist_epoch5.png")) > 0
        confusion = os.path.join(tmp, "confusion.png")
        evaluate.main(["--config", path, "--checkpoint",
                       ckpt_io.latest_checkpoint(cfg["TRAIN"]["SAVE_CP"]),
                       "--confusion", confusion, "--device", "cpu"])
        assert os.path.getsize(confusion) > 0
