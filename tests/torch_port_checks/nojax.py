"""Port checks: the package imports no JAX, and its entry points default to CUDA.

The import check runs in a fresh interpreter, so what the test process
itself has imported cannot hide a leak. It covers every module of the
package and ``tests/torch_port_checks/path_{c,...,l}.py``, which
``chip_smoke.py`` runs on the card's machine: no JAX and nothing of
``endoscopy_tpu``, and none of what that machine lacks (pandas, cv2, PIL,
PyYAML) at import time. ``chip_smoke.py`` itself is read, not run: no
import statement in it names JAX or the JAX package.
"""

import ast
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from endoscopy_tpu_torch import device as tdevice
from endoscopy_tpu_torch.aug import views
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.cli import learn
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.serve import export, server
from endoscopy_tpu_torch.train.comatch import CoMatch
from endoscopy_tpu_torch.train.common import BaseTrainer
from endoscopy_tpu_torch.train.ezbm import EZBM
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from endoscopy_tpu_torch.train.semiformer import SemiFormer
from endoscopy_tpu_torch.train.supervised import SupLearning
from torch_port_checks import path_d

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "endoscopy_tpu_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


NOT_ON_THE_CARD = ("jax", "jaxlib", "flax", "optax", "orbax", "endoscopy_tpu",
                   "pandas", "cv2", "PIL", "yaml")


def check_package_imports_no_jax():
    mods = _modules() + [f"torch_port_checks.path_{p}" for p in "cdefghijkl"]
    assert {"endoscopy_tpu_torch.ops.randaugment_kernel",
            "endoscopy_tpu_torch.cli.learn",
            "endoscopy_tpu_torch.ckpt.io",
            "endoscopy_tpu_torch.train.supervised",
            "endoscopy_tpu_torch.models.modelwemb",
            "endoscopy_tpu_torch.aug.mixup",
            "endoscopy_tpu_torch.losses.triplet",
            "endoscopy_tpu_torch.cli.evaluate",
            "endoscopy_tpu_torch.cli.pseudo_label",
            "endoscopy_tpu_torch.serve.quantize",
            "endoscopy_tpu_torch.cli.infer",
            "endoscopy_tpu_torch.ssl_state.comatch_state",
            "endoscopy_tpu_torch.train.comatch",
            "endoscopy_tpu_torch.models.conformer",
            "endoscopy_tpu_torch.train.semiformer",
            "endoscopy_tpu_torch.train.ezbm",
            "endoscopy_tpu_torch.models.efficientnet",
            "endoscopy_tpu_torch.models.attention"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_ON_THE_CARD!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def check_chip_smoke_imports_no_jax():
    """Every import statement of ``chip_smoke.py``, at any depth."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert "endoscopy_tpu_torch.cli" in names and "torch_port_checks" in names
    bad = [m for m in names if m.split(".")[0] in NOT_ON_THE_CARD[:6]]
    assert not bad, bad


def _u8():
    return np.zeros((1, 28, 28, 3), np.uint8)


def check_entry_points_need_cuda_unless_cpu_is_asked():
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(torch.cuda, "is_available", lambda: False):
        for entry in ("resolve_device", "eval_view", "fixmatch_views",
                      "comatch_views", "labeled_train_view", "make_infer_fn",
                      "load_exported", "make_server", "FixMatch", "CoMatch",
                      "SemiFormer", "BaseTrainer", "SupLearning", "EZBM",
                      "prepare_trainer", "restore_checkpoint"):
            _entry_needs_cuda(Path(tmp), entry)
        _clis_need_cuda(Path(tmp))


def _clis_need_cuda(tmp_path):
    """``cli/evaluate.py``, ``cli/pseudo_label.py`` and ``cli/infer.py``
    without ``--device`` raise before they read a file (``supervised.py``
    and ``serve.py`` run them with ``--device cpu``)."""
    from endoscopy_tpu_torch.cli import evaluate, infer, pseudo_label

    cfg = tmp_path / "sup.yaml"
    cfg.write_text("MODEL:\n  NAME: resnet_tiny\nTRAIN:\n  IS_SSL: False\n")
    for main, extra in ((evaluate.main, []),
                        (pseudo_label.main, ["--unlabeled-csv", "u.csv",
                                             "--out", "o.csv"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--config", str(cfg), "--checkpoint", "ck", *extra])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main(["--model", "m.pt", "--images", "in.csv", "--out", "o.csv"])


def _entry_needs_cuda(tmp_path, entry):
    model = build_model(default_config({"MODEL": {"NAME": "resnet_tiny"}}))
    path = str(tmp_path / "m.pt")
    cfg = default_config({"DATA": {"IMG_SIZE": 24},
                          "MODEL": {"NAME": "resnet_tiny"}})
    export.export_model(cfg, model.state_dict(), path)
    ckpt = ckpt_io.save_checkpoint(str(tmp_path), "epoch_1",
                                   {"w": torch.ones(2)}, {"epoch": 1})
    ssl = default_config({"DATA": {"IMG_SIZE": 24, "BATCH_SIZE": 2, "MU": 1},
                          "MODEL": {"NAME": "resnet_tiny", "NUM_CLASSES": 2},
                          "TRAIN": {"IS_SSL": True}})
    data = path_d.synthetic_data(ssl, (4, 4, 4), seed=0)
    calls = {
        "resolve_device": lambda **kw: tdevice.resolve_device(**kw),
        "eval_view": lambda **kw: views.eval_view(_u8(), 24, **kw),
        "fixmatch_views": lambda **kw: views.fixmatch_views(
            _u8(), 24, generator=torch.Generator(), **kw),
        "comatch_views": lambda **kw: views.comatch_views(
            _u8(), 24, generator=torch.Generator(), **kw),
        "labeled_train_view": lambda **kw: views.labeled_train_view(
            _u8(), 24, generator=torch.Generator(), **kw),
        "make_infer_fn": lambda **kw: export.make_infer_fn(model, 24, **kw),
        "load_exported": lambda **kw: export.load_exported(path, **kw),
        "make_server": lambda **kw: server.make_server(
            path, host="127.0.0.1", port=0, buckets=(1,), warmup=False,
            **kw).server_close(),
        "FixMatch": lambda **kw: FixMatch(model, "Adam", **kw),
        "CoMatch": lambda **kw: CoMatch(model, "Adam", **kw),
        "SemiFormer": lambda **kw: SemiFormer(model, "Adam", **kw),
        "SupLearning": lambda **kw: SupLearning(model, "Adam", **kw),
        "EZBM": lambda **kw: EZBM(model, "Adam", **kw),
        "BaseTrainer": lambda **kw: BaseTrainer(model, "Adam", **kw),
        # what cli/learn.py's run_config runs before fit, and --device
        "prepare_trainer": lambda **kw: learn.prepare_trainer(
            ssl, data=data, **kw),
        "restore_checkpoint": lambda **kw: ckpt_io.restore_checkpoint(
            ckpt, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    calls[entry](device="cpu")  # the explicit choice runs
