"""Port checks: the package imports no JAX, and its entry points default to CUDA.

The import check runs in a fresh interpreter, so what the test process
itself has imported cannot hide a leak.
"""

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
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.serve import export, server

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "endoscopy_tpu_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def check_package_imports_no_jax():
    mods = _modules()
    assert "endoscopy_tpu_torch.ops.randaugment_kernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'endoscopy_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _u8():
    return np.zeros((1, 28, 28, 3), np.uint8)


def check_entry_points_need_cuda_unless_cpu_is_asked():
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(torch.cuda, "is_available", lambda: False):
        for entry in ("resolve_device", "eval_view", "fixmatch_views",
                      "make_infer_fn", "load_exported", "make_server"):
            _entry_needs_cuda(Path(tmp), entry)


def _entry_needs_cuda(tmp_path, entry):
    model = build_model(default_config({"MODEL": {"NAME": "resnet_tiny"}}))
    path = str(tmp_path / "m.pt")
    cfg = default_config({"DATA": {"IMG_SIZE": 24},
                          "MODEL": {"NAME": "resnet_tiny"}})
    export.export_model(cfg, model.state_dict(), path)
    calls = {
        "resolve_device": lambda **kw: tdevice.resolve_device(**kw),
        "eval_view": lambda **kw: views.eval_view(_u8(), 24, **kw),
        "fixmatch_views": lambda **kw: views.fixmatch_views(
            _u8(), 24, generator=torch.Generator(), **kw),
        "make_infer_fn": lambda **kw: export.make_infer_fn(model, 24, **kw),
        "load_exported": lambda **kw: export.load_exported(path, **kw),
        "make_server": lambda **kw: server.make_server(
            path, host="127.0.0.1", port=0, buckets=(1,), warmup=False,
            **kw).server_close(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    calls[entry](device="cpu")  # the explicit choice runs
