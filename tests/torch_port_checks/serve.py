"""Port checks: the serving slice end to end, against the JAX package.

A flax ``resnet_tiny`` goes through ``from_jax_params`` and the port's
``export_model``; ``make_server(device="cpu")`` serves it over real HTTP.
Its probabilities are compared with the JAX ``make_infer_fn`` at atol 1e-5
(float32 on both sides; the logits agree to ~1e-5 and softmax does not
amplify that).
"""

import contextlib
import functools
import io
import json
import tempfile
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.serve.export import make_infer_fn as jax_make_infer_fn
from endoscopy_tpu_torch.ckpt.convert import from_jax_params, write_npz
from endoscopy_tpu_torch.cli import export_model as export_cli
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.serve.export import export_model, load_exported
from endoscopy_tpu_torch.serve.server import make_server

from torch_port_checks.models import NUM_CLASSES, flax_tiny

IMG = 24
CANON = int(IMG * 1.2)


def _config():
    return default_config({"DATA": {"IMG_SIZE": IMG},
                           "MODEL": {"NAME": "resnet_tiny",
                                     "NUM_CLASSES": NUM_CLASSES},
                           "TRAIN": {"DTYPE": "float32"}})


@functools.cache
def exported():
    """The exported artifact's path and the JAX infer function; the
    directory lives as long as the process."""
    model, params, stats = flax_tiny(seed=3)
    tmp = tempfile.TemporaryDirectory()
    exported.tmp = tmp  # removed when the process ends
    path = str(Path(tmp.name) / "tiny.pt")
    size, n = export_model(_config(), from_jax_params(params, stats), path)
    assert (size, n) == (CANON, NUM_CLASSES)
    ref = jax_make_infer_fn(model, params, stats, IMG, jnp.float32)
    return path, ref


def _post(port, img):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=img.tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def check_http_predict_matches_jax_infer():
    path, ref_fn = exported()
    imgs = np.random.default_rng(0).integers(
        0, 256, (6, CANON, CANON, 3)).astype(np.uint8)
    ref = np.asarray(ref_fn(jnp.asarray(imgs)))
    server = make_server(path, host="127.0.0.1", port=0, buckets=(1, 2, 4),
                         max_wait_ms=20, device="cpu", log=lambda *_: None)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        health = _get(port, "/healthz")
        assert health["backend"] == "cpu"
        assert health["input_size"] == CANON
        assert health["num_classes"] == NUM_CLASSES
        with ThreadPoolExecutor(6) as pool:
            replies = list(pool.map(lambda im: _post(port, im), imgs))
        probs = np.asarray([r["probs"] for r in replies])
        np.testing.assert_allclose(probs, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)
        assert [r["pred"] for r in replies] == list(ref.argmax(1))
        stats = _get(port, "/stats")
        assert stats["requests"] == 6 and stats["errors"] == 0
    finally:
        server.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def check_load_exported_contract_and_batch_sizes():
    path, ref_fn = exported()
    infer = load_exported(path, device="cpu")
    assert (infer.input_size, infer.num_classes, infer.batch) == (
        CANON, NUM_CLASSES, None)
    for n in (1, 3):
        imgs = np.random.default_rng(n).integers(
            0, 256, (n, CANON, CANON, 3)).astype(np.uint8)
        np.testing.assert_allclose(infer(imgs),
                                   np.asarray(ref_fn(jnp.asarray(imgs))),
                                   rtol=0, atol=1e-5)


def check_export_cli_from_npz():
    _, params, stats = flax_tiny(seed=4)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = Path(tmp)
        npz = str(tmp_path / "w.npz")
        write_npz(npz, params, stats)
        cfg = tmp_path / "c.yaml"
        cfg.write_text(f"DATA:\n  IMG_SIZE: {IMG}\nMODEL:\n  NAME: resnet_tiny\n"
                       f"  NUM_CLASSES: {NUM_CLASSES}\nTRAIN:\n  DTYPE: float32\n")
        out = str(tmp_path / "m.pt")
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            export_cli.main(["--config", str(cfg), "--weights", npz, "--out",
                             out, "--batch", "2", "--device", "cpu"])
        assert "checked: probs (2, 4)" in stdout.getvalue()
        assert load_exported(out, device="cpu").batch == 2


def check_export_cli_refuses_unported_sources():
    """int8 PTQ is refused; ``--checkpoint`` is ported (``learn.py``)."""
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(SystemExit), \
                contextlib.redirect_stderr(io.StringIO()):
            export_cli.main(["--config", "c.yaml", "--out",
                             str(Path(tmp) / "m.pt"), "--weights", "w.npz",
                             "--quantize", "int8"])


def check_load_exported_rejects_foreign_file():
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "x.pt")
        torch.save({"format": "something-else"}, path)
        with pytest.raises(ValueError, match="artifact"):
            load_exported(path, device="cpu")
