"""Port checks: the serving slice end to end, against the JAX package.

A flax ``resnet_tiny`` goes through ``from_jax_params`` and the port's
``export_model``; ``make_server(device="cpu")`` serves it over real HTTP.
Its probabilities are compared with the JAX ``make_infer_fn`` at atol 1e-5
(float32 on both sides; the logits agree to ~1e-5 and softmax does not
amplify that). Weight-only int8: the port's int8 kernels and scales equal
``quantize_tree``'s (transposed) exactly, the dequantized weights equal in
float32 and bf16, the other tensors are bit-identical; the int8 artifact's
probabilities match the JAX int8 forward at 1e-5. ``cli/infer.py``'s CSV
equals the JAX CLI's: ``pred`` exactly, ``max_prob`` at 1e-5.
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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.cli import infer as jax_infer_cli
from endoscopy_tpu.serve import quantize as jquant
from endoscopy_tpu.serve.export import make_infer_fn as jax_make_infer_fn
from endoscopy_tpu_torch.ckpt.convert import (_port_items, from_jax_params,
                                              write_npz)
from endoscopy_tpu_torch.cli import export_model as export_cli
from endoscopy_tpu_torch.cli import infer as infer_cli
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.serve import quantize
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.serve.export import export_model, load_exported
from endoscopy_tpu_torch.serve.server import make_server

from torch_port_checks.models import NUM_CLASSES, flax_tiny

IMG = 24
CANON = int(IMG * 1.2)
_tiny = functools.cache(flax_tiny)  # flax's eager init takes seconds


def _config():
    return default_config({"DATA": {"IMG_SIZE": IMG},
                           "MODEL": {"NAME": "resnet_tiny",
                                     "NUM_CLASSES": NUM_CLASSES},
                           "TRAIN": {"DTYPE": "float32"}})


@functools.cache
def exported():
    """The exported artifact's path and the JAX infer function; the
    directory lives as long as the process."""
    model, params, stats = _tiny(3)
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
    _, params, stats = _tiny(4)
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


def check_export_cli_quantizes_int8_and_refuses_unknown_modes():
    """``--quantize int8`` exports an int8 artifact that loads and runs;
    an unknown mode raises in the CLI, in ``export_model`` and in
    ``load_exported``."""
    _, params, stats = _tiny(4)
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
                             out, "--quantize", "int8", "--device", "cpu"])
        assert "quantize int8; checked: probs (1, 4)" in stdout.getvalue()
        assert load_exported(out, device="cpu").quantize == "int8"
        with pytest.raises(SystemExit), \
                contextlib.redirect_stderr(io.StringIO()):
            export_cli.main(["--config", str(cfg), "--out", out, "--weights",
                             npz, "--quantize", "int4", "--device", "cpu"])
        with pytest.raises(ValueError, match="unknown quantize mode"):
            export_model(_config(), from_jax_params(params, stats), out,
                         quantize="int4")
        art = torch.load(out, weights_only=True)
        art["quantize"] = "int4"
        torch.save(art, out)
        with pytest.raises(ValueError, match="unknown quantize mode"):
            load_exported(out, device="cpu")


def check_load_exported_rejects_foreign_file():
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "x.pt")
        torch.save({"format": "something-else"}, path)
        with pytest.raises(ValueError, match="artifact"):
            load_exported(path, device="cpu")


# -- weight-only int8 and cli/infer.py ------------------------------------


def _jax_q(tree, part):
    """A tree of ``quantize_tree``'s q-nodes with each node replaced by its
    int8 values (``part`` 0) or its scale broadcast to them (1), so that
    ``_port_items`` lays it out as the port's weights."""
    def pick(node):
        if jquant._is_qnode(node):
            q = np.asarray(node[jquant._Q])
            return q if part == 0 else np.broadcast_to(
                np.asarray(node[jquant._S]), q.shape)
        return node
    return jax.tree.map(pick, tree, is_leaf=jquant._is_qnode)


def _same_quantization(params, stats, overrides):
    """The port's ``quantize_state_dict`` of the model converted from
    ``params``/``stats`` against ``quantize_tree(params)``."""
    model = build_model(default_config(overrides))
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    qsd = quantize.quantize_state_dict(model)
    jq = jquant.quantize_tree(params)
    want_q = dict(_port_items(_jax_q(jq, 0), None))
    want_s = dict(_port_items(_jax_q(jq, 1), None))
    kernels = {k for k, v in qsd.items() if quantize._is_qnode(v)}
    assert kernels == {k for k, v in want_q.items() if v.dtype == np.int8}
    sd = model.state_dict()
    for k, v in qsd.items():
        if k in kernels:
            assert v["int8"].dtype == torch.int8 and v["scale"].dtype == torch.float32
            np.testing.assert_array_equal(v["int8"].numpy(), want_q[k], err_msg=k)
            np.testing.assert_array_equal(
                v["scale"].expand(v["int8"].shape).numpy(), want_s[k], err_msg=k)
        else:
            assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = quantize.dequantize_state_dict(qsd, tdt)
        want = dict(_port_items(jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)),
            jquant.dequantize_tree(jq, jdt)), None))
        for k in kernels:
            assert got[k].dtype == tdt
            np.testing.assert_array_equal(got[k].float().numpy(), want[k],
                                          err_msg=f"{k} {tdt}")
    assert quantize.quantized_fraction(qsd, model) == jquant.quantized_fraction(jq)
    return model, qsd


def check_int8_quantization_matches_jax():
    """``resnet_tiny`` under the linear head and under ``ModelwEmb`` (the MLP
    and projection heads are dense kernels too), one output channel of a
    convolution set to zero (scale 1, q 0)."""
    _, params, stats = _tiny(3)
    params = jax.tree.map(np.array, params)  # a copy
    params["backbone"]["layer1_0"]["conv2"]["kernel"][..., 3] = 0.0
    model, qsd = _same_quantization(
        params, stats, {"MODEL": {"NAME": "resnet_tiny",
                                  "NUM_CLASSES": NUM_CLASSES}})
    zero = qsd["backbone.layer1.0.conv2.weight"]
    assert float(zero["scale"][3]) == 1.0 and not zero["int8"][3].any()
    from torch_port_checks.supervised import _jax_sup_base, _sup_overrides
    st = _jax_sup_base(True).state
    _same_quantization(jax.tree.map(np.asarray, st.params),
                       jax.tree.map(np.asarray, st.batch_stats),
                       _sup_overrides(True))


@functools.cache
def exported_int8():
    """The int8 artifact of ``exported()``'s weights, its size against the
    float32 artifact's, and the JAX int8 infer function."""
    model, params, stats = _tiny(3)
    path = str(Path(exported()[0]).parent / "tiny_int8.pt")
    export_model(_config(), from_jax_params(params, stats), path,
                 quantize="int8")
    ref = jax_make_infer_fn(model, params, stats, IMG, jnp.float32,
                            quantize="int8")
    return path, ref


def check_int8_export_matches_jax():
    """The int8 artifact is under 0.55 of the float32 one
    (``tests/test_serve.py``'s bar) and its probabilities match the JAX
    int8 forward's; the float32 and int8 artifacts keep the argmax."""
    path, ref_fn = exported_int8()
    full = Path(exported()[0]).stat().st_size
    assert Path(path).stat().st_size < 0.55 * full, (Path(path).stat().st_size, full)
    infer = load_exported(path, device="cpu")
    assert infer.quantize == "int8"
    imgs = np.random.default_rng(7).integers(
        0, 256, (5, CANON, CANON, 3)).astype(np.uint8)
    got = infer(imgs)
    np.testing.assert_allclose(got, np.asarray(ref_fn(jnp.asarray(imgs))),
                               rtol=0, atol=1e-5)
    plain = load_exported(exported()[0], device="cpu")(imgs)
    np.testing.assert_allclose(got, plain, rtol=0, atol=0.03)


def _jax_artifact(ref_fn, path):
    """A JAX artifact of ``ref_fn`` with a symbolic batch, as the JAX
    ``export_model`` writes it (its checkpoint loading aside)."""
    from jax import export as jax_export

    (b,) = jax_export.symbolic_shape("b")
    spec = jax.ShapeDtypeStruct((b, CANON, CANON, 3), jnp.uint8)
    exported_fn = jax_export.export(jax.jit(ref_fn), platforms=["cpu"])(spec)
    Path(path).write_bytes(exported_fn.serialize())


def check_infer_cli_matches_jax():
    """Five PNG images in batches of 2 (a ragged last batch), the int8
    artifact, with ``--thres`` and without: the same CSV as the JAX
    ``cli/infer.py`` on the JAX artifact of the same weights; a ``--size``
    against the artifact's fails fast."""
    import cv2
    import pandas as pd

    imgs = np.random.default_rng(8).integers(
        0, 256, (5, CANON, CANON, 3)).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = Path(tmp)
        for i, im in enumerate(imgs):
            cv2.imwrite(str(tmp_path / f"im{i}.png"), im[..., ::-1])
        csv_path = tmp_path / "in.csv"
        pd.DataFrame({"image": [f"im{i}.png" for i in range(5)],
                      "extra": np.arange(5)}).to_csv(csv_path, index=False)
        for name, (port_path, ref_fn) in (("int8", exported_int8()),):
            jax_path = str(tmp_path / f"{name}.jaxexport")
            _jax_artifact(ref_fn, jax_path)
            plain = None
            for thres in (None, "gap"):
                if thres is not None:  # in the widest gap of the max_probs
                    v = np.sort(plain["max_prob"].to_numpy())
                    i = int(np.argmax(np.diff(v)))
                    thres = float(v[i] + v[i + 1]) / 2
                extra = [] if thres is None else ["--thres", repr(thres)]
                outs = []
                for main, model, dev in ((jax_infer_cli.main, jax_path, []),
                                         (infer_cli.main, port_path,
                                          ["--device", "cpu"])):
                    out = str(tmp_path / f"out{len(outs)}.csv")
                    with contextlib.redirect_stdout(io.StringIO()):
                        main(["--model", model, "--images", str(csv_path),
                              "--root", tmp, "--out", out, "--batch", "2",
                              *extra, *dev])
                    outs.append(pd.read_csv(out))
                want, got = outs
                assert list(got.columns) == list(want.columns), name
                for col in want.columns:
                    if col == "max_prob":
                        np.testing.assert_allclose(got[col], want[col],
                                                   rtol=0, atol=1e-5)
                    else:
                        assert got[col].tolist() == want[col].tolist(), (
                            name, col, got.to_dict(), want.to_dict())
                if thres is None:
                    plain = got
                else:
                    assert got["pred"].tolist() == (
                        plain["pred"] * (plain["max_prob"] > thres)).tolist()
        with pytest.raises(SystemExit, match="input edge"):
            infer_cli.main(["--model", exported()[0], "--images",
                            str(csv_path), "--out", str(tmp_path / "x.csv"),
                            "--size", str(CANON + 1), "--device", "cpu"])
