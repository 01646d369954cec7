"""Port checks: ``cli/learn.py`` and what it stands on, against the JAX package.

float32 on the CPU: ``resnet_tiny`` at 32 px, B=8, MU=2 (``train.py``'s
setting, its shared initial JAX state and its step helpers), and the JAX
package's ``make_synthetic_dataset`` (four colour classes, JPEGs and CSVs
that both packages read). Tolerances, and why:

- manifests, loader batches (pixels, targets, masks), metrics, checkpoint
  round trips, transfer grafts, the stage carry and the state a JAX
  checkpoint maps to: exact (the same numpy code, the same cv2 decode,
  copies and layout changes of the same floats);
- evaluation from the same weights: the loss 1e-5 relative (float32
  forwards in another summation order), the metrics, ``test_one`` and
  ``inference`` equal (the same argmax);
- one step after resuming a JAX checkpoint: ``train.py``'s step bounds;
- ``fit``: the same sequence of epochs, evaluations and saves, and the
  same ``meta.json``, with ``train_one`` and ``evaluate_one`` replaced by
  the same recorded stand-ins on both sides (what the loop does with them
  is what is compared; the two training steps are compared in
  ``train.py``). The JAX CLI runs likewise with its ``train_one`` stood in
  (a real JAX epoch costs about a minute of compile time here); the
  port's CLI runs for real, in its own process.
"""

import contextlib
import copy
import functools
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from endoscopy_tpu.ckpt import orbax_io as jax_orbax_io
from endoscopy_tpu.ckpt import transfer as jtransfer
from endoscopy_tpu.ckpt.torch_import import export_resnet_torch_state
from endoscopy_tpu.cli import learn as jax_learn
from endoscopy_tpu.data import manifest as jmanifest
from endoscopy_tpu.data import pipeline as jpipeline
from endoscopy_tpu.data.synthetic import _class_image, make_synthetic_dataset
from endoscopy_tpu.eval import metrics as jmetrics
from endoscopy_tpu.train import preempt as jpreempt
from endoscopy_tpu.train import state as jax_state
from endoscopy_tpu.train.fixmatch import FixMatch as JaxFixMatch
from endoscopy_tpu.utils.meters import AverageMeter as JaxMeter
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt import transfer
from endoscopy_tpu_torch.ckpt.convert import write_npz
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data import manifest, pipeline
from endoscopy_tpu_torch.eval import metrics
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.train import preempt
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from endoscopy_tpu_torch.utils.meters import AverageMeter
from torch_port_checks import path_d
from torch_port_checks.train import (B, CANON, IMG, NUM_CLASSES, OVERRIDES,
                                     ROOT, _compare_step, _core_inputs,
                                     _jax_base, _jax_config, _jax_trainer,
                                     _JitInit, _port_state, _port_trainer,
                                     _weights)

N_TRAIN, N_VALID, N_UNLABELED = 40, 12, 16


@functools.cache
def _dataset():
    """The synthetic dataset, in a directory kept for the process."""
    tmp = tempfile.TemporaryDirectory()
    paths = make_synthetic_dataset(
        tmp.name, num_classes=NUM_CLASSES, n_train=N_TRAIN, n_valid=N_VALID,
        n_unlabeled=N_UNLABELED, img_size=48)
    return tmp, paths


def _data_overrides(mock_ssl: bool = True):
    _, (img_root, anno, unl_root, unanno) = _dataset()
    return {"PATH": img_root, "ANNO": anno, "UNANNO_PATH": unl_root,
            "UNANNO": unanno, "MOCKUP_SSL": mock_ssl}


def _configs(mock_ssl: bool = True, **train):
    """(jax config, port config) of ``train.py``'s setting on the dataset."""
    over = copy.deepcopy(OVERRIDES)
    over["DATA"].update(_data_overrides(mock_ssl))
    over["TRAIN"].update(train)
    over["TRAIN"]["IS_SSL"] = True
    return _jax_config(over), default_config(over)


def _frames(cfg):
    anno = pd.read_csv(cfg.DATA.ANNO)
    return anno, (None if cfg.DATA.MOCKUP_SSL else pd.read_csv(cfg.DATA.UNANNO))


# -- (a) manifests, (b) loaders, (c) metrics ----------------------------------


def _same_manifest(got, want):
    assert list(got.paths) == list(want.paths)
    np.testing.assert_array_equal(got.targets, want.targets)


def check_manifests_match_jax():
    """Mock and real SSL pools, the supervised splits and ``cls_num_list``:
    exact. ``shard_for_host`` is the identity in one process and raises
    in a group of several."""
    for mock_ssl in (True, False):
        jcfg, cfg = _configs(mock_ssl)
        anno, unanno = _frames(cfg)
        got = manifest.build_ssl_manifests(cfg, anno, unanno)
        want = jmanifest.build_ssl_manifests(jcfg, anno, unanno)
        for g, w in zip(got[:3], want[:3]):
            _same_manifest(g, w)
        assert got[3] == want[3] and len(got[1]) > 0
        for full in (True, False):
            got = manifest.build_supervised_manifests(cfg, anno, full)
            want = jmanifest.build_supervised_manifests(jcfg, anno, full)
            _same_manifest(got[0], want[0])
            _same_manifest(got[1], want[1])
            assert got[2] == want[2]
    assert (manifest.get_cls_num_list(np.array([0, 2, 2]), 4)
            == jmanifest.get_cls_num_list(np.array([0, 2, 2]), 4))
    m = got[0]
    assert manifest.shard_for_host(m) is m
    dist = torch.distributed
    with mock.patch.object(dist, "is_initialized", lambda: True), \
            mock.patch.object(dist, "get_world_size", lambda: 2), \
            pytest.raises(NotImplementedError, match="ROADMAP.md"):
        manifest.shard_for_host(m)


def check_loaders_match_jax():
    """The same seed gives the same batches (pixels and targets), through
    several reshuffled passes, from the cache and streaming; ``sample``;
    ``EvalLoader``'s padded last batch and its mask: exact."""
    jcfg, cfg = _configs()
    anno, _ = _frames(cfg)
    lab, _, valid, _ = manifest.build_ssl_manifests(cfg, anno)
    jlab, _, jvalid, _ = jmanifest.build_ssl_manifests(jcfg, anno)
    ref = jpipeline.CanonicalLoader(jlab, B, CANON, seed=3)
    want = list(zip(range(6), ref))  # 20 rows: 2.4 reshuffled passes
    for cache in (True, False):
        got = pipeline.CanonicalLoader(lab, B, CANON, seed=3, cache=cache)
        for (_, (x, t)), (_, (wx, wt)) in zip(zip(range(6), got), want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(got.sample([4, 0, 4]),
                                      ref.sample([4, 0, 4]))
        got.close()
    ref.close()
    for cache in (None, False):
        got = pipeline.EvalLoader(valid, B, CANON, cache=cache)
        ref = jpipeline.EvalLoader(jvalid, B, CANON, cache=cache)
        assert len(got) == len(ref) == 2
        batches = list(zip(got, ref))
        assert len(batches) == 2
        for g, w in batches:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        assert batches[-1][0][2].sum() == N_VALID - B


def check_metrics_match_jax():
    """Seeded predictions with a class never predicted and a class absent:
    every value equal, ``sen/spec`` as the DataFrame's columns."""
    rng = np.random.default_rng(11)
    target = rng.integers(0, 4, 60)
    pred = np.where(rng.random(60) < 0.6, target, rng.integers(0, 4, 60))
    pred[pred == 3] = 2
    for c in (4, 5):
        got = metrics.calculate_metrics(pred, target, num_classes=c)
        want = jmetrics.calculate_metrics(pred, target, num_classes=c)
        assert set(got) == set(want)
        for k in want:
            if k != "sen/spec":
                assert got[k] == want[k], k
        for col in want["sen/spec"].columns:
            np.testing.assert_array_equal(got["sen/spec"][col],
                                          want["sen/spec"][col].to_numpy())
        np.testing.assert_array_equal(
            metrics.confusion_matrix(target, pred, c),
            jmetrics.confusion_matrix(target, pred, c))


# -- shared JAX state: two Adam steps ----------------------------------------


@functools.cache
def _jax_adam():
    """The JAX Adam trainer after one ``_train_core`` step (the EMA and the
    moments moved), the second step from there on the same views, and its
    valid loader."""
    jt = _jax_trainer("Adam")
    core = jax.jit(jt._train_core)
    (x, u_w, u_s), t = _core_inputs()
    args = (x, u_w, u_s, jnp.asarray(t), jnp.asarray(_weights()),
            jax.random.key(0))
    state1 = core(jt.state, *args)[0]
    second = core(state1, *args)
    jt.state = state1
    jcfg, _ = _configs()
    _, _, jvalid, _ = jmanifest.build_ssl_manifests(jcfg, _frames(jcfg)[0])
    jt.valid_dl = jpipeline.EvalLoader(jvalid, B, CANON)
    return jt, second


def _port_at(state, opt: str = "Adam"):
    """A port trainer holding the JAX ``state``'s weights and EMA, with the
    dataset's valid loader."""
    port = _port_trainer(opt)
    port.state.model.load_state_dict(_port_state(state.params,
                                                 state.batch_stats))
    port.state.ema.load_state_dict(_port_state(state.ema_params,
                                               state.ema_batch_stats))
    _, cfg = _configs()
    _, _, valid, _ = manifest.build_ssl_manifests(cfg, _frames(cfg)[0])
    port.valid_dl = pipeline.EvalLoader(valid, B, CANON)
    return port


@functools.cache
def _jax_eval(use_ema: bool):
    jt = copy.copy(_jax_adam()[0])
    jt.use_ema = use_ema
    return jt.evaluate_one(), jt.test_one(), jt.inference(jt.valid_dl)


def _same_eval(port, use_ema: bool):
    (jloss, jmetric), jwrong, jpseudo = _jax_eval(use_ema)
    loss, metric = port.evaluate_one()
    np.testing.assert_allclose(loss.avg, jloss.avg, rtol=1e-5)
    assert loss.count == jloss.count == N_VALID
    assert {k: v for k, v in metric.items() if k != "sen/spec"} == {
        k: v for k, v in jmetric.items() if k != "sen/spec"}
    np.testing.assert_array_equal(port.test_one(), jwrong)
    assert port.inference(port.valid_dl) == jpseudo


# -- (d) evaluation, (e) checkpoints, (f) a JAX checkpoint ---------------------


def check_evaluation_matches_jax():
    """``evaluate_one``, ``test_one`` and ``inference`` from the same
    weights, on the EMA teacher and on the model (they differ after a
    step); the teacher's loss differs from the model's."""
    port = _port_at(_jax_adam()[0].state)
    losses = []
    for use_ema in (True, False):
        port.use_ema = use_ema
        _same_eval(port, use_ema)
        losses.append(_jax_eval(use_ema)[0][0].avg)
    assert losses[0] != losses[1]


def _assert_same_state(got, want):
    got, want = path_d.flat_state(got), path_d.flat_state(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def check_checkpoint_round_trip_and_crash_cases():
    """A trainer's state through ``save_checkpoint``/``load_checkpoint``
    bit-identical, with the meta fields the JAX trainer writes for the same
    epoch and loss; and the four crash and re-save cases of
    ``tests/test_ckpt_durability.py`` against ``ckpt/io.py``."""
    jt, _ = _jax_adam()
    with tempfile.TemporaryDirectory() as tmp:
        port = _port_at(jt.state)
        port._train_core(*(torch.from_numpy(np.asarray(v))
                           for v in _core_inputs()[0]),
                         torch.from_numpy(_core_inputs()[1]).long(),
                         torch.from_numpy(_weights()))
        jt2 = copy.copy(jt)
        for trainer in (port, jt2):
            trainer.epoch, trainer.best_valid_perf = 3, 0.625
        path = port.save_checkpoint(os.path.join(tmp, "port"))
        jpath = jt2.save_checkpoint(os.path.join(tmp, "jax"))
        jax_orbax_io.wait_until_finished()
        metas = [json.loads(Path(p, "meta.json").read_text())
                 for p in (path, jpath)]
        assert metas[0] == metas[1] == {"epoch": 3, "best_valid_perf": 0.625,
                                        "trainer": "FixMatch",
                                        "img_size": IMG}
        fresh = _port_trainer("Adam")
        fresh.load_checkpoint(path, is_train=True)
        _assert_same_state(fresh.state.state_dict(), port.state.state_dict())
        assert fresh.state.step == 1 and fresh.epoch_start == 3
        assert fresh.best_valid_perf == 0.625 and fresh._resumed
        with pytest.raises(RuntimeError, match="device='cpu'"), \
                mock.patch.object(torch.cuda, "is_available", lambda: False):
            ckpt_io.restore_checkpoint(path)
    _crash_cases()


def _crash_cases():
    def state(shift):
        return {"w": torch.arange(4.0) + shift, "b": torch.ones(2, 2) + shift}

    def restored_w(d):
        latest = ckpt_io.latest_checkpoint(d)
        return latest, ckpt_io.restore_checkpoint(latest, "cpu")[0]["w"]

    def debris(d):
        return [p.name for p in Path(d).rglob("*.tmp")]

    with tempfile.TemporaryDirectory() as d:  # 1: a crash before the write
        ckpt_io.save_checkpoint(d, "epoch_1", state(0), {"epoch": 1})

        def crashing_save(*a, **k):
            raise RuntimeError("simulated crash")

        with mock.patch.object(ckpt_io.torch, "save", crashing_save), \
                pytest.raises(RuntimeError, match="simulated"):
            ckpt_io.save_checkpoint(d, "epoch_1", state(100), {"epoch": 1})
        latest, w = restored_w(d)
        assert latest.endswith("epoch_1") and torch.equal(w, state(0)["w"])
        assert not debris(d)
    with tempfile.TemporaryDirectory() as d:  # 2: written, not yet renamed
        ckpt_io.save_checkpoint(d, "epoch_3", state(0), {"epoch": 3})
        real_replace = os.replace

        def crash_on_state(src, dst):
            if dst.endswith(ckpt_io.STATE):
                raise OSError("simulated crash before the rename")
            real_replace(src, dst)

        with mock.patch.object(ckpt_io.os, "replace", crash_on_state), \
                pytest.raises(OSError, match="simulated"):
            ckpt_io.save_checkpoint(d, "epoch_3", state(7), {"epoch": 3})
        latest, w = restored_w(d)
        assert latest.endswith("epoch_3") and torch.equal(w, state(0)["w"])
        assert not debris(d)
    with tempfile.TemporaryDirectory() as d:  # 3: an initial save cut short
        ckpt_io.save_checkpoint(d, "epoch_1", state(0), {"epoch": 1})
        os.makedirs(os.path.join(d, "epoch_2"))
        Path(d, "epoch_2", "meta.json").write_text('{"epoch": 2}')
        assert ckpt_io.latest_checkpoint(d).endswith("epoch_1")
        with pytest.raises(FileNotFoundError):
            ckpt_io.restore_checkpoint(os.path.join(d, "epoch_2"), "cpu")
    with tempfile.TemporaryDirectory() as d:  # 4: a clean re-save
        ckpt_io.save_checkpoint(d, "epoch_5", state(0), {"epoch": 5})
        path = ckpt_io.save_checkpoint(d, "epoch_5", state(7), {"epoch": 5})
        assert torch.equal(ckpt_io.restore_checkpoint(path, "cpu")[0]["w"],
                           state(7)["w"])
        assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    assert ckpt_io.latest_checkpoint(os.path.join(d, "gone")) is None


def _orbax_to_npz():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", ROOT / "tools" / "torch_port" / "orbax_to_npz.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.orbax_to_npz


def _port_params(tree):
    """A parameter-shaped flax tree (Adam's ``mu``/``nu``) by port name."""
    from endoscopy_tpu_torch.ckpt.convert import _port_items
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in _port_items(jax.tree.map(np.asarray, tree), None)}


def check_jax_checkpoint_resumes_in_the_port():
    """A JAX FixMatch checkpoint (one Adam step) through
    ``tools/torch_port/orbax_to_npz.py`` and ``load_checkpoint``: weights,
    BN statistics, EMA, Adam's moments and count, and the step equal the
    mapped JAX state; the evaluation equals the JAX trainer's; one more
    port step equals the JAX step from the same state on the same views
    (``train.py``'s bounds)."""
    jt, second = _jax_adam()
    st = jt.state
    with tempfile.TemporaryDirectory() as tmp:
        jax_orbax_io.save_checkpoint(
            tmp, "epoch_2", st, {"epoch": 2, "best_valid_perf": 1.5,
                                 "trainer": "FixMatch", "img_size": IMG},
            block=True)
        npz = os.path.join(tmp, "state.npz")
        _orbax_to_npz()(os.path.join(tmp, "epoch_2"), npz)
        port = _port_at(_jax_base().state)  # other weights, to be replaced
        port.load_checkpoint(npz, is_train=True)
    assert port.state.step == 1 and port.epoch_start == 2
    assert port.best_valid_perf == 1.5
    sd = port.state.state_dict()
    adam = st.opt_state[0]
    mu, nu = _port_params(adam.mu), _port_params(adam.nu)
    for part, (p, s) in (("model", (st.params, st.batch_stats)),
                         ("ema", (st.ema_params, st.ema_batch_stats))):
        for k, v in _port_state(p, s).items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sd[part][k], v), (part, k)
    assert set(sd["optimizer"]) == set(mu)
    for k, s in sd["optimizer"].items():
        assert torch.equal(s["exp_avg"], mu[k]), k
        assert torch.equal(s["exp_avg_sq"], nu[k]), k
        assert float(s["step"]) == int(adam.count) == 1
    _same_eval(port, use_ema=True)
    port.use_ema = True
    (x, u_w, u_s), t = _core_inputs()
    got = port._train_core(*(torch.from_numpy(np.asarray(v))
                             for v in (x, u_w, u_s)),
                           torch.from_numpy(t).long(),
                           torch.from_numpy(_weights()))
    _compare_step(port, second, got, "Adam", start=st)


# -- (g) transfer -------------------------------------------------------------


def _donor(num_classes: int, seed: int):
    """Flax trees of another run: the shared initial trunk moved by seeded
    noise, and a head of ``num_classes``."""
    base = _jax_base().state
    rng = np.random.default_rng(seed)

    def moved(x):
        x = np.asarray(x)
        return (x + rng.normal(0, 0.1, x.shape)).astype(x.dtype)

    params = jax.tree.map(moved, base.params)
    width = params["head"]["fc"]["kernel"].shape[0]
    params["head"]["fc"] = {
        "kernel": rng.normal(0, 0.1, (width, num_classes)).astype(np.float32),
        "bias": rng.normal(0, 0.1, num_classes).astype(np.float32)}
    stats = jax.tree.map(lambda x: np.abs(moved(x)), base.batch_stats)
    return params, stats


def _no_counts(sd):
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def check_transfer_matches_jax():
    """``apply_pretrain`` from a port checkpoint directory, a ``.npz`` and
    a timm-layout ``.pth`` (``module.`` prefix, a 2-class ``fc``) grafts the
    tensors the JAX package's grafts from an orbax directory and from the
    same ``.pth``: the 2-class head keeps its fresh init, the EMA is
    re-synced. ``carry_stage_weights`` equals the JAX package's."""
    params, stats = _donor(2, seed=21)
    jcfg, cfg = _configs()
    with tempfile.TemporaryDirectory() as tmp:
        orbax_dir = os.path.join(tmp, "orbax")
        jax_orbax_io.save_checkpoint(orbax_dir, "epoch_1",
                                     {"params": params, "batch_stats": stats},
                                     {}, block=True)
        pth = os.path.join(tmp, "donor.pth")
        timm = export_resnet_torch_state(params, stats)
        timm["fc.weight"] = params["head"]["fc"]["kernel"].T
        timm["fc.bias"] = params["head"]["fc"]["bias"]
        torch.save({"model_state_dict": {
            f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
            for k, v in timm.items()}}, pth)
        npz = os.path.join(tmp, "donor.npz")
        write_npz(npz, params, stats)
        donor_cfg = copy.deepcopy(cfg)
        donor_cfg.MODEL.NUM_CLASSES = 2
        donor = FixMatch(build_model(donor_cfg), "Adam", device="cpu")
        donor.get_config(donor_cfg)
        donor.state.model.load_state_dict(_port_state(params, stats))
        port_dir = donor.save_checkpoint(os.path.join(tmp, "port"))

        wants = {}
        for name, path in (("orbax", os.path.join(orbax_dir, "epoch_1")),
                           ("pth", pth)):
            jt = copy.copy(_jax_base())
            jcfg.MODEL.PRE_TRAIN_PATH = path
            with contextlib.redirect_stdout(io.StringIO()):
                assert jtransfer.apply_pretrain(jt, jcfg)
            assert jax.tree.all(jax.tree.map(np.array_equal, jt.state.params,
                                             jt.state.ema_params))
            wants[name] = _no_counts(_port_state(jt.state.params,
                                                 jt.state.batch_stats))
        for a, b in zip(wants["orbax"].values(), wants["pth"].values()):
            assert torch.equal(a, b)
        init = _port_state(_jax_base().state.params,
                           _jax_base().state.batch_stats)
        for path in (port_dir, npz, pth):
            port = _port_trainer("Adam")
            cfg.MODEL.PRE_TRAIN_PATH = path
            with contextlib.redirect_stdout(io.StringIO()):
                assert transfer.apply_pretrain(port, cfg)
            got = port.state.model.state_dict()
            for k, v in wants["orbax"].items():
                assert torch.equal(got[k], v), (path, k)
            assert torch.equal(got["head.fc.weight"], init["head.fc.weight"])
            for k, v in port.state.ema.state_dict().items():
                assert torch.equal(v, got[k]), ("ema", k)
        cfg.MODEL.PRE_TRAIN_PATH = "None"
        assert not transfer.apply_pretrain(port, cfg)
        cfg.MODEL.PRE_TRAIN_PATH = os.path.join(tmp, "missing.pth")
        with pytest.raises(FileNotFoundError):
            transfer.apply_pretrain(port, cfg)

    params, stats = _donor(NUM_CLASSES, seed=22)
    jt = copy.copy(_jax_base())
    jtransfer.carry_stage_weights(jt, params, stats)
    port = _port_trainer("Adam")
    transfer.carry_stage_weights(port, _port_state(params, stats))
    want = _port_state(jt.state.ema_params, jt.state.ema_batch_stats)
    for sd in (port.state.model.state_dict(), port.state.ema.state_dict()):
        for k, v in _no_counts(want).items():
            assert torch.equal(sd[k], v), k


# -- (h) fit, (i) the CLI -------------------------------------------------------


class _Recorder:
    """Stand-ins for ``train_one`` and ``evaluate_one``: record the call
    and return fixed losses (a valid loss that rises after epoch 2, so
    ``best_valid_perf`` keeps an earlier value); ``preempt_at`` requests a
    preemption during that epoch's training."""

    VALID = {1: 0.9, 2: 0.5, 3: 0.7, 4: 0.6}

    def __init__(self, trainer, meter, request, preempt_at=None):
        self.trainer, self.meter, self.request = trainer, meter, request
        self.preempt_at = preempt_at
        self.events = []
        trainer.train_one = self.train_one
        trainer.evaluate_one = self.evaluate_one
        save = trainer.save_checkpoint

        def save_checkpoint(folder):
            self.events.append(("save", trainer.epoch))
            return save(folder)

        trainer.save_checkpoint = save_checkpoint

    def train_one(self, epoch):
        self.events.append(("train", epoch))
        if epoch == self.preempt_at:
            self.request()
        m = self.meter()
        m.update(1.0 / epoch, 4)
        return m

    def evaluate_one(self):
        self.events.append(("eval", self.trainer.epoch))
        m = self.meter()
        m.update(self.VALID.get(self.trainer.epoch, 1.0), 4)
        return m, {"macro/f1": 0.5, "sen/spec": None}


def _fit_both(tmp, epochs, freq, resumed_at=None, preempt_at=None):
    """Run the JAX and the port ``fit`` with the stand-ins; returns each
    side's (events, saved meta by directory, best_valid_perf)."""
    out = []
    for side, trainer, meter, module in (
            ("jax", copy.copy(_jax_adam()[0]), JaxMeter, jpreempt),
            ("port", _port_at(_jax_adam()[0].state), AverageMeter, preempt)):
        trainer.config = copy.deepcopy(trainer.config)
        save = os.path.join(tmp, f"{side}_{epochs}_{freq}_{resumed_at}_"
                                 f"{preempt_at}")
        trainer.config.TRAIN.update(EPOCHS=epochs, FREQ_EVAL=freq,
                                    SAVE_CP=save, LOG_DIR="")
        if resumed_at is not None:
            trainer._resumed, trainer.epoch_start = True, resumed_at
        rec = _Recorder(trainer, meter, module.request, preempt_at)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                trainer.fit()
            jax_orbax_io.wait_until_finished()
        finally:
            module.reset()
        saved = ({d: json.loads(Path(save, d, "meta.json").read_text())
                  for d in sorted(os.listdir(save))}
                 if os.path.isdir(save) else {})
        out.append((rec.events, saved, trainer.best_valid_perf))
    return out


def check_fit_behaves_like_jax():
    """The same epochs, evaluations, saves and ``meta.json`` as the JAX
    ``fit``: the ``FREQ_EVAL`` cadence (every second epoch of 4), a fresh
    ``EPOCHS=1`` run that trains, a resume at the final epoch that only
    evaluates, and preemption: after an epoch without an evaluation it
    saves and stops, after one with an evaluation its save stands."""
    with tempfile.TemporaryDirectory() as tmp:
        for kw, expect in (
                (dict(epochs=4, freq=2), [("train", 1), ("train", 2),
                                          ("eval", 2), ("save", 2),
                                          ("train", 3), ("train", 4),
                                          ("eval", 4), ("save", 4)]),
                (dict(epochs=1, freq=1), [("train", 1), ("eval", 1),
                                          ("save", 1)]),
                (dict(epochs=3, freq=1, resumed_at=3), [("eval", 0)]),
                (dict(epochs=4, freq=2, preempt_at=1), [("train", 1),
                                                        ("save", 1)]),
                (dict(epochs=4, freq=2, preempt_at=2), [("train", 1),
                                                        ("train", 2),
                                                        ("eval", 2),
                                                        ("save", 2)])):
            (jev, jsaved, jbest), (ev, saved, best) = _fit_both(tmp, **kw)
            assert ev == jev == expect, (kw, ev, jev)
            assert saved == jsaved and best == jbest, (kw, saved, jsaved)


def _write_stage_configs(tmp, tag):
    """Two stages on the dataset from ``configs/synthetic_smoke.yaml``: 32
    px for 2 epochs of 2 steps, then 40 px with IS_FREEZE for 1 epoch."""
    import yaml

    base = yaml.safe_load((ROOT / "configs" / "synthetic_smoke.yaml").read_text())
    out = []
    for stage, (img, epochs, extra) in enumerate(
            ((32, 2, {}), (40, 1, {"IS_FREEZE": True}))):
        cfg = copy.deepcopy(base)
        cfg["DATA"].update(_data_overrides(True), IMG_SIZE=img)
        cfg["TRAIN"].update(EPOCHS=epochs, EVAL_STEP=2, MESH_DATA=1,
                            SAVE_CP=os.path.join(tmp, tag, f"stage{stage}"),
                            **extra)
        path = os.path.join(tmp, f"{tag}_{stage}.yaml")
        Path(path).write_text(yaml.safe_dump(cfg))
        out.append(path)
    return out


def _tree(root):
    return {str(p.relative_to(root)) for p in Path(root).rglob("epoch_*")}


def check_learn_cli_runs_both_stages_like_jax():
    """``python -m endoscopy_tpu_torch.cli.learn --device cpu`` on two
    stages of ``configs/synthetic_smoke.yaml``: exit 0, and the same
    ``epoch_<N>`` directories and meta fields as the JAX CLI (``train_one``
    stood in); without ``--device`` and a card it raises (with ``--trainer
    ezbm`` too), a requested preemption exits 143 after a checkpoint, and
    ``--preview`` points at ROADMAP.md."""
    with tempfile.TemporaryDirectory() as tmp:
        port_cfgs = _write_stage_configs(tmp, "port")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        # the port's CLI runs in its own process while the JAX one runs here
        proc = subprocess.Popen(
            [sys.executable, "-m", "endoscopy_tpu_torch.cli.learn",
             "--config-1", port_cfgs[0], "--config-2", port_cfgs[1],
             "--device", "cpu"], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        jax_cfgs = _write_stage_configs(tmp, "jax")

        def stand_in(self, epoch):
            m = JaxMeter()
            m.update(1.0, 1)
            return m

        create = jax_state.create_train_state
        handler = signal.getsignal(signal.SIGTERM)
        try:
            with mock.patch.object(JaxFixMatch, "train_one", stand_in), \
                    mock.patch.object(jax_state, "create_train_state",
                                      lambda model, *a, **k: create(
                                          _JitInit(model), *a, **k)), \
                    contextlib.redirect_stdout(io.StringIO()):
                jax_learn.main(["--config-1", jax_cfgs[0],
                                "--config-2", jax_cfgs[1]])
            jax_orbax_io.wait_until_finished()
            out, err = proc.communicate(timeout=600)
        finally:
            signal.signal(signal.SIGTERM, handler)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err[-3000:]
        assert "=== stage 1 | IMG_SIZE=40 ===" in out
        port_root, jax_root = Path(tmp, "port"), Path(tmp, "jax")
        assert _tree(port_root) == _tree(jax_root) == {
            "stage0/epoch_1", "stage0/epoch_2", "stage1/epoch_1"}
        for d in _tree(jax_root):
            got = json.loads((port_root / d / "meta.json").read_text())
            want = json.loads((jax_root / d / "meta.json").read_text())
            assert set(got) == set(want)
            for k in ("epoch", "trainer", "img_size"):
                assert got[k] == want[k], (d, k)
            assert isinstance(got["best_valid_perf"], float)

        from endoscopy_tpu_torch.cli import learn
        handler = signal.getsignal(signal.SIGTERM)
        try:
            with mock.patch.object(torch.cuda, "is_available", lambda: False), \
                    pytest.raises(RuntimeError, match="device='cpu'"):
                learn.main(["--config-1", port_cfgs[0]])
            preempt.request()
            with pytest.raises(SystemExit) as exit_info, \
                    contextlib.redirect_stdout(io.StringIO()):
                learn.main(["--config-1", port_cfgs[1], "--device", "cpu"])
            assert exit_info.value.code == 143
        finally:
            preempt.reset()
            signal.signal(signal.SIGTERM, handler)
        assert (Path(tmp, "port", "stage1", "epoch_1", "state.pt").is_file())
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            learn.main(["--config-1", port_cfgs[0], "--preview", "p.png"])
        # --trainer ezbm is ported: it reaches the trainer, which asks for
        # the device (ezbm.py runs it)
        with mock.patch.object(torch.cuda, "is_available", lambda: False), \
                mock.patch.object(learn.preempt, "install", lambda: None), \
                contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(RuntimeError, match="device='cpu'"):
            learn.main(["--config-1", port_cfgs[0], "--trainer", "ezbm"])


def check_export_cli_from_a_checkpoint():
    """``cli/export_model.py --checkpoint latest`` exports the EMA weights
    of the newest complete checkpoint under ``TRAIN.SAVE_CP``."""
    from endoscopy_tpu_torch.cli import export_model as export_cli
    from endoscopy_tpu_torch.serve.export import load_exported

    port = _port_at(_jax_adam()[0].state)
    with tempfile.TemporaryDirectory() as tmp:
        port.epoch = 2
        port.save_checkpoint(os.path.join(tmp, "ck"))
        cfg = Path(tmp, "c.yaml")
        cfg.write_text(f"DATA:\n  IMG_SIZE: {IMG}\nMODEL:\n  NAME: resnet_tiny\n"
                       f"  NUM_CLASSES: {NUM_CLASSES}\nTRAIN:\n  DTYPE: float32\n"
                       f"  SAVE_CP: {os.path.join(tmp, 'ck')}\n")
        out = os.path.join(tmp, "m.pt")
        with contextlib.redirect_stdout(io.StringIO()):
            export_cli.main(["--config", str(cfg), "--checkpoint", "latest",
                             "--out", out, "--device", "cpu"])
        imgs = np.random.default_rng(2).integers(
            0, 256, (3, CANON, CANON, 3)).astype(np.uint8)
        probs = load_exported(out, device="cpu")(imgs)
        port.use_ema = True
        want = port._eval_step(port._eval_model(), imgs, np.zeros(3),
                               np.ones(3, bool))[2].numpy()
        np.testing.assert_array_equal(probs, want)


def check_path_d_images_follow_the_jax_generator():
    """``path_d.class_images`` is ``_class_image`` batched: the same noise
    draws give the same uint8 images, for six classes."""
    classes = np.array([0, 5, 3, 1, 4, 2, 5])
    rng = np.random.default_rng(9)
    want = np.stack([_class_image(rng, int(c), 20) for c in classes])
    rng = np.random.default_rng(9)
    noise = np.stack([rng.normal(0.0, 18.0, (20, 20, 3)) for _ in classes])
    np.testing.assert_array_equal(path_d.class_images(classes, 20, noise),
                                  want)
    imgs = path_d.make_images(np.random.default_rng(0), classes, 20)
    assert imgs.shape == (7, 20, 20, 3) and imgs.dtype == np.uint8
