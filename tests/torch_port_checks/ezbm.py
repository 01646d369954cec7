"""Port checks: the EZBM trainer against the JAX package.

float32 on the CPU, ``resnet_tiny`` under ``ModelwEmb`` at 32 px (canonical
38) with B=8, MU=2 and four classes (``supervised.py``'s triplet setting,
whose compiled JAX init and dropout forward these checks share), both
trainers from the JAX trainer's initial weights. Tolerances, and why:

- the stage-2 sampler over a memory with an absent class: indices, the
  feature rows, targets and ``lam`` of every step exact, for ``balance``
  and ``reverse`` (the same numpy code and ``default_rng(SEED + epoch)``);
- a stage-1 step (SGD) on the JAX step's own view and dropout mask: the
  loss 1e-5 relative, the memorized anchor features 1e-4 of their largest
  (the backbone's float32 sums in another order), parameters, BN
  statistics and EMA at ``train.py``'s step bounds;
- a stage-2 step on given features, ``lam`` and the JAX step's dropout
  mask, under SGD and Adam: the loss 1e-5 relative, ``fc``'s update 1e-4
  of its largest (a small float32 MLP, no backbone), the head's BN
  statistics after both passes 1e-4 relative, the EMA 1e-6; every
  tensor outside ``fc`` bit-identical under Adam and moved by weight decay
  alone under SGD, 1e-6 relative of its update; the port's own draw is one
  mask for both passes;
- ``fit``'s events (train, evaluate, save, the stage-2 optimizer, both
  early stops) for one scripted sequence of valid losses and F1s: equal;
  the stage switch in a real ``run_config``: a fresh optimizer whose
  learning rates restart at ``lr(0)``, the checkpoint's optimizer state
  stage 1's bit for bit;
- the Kvasir-Capsule graft (a 6-class plain checkpoint into the 11-class
  ``ModelwEmb`` through ``prepare_trainer(..., trainer_override='ezbm')``):
  every tensor equal to the JAX package's graft, the trunk bit-identical
  to the donor, ``fc`` and ``head_emb`` fresh, the EMA re-synced; the
  capsule CSV's ``path`` column read by both manifests alike;
- ``path_{h,i,j}.py``'s fields against the YAML files: equal.
"""

import contextlib
import copy
import functools
import io
import os
import tempfile
import types
from pathlib import Path
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from endoscopy_tpu.ckpt import orbax_io as jax_orbax_io
from endoscopy_tpu.ckpt import transfer as jtransfer
from endoscopy_tpu.data.manifest import (
    build_supervised_manifests as jax_manifests)
from endoscopy_tpu.losses import classification as jcls
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu.optim import optimizers as jopt
from endoscopy_tpu.train import ezbm as jezbm
from endoscopy_tpu.train import state as jax_state
from endoscopy_tpu.utils.meters import AverageMeter as JaxMeter
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt.convert import write_npz
from endoscopy_tpu_torch.cli import learn
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data.manifest import build_supervised_manifests
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.models.heads import KEEP
from endoscopy_tpu_torch.train import ezbm
from endoscopy_tpu_torch.train.ezbm import EZBM
from endoscopy_tpu_torch.utils.meters import AverageMeter
from torch_port_checks import path_e, path_h, path_i, path_j
from torch_port_checks.learn import _donor, _no_counts
from torch_port_checks.supervised import (LABELED, _dropout_forward,
                                          _dropout_masks, _step_batch,
                                          _sup_overrides)
from torch_port_checks.train import (B, IMG, NUM_CLASSES, ROOT, _close,
                                     _compare_state, _jax_config,
                                     _jax_labeled, _JitInit, _port_state)

F32 = np.float32
MU = 2
CLS_NUM = [3, 2, 1, 4]


def _overrides(num_classes: int = NUM_CLASSES, **train):
    over = _sup_overrides(True, LAMBDA_C=4.0, **train)
    over["DATA"]["MU"] = MU
    over["MODEL"]["NUM_CLASSES"] = num_classes
    return over


def _jit_init():
    create = jax_state.create_train_state
    return mock.patch.object(jax_state, "create_train_state",
                             lambda model, *a, **k: create(_JitInit(model),
                                                           *a, **k))


@functools.cache
def _jax_base(num_classes: int = NUM_CLASSES):
    """The JAX EZBM trainer (SGD) whose initial state the cases start
    from; one stage-1 step an epoch (no train loader)."""
    cfg = _jax_config(_overrides(num_classes))
    trainer = jezbm.EZBM(model=jax_build_model(cfg), opt_func="SGD")
    trainer.train_dl = trainer.valid_dl = None
    with _jit_init():
        trainer.get_config(cfg, cls_num_list=CLS_NUM, labeled_targets=LABELED)
    return trainer


def _port(opt: str = "SGD") -> EZBM:
    """The port's EZBM from the JAX trainer's initial state."""
    cfg = default_config(_overrides())
    model = build_model(cfg)
    base = _jax_base().state
    model.load_state_dict(_port_state(base.params, base.batch_stats),
                          strict=True)
    trainer = EZBM(model, opt, device="cpu")
    trainer.train_dl = None
    trainer.get_config(cfg, cls_num_list=CLS_NUM, labeled_targets=LABELED)
    return trainer


def _weights():
    return jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)


# -- the stage-2 sampler --------------------------------------------------------


def _memory(seed: int):
    """Memorized features and targets of three epochs' steps, class 2
    absent (its count in ``cls_num_list`` is not 0: ``reverse`` draws it
    and must draw again)."""
    rng = np.random.default_rng(seed)
    targets = [rng.choice([0, 1, 3], B) for _ in range(3)]
    feats = [rng.normal(0, 1, (B, 6)).astype(F32) for _ in range(3)]
    return feats, targets


def _recorded_stage2(trainer, jax_side: bool, epoch: int):
    """The inputs of every stage-2 step ``train_one_stage_2(epoch)``
    takes, the step itself stood in."""
    steps = []
    if jax_side:
        def step(state, opt, f, y, fd, yd, lam, rng):
            steps.append([np.asarray(v) for v in (f, y, fd, yd, lam)])
            return state, opt, jnp.float32(0.0)
        trainer._stage2_step, trainer._next_rng = step, lambda: None
        trainer.state = trainer._opt_state2 = None
    else:
        def core(f, y, fd, yd, lam, keep_mask=None):
            steps.append([v.numpy() for v in (f, y, fd, yd, lam)])
            return torch.tensor(0.0)
        trainer._stage2_core = core
    trainer.train_one_stage_2(epoch)
    return steps


def check_stage2_sampler_matches_jax():
    """``train_one_stage_2`` with its step stood in, on one memory, for
    ``balance`` and ``reverse``: the same number of steps, and in each the
    same feature rows, targets, dual rows and ``lam``."""
    feats, targets = _memory(31)
    for expansion in ("balance", "reverse"):
        over = _overrides(EXPANSION=expansion, SEED=7)
        over["DATA"]["BATCH_SIZE"] = 4
        jt = jezbm.EZBM(model=None)
        jt.config, jt.cls_num_list, jt.expansion = (_jax_config(over),
                                                    CLS_NUM, expansion)
        jt.mem_features, jt.mem_targets = feats, targets
        port = EZBM(device="cpu")
        port.config, port.cls_num_list, port.expansion = (
            default_config(over), CLS_NUM, expansion)
        port.mem_features = [torch.from_numpy(f) for f in feats]
        port.mem_targets = targets
        want = _recorded_stage2(jt, True, 3)
        got = _recorded_stage2(port, False, 3)
        assert len(got) == len(want) == 3 * B // (4 * MU)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b), expansion
        lam = np.concatenate([g[4] for g in got])
        assert lam.dtype == np.float32 and lam.shape == (3 * B, 1)
        assert not (np.concatenate([g[3] for g in got]) == 2).any()
        assert (lam == 0.5).all() == (expansion == "balance"), lam.ravel()


# -- the steps --------------------------------------------------------------------


def check_stage1_step_matches_jax():
    """One stage-1 SGD step on the JAX step's view and dropout mask: the
    loss, the anchors' features, every update. Then two epochs of
    ``train_one_stage_1``: each memorizes its own steps' anchors (on the
    device) and targets."""
    jt = _jax_base()
    u8, t = _step_batch(40, True)
    w = _weights()
    key = jax.random.key(40)
    jstate, jloss, jfts = jt._stage1_step(jt.state, jnp.asarray(u8),
                                          jnp.asarray(t), jnp.asarray(w), key)
    k_aug, k_drop = jax.random.split(key)
    x = _jax_labeled(jnp.asarray(u8), k_aug, IMG, jnp.float32)
    (mask,) = _dropout_masks(_dropout_forward(jt.model)(
        jt.state.params, jt.state.batch_stats, x, k_drop)[2])
    port = _port()
    port.state.model.fc.keep_mask = torch.from_numpy(mask)
    loss, fts = port._stage1_core(torch.from_numpy(np.asarray(x)),
                                  torch.from_numpy(t).long(),
                                  torch.from_numpy(w))
    _close(float(loss), float(jloss), rtol=1e-5, what="loss")
    jfts = np.asarray(jfts)
    assert fts.shape == jfts.shape == (B, 256)
    _close(fts.numpy(), jfts, rtol=0, atol=1e-4 * np.abs(jfts).max())
    _compare_state(port, jstate, "SGD", (), jt.state)

    port = _port()
    port.get_dataloader(path_e._Rows(port.config, 41, n=3 * B), None)
    port.n_iter_per_epoch = 2
    seen = []  # (targets, (loss, anchor features)) of every step
    step = port._stage1_step
    port._stage1_step = lambda x3, t, w: seen.append((t, step(x3, t, w))) \
        or seen[-1][1]
    for epoch in (1, 2):
        port.train_one_stage_1(epoch)
        assert len(port.mem_features) == len(port.mem_targets) == 2
        for f, t, (want_t, (_, want)) in zip(port.mem_features,
                                             port.mem_targets, seen[-2:]):
            assert f is want and f.device == port.device
            assert np.array_equal(t, want_t)


def _classify_dropout(model):
    """A compiled train-mode ``classify_features`` recording its dropout
    calls (``supervised.py::_dropout_forward`` for stage 2)."""
    def forward(params, batch_stats, f, key):
        calls = []

        def record(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                calls.append((args[0], y))
            return y

        with fnn.intercept_methods(record):
            model.apply({"params": params, "batch_stats": batch_stats}, f,
                        train=True, mutable=["batch_stats"],
                        rngs={"dropout": key},
                        method=model.classify_features)
        return calls

    return jax.jit(forward)


def _stage2_inputs(seed: int):
    """Features, targets, dual features and targets and a ``lam`` strictly
    between 0 and 1 (reverse-style), numpy."""
    rng = np.random.default_rng(seed)
    n = B * MU
    feats = np.abs(rng.normal(0, 1, (2, n, 256))).astype(F32)
    y = rng.integers(0, NUM_CLASSES, (2, n)).astype(np.int32)
    lam = rng.uniform(0.2, 0.8, (n, 1)).astype(F32)
    return feats[0], y[0], feats[1], y[1], lam


def check_stage2_step_matches_jax():
    """One stage-2 step with SGD and with Adam on the same features,
    ``lam`` and the JAX step's dropout mask: the loss, ``fc``'s update and
    BN statistics after both passes, the EMA; the rest bit-identical
    (Adam) or moved by its weight decay (SGD). Then the port's own draw:
    one mask for both passes."""
    base = _jax_base()
    f, y, fd, yd, lam = _stage2_inputs(50)
    key = jax.random.key(50)
    # both passes' dropout outputs: a unit that is 0 in one pass (its
    # ReLU off) shows its mask in the other
    forward = _classify_dropout(base.model)
    mask = np.logical_or(*(_dropout_masks(forward(
        base.state.params, base.state.batch_stats, jnp.asarray(v), key))[0]
        for v in (f, lam * f + (1 - lam) * fd)))
    start = base.state
    init = _port_state(start.params, start.batch_stats)
    for opt in ("SGD", "Adam"):
        jt = copy.copy(base)
        jt._tx2 = jopt.build_optimizer(start.params, opt, lr=jt.lr_schedule)
        jt._build_stage2_step()
        jstate, _, jloss = jt._stage2_step(
            start, jt._tx2.init(start.params), *(jnp.asarray(v) for v in
                                                 (f, y, fd, yd, lam)), key)
        port = _port(opt)
        port._new_stage2_optimizer()
        loss = port._stage2_core(
            *(torch.from_numpy(v) for v in (f, y.astype(np.int64), fd,
                                            yd.astype(np.int64), lam)),
            keep_mask=torch.from_numpy(mask))
        _close(float(loss), float(jloss), rtol=1e-5, what=f"{opt} loss")
        frozen = ("backbone.", "head_emb.") if opt == "Adam" else ()
        _compare_state(port, jstate, opt, frozen, start)
        want = _port_state(jstate.params, jstate.batch_stats)
        now = port.state.model.state_dict()
        params = dict(port.state.model.named_parameters())
        for k in params if opt == "SGD" else ():  # Adam: _compare_state's
            d_got = (now[k] - init[k]).numpy()
            d_want = (want[k] - init[k]).numpy()
            bound = (1e-4 if k.startswith("fc.") else 1e-6) * np.abs(
                d_want).max()
            # the decay moves every kernel, and nothing else outside fc
            assert d_want.any() == (k.startswith("fc.")
                                    or params[k].ndim > 1), k
            _close(d_got, d_want, rtol=0, atol=bound, what=f"{opt} {k}")
        moved = [k for k in want if k.startswith("fc.bn.running")]
        assert moved and all(not torch.equal(now[k], init[k]) for k in moved)
        assert port._opt2_count == 1 and port.state.step == 1
    runs = []
    for keep in (None, "drawn"):
        port = _port("SGD")
        port._new_stage2_optimizer()
        port.generator = torch.Generator().manual_seed(3)
        mask = None
        if keep:
            mask = torch.rand((B * MU, 64), generator=torch.Generator(
            ).manual_seed(3)) < KEEP
        runs.append(float(port._stage2_core(
            *(torch.from_numpy(v) for v in (f, y.astype(np.int64), fd,
                                            yd.astype(np.int64), lam)),
            keep_mask=mask)))
    assert runs[0] == runs[1], runs


def check_grad_accum_is_refused_like_jax():
    cfg = _jax_config(_overrides(GRAD_ACCUM=2))
    jt = jezbm.EZBM(model=None)
    jt.train_dl = None
    with pytest.raises(ValueError) as want:
        jt.get_config(cfg, cls_num_list=CLS_NUM)
    cfg = default_config(_overrides(GRAD_ACCUM=2))
    port = EZBM(build_model(cfg), "SGD", device="cpu")
    port.train_dl = None
    with pytest.raises(ValueError) as got:
        port.get_config(cfg, cls_num_list=CLS_NUM)
    assert str(got.value) == str(want.value) and "GRAD_ACCUM" in str(got.value)


# -- fit --------------------------------------------------------------------------


# (stage, epoch) → (valid loss, macro-F1): stage 1 a first best, then six
# misses (the stop before epoch 8); stage 2 a better pair (a save), an
# equal one, then misses until the count passes 10
SCRIPT = {**{(1, e): (0.9 + 0.01 * e, 0.5) for e in range(1, 21)},
          (1, 1): (0.9, 0.5),
          **{(2, e): (0.8 + 0.01 * e, 0.55) for e in range(1, 21)},
          (2, 1): (0.8, 0.6), (2, 2): (0.8, 0.6)}


def _scripted_fit(trainer, meter, cfg, events):
    """``fit`` with both stages' epochs, the evaluation and the checkpoint
    appending their calls to ``events``."""
    stage = [1]

    def train(s):
        def one(epoch):
            stage[0] = s
            events.append((f"train{s}", epoch))
            m = meter()
            m.update(1.0, 4)
            return m
        return one

    def evaluate_one():
        events.append(("eval", trainer.epoch))
        loss, f1 = SCRIPT[stage[0], trainer.epoch]
        m = meter()
        m.update(loss, 4)
        return m, {"macro/f1": f1}

    cfg.TRAIN.update(EPOCHS=20, FREQ_EVAL=1, SAVE_CP="x")
    trainer.config = cfg
    trainer.train_one_stage_1, trainer.train_one_stage_2 = train(1), train(2)
    trainer.evaluate_one = evaluate_one
    trainer.save_checkpoint = lambda folder: events.append(
        ("save", trainer.epoch))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.fit()
    return events


def check_fit_matches_jax():
    """The JAX and the port's ``fit`` on one scripted sequence: stage 1
    stops after more than 5 misses without a save, the stage-2 optimizer
    is built once, at the switch, stage 2 restarts at ``epoch_start``,
    saves on both better and stops after more than 10 misses."""
    jt = jezbm.EZBM(model=None)
    jt.state = types.SimpleNamespace(params={"w": jnp.zeros(2)})
    jt.lr_schedule = lambda count: 1e-3
    build = jopt.build_optimizer
    want = []

    def jax_build(*a, **k):
        want.append(("opt2", jt.epoch))
        return build(*a, **k)

    with mock.patch.object(jezbm, "build_optimizer", jax_build), \
            mock.patch.object(jax_orbax_io, "wait_until_finished",
                              lambda: None):
        _scripted_fit(jt, JaxMeter, _jax_config(_overrides()), want)
    port = EZBM(device="cpu")
    got = []
    port._new_stage2_optimizer = lambda: got.append(("opt2", port.epoch))
    _scripted_fit(port, AverageMeter, default_config(_overrides()), got)
    assert got == want, (got, want)
    assert got.index(("opt2", 7)) == got.index(("train2", 1)) - 1
    assert ("train1", 8) not in got and ("train2", 13) in got
    assert ("train2", 14) not in got
    assert [e for e in got if e[0] == "save"] == [("save", 1)]


def check_stage_switch_restarts_the_optimizer():
    """``run_config`` with ``trainer_override='ezbm'`` (Adam, 2 epochs of 2
    stage-1 steps and 1 stage-2 step): the stage-2 optimizer is new, its
    learning rates are ``lr(0), lr(1)`` while the step count runs on from
    stage 1; stage 1's Adam moments are what a checkpoint holds, bit for
    bit, with ``best_valid_perf`` None; ``--trainer ezbm`` reaches
    ``run_config``."""
    cfg = default_config(_overrides(OPT_NAME="Adam", EPOCHS=2, FREQ_EVAL=1,
                                    SAVE_CP=""))
    cfg.DATA.BATCH_SIZE = 4
    data = path_h.capsule_data(cfg, (4, 4, 8), seed=0)
    lrs, snap = [], {}
    set_lr = ezbm.set_lr
    new_opt = EZBM._new_stage2_optimizer

    def switched(self):
        snap["opt"] = copy.deepcopy(self.state.optimizer.state_dict())
        snap["step"] = self.state.step
        new_opt(self)

    with mock.patch.object(ezbm, "set_lr",
                           lambda opt, lr: lrs.append(lr) or set_lr(opt, lr)), \
            mock.patch.object(EZBM, "_new_stage2_optimizer", switched), \
            contextlib.redirect_stdout(io.StringIO()):
        trainer, _ = learn.run_config(cfg, device="cpu", data=data,
                                      trainer_override="ezbm")
    assert type(trainer) is EZBM and trainer.n_iter_per_epoch == 2
    assert snap["step"] == 4 and trainer.state.step == 6
    assert trainer._opt2 is not trainer.state.optimizer
    assert lrs == [trainer.lr_schedule(0), trainer.lr_schedule(1)]
    assert trainer._opt2_count == 2
    now = trainer.state.optimizer.state_dict()
    assert snap["opt"]["state"].keys() == now["state"].keys()
    for i, s in snap["opt"]["state"].items():
        for k, v in s.items():
            assert torch.equal(now["state"][i][k], v), (i, k)
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        state, meta = ckpt_io.restore_checkpoint(
            trainer.save_checkpoint(tmp), "cpu")
    assert meta["best_valid_perf"] is None and meta["trainer"] == "EZBM"
    for name, s in state["optimizer"].items():
        i = trainer.state._param_names().index(name)
        for k, v in s.items():
            assert torch.equal(v, snap["opt"]["state"][i][k]), (name, k)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c.yaml")
        Path(path).write_text("MODEL:\n  NAME: resnet_tiny\n")
        with mock.patch.object(learn, "run_config") as run, \
                mock.patch.object(learn.preempt, "install", lambda: None), \
                contextlib.redirect_stdout(io.StringIO()):
            run.return_value = (None, torch.nn.Linear(1, 1))
            learn.main(["--config", path, "--trainer", "ezbm",
                        "--device", "cpu"])
        assert run.call_args.kwargs["trainer_override"] == "ezbm"


# -- the Kvasir-Capsule transfer -------------------------------------------------


def check_capsule_graft_matches_jax():
    """A 6-class plain-head checkpoint (orbax for JAX; the same trees as a
    ``.npz`` and as a port checkpoint) as the 11-class EZBM model's
    ``PRE_TRAIN_PATH`` through ``prepare_trainer``: the same state as the
    JAX package's graft; the trunk the donor's bit for bit, ``fc`` and
    ``head_emb`` their fresh weights, the EMA re-synced. The capsule CSV's
    ``path`` column gives both packages the same manifest."""
    params, stats = _donor(6, seed=43)
    jbase = _jax_base(11)
    init = _port_state(jbase.state.params, jbase.state.batch_stats)
    donor = _no_counts(_port_state(params, stats))
    with tempfile.TemporaryDirectory() as tmp:
        jax_orbax_io.save_checkpoint(os.path.join(tmp, "orbax"), "epoch_1",
                                     {"params": params, "batch_stats": stats},
                                     {}, block=True)
        jt = copy.copy(jbase)
        jcfg = _jax_config(_overrides(11))
        jcfg.MODEL.PRE_TRAIN_PATH = os.path.join(tmp, "orbax", "epoch_1")
        with contextlib.redirect_stdout(io.StringIO()):
            assert jtransfer.apply_pretrain(jt, jcfg)
        want = _no_counts(_port_state(jt.state.params, jt.state.batch_stats))
        npz = os.path.join(tmp, "donor.npz")
        write_npz(npz, params, stats)
        donor_cfg = default_config(_sup_overrides())
        donor_cfg.MODEL.NUM_CLASSES = 6
        donor_model = build_model(donor_cfg)
        donor_model.load_state_dict(_port_state(params, stats))
        port_dir = ckpt_io.save_checkpoint(
            tmp, "port", {"step": 0, "model": donor_model.state_dict(),
                          "optimizer": {}, "ema": None}, {})
        cfg = default_config(_overrides(11))
        cfg.DATA.INPUT_NAME = "path"
        data = path_h.capsule_data(cfg, (22, 11, 11), seed=1)
        for path in (port_dir, npz):
            cfg.MODEL.PRE_TRAIN_PATH = path
            model = build_model(cfg)
            model.load_state_dict(init)
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = learn.prepare_trainer(cfg, model=model, data=data,
                                                device="cpu",
                                                trainer_override="ezbm")
            assert type(trainer) is EZBM
            got = trainer.state.model.state_dict()
            assert set(_no_counts(got)) == set(want)
            for k, v in want.items():
                assert torch.equal(got[k], v), (path, k)
                src = donor if k.startswith("backbone.") else init
                assert torch.equal(got[k], src[k]), (path, k)
            for k, v in trainer.state.ema.state_dict().items():
                assert torch.equal(v, got[k]), ("ema", k)
    df = pd.DataFrame({"path": [f"img_{i}.jpg" for i in range(14)],
                       "target": np.arange(14) % 11,
                       "is_valid": np.arange(14) % 4 == 0})
    jcfg = _jax_config(_overrides(11))
    jcfg.DATA.update(INPUT_NAME="path", PATH="/capsule")
    cfg.DATA.PATH = "/capsule"
    want, got = jax_manifests(jcfg, df), build_supervised_manifests(cfg, df)
    for w, g in zip(want[:2], got[:2]):
        assert list(w.paths) == list(g.paths) and list(w.paths)
        assert np.array_equal(w.targets, g.targets)
    assert want[2] == got[2] and len(got[2]) == 11


def check_paths_h_i_j_configs_match_yaml():
    """``chip_smoke.py``'s paths H, I and J write their presets' fields out
    (``torch_port_checks/path_{h,i,j}.py``): each equals the file's value,
    and every field the file sets is there, but data paths, the
    pretrained checkpoint and the checkpoint directory."""
    import yaml

    from endoscopy_tpu.config.loader import get_config as jax_get_config

    skip = {"PATH", "ANNO", "UNANNO_PATH", "UNANNO", "PRE_TRAIN",
            "PRE_TRAIN_PATH", "PRE_TRAIN_RESUME", "SAVE_CP"}
    presets = {**path_h.PRESETS, **path_i.PRESETS, **path_j.PRESETS}
    assert len(presets) == 5
    for name, over in presets.items():
        path = str(ROOT / "configs" / f"{name}.yaml")
        cfg = jax_get_config(path)
        raw = yaml.safe_load(Path(path).read_text())
        for section, values in over.items():
            for k, v in values.items():
                assert cfg[section][k] == v, (name, section, k)
        for section, values in raw.items():
            for k in values:
                assert k in skip or k in over.get(section, {}), (name, k)
