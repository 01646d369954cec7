"""Path N's data-parallel cases: each trainer's step in a process group of
P ranks against the 1-process step on the same global batch. No JAX.

Every case builds its trainer, weights and global batch from seeds and
feeds the trainer this rank's rows of that batch
(``parallel/sharding.py::local_rows``: every row outside a group). So the
same function gives the 1-process result in one process and a rank's
result in a group, and ``compare_steps`` holds one against the other at
``train.py``'s float32 step bounds:

- the losses (the global ones: each rank logs the sum of the shares) 1e-5
  relative;
- each parameter's SGD update within 0.1 of the tensor's largest: float32
  gradients of ``resnet_tiny`` differ by several percent between two
  correct runs (a ReLU input within rounding of 0 lands on the other
  side), and the group's BN takes flax's one-pass variance where torch's
  fused BN takes another, over sums split by rank;
- BN running statistics 1e-4 relative, the EMA 1e-6.

``tests/torch_port_checks/parallel.py`` runs :func:`main` in two gloo
processes on the CPU and the cases again in its own process;
``chip_smoke.py``'s path N holds the FixMatch step on the card the same
way. A process joins the group through
``endoscopy_tpu_torch/parallel/mesh.py::init_from_env`` from the
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_*`` environment, as
``torchrun`` sets it.

    python -m torch_port_checks.path_n <out dir> [--device cpu]

(from ``tests/`` with the repository on ``PYTHONPATH``) writes each rank's
results of :data:`CASES` to ``<out dir>/rank<r>.pt``, after reading
``<out dir>/inputs.pt``: the views and weights of the ``core`` case and
the ``checkpoint`` case's directory, which the caller made.
"""

from __future__ import annotations

import argparse
import copy
import os
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data.manifest import Manifest, shard_for_host
from endoscopy_tpu_torch.data.pipeline import EvalLoader, canonical_size
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.parallel import (group_size, init_from_env,
                                          leave_group, local_rows)
from endoscopy_tpu_torch.ssl_state.comatch_state import CoMatchState
from endoscopy_tpu_torch.train.comatch import CoMatch
from endoscopy_tpu_torch.train.ezbm import EZBM
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from endoscopy_tpu_torch.train.semiformer import SemiFormer
from endoscopy_tpu_torch.train.supervised import SupLearning
from torch_port_checks import path_d

IMG, NUM_CLASSES, LOW_DIM = 32, 4, 8
LABELED = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])  # the class weights'
CLS_NUM = [3, 2, 1, 4]  # EZBM's class counts (an uneven ``lam``)
BASE = {"DATA": {"IMG_SIZE": IMG, "BATCH_SIZE": 8, "MU": 2},
        "MODEL": {"NAME": "resnet_tiny", "NUM_CLASSES": NUM_CLASSES,
                  "LOW_DIM": LOW_DIM},
        "TRAIN": {"DTYPE": "float32", "EVAL_STEP": 2, "THRES": 0.3,
                  "CLS_WEIGHT": True, "MESH_DATA": -1}}
TINY_CONFORMER = {"NAME": "conformer", "TYPE_SEMI": "SemiFormer",
                  "EMBED_DIM": 24, "DEPTH": 3, "NUM_HEADS": 2,
                  "MLP_RATIO": 2.0}
# step bounds (module docstring)
LOSS_RTOL, UPDATE_BOUND, BN_RTOL, EMA_TOL = 1e-5, 0.1, 1e-4, 1e-6
CASES = ("core", "accum", "mixup", "cutmix", "plain", "triplet", "comatch",
         "semiformer", "ezbm", "evaluate", "checkpoint", "shard", "mesh")


def config(**sections):
    """``default_config`` with :data:`BASE`, then ``sections`` (name →
    {key: value}) over it."""
    merged = copy.deepcopy(BASE)
    for name, fields in sections.items():
        merged.setdefault(name, {}).update(fields)
    return default_config(merged)


def own(a, *blocks):
    """This rank's rows of a global array laid out as ``blocks`` (global
    row counts; default one block): every row outside a group."""
    return a[local_rows(*(blocks or (len(a),))).numpy()]


def seeded_model(cfg, seed: int):
    """The config's model with torch's initializers under ``seed``."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return build_model(cfg)


def u8(rng: np.random.Generator, n: int, cfg) -> np.ndarray:
    s = canonical_size(cfg)
    return rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def flat(trainer) -> dict:
    """The trainer's state as one flat name → CPU tensor dict."""
    return {k: v.detach().cpu().clone()
            for k, v in path_d.flat_state(trainer.state.state_dict()).items()}


def _trainer(cls, cfg, seed: int, device, state=None, **get_config):
    model = seeded_model(cfg, seed)
    if state is not None:
        model.load_state_dict(state, strict=True)
    trainer = cls(model, "SGD", device=device)
    trainer.get_dataloader(None, None)
    trainer.get_config(cfg, **get_config)
    return trainer


def _step(trainer, run) -> dict:
    init = flat(trainer)
    loss, aux = run()
    return {"stats": torch.stack([loss, *aux]).detach().cpu(), "init": init,
            "state": flat(trainer)}


# -- the cases: each returns this rank's result -------------------------------


def case_core(device, inputs):
    """FixMatch's ``_train_core`` on given global views (``inputs``: the
    JAX package's, from ``train.py``) with the class weights."""
    cfg = config()
    trainer = _trainer(FixMatch, cfg, 0, device, inputs["state"],
                       labeled_targets=LABELED)
    x, u_w, u_s, t = (own(inputs[k]) for k in ("x", "u_w", "u_s", "t"))
    return _step(trainer, lambda: trainer._train_core(
        x, u_w, u_s, t.long(), inputs["w"]))


def case_accum(device, inputs=None):
    """FixMatch's ``_train_step`` at GRAD_ACCUM=2 from canonical batches,
    the views drawn from the trainer's generator: microbatch ``j`` is every
    rank's ``j``-th chunk, so rank ``r`` holds rows ``r`` of each half."""
    cfg = config(TRAIN={"GRAD_ACCUM": 2})
    trainer = _trainer(FixMatch, cfg, 1, device, labeled_targets=LABELED)
    rng = np.random.default_rng(1)
    b, bu = 8, 16
    x, u = u8(rng, b, cfg), u8(rng, bu, cfg)
    t = rng.integers(0, NUM_CLASSES, b)
    return _step(trainer, lambda: trainer._train_step(
        own(x, b // 2, b // 2), own(t, b // 2, b // 2),
        own(u, bu // 2, bu // 2), trainer.class_weights))


def _supervised(device, seed: int, **train):
    cfg = config(TRAIN={"IS_SSL": False, **train})
    trainer = _trainer(SupLearning, cfg, seed, device,
                       labeled_targets=LABELED)
    rng = np.random.default_rng(seed)
    x, t = u8(rng, 8, cfg), rng.integers(0, NUM_CLASSES, 8)
    return _step(trainer, lambda: trainer._train_step(
        own(x), own(t), trainer._epoch_weights(1)))


def case_mixup(device, inputs=None):
    """The supervised step with Mixup: the partner rows are the global
    batch's ``flip(0)``."""
    return _supervised(device, 2, MIXUP=0.8)


def case_cutmix(device, inputs=None):
    """The supervised step with CutMix."""
    return _supervised(device, 3, CUTMIX=1.0)


def case_plain(device, inputs=None):
    """The supervised step's class-weighted CE: ``Σ w·l / Σ w`` over the
    global batch."""
    return _supervised(device, 4)


def case_triplet(device, inputs=None):
    """The triplet step (``ModelwEmb``, the MLP head's dropout) on the
    global ``[A; P; N]``: each rank its anchors, positives and negatives."""
    cfg = config(DATA={"BATCH_SIZE": 4},
                 MODEL={"IS_TRIPLET": True}, TRAIN={"IS_SSL": False})
    trainer = _trainer(SupLearning, cfg, 5, device, labeled_targets=LABELED)
    rng = np.random.default_rng(5)
    x3, t = u8(rng, 12, cfg), rng.integers(0, NUM_CLASSES, 4)
    return _step(trainer, lambda: trainer._train_step(
        own(x3, 4, 4, 4), own(t), trainer._epoch_weights(1)))


def _comatch_state(device, queue_size: int) -> CoMatchState:
    """A seeded non-zero memory bank and DA ring (5 of 32 rows filled)."""
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(queue_size, LOW_DIM)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    probs = rng.dirichlet(np.ones(NUM_CLASSES), queue_size + 32)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device, dtype)

    return CoMatchState(queue_feats=dev(feats),
                        queue_probs=dev(probs[:queue_size]),
                        queue_ptr=dev(0, torch.long),
                        da_buffer=dev(probs[queue_size:]),
                        da_ptr=dev(5, torch.long), da_count=dev(5, torch.long))


def case_comatch(device, inputs=None):
    """One CoMatch step from a seeded queue and DA ring, the queue's gate
    open (``queue_batch`` 1, so the step's global rows fill it): the DA
    mean, the graph and the queue write span the global batch."""
    cfg = config(DATA={"BATCH_SIZE": 4}, MODEL={"TYPE_SEMI": "CoMatch"})
    model = seeded_model(cfg, 6)
    trainer = CoMatch(model, "SGD", device=device)
    trainer.queue_batch = 1
    trainer.get_dataloader(None, None)
    trainer.get_config(cfg, labeled_targets=LABELED)
    trainer.comatch_state = _comatch_state(trainer.device, trainer.queue_size)
    rng = np.random.default_rng(6)
    x, u = u8(rng, 4, cfg), u8(rng, 8, cfg)
    t = rng.integers(0, NUM_CLASSES, 4)
    out = _step(trainer, lambda: trainer._train_step(
        own(x), own(t), own(u), trainer.class_weights, True))
    out["comatch_state"] = {k: v.cpu() for k, v in
                            vars(trainer.comatch_state).items()}
    return out


def case_semiformer(device, inputs=None):
    """One SemiFormer FixMatch-phase step on the tiny Conformer."""
    cfg = config(DATA={"BATCH_SIZE": 4, "MU": 1}, MODEL=TINY_CONFORMER,
                 TRAIN={"EVAL_STEP_SUP": 1})
    trainer = _trainer(SemiFormer, cfg, 7, device, labeled_targets=LABELED)
    rng = np.random.default_rng(7)
    x, u = u8(rng, 4, cfg), u8(rng, 4, cfg)
    t = rng.integers(0, NUM_CLASSES, 4)
    return _step(trainer, lambda: trainer._train_step(
        own(x), own(t), own(u), trainer.class_weights))


def _ezbm_config():
    return config(DATA={"BATCH_SIZE": 4}, MODEL={"IS_TRIPLET": True},
                  TRAIN={"IS_SSL": False, "EXPANSION": "reverse"})


def ezbm_trainer(device, state=None):
    return _trainer(EZBM, _ezbm_config(), 8, device, state,
                    cls_num_list=CLS_NUM, labeled_targets=LABELED)


def case_ezbm(device, inputs=None):
    """EZBM: a stage-1 epoch of one triplet step (its state and memory), a
    second of two steps, each memory gathered in the global batch's row
    order (the rank's own anchors kept beside it), then a stage-2 epoch
    (one step of 8 pairs) on the second memory."""
    trainer = ezbm_trainer(device)
    cfg = trainer.config
    rng = np.random.default_rng(8)
    local = [(own(u8(rng, 12, cfg), 4, 4, 4),
              own(rng.integers(0, NUM_CLASSES, 4))) for _ in range(3)]
    x3s = iter(x3 for x3, _ in local)
    trainer._build_triplet_batch = lambda batch_u8, targets: next(x3s)
    kept = {}
    gather = trainer._gather_memory

    def keep_local():
        kept["local"] = torch.cat(trainer.mem_features).cpu()
        gather()

    out = {"init": flat(trainer)}
    with mock.patch.object(trainer, "_gather_memory", keep_local):
        for epoch, steps in ((1, local[:1]), (2, local[1:])):
            trainer.n_iter_per_epoch = len(steps)
            trainer.train_dl = [(x3[:len(t)], t) for x3, t in steps]
            loss = trainer.train_one_stage_1(epoch).avg
            features = torch.cat(trainer.mem_features).cpu()
            out[f"memory{epoch}"] = {
                "features": features, "local": kept.pop("local", features),
                "targets": np.concatenate(trainer.mem_targets)}
            if epoch == 1:
                out.update(stage1=flat(trainer), loss1=loss)
    out.update(after_stage1=flat(trainer),
               generator=trainer.generator.get_state())
    trainer._new_stage2_optimizer()
    out["loss2"] = trainer.train_one_stage_2(1).avg
    out["stage2"] = flat(trainer)
    return out


def stage2_from(device, stage1: dict, features, targets, generator) -> dict:
    """The 1-process stage-2 epoch from a stage-1 state, memory and
    generator state."""
    trainer = ezbm_trainer(device)
    trainer.generator.set_state(generator)
    trainer.state.step = int(stage1["step"])
    sd = trainer.state.state_dict()
    for part in ("model", "ema"):
        getattr(trainer.state, part).load_state_dict(
            {k: stage1[f"{part}.{k}"] for k in sd[part]}, strict=True)
    trainer.mem_features = [features.to(trainer.device)]
    trainer.mem_targets = [np.asarray(targets)]
    trainer._new_stage2_optimizer()
    return {"loss2": trainer.train_one_stage_2(1).avg,
            "stage2": flat(trainer)}


def _valid_loader(cfg):
    rng = np.random.default_rng(9)
    images = u8(rng, 10, cfg)
    targets = rng.integers(0, NUM_CLASSES, 10)
    return path_d.array_loader(EvalLoader, images)(
        Manifest(paths=np.arange(10), targets=targets), 4,
        canonical_size(cfg))


def case_evaluate(device, inputs=None):
    """``evaluate_one`` over the whole validation set on every rank."""
    cfg = config()
    trainer = _trainer(FixMatch, cfg, 9, device, labeled_targets=LABELED)
    trainer.valid_dl = _valid_loader(cfg)
    loss, metric = trainer.evaluate_one()
    sums, probs, _, _ = trainer._eval_pass(trainer.valid_dl)
    return {"loss": loss.avg, "f1": float(metric["macro/f1"]),
            "sums": torch.as_tensor(sums), "probs": torch.as_tensor(probs)}


def case_checkpoint(device, inputs):
    """One step, a checkpoint (the files each rank wrote counted), and a
    fresh trainer that restores it: its state against the saved one, bit
    for bit."""
    cfg = config(TRAIN={"SAVE_CP": str(inputs["dir"])})
    trainer = _trainer(FixMatch, cfg, 10, device, labeled_targets=LABELED)
    rng = np.random.default_rng(10)
    x, u = u8(rng, 8, cfg), u8(rng, 16, cfg)
    t = rng.integers(0, NUM_CLASSES, 8)
    trainer._train_step(own(x), own(t), own(u), trainer.class_weights)
    trainer.epoch = 1
    writes = []
    replace = ckpt_io._durable_replace
    with mock.patch.object(ckpt_io, "_durable_replace",
                           lambda path, write: (writes.append(path),
                                                replace(path, write))):
        path = trainer.save_checkpoint(cfg.TRAIN.SAVE_CP)
    fresh = _trainer(FixMatch, cfg, 11, device, labeled_targets=LABELED)
    fresh.load_checkpoint(path, is_train=True)
    saved, restored = flat(trainer), flat(fresh)
    same = (saved.keys() == restored.keys()
            and all(torch.equal(saved[k], restored[k]) for k in saved))
    return {"writes": [os.path.basename(p) for p in writes],
            "restored_equal": same, "epoch_start": fresh.epoch_start}


def case_shard(device, inputs=None):
    """``shard_for_host`` on ten rows."""
    m = shard_for_host(Manifest(paths=np.arange(10), targets=np.arange(10)))
    return {"paths": torch.as_tensor(m.paths.astype(np.int64)),
            "targets": torch.as_tensor(m.targets)}


def case_mesh(device, inputs=None):
    """``TRAIN.MESH_DATA`` of another size than the group raises."""
    world = group_size()
    raised = {}
    for data in (-1, world, world + 1):
        try:
            _trainer(FixMatch, config(TRAIN={"MESH_DATA": data}), 0, device)
            raised[data] = False
        except ValueError as e:
            raised[data] = "MESH_DATA" in str(e)
    return {"raised": raised}


def run_cases(device, inputs, names=CASES) -> dict:
    """Every case of ``names`` on ``device``; ``inputs`` is what
    ``case_core`` and ``case_checkpoint`` read."""
    return {name: globals()[f"case_{name}"](device, inputs)
            for name in names}


# -- the comparison -----------------------------------------------------------


def compare_steps(got: dict, want: dict, what: str, stats=("stats",),
                  rounding=()):
    """Failures of a step's result ``got`` against ``want`` at the step
    bounds (module docstring); both started from the same state. A
    parameter whose name ends with one of ``rounding`` has a gradient of 0
    in exact arithmetic (a bias before a BN): both of its updates must be
    under 1e-3 of the largest update of any parameter."""
    bad = []
    for key in stats:
        g, w = (np.asarray(r[key], np.float64) for r in (got, want))
        if not np.allclose(g, w, rtol=LOSS_RTOL, atol=1e-7):
            bad.append(f"{what}: {key} {g} vs {w}")
    init, gs, ws = got["init"], got["state"], want["state"]
    if any(not torch.equal(init[k], want["init"][k]) for k in init):
        bad.append(f"{what}: the two runs started from other states")
    largest = max(float((ws[k] - init[k]).abs().max()) for k in ws
                  if k.startswith("model.") and not k.endswith(
                      ("running_mean", "running_var", "num_batches_tracked")))
    for k, w in ws.items():
        g = gs[k]
        if k.endswith("num_batches_tracked") or k == "step":
            ok = torch.equal(g, w)
        elif k.endswith(("running_mean", "running_var")):
            ok = torch.allclose(g, w, rtol=BN_RTOL, atol=1e-6)
        elif k.startswith("ema."):
            ok = torch.allclose(g, w, rtol=EMA_TOL, atol=EMA_TOL)
        elif k.startswith("model.") and k.endswith(rounding):
            ok = max(float((g - init[k]).abs().max()),
                     float((w - init[k]).abs().max())) <= 1e-3 * largest
        elif k.startswith("model."):
            d_got, d_want = g - init[k], w - init[k]
            ok = float((d_got - d_want).abs().max()) <= (
                UPDATE_BOUND * float(d_want.abs().max()))
        else:  # the optimizer's state follows the update
            continue
        if not ok:
            bad.append(f"{what}: {k} differs beyond the step bounds")
    return bad


def shared(result):
    """A case's result without what is each rank's own (EZBM's local
    anchors)."""
    if isinstance(result, dict):
        return {k: shared(v) for k, v in result.items() if k != "local"}
    return result


def same_result(a, b) -> bool:
    """Two ranks' results, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_result(a[k], b[k])
                                            for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out", type=Path)
    parser.add_argument("--device", default=None)
    parser.add_argument("--cases", default=",".join(CASES))
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    group = init_from_env(args.device)
    try:
        inputs = torch.load(args.out / "inputs.pt", weights_only=False)
        results = run_cases(group.device, inputs, args.cases.split(","))
        torch.save(results, args.out / f"rank{group.rank}.pt")
    finally:
        leave_group()


if __name__ == "__main__":
    main()
