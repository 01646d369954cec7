"""Port checks: data parallelism (``endoscopy_tpu_torch/parallel/``), CPU.

One pair of gloo processes (``path_n.py``'s worker, joined through
``init_from_env`` from the environment ``torchrun`` would set, on a free
port retried once as ``tests/test_multiprocess.py`` retries) runs every
case of ``path_n.CASES`` in sequence while this process computes the same
cases in one process and the JAX step. Each 2-rank result is held against
the 1-process port on the same global batch at ``train.py``'s float32
step bounds (``path_n.compare_steps``), and the two ranks against each
other, bit for bit:

- FixMatch's ``_train_core`` on the JAX package's views with the class
  weights, also held against the JAX step through ``train.py``'s
  ``_compare_step``; FixMatch at GRAD_ACCUM=2; the supervised step with
  Mixup, with CutMix and with the class-weighted CE; the triplet step with
  the MLP head's dropout; a CoMatch step from a seeded queue and DA ring
  (the queue and ring after it 1e-4 relative, the write's targets exact);
  a SemiFormer FixMatch-phase step;
- EZBM: the gathered memory exactly the ranks' anchors in the global
  batch's row order, its targets the 1-process memory's, its features
  within 1e-4 of their largest of the 1-process features; a stage-2 epoch
  from the 2-rank stage-1 state and memory;
- ``evaluate_one`` bit-identical on both ranks and to one process;
- a checkpoint written by rank 0 alone (``state.pt``, then
  ``meta.json``) and restored bit-identical on both ranks;
- ``shard_for_host`` gives rank ``i`` rows ``i::2``; ``TRAIN.MESH_DATA``
  of another size than the group raises, ``MESH_MODEL`` > 1 warns.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.parallel import Group, mesh_from_config
from torch_port_checks import path_n, train
from torch_port_checks.semiformer import BIAS_BEFORE_BN

ROOT = Path(__file__).resolve().parents[2]
PAIR_TIMEOUT_S = 300
STEP_CASES = ("core", "accum", "mixup", "cutmix", "plain", "triplet",
              "comatch", "semiformer")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(workdir: Path):
    port = _free_port()
    path = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch_port_checks.path_n", str(workdir),
             "--device", "cpu"], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=PAIR_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    return [p.returncode for p in procs], logs


def _inputs(workdir: Path) -> dict:
    """FixMatch's views, targets, class weights and initial weights from
    ``train.py`` (the JAX package's views and initial state)."""
    (x, u_w, u_s), t = train._core_inputs()
    base = train._jax_base().state
    views = {k: torch.tensor(np.asarray(v))
             for k, v in (("x", x), ("u_w", u_w), ("u_s", u_s))}
    return {"state": train._port_state(base.params, base.batch_stats),
            **views, "t": torch.tensor(t),
            "w": torch.tensor(train._weights()), "dir": workdir / "ckpt"}


def _one_process(inputs):
    """The cases in this process, and the JAX FixMatch step."""
    single = path_n.run_cases("cpu", inputs,
                              [c for c in path_n.CASES if c != "checkpoint"])
    _, jax_out, _ = train._cores("SGD")
    return single, jax_out


def _jax_failures(state: dict, stats, jax_out):
    """The 2-rank ``core`` step against the JAX step, through
    ``train.py``'s ``_compare_step``."""
    port = train._port_trainer("SGD")
    for part in ("model", "ema"):
        module = getattr(port.state, part)
        module.load_state_dict({k: state[f"{part}.{k}"]
                                for k in module.state_dict()}, strict=True)
    port.state.step = int(state["step"])
    try:
        train._compare_step(port, jax_out, (stats[0], tuple(stats[1:])),
                            "SGD")
    except AssertionError as e:
        return [f"core against JAX: {e}"]
    return []


def _ezbm_failures(ranks, single):
    bad = []
    r0 = ranks[0]
    for epoch, steps in ((1, 1), (2, 2)):
        mem, one = r0[f"memory{epoch}"], single[f"memory{epoch}"]
        n = len(mem["local"]) // steps  # anchors a step on a rank
        local = [r[f"memory{epoch}"]["local"] for r in ranks]
        interleaved = torch.cat([a[s * n:(s + 1) * n]
                                 for s in range(steps) for a in local])
        if not torch.equal(mem["features"], interleaved):
            bad.append(f"ezbm: epoch {epoch}'s gathered memory is not the "
                       "ranks' anchors in the global row order")
        if not np.array_equal(mem["targets"], one["targets"]):
            bad.append(f"ezbm: epoch {epoch}'s gathered targets differ from "
                       "one process's")
    mem, one = r0["memory1"]["features"], single["memory1"]["features"]
    err = float((mem - one).abs().max())
    if err > 1e-4 * float(one.abs().max()):
        bad.append(f"ezbm: memorized features {err} from one process's")
    bad += path_n.compare_steps(
        {"init": r0["init"], "state": r0["stage1"], "loss1": r0["loss1"]},
        {"init": single["init"], "state": single["stage1"],
         "loss1": single["loss1"]}, "ezbm stage 1", stats=("loss1",))
    start = r0["after_stage1"]
    want = path_n.stage2_from("cpu", start, r0["memory2"]["features"],
                              r0["memory2"]["targets"], r0["generator"])
    bad += path_n.compare_steps(
        {"init": start, "state": r0["stage2"], "loss2": r0["loss2"]},
        {"init": start, "state": want["stage2"], "loss2": want["loss2"]},
        "ezbm stage 2", stats=("loss2",))
    return bad


def _failures(ranks, single, jax_out):
    bad = []
    r0, r1 = ranks
    for case in path_n.CASES:
        same = path_n.same_result(*(path_n.shared(r[case]) for r in ranks))
        if case not in ("checkpoint", "shard") and not same:
            bad.append(f"{case}: the two ranks differ")
    for case in STEP_CASES:
        bad += path_n.compare_steps(r0[case], single[case], case,
                                    rounding=(BIAS_BEFORE_BN,))
    bad += _jax_failures(r0["core"]["state"], r0["core"]["stats"], jax_out)
    cs = r0["comatch"]["comatch_state"]
    cs1 = single["comatch"]["comatch_state"]
    for k, v in cs.items():
        err = float((v.double() - cs1[k].double()).abs().max())
        if err > 1e-4 * float(cs1[k].double().abs().max()):
            bad.append(f"comatch: state {k} differs by {err}")
    bad += _ezbm_failures([r["ezbm"] for r in ranks], single["ezbm"])
    if not path_n.same_result(r0["evaluate"], single["evaluate"]):
        bad.append("evaluate: the ranks' evaluation differs from one "
                   "process's")
    writes = [r["checkpoint"]["writes"] for r in ranks]
    if writes != [["state.pt", "meta.json"], []]:
        bad.append(f"checkpoint: files written by the ranks {writes}")
    if not all(r["checkpoint"]["restored_equal"]
               and r["checkpoint"]["epoch_start"] == 1 for r in ranks):
        bad.append("checkpoint: a rank's restore differs from the save")
    for rank, r in enumerate(ranks):
        if r["shard"]["paths"].tolist() != list(range(rank, 10, 2)):
            bad.append(f"shard: rank {rank} got {r['shard']['paths']}")
    if single["shard"]["paths"].tolist() != list(range(10)):
        bad.append("shard: one process does not keep every row")
    if (r0["mesh"]["raised"] != {-1: False, 2: False, 3: True}
            or single["mesh"]["raised"] != {-1: False, 1: False, 2: True}):
        bad.append(f"mesh: MESH_DATA raised {r0['mesh']}, "
                   f"{single['mesh']} in one process")
    return bad


def check_two_gloo_ranks_equal_one_process():
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        inputs = _inputs(workdir)
        torch.save(inputs, workdir / "inputs.pt")
        for attempt in range(2):
            procs = _launch(workdir)
            if attempt == 0:
                single, jax_out = _one_process(inputs)
            rcs, logs = _wait(procs)
            retry = any("Address already in use" in log
                        or "EADDRINUSE" in log for log in logs)
            if rcs == [0, 0] or not retry:
                break
        assert rcs == [0, 0], (f"workers exited {rcs}:\n--- rank 0 ---\n"
                               f"{logs[0][-4000:]}\n--- rank 1 ---\n"
                               f"{logs[1][-4000:]}")
        ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
    bad = _failures(ranks, single, jax_out)
    assert not bad, "\n".join(bad)


def check_mesh_model_warns_that_the_heads_stay_replicated():
    group = Group(0, 1, torch.device("cpu"))
    with pytest.warns(UserWarning, match="replicated"):
        mesh_from_config(default_config({"TRAIN": {"MESH_MODEL": 2}}), group)
    with pytest.raises(ValueError, match="MESH_DATA"):
        mesh_from_config(default_config({"TRAIN": {"MESH_DATA": 2}}), group)
