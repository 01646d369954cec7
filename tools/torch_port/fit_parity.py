"""Both packages' ``fit`` from the same weights, on the CPU: a learning check.

    python tools/torch_port/fit_parity.py
        [--trainers fixmatch supervised comatch] [--epochs 8] [--seeds 0 1]
        [--out fit_parity.json]

For each trainer and seed, the JAX package's trainer and the port's start
from the same converted weights (the JAX trainer's initial state, seeded
by ``TRAIN.SEED``) and run ``fit`` on the same synthetic data
(``endoscopy_tpu/data/synthetic.py``: four colour-separable classes, JPEGs
and CSVs both packages read; ``resnet_tiny`` at 32 px, B=8, MU=2, float32,
Adam, EMA decay 0.9, an evaluation every epoch; CoMatch under
``ModelwEmb`` with LOW_DIM 64 and ``LAMBDA_C`` 2). After each epoch it
prints the train loss and, for both packages, the valid loss and
macro-F1 of the EMA teacher and of the student, both in eval mode.

The two packages draw their augmentations from different generators
(``jax.random`` against ``torch.Generator``), so their curves agree in
shape, not step for step: what the script tells apart is a teacher that
trails its student in both packages (the reference's behaviour) from one
that does so in the port only (a fault of the port).

It imports JAX and the JAX package besides the port, so it runs where
both packages are installed, on the CPU. Each trainer and seed takes well
under a minute, most of it the JAX step's compile.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
from pathlib import Path
from unittest import mock

os.environ.setdefault("ETPU_PLATFORM", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from endoscopy_tpu.cli import learn as jax_learn  # noqa: E402
from endoscopy_tpu.config.loader import default_config as jax_default_config  # noqa: E402
from endoscopy_tpu.data.synthetic import make_synthetic_dataset  # noqa: E402
from endoscopy_tpu.models import build_model as jax_build_model  # noqa: E402
from endoscopy_tpu.train import state as jax_state  # noqa: E402
from endoscopy_tpu_torch.ckpt.convert import from_jax_params  # noqa: E402
from endoscopy_tpu_torch.cli import learn  # noqa: E402
from endoscopy_tpu_torch.config.loader import default_config  # noqa: E402
from endoscopy_tpu_torch.models import build_model  # noqa: E402


class _JitInit:
    """The flax model with ``init`` compiled (run eagerly it takes many
    seconds for each trainer)."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x, **kw):
        return jax.jit(functools.partial(self.model.init, **kw))(key, x)


def overrides(kind: str, data: tuple, epochs: int, seed: int) -> dict:
    img_root, anno, unl_root, unanno = data
    return {
        "DATA": {"PATH": img_root, "ANNO": anno, "UNANNO_PATH": unl_root,
                 "UNANNO": unanno, "MOCKUP_SSL": True, "IMG_SIZE": 32,
                 "BATCH_SIZE": 8, "MU": 2, "NUM_WORKERS": 1},
        "MODEL": {"NAME": "resnet_tiny", "NUM_CLASSES": 4,
                  "TYPE_SEMI": "CoMatch" if kind == "comatch" else "FixMatch",
                  "LOW_DIM": 64},
        "TRAIN": {"IS_SSL": kind != "supervised", "DTYPE": "float32",
                  "LAMBDA_C": 2.0,
                  "OPT_NAME": "Adam", "EPOCHS": epochs, "FREQ_EVAL": 1,
                  "EVAL_STEP": 8, "USE_EMA": True, "EMA_DECAY": 0.9,
                  "SAVE_CP": "", "LOG_DIR": "", "MESH_DATA": 1,
                  "SEED": seed},
    }


def _jax_config(over):
    cfg = jax_default_config()
    for section, values in over.items():
        for k, v in values.items():
            cfg[section][k] = v
    return cfg


def _record(trainer, side: str, log: list) -> None:
    """Wrap ``train_one`` and ``evaluate_one``: every evaluation also
    evaluates the student and appends a row to ``log``; ``fit`` still sees
    the teacher's result."""
    train_one, evaluate_one = trainer.train_one, trainer.evaluate_one
    losses = {}

    def train(epoch):
        meter = train_one(epoch)
        losses[epoch] = float(meter.avg)
        return meter

    def evaluate(*args, **kwargs):
        trainer.use_ema = False
        s_loss, s_metric = evaluate_one()
        trainer.use_ema = True
        t_loss, t_metric = evaluate_one()
        log.append({"side": side, "epoch": int(trainer.epoch),
                    "train_loss": losses.get(trainer.epoch),
                    "teacher_loss": float(t_loss.avg),
                    "teacher_f1": float(t_metric["macro/f1"]),
                    "student_loss": float(s_loss.avg),
                    "student_f1": float(s_metric["macro/f1"])})
        return t_loss, t_metric

    trainer.train_one, trainer.evaluate_one = train, evaluate


def run(kind: str, data: tuple, epochs: int, seed: int) -> list:
    """Both packages' ``fit`` of one trainer from one seed's weights;
    returns the rows ``_record`` logs."""
    over = overrides(kind, data, epochs, seed)
    jcfg, cfg = _jax_config(over), default_config(over)
    jtrainer = jax_learn.make_trainer(jcfg, jax_build_model(jcfg))
    jdata = jax_learn.build_data(jcfg, jcfg.MODEL.TYPE_SEMI)
    jtrainer.get_dataloader(*jdata[:2])
    create = jax_state.create_train_state
    with mock.patch.object(jax_state, "create_train_state",
                           lambda model, *a, **k: create(_JitInit(model), *a,
                                                         **k)):
        if kind != "supervised":
            jtrainer.get_config(jcfg, labeled_targets=jdata[3])
        else:
            jtrainer.get_config(jcfg, cls_num_list=jdata[2],
                                labeled_targets=jdata[3])
    state = jax.tree.map(np.asarray, (jtrainer.state.params,
                                      jtrainer.state.batch_stats))
    model = build_model(cfg)
    model.load_state_dict(from_jax_params(*state), strict=True)
    trainer = learn.make_trainer(cfg, model, device="cpu")
    learn.configure(trainer, cfg, learn.build_data(cfg))
    log = []
    for side, t in (("jax", jtrainer), ("port", trainer)):
        _record(t, side, log)
        with contextlib.redirect_stdout(io.StringIO()):
            t.fit()
    return log


def table(kind: str, seed: int, log: list) -> str:
    rows = {(r["side"], r["epoch"]): r for r in log}
    epochs = sorted({r["epoch"] for r in log})
    out = [f"{kind}, seed {seed}: per epoch, JAX | port",
           "epoch  train loss       teacher loss     teacher F1       "
           "student loss     student F1"]
    for e in epochs:
        j, p = rows.get(("jax", e), {}), rows.get(("port", e), {})
        cells = []
        for key in ("train_loss", "teacher_loss", "teacher_f1",
                    "student_loss", "student_f1"):
            a, b = j.get(key), p.get(key)
            cells.append(" | ".join("   -  " if v is None else f"{v:6.3f}"
                                    for v in (a, b)))
        out.append(f"{e:5d}  " + "  ".join(f"{c:15s}" for c in cells))
    return "\n".join(out)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trainers", nargs="+", default=["fixmatch",
                                                          "supervised"],
                        choices=["fixmatch", "supervised", "comatch"])
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--out", default=None, help="write the rows as JSON")
    args = parser.parse_args(argv)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_dataset(tmp, num_classes=4, n_train=64,
                                      n_valid=32, n_unlabeled=32, img_size=48)
        for kind in args.trainers:
            for seed in args.seeds:
                log = run(kind, data, args.epochs, seed)
                print(table(kind, seed, log), flush=True)
                results.append({"trainer": kind, "seed": seed, "rows": log})
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
