"""The comparison that decides ``correct``.

Set-up drives the trainer from the seed through its first steps (three),
through the window's own ``train_one`` call and loaders, and records what
they produced (:class:`Capture`): the batches the loaders handed out, the
views, each step's loss, the first gradient as Adam holds it after one
step (``exp_avg / (1 - β1)``), and the change of every parameter and of
its EMA after the three steps: the first gradient's tensors (on the
host) and, of the changes, norms per parameter.

After the window, the reference (``reference/``, plain float32 PyTorch
with TF32 off) recomputes the same steps from the same inputs: the pool,
the seeded weights and the seeds. :func:`compare` gives each number:

- the loaders' (``traffic.check_batches``): ``batch_mismatch``, bytes of
  the cached loaders' batches and targets that differ from the rows the
  reference reads by the loaders' index stream; for JPEG files
  ``batch_unmatched``, rows that match no file of the core's stream or
  whose target differs, and ``decode_mean_abs``, the largest mean absolute
  gap of a row from Pillow's decode of its file, resized;
- ``views_max_abs``: the largest gap of a view's value (normalized
  units) between the program and the reference, and ``views_mean_abs``
  the largest mean gap of one view of one step (where the two sides'
  batches differ by a decoder's rounding, a threshold in RandAugment
  turns one unit into a full-scale gap at a few pixels);
- ``loss_rel``: the largest relative gap of a step's loss;
- ``grad_dist_median``: the median parameter's distance between the
  program's first gradient and the reference's, over the reference's
  norm (the norms' gaps average each element's rounding away; this
  does not), and ``head_grad_dist`` the largest such distance of the
  classifier kernels the configuration names (``check.head_leaves``):
  the features' precision reaches them with no ReLU or pooling decision
  in between;
- ``grad_gap``, ``update_gap``, ``ema_gap``: the worst parameter's gap
  between the program's norm and the reference's (first gradient; change
  after the steps; the EMA's change), over the reference's norm of that
  parameter or of the median parameter, whichever is larger. Parameters
  whose reference gradient is under a thousandth of the median
  parameter's are left out of the three: Adam moves them by round-off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STEPS = 3
SKIP_BELOW = 1e-3  # of the median parameter's first-gradient norm


def _leaves(tensors: dict) -> dict:
    """The published layers' tensors: a fused ``qkv`` projection counts as
    its three parts, ``name[q]``, ``name[k]`` and ``name[v]`` (a key's bias
    has no gradient under softmax but round-off, and must be left out of
    the change by itself)."""
    out = {}
    for k, v in tensors.items():
        if k.endswith((".qkv.weight", ".qkv.bias")):
            for part, t in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}[{part}]"] = t
        else:
            out[k] = v
    return out


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            _leaves(tensors).items()}


class Capture:
    """Hooks on one trainer instance for its first :data:`STEPS` steps."""

    def __init__(self, trainer, clock):
        self.trainer, self.clock = trainer, clock
        self.losses, self.views = [], []
        self.grad_norms = self.grads = None
        model = trainer.state.model
        self.p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
        clock.capture = []
        step, views = trainer._train_step, trainer._views

        def train_step(*args):
            out = step(*args)
            self.losses.append(out[0].detach().clone())
            if self.grad_norms is None:
                opt = trainer.state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                moments = {  # 0 where Adam holds no moment
                    k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                    for k, p in model.named_parameters()}
                self.grad_norms = {k: v / (1.0 - beta1)
                                   for k, v in _norms(moments).items()}
                self.grads = {k: v.detach().float().cpu() / (1.0 - beta1)
                              for k, v in _leaves(moments).items()}
            return out

        def capture_views(*args):
            out = views(*args)
            self.views.append(tuple(v.detach().float().cpu() for v in out))
            return out

        self._saved = (step, views)
        trainer._train_step, trainer._views = train_step, capture_views

    def finish(self) -> dict:
        """Remove the hooks; the program's readings."""
        trainer = self.trainer
        trainer._train_step, trainer._views = self._saved
        batches = self.clock.capture
        self.clock.capture = None
        st = trainer.state
        ema = dict(st.ema.named_parameters()) if st.ema is not None else {}
        model = dict(st.model.named_parameters())
        readings = {
            "losses": [float(v) for v in self.losses],
            "grad_norms": self.grad_norms,
            "grads": self.grads,
            "update_norms": _norms({k: model[k].detach() - self.p0[k]
                                    for k in model}),
            "ema_norms": _norms({k: ema[k].detach() - self.p0[k]
                                 for k in ema}),
            "batches": [(_host(batches[2 * i][0]), np.asarray(batches[2 * i][1]),
                         _host(batches[2 * i + 1][0]))
                        for i in range(len(batches) // 2)],
            "views": self.views,
        }
        self.p0 = None
        return readings


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def reference_readings(run: dict, weights: dict) -> dict:
    """``reference.train.run_steps``' output in the program's form."""
    return {
        "losses": run["losses"],
        "grad_norms": _norms(run["first_grad"]),
        "grads": {k: v.detach().float().cpu()
                  for k, v in _leaves(run["first_grad"]).items()},
        "update_norms": _norms({k: run["params"][k] - weights[k]
                                for k in weights}),
        "ema_norms": _norms({k: run["ema"][k] - weights[k] for k in weights}),
        "views": [tuple(v.cpu() for v in step) for step in run["views"]],
    }


def kept_leaves(ref_grad_norms: dict) -> list:
    """The parameters the gaps cover: those whose reference first
    gradient reaches :data:`SKIP_BELOW` of the median parameter's."""
    median = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= SKIP_BELOW * median]


def _gaps(got: dict, ref: dict, keep) -> dict:
    """Each kept parameter's gap of norms, over the reference's norm of
    that parameter or of the median one, whichever is larger."""
    median = float(np.median([ref[k] for k in keep]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], median) for k in keep}


def _leaf_gap(got: dict, ref: dict, keep) -> float:
    return max(_gaps(got, ref, keep).values())


def _dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def compare(prog: dict, ref: dict, head_leaves=()) -> dict:
    """Each number of the module docstring but the loaders' (which
    ``traffic.check_batches`` gives); ``head_leaves`` name the
    classifier kernels of ``head_grad_dist``."""
    out = {}
    out["views_max_abs"] = max(
        (float((a - b).abs().max()) if a.shape == b.shape else math.inf)
        for pv, rv in zip(prog["views"], ref["views"]) for a, b in zip(pv, rv))
    out["views_mean_abs"] = max(
        (float((a - b).abs().mean()) if a.shape == b.shape else math.inf)
        for pv, rv in zip(prog["views"], ref["views"]) for a, b in zip(pv, rv))
    out["loss_rel"] = (max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], ref["losses"]))
                       if len(prog["losses"]) == len(ref["losses"])
                       else math.inf)
    g_ref = ref["grad_norms"]
    keep = kept_leaves(g_ref)
    out["grad_gap"] = _leaf_gap(prog["grad_norms"], g_ref, keep)
    out["grad_dist_median"] = float(np.median(
        [_dist(prog["grads"][k], ref["grads"][k]) for k in keep]))
    if head_leaves:
        out["head_grad_dist"] = max(_dist(prog["grads"][k], ref["grads"][k])
                                    for k in head_leaves)
    out["update_gap"] = _leaf_gap(prog["update_norms"], ref["update_norms"],
                                  keep)
    out["ema_gap"] = _leaf_gap(prog["ema_norms"], ref["ema_norms"], keep)
    return out


def worst_leaves(prog: dict, ref: dict, n: int = 4) -> dict:
    """For each of the three parameter gaps, the ``n`` worst parameters:
    ``[name, program norm, reference norm, reference gradient norm]``."""
    g_ref = ref["grad_norms"]
    keep = kept_leaves(g_ref)
    out = {}
    for key in ("grad_norms", "update_norms", "ema_norms"):
        gaps = _gaps(prog[key], ref[key], keep)
        gap = sorted(gaps, key=gaps.get, reverse=True)
        out[key] = [[k, prog[key][k], ref[key][k], g_ref[k]]
                    for k in gap[:n]]
    out["median_grad"] = float(np.median(list(g_ref.values())))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number finite and
    within its limit (``batch_mismatch`` -1 means a step is missing)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = (value is not None and math.isfinite(value) and value >= 0
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
