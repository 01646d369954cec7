"""The reference's FixMatch and SemiFormer steps, plain PyTorch, float32.

What the trainers' first steps compute, written from the reference
repository's ``fixmatch.py``, ``semiformer.py``, ``loss.py``,
``optimizer.py``, ``lr_scheduler.py`` and ``ema.py``:

- the batches: each train loader's rows in the order of its index stream
  (``numpy.random.default_rng(seed).permutation(n)``, batches of
  consecutive indices), read from the benchmark's pool;
- balanced class weights ``n / (classes present · count)`` over the
  labeled targets;
- FixMatch: one forward over ``[labeled view, weak, strong]``; the
  poly-1 loss (epsilon 2) of the labeled rows, ``w[y] ce + 2 (1 - p_y)``,
  as a plain mean; the consistency loss, the CE of the strong logits on
  the weak argmax where the weak max-probability reaches THRES, over every
  unlabeled row; ``lx + LAMBDA_U · lu``;
- SemiFormer's FixMatch phase: the class-weighted mean CE of both heads
  on the labeled rows, and both heads' consistency losses on the conv
  head's weak pseudo-labels;
- Adam (0.9, 0.999, eps 1e-8, no weight decay) at the step schedule's
  rate: a linear warm-up from WARMUP_LR to BASE_LR over WARMUP_EPOCHS ·
  EVAL_STEP steps, in float32;
- the EMA teacher, ``decay · ema + (1 - decay) · model`` over parameters
  and BN statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import views


def index_batches(n: int, batch: int, seed: int, steps: int):
    """The first ``steps`` batches of a loader's index stream."""
    rng = np.random.default_rng(seed)
    order = np.concatenate([rng.permutation(n)
                            for _ in range(-(-steps * batch // n))])
    return [order[i * batch:(i + 1) * batch] for i in range(steps)]


def class_weights(targets: np.ndarray, classes: int) -> np.ndarray:
    t = np.asarray(targets, np.int64)
    present = np.unique(t)
    w = np.zeros(classes)
    w[present] = len(t) / (len(present) * np.bincount(t)[present])
    return w


def learning_rate(step: int, train: dict) -> float:
    """The step schedule during its warm-up (the checked steps lie in
    it; later steps raise)."""
    per_epoch = int(train["EVAL_STEP"])
    warm = int(train["WARMUP_EPOCHS"] * per_epoch)
    if step >= warm:
        raise ValueError("the reference's schedule covers the warm-up only")
    f = np.float32
    slope = f((train["BASE_LR"] - train["WARMUP_LR"]) / warm)
    return float(f(train["WARMUP_LR"]) + f(step) * slope)


def _ce(logits, targets, weights=None):
    nll = -F.log_softmax(logits, -1).gather(-1, targets[:, None])[:, 0]
    return nll if weights is None else nll * weights[targets]


def _weighted_mean_ce(logits, targets, weights):
    return _ce(logits, targets, weights).sum() / weights[targets].sum()


def _poly(logits, targets, weights, eps: float = 2.0):
    pt = F.softmax(logits, -1).gather(-1, targets[:, None])[:, 0]
    return (_ce(logits, targets, weights) + eps * (1.0 - pt)).mean()


def _consistency(weak, strong, thres: float):
    probs = F.softmax(weak.detach(), -1)
    top, label = probs.max(-1)
    mask = (top >= thres).float()
    return (_ce(strong, label) * mask).mean()


def fixmatch_loss(logits, b: int, bu: int, targets, weights, cfg) -> torch.Tensor:
    lx = _poly(logits[:b], targets, weights)
    lu = _consistency(logits[b:b + bu], logits[b + bu:], cfg["THRES"])
    return lx + cfg["LAMBDA_U"] * lu


def semiformer_loss(out, b: int, bu: int, targets, weights, cfg) -> torch.Tensor:
    conv, trans = out
    lx = (_weighted_mean_ce(conv[:b], targets, weights)
          + _weighted_mean_ce(trans[:b], targets, weights))
    weak = conv[b:b + bu]
    lu = (_consistency(weak, conv[b + bu:], cfg["THRES"])
          + _consistency(weak, trans[b + bu:], cfg["THRES"]))
    return lx + cfg["LAMBDA_U"] * lu


LOSSES = {"FixMatch": fixmatch_loss, "SemiFormer": semiformer_loss}


def run_steps(model, batches, weights: np.ndarray, config: dict,
              steps: int = 3, view_dtype=None):
    """``steps`` training steps of ``model`` (float32, on its device) from
    ``batches``, a list of ``(labeled u8, targets, unlabeled u8)``
    tensors on that device, with the class ``weights``; the views' draws
    come from a generator on that device seeded with ``TRAIN.SEED``.
    ``view_dtype`` rounds the views to that type (the control's float8).
    Returns, per step, the loss and the views
    ``(labeled, weak, strong)`` (float32, normalized), the first step's
    gradient per parameter, and the parameters and EMA parameters after
    the last step, as dicts of float32 tensors."""
    data, model_cfg, train = config["DATA"], config["MODEL"], config["TRAIN"]
    img = int(data["IMG_SIZE"])
    loss_fn = LOSSES[model_cfg["TYPE_SEMI"]]
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(int(train["SEED"]))
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=learning_rate(0, train),
                           betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    ema = {k: v.detach().clone() for k, v in model.state_dict().items()
           if v.is_floating_point()}
    decay = float(train["EMA_DECAY"])
    losses, step_views, first_grad = [], [], None
    model.train()
    for step in range(steps):
        x_u8, t, u_u8 = batches[step]
        d_lab = views.labeled_draws(g, len(x_u8))
        d_fix = views.fixmatch_draws(g, len(u_u8), img)
        x = views.labeled_view(x_u8, img, d_lab)
        weak, strong = views.fixmatch_views(u_u8, img, d_fix)
        if view_dtype is not None:
            x, weak, strong = (v.to(view_dtype).float()
                               for v in (x, weak, strong))
        step_views.append((x, weak, strong))
        opt.zero_grad(set_to_none=True)
        out = model(torch.cat([x, weak, strong]).permute(0, 3, 1, 2))
        loss = loss_fn(out, len(x), len(weak), t, weights, train)
        loss.backward()
        if step == 0:
            first_grad = {k: p.grad.detach().clone() for k, p in params.items()}
        for group in opt.param_groups:
            group["lr"] = learning_rate(step, train)
        opt.step()
        with torch.no_grad():
            for k, v in model.state_dict().items():
                if k in ema:
                    ema[k].mul_(decay).add_(v, alpha=1.0 - decay)
        losses.append(float(loss.detach()))
    after = {k: p.detach().clone() for k, p in params.items()}
    return {"losses": losses, "views": step_views, "first_grad": first_grad,
            "params": after, "ema": {k: ema[k] for k in params}}
