"""The reference's FixMatch steps computed in blocks of rows, float32.

What ``reference/train.py::run_steps`` computes for FixMatch, for a model
whose rows do not interact in the forward (no BatchNorm: Swin), so that a
float32 step over 480 view images fits on one card. Swin-T keeps about
162 MB an image for its backward in float32: one forward over the step's
480 images would hold about 78 GB.

Each step draws the views exactly as ``train.run_steps`` does. The weak
rows' logits are taken under ``no_grad`` (they enter the loss detached:
the pseudo-labels and the mask); then the labeled rows and the strong rows,
in that order, go forward and backward :data:`BLOCK` rows at a time, each
block's loss the sum of its rows' terms over the mean it belongs to (a
labeled row's poly-1 term over B, a strong row's masked CE times
``LAMBDA_U`` over B·MU), so that the gradients the blocks add up are the
whole step's, exact up to the order of the sums. One Adam step and the
EMA follow, as there.

:data:`BLOCK` is 64 rows: about 10.4 GB of saved activations for Swin-T
at 224 px, beside the float32 model, Adam's moments and the EMA (under
1 GB) and the step's uint8 rows and views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import views
from .train import _ce, class_weights, learning_rate  # noqa: F401

BLOCK = 64


def _blocks(n: int, block: int):
    return [slice(i, min(i + block, n)) for i in range(0, n, block)]


def _pseudo_labels(model, weak, block: int, thres: float):
    """The weak rows' argmax and mask, from logits taken without a graph."""
    with torch.no_grad():
        logits = torch.cat([model(weak[s].permute(0, 3, 1, 2))
                            for s in _blocks(len(weak), block)])
    top, label = F.softmax(logits, -1).max(-1)
    return label, (top >= thres).float()


def _step_blocks(model, x, t, strong, label, mask, weights, train,
                 block: int) -> float:
    """Forward and backward of the labeled and strong rows, ``block`` at a
    time; gradients add into ``.grad``. Returns the step's loss: each
    row's ``a · CE + c · (1 - p_target)``, summed, with ``a = w[y] / B``
    and ``c = 2 / B`` for a labeled row (poly-1, epsilon 2) and ``a =
    LAMBDA_U · mask / (B·MU)``, ``c = 0`` for a strong row."""
    b, bu = len(x), len(strong)
    rows = torch.cat([x, strong])
    targets = torch.cat([t, label])
    a = torch.cat([weights[t] / b, float(train["LAMBDA_U"]) * mask / bu])
    c = torch.cat([torch.full((b,), 2.0 / b, device=a.device),
                   torch.zeros(bu, device=a.device)])
    loss = 0.0
    for s in _blocks(len(rows), block):
        logits = model(rows[s].permute(0, 3, 1, 2))
        pt = F.softmax(logits, -1).gather(-1, targets[s, None])[:, 0]
        part = (a[s] * _ce(logits, targets[s]) + c[s] * (1.0 - pt)).sum()
        part.backward()
        loss += float(part.detach())
    return loss


def run_steps(model, batches, weights, config: dict, steps: int = 3,
              view_dtype=None, block: int = BLOCK):
    """``train.run_steps`` for FixMatch, in blocks of ``block`` rows;
    the same arguments and the same dict."""
    data, train = config["DATA"], config["TRAIN"]
    if config["MODEL"]["TYPE_SEMI"] != "FixMatch":
        raise ValueError("the blocked steps follow FixMatch only")
    img = int(data["IMG_SIZE"])
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
        label, mask = _pseudo_labels(model, weak, block, float(train["THRES"]))
        loss = _step_blocks(model, x, t, strong, label, mask, weights, train,
                            block)
        if step == 0:
            first_grad = {k: p.grad.detach().clone() for k, p in params.items()}
        for group in opt.param_groups:
            group["lr"] = learning_rate(step, train)
        opt.step()
        with torch.no_grad():
            for k, v in model.state_dict().items():
                if k in ema:
                    ema[k].mul_(decay).add_(v, alpha=1.0 - decay)
        losses.append(loss)
    after = {k: p.detach().clone() for k, p in params.items()}
    return {"losses": losses, "views": step_views, "first_grad": first_grad,
            "params": after, "ema": {k: ema[k] for k in params}}
