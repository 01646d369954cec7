"""Step-granularity LR schedules (port of ``endoscopy_tpu/optim/schedules.py``).

The three schedules share the linear warmup
``lr(t) = warmup_lr_init + t * (base_lr - warmup_lr_init) / warmup_t`` for
``t < warmup_t``; after it, ``cosine`` (timm, global step over
``num_steps``, ``lr_min = 5e-6``), ``linear`` (down to 1% of ``base_lr``
over the post-warmup span) or ``step`` (``base_lr * decay_rate ** (t //
decay_t)``).

Each schedule is a function of the optimizer's step count *before* the
update (step 0 uses ``lr(0)``, as optax's ``scale_by_schedule`` does) and
computes in float32, as the reference does, returning a Python float.
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32


def _warmup(t: np.float32, base_lr: float, warmup_lr_init: float,
            warmup_t: int) -> np.float32:
    if warmup_t <= 0:
        return _F(base_lr)
    slope = _F((base_lr - warmup_lr_init) / warmup_t)
    return _F(warmup_lr_init) + t * slope


def cosine_schedule(base_lr: float, num_steps: int, warmup_lr_init: float,
                    warmup_t: int, lr_min: float = 5e-6):
    def fn(step: int) -> float:
        t = _F(step)
        if t < warmup_t:
            return float(_warmup(t, base_lr, warmup_lr_init, warmup_t))
        arg = _F(math.pi) * min(t, _F(num_steps)) / _F(num_steps)
        return float(_F(lr_min) + _F(0.5 * (base_lr - lr_min))
                     * (_F(1.0) + np.cos(arg)))
    return fn


def linear_schedule(base_lr: float, num_steps: int, warmup_lr_init: float,
                    warmup_t: int, lr_min_rate: float = 0.01):
    def fn(step: int) -> float:
        t = _F(step)
        if t < warmup_t:
            return float(_warmup(t, base_lr, warmup_lr_init, warmup_t))
        total = _F(max(num_steps - warmup_t, 1))
        frac = np.clip((t - _F(warmup_t)) / total, _F(0.0), _F(1.0))
        return float(_F(base_lr) - _F(base_lr - base_lr * lr_min_rate) * frac)
    return fn


def step_schedule(base_lr: float, decay_t: int, decay_rate: float,
                  warmup_lr_init: float, warmup_t: int):
    def fn(step: int) -> float:
        t = _F(step)
        if t < warmup_t:
            return float(_warmup(t, base_lr, warmup_lr_init, warmup_t))
        k = np.floor(t / _F(max(decay_t, 1)))
        return float(_F(base_lr) * np.power(_F(decay_rate), k))
    return fn


def build_schedule(config, n_iter_per_epoch: int):
    """The config's schedule over ``n_iter_per_epoch`` steps an epoch."""
    num_steps = int(config.TRAIN.EPOCHS * n_iter_per_epoch)
    warmup_t = int(config.TRAIN.WARMUP_EPOCHS * n_iter_per_epoch)
    decay_t = int(config.TRAIN.DECAY_EPOCHS * n_iter_per_epoch)
    base_lr = float(config.TRAIN.BASE_LR)
    warmup_lr = float(config.TRAIN.WARMUP_LR)

    name = config.TRAIN.SCH_NAME
    if name == "cosine":
        return cosine_schedule(base_lr, num_steps, warmup_lr, warmup_t)
    if name == "linear":
        return linear_schedule(base_lr, num_steps, warmup_lr, warmup_t)
    if name == "step":
        return step_schedule(base_lr, decay_t, float(config.TRAIN.LR_DECAY),
                             warmup_lr, warmup_t)
    raise ValueError(f"unknown scheduler '{name}'")
