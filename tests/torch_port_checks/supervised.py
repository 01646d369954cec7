"""Port checks: the supervised trainer and what it stands on, against the JAX package.

float32 on the CPU, ``resnet_tiny`` at 32 px (canonical 38) with B=8 and
four classes (``train.py``'s setting), inputs from numpy seeds, weights
converted from the JAX trainers' initial states (``_JitInit``). Each
JAX step's views, Mixup draws and dropout masks are rebuilt from the JAX
step's own key splits and handed to the port. Tolerances, and why:

- fresh weights (fault 1): for every weight of ResNet-50 and of the MLP,
  projection and linear heads, ``var · fan_in`` within five standard
  errors of 1 (flax's ``lecun_normal``: ``5 sqrt(2 / n)`` for ``n``
  elements, the truncated normal's kurtosis being under 3), and for
  four of them (``FLAX_DRAWN``) of flax's own draw of the same shape
  (``5 sqrt(4 / n)``); no element beyond two standard deviations, biases
  exactly 0, BN scale 1 and offset 0;
- checkpoints (fault 3): a save whose second file write fails leaves the
  old pair or the new state beside the old meta, never a new meta beside
  an old state; ``latest_checkpoint``/``restore_checkpoint`` take it;
- ``rdw_weights``/``effective_number_weights`` and the triplet batch's
  indices: exact (the same numpy code and generator);
- ``triplet_loss``: values and gradients 1e-6 relative;
- the heads and ``ModelwEmb`` from converted weights: eval and train
  outputs within 1e-4 of each output's largest magnitude (float32
  convolutions summed in another order, and flax's one-pass batch
  variance in train mode), BN running statistics 1e-4 relative
  (``train.py``'s);
- ``mixup_cutmix``: mixed pixels and soft targets 1e-6 relative (XLA may
  contract ``lam x + (1 - lam) x'`` into one fused multiply-add);
- one step of the plain, the Mixup and the triplet branch, each also at
  GRAD_ACCUM=2, against JAX ``_train_step``: losses and triplet distances
  1e-5 relative, parameters, BN statistics and EMA at ``train.py``'s step
  bounds (SGD's update within 0.1 of a tensor's largest);
- ``fit``: the same train, evaluate, save and stop events for one
  scripted sequence of valid losses and macro-F1s, with ``train_one`` and
  ``evaluate_one`` stood in on both sides;
- the ``evaluate`` and ``pseudo_label`` CLIs in a subprocess with
  ``--device cpu`` against the JAX CLIs from the same weights: macro-F1
  equal as printed (4 digits), the pseudo-label and misclassified CSVs
  equal;
- ``path_e.py``'s fields against both YAML files: equal.
"""

import contextlib
import copy
import csv
import functools
import io
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from endoscopy_tpu.aug import mixup as jmixup
from endoscopy_tpu.aug import views as jviews
from endoscopy_tpu.ckpt import orbax_io as jax_orbax_io
from endoscopy_tpu.cli import evaluate as jax_evaluate
from endoscopy_tpu.cli import pseudo_label as jax_pseudo_label
from endoscopy_tpu.losses import classification as jcls
from endoscopy_tpu.losses import triplet as jtriplet
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu.serve import export as jexport
from endoscopy_tpu.optim import optimizers as jopt
from endoscopy_tpu.train import state as jax_state
from endoscopy_tpu.train.common import trainable_mask as jax_trainable_mask
from endoscopy_tpu.train.supervised import SupLearning as JaxSupLearning
from endoscopy_tpu.utils.meters import AverageMeter as JaxMeter
from endoscopy_tpu_torch.aug import mixup
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt.convert import (from_jax_params,
                                              train_state_from_npz)
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.losses import (effective_number_weights, rdw_weights,
                                        triplet_loss)
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.models.heads import MLPHead
from endoscopy_tpu_torch.serve import export
from endoscopy_tpu_torch.train import supervised as supervised_mod
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from endoscopy_tpu_torch.train.supervised import SupLearning
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter
from torch_port_checks import path_e
from torch_port_checks.learn import (_data_overrides, _dataset,
                                     _orbax_to_npz, _port_params)
from torch_port_checks.train import (CANON, IMG, NUM_CLASSES, OVERRIDES, ROOT,
                                     _close, _compare_state, _jax_config,
                                     _jax_labeled, _JitInit, _port_state)

F32 = np.float32
B = 8
LABELED = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])


def _sup_overrides(triplet: bool = False, **train):
    over = copy.deepcopy(OVERRIDES)
    over["MODEL"]["IS_TRIPLET"] = triplet
    over["TRAIN"].update(IS_SSL=False, **train)
    return over


# -- Step 0: fresh weights, checkpoint order ---------------------------------


# the tensors also held against a draw of flax's own initializer at their
# shape: the stem, a 3x3 convolution, the MLP head's first layer and the
# linear head
FLAX_DRAWN = {"backbone.conv1", "backbone.layer3.0.conv2", "fc.fc1",
              "head.fc"}


def check_fresh_weights_follow_flax_initializer():
    """ResNet-50 under ``ModelwEmb`` (so the MLP and projection heads too)
    and a resnet_tiny classifier (the linear head): every weight as
    flax's ``lecun_normal`` draws it, every bias 0, BN 1 and 0."""
    from flax.linen.initializers import lecun_normal

    torch.manual_seed(0)
    models = [build_model(default_config({"MODEL": {
        "NAME": name, "NUM_CLASSES": 6, "IS_TRIPLET": triplet}}))
        for name, triplet in (("resnet50", True), ("resnet_tiny", False))]
    draw = jax.jit(lambda key, fan_in, n: lecun_normal()(key, (fan_in, n)),
                   static_argnums=(1, 2))
    flax_ratio = {}
    n_weights = 0
    for model in models:
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                assert torch.all(m.weight == 1) and not m.bias.any(), name
                assert not m.running_mean.any(), name
                assert torch.all(m.running_var == 1), name
                continue
            if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                continue
            assert m.bias is None or not m.bias.any(), name
            p = m.weight.detach().double()
            fan_in, n = p[0].numel(), p.numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            ratio = float(p.var(unbiased=False)) * fan_in
            assert abs(ratio - 1.0) <= 5 * (2 / n) ** 0.5, (name, ratio)
            assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), name
            if name in FLAX_DRAWN:
                w = np.asarray(draw(jax.random.key(n_weights), fan_in,
                                    n // fan_in), np.float64)
                flax_ratio[name] = w.var() * fan_in
                assert abs(ratio - flax_ratio[name]) <= 5 * (4 / n) ** 0.5, (
                    name, ratio, flax_ratio[name])
            n_weights += 1
    assert n_weights == 53 + 4 + 17 + 1  # convs, fc1-2, proj1-2; tiny
    assert set(flax_ratio) == FLAX_DRAWN


def check_checkpoint_writes_state_before_meta():
    """A re-save of ``epoch_1`` whose first or second file write fails:
    the directory holds the old pair, or the new state beside the old
    meta, and ``latest_checkpoint``/``restore_checkpoint`` accept it. A
    first save cut after its state restores with an empty meta."""
    def state(shift):
        return {"w": torch.arange(4.0) + shift}

    real = ckpt_io._durable_replace
    for fail_at in (1, 2):
        with tempfile.TemporaryDirectory() as d:
            ckpt_io.save_checkpoint(d, "epoch_1", state(0), {"epoch": 1,
                                                             "v": "old"})
            calls = []

            def flaky(path, write):
                calls.append(os.path.basename(path))
                if len(calls) == fail_at:
                    raise OSError("simulated crash")
                real(path, write)

            with mock.patch.object(ckpt_io, "_durable_replace", flaky), \
                    pytest.raises(OSError, match="simulated"):
                ckpt_io.save_checkpoint(d, "epoch_1", state(7),
                                        {"epoch": 1, "v": "new"})
            latest = ckpt_io.latest_checkpoint(d)
            assert latest and latest.endswith("epoch_1")
            got, meta = ckpt_io.restore_checkpoint(latest, "cpu")
            new_state = torch.equal(got["w"], state(7)["w"])
            assert meta["v"] == "old", (fail_at, meta)
            assert new_state == (fail_at == 2), fail_at
            assert calls[0] == ckpt_io.STATE
    with tempfile.TemporaryDirectory() as d:
        def meta_fails(path, write):
            if path.endswith(ckpt_io.META):
                raise OSError("simulated crash")
            real(path, write)

        with mock.patch.object(ckpt_io, "_durable_replace", meta_fails), \
                pytest.raises(OSError):
            ckpt_io.save_checkpoint(d, "epoch_2", state(1), {"epoch": 2})
        latest = ckpt_io.latest_checkpoint(d)
        got, meta = ckpt_io.restore_checkpoint(latest, "cpu")
        assert latest.endswith("epoch_2") and meta == {}
        assert torch.equal(got["w"], state(1)["w"])


# -- losses, heads, Mixup ----------------------------------------------------


def check_class_weights_match_jax():
    """``rdw_weights`` on both sides of epoch 25 and
    ``effective_number_weights`` at several betas: equal. The trainer
    takes RDW's only for ``TRAIN_RULE: 'RDW'`` exactly ('DRW', as
    ``configs/kaggle_reproduce.yaml`` writes it, keeps the balanced
    weights)."""
    counts = [120, 7, 33, 1, 64]
    for epoch in (0, 24, 25, 26, 100):
        np.testing.assert_array_equal(rdw_weights(epoch, counts),
                                      jcls.rdw_weights(epoch, counts))
    for beta in (0.0, 0.9, 0.999, 0.9999):
        np.testing.assert_array_equal(
            effective_number_weights(counts, beta),
            jcls.effective_number_weights(counts, beta))
    assert not np.allclose(rdw_weights(25, counts), 1.0)
    np.testing.assert_array_equal(rdw_weights(24, counts), np.ones(5))
    for rule, want in (("RDW", rdw_weights(30, [4, 1, 2, 3])),
                       ("DRW", jcls.balanced_class_weights(
                           LABELED, num_classes=NUM_CLASSES))):
        cfg = default_config(_sup_overrides(TRAIN_RULE=rule))
        trainer = SupLearning(build_model(cfg), "Adam", device="cpu")
        trainer.train_dl = None
        trainer.get_config(cfg, cls_num_list=[4, 1, 2, 3],
                           labeled_targets=LABELED)
        _close(trainer._epoch_weights(30).numpy(), want, rtol=1e-7)


def check_triplet_loss_matches_jax():
    """Random anchors, positives and negatives, some triplets inside the
    margin and some outside: the loss, both mean distances and the
    gradients of the loss."""
    rng = np.random.default_rng(11)
    a, p, n = (rng.normal(0, 0.3, (12, 16)).astype(F32) for _ in range(3))
    n[:4] = a[:4] + 5.0  # far negatives: zero loss terms
    want = jtriplet.triplet_loss(*(jnp.asarray(v) for v in (a, p, n)))
    leaves = [torch.tensor(v, requires_grad=True) for v in (a, p, n)]
    got = triplet_loss(*leaves)
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w, rtol=1e-6)
    got[0].backward()
    grads = jax.grad(lambda *v: jtriplet.triplet_loss(*v)[0], (0, 1, 2))(
        *(jnp.asarray(v) for v in (a, p, n)))
    for leaf, g in zip(leaves, grads):
        _close(leaf.grad.numpy(), g, rtol=1e-6, atol=1e-8)
    assert float(got[0].detach()) > 0 and not leaves[2].grad[:4].any()


@functools.cache
def _jax_sup_base(triplet: bool):
    """The JAX supervised trainer whose initial state the step cases of
    this branch start from (SGD; one step an epoch: no train loader)."""
    cfg = _jax_config(_sup_overrides(triplet))
    trainer = JaxSupLearning(model=jax_build_model(cfg), opt_func="SGD")
    trainer.train_dl = trainer.valid_dl = None
    create = jax_state.create_train_state
    with mock.patch.object(jax_state, "create_train_state",
                           lambda model, *a, **k: create(_JitInit(model), *a,
                                                         **k)):
        trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4],
                           labeled_targets=LABELED)
    return trainer


@functools.cache
def _dropout_forward(model):
    """A compiled train-mode forward of ``model``: ``(outputs, the
    updated batch_stats, [(input, output) of every nn.Dropout call])``."""
    def forward(params, batch_stats, x, key):
        calls = []

        def record(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                calls.append((args[0], y))
            return y

        with fnn.intercept_methods(record):
            out, mut = model.apply(
                {"params": params, "batch_stats": batch_stats}, x,
                train=True, mutable=["batch_stats"], rngs={"dropout": key})
        return out, mut["batch_stats"], calls

    return jax.jit(forward)


def _dropout_masks(calls):
    """The keep-masks of ``nn.Dropout`` calls, read off the layer's
    outputs (a dropped element is 0; a kept one is 0 only where its input
    is, which the mask does not change)."""
    masks = [np.asarray(y) != 0 for _, y in calls]
    # the share kept where the input is not 0: about 0.8
    kept = [m[np.asarray(x) != 0].mean() for m, (x, _) in zip(masks, calls)]
    assert all(0.7 < k < 0.9 for k in kept), kept
    return masks


def check_heads_match_flax():
    """``ModelwEmb`` (resnet_tiny, the MLP and projection heads) from the
    JAX model's converted weights, with randomized BN statistics: eval
    outputs, then a train-mode forward with the JAX dropout mask injected
    (outputs and every BN's running statistics, the head's 1-D BN
    included); a strict load of the converted tree. The MLP head alone
    draws its dropout from a generator, and the same seed gives the same
    draw."""
    base = _jax_sup_base(True)
    rng = np.random.default_rng(12)
    params = jax.tree.map(np.asarray, base.state.params)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.2, a.shape)).astype(F32),
        base.state.batch_stats)
    x = rng.normal(0, 1, (3 * B, IMG, IMG, 3)).astype(F32)  # a step's
    port = build_model(default_config(_sup_overrides(True)))
    port.load_state_dict(from_jax_params(params, stats), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, x: base.model.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(xt)
    assert np.isfinite(np.asarray(want[2])).all() and np.asarray(want[1]).any()
    for g, w in zip(got, want):
        _close(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    want, moved, calls = _dropout_forward(base.model)(
        params, stats, jnp.asarray(x), jax.random.key(13))
    (mask,) = _dropout_masks(calls)
    port.fc.keep_mask = torch.from_numpy(mask)
    with torch.no_grad():
        got = port.train()(xt)
    for g, w in zip(got, want):
        _close(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    now = port.state_dict()
    moved = _port_state(params, moved)
    keys = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert "fc.bn.running_var" in keys
    for k in keys:
        _close(now[k].numpy(), moved[k].numpy(), rtol=1e-4, atol=1e-6, what=k)
    head = MLPHead(16, 3).train()
    h = torch.randn(5, 16, generator=torch.Generator().manual_seed(0))
    outs = []
    for s in (1, 1, 2):
        head.generator = torch.Generator().manual_seed(s)
        outs.append(head(h))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@jax.jit
def _jax_mix_draw_fn(key, h, w, mixup_alpha, cutmix_alpha):
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    ky, kx = jax.random.split(k_box)
    return {"apply": jax.random.uniform(k_apply),
            "switch": jax.random.uniform(k_switch),
            "lam_m": jax.random.beta(k_lam_m, mixup_alpha, mixup_alpha),
            "lam_c": jax.random.beta(k_lam_c, cutmix_alpha, cutmix_alpha),
            "cy": jax.random.randint(ky, (), 0, h),
            "cx": jax.random.randint(kx, (), 0, w)}


def _jax_mix_draws(key, h, w, mixup_alpha, cutmix_alpha):
    """What jax ``mixup_cutmix`` draws from ``key``, as the port's
    ``draws`` (a Beta of an alpha at 0 is not drawn: 1)."""
    draws = _jax_mix_draw_fn(key, h, w, max(mixup_alpha, 1e-3),
                             max(cutmix_alpha, 1e-3))
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    for k, alpha in (("lam_m", mixup_alpha), ("lam_c", cutmix_alpha)):
        if alpha <= 0:
            draws[k] = torch.tensor(1.0)
    return draws


MIX_CASES = (  # (mixup_alpha, cutmix_alpha, prob): mixup, cutmix, both, off
    (0.4, 0.0, 1.0), (0.0, 1.0, 1.0), (0.8, 1.0, 1.0), (0.8, 1.0, 0.0))


def check_mixup_cutmix_matches_jax():
    """Mixup alone, CutMix alone, both (seeds where each is chosen) and
    ``prob`` 0, on the JAX draws: the same mixed batch and soft targets.
    Then the generator's draws: Beta(0.4, 0.4)'s mean and variance over
    2,000 draws within five standard errors, a box inside the image, and
    the same draws from the same seed."""
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (B, 16, 16, 3)).astype(F32)
    t = rng.integers(0, NUM_CLASSES, B)
    seen = set()
    for mix_a, cut_a, prob in MIX_CASES:
        kw = dict(num_classes=NUM_CLASSES, mixup_alpha=mix_a,
                  cutmix_alpha=cut_a, prob=prob, switch_prob=0.5,
                  label_smoothing=0.1)
        mix = jax.jit(lambda x, t, k: jmixup.mixup_cutmix(x, t, k, **kw))
        for seed in range(3):
            key = jax.random.key(100 + seed)
            want = mix(jnp.asarray(x), jnp.asarray(t), key)
            draws = _jax_mix_draws(key, 16, 16, mix_a, cut_a)
            got = mixup.mixup_cutmix(torch.from_numpy(x), torch.from_numpy(t),
                                     draws=draws, **kw)
            for g, w in zip(got, want):
                _close(g.numpy(), w, rtol=1e-6, atol=1e-6)
            cut = cut_a > 0 and (mix_a <= 0 or float(draws["switch"]) < 0.5)
            seen.add((mix_a, cut_a, prob, cut))
            if prob == 0:
                np.testing.assert_array_equal(got[0].numpy(), x)
    assert {(0.8, 1.0, 1.0, True), (0.8, 1.0, 1.0, False)} <= seen, seen
    a, n = 0.4, 2000
    gen = torch.Generator().manual_seed(15)
    lams = torch.stack([mixup._beta(a, gen) for _ in range(n)]).double()
    var = 1.0 / (4 * (2 * a + 1))
    assert abs(float(lams.mean()) - 0.5) <= 5 * (var / n) ** 0.5
    assert abs(float(lams.var()) - var) <= 5 * 0.02
    draws = [mixup.sample_mixup_draws(torch.Generator().manual_seed(16),
                                      16, 12, 0.4, 1.0) for _ in range(2)]
    assert all(torch.equal(draws[0][k], draws[1][k]) for k in draws[0])
    assert 0 <= int(draws[0]["cy"]) < 16 and 0 <= int(draws[0]["cx"]) < 12


# -- the step -----------------------------------------------------------------


@functools.cache
def _jax_sup_trainer(triplet: bool, accum: int, mix: bool):
    """The branch's JAX trainer from its shared initial state, rebuilt for
    this accumulation and Mixup setting (its ``_train_step`` is pure: the
    cases share one compile)."""
    base = _jax_sup_base(triplet)
    trainer = copy.copy(base)
    trainer.config = copy.deepcopy(base.config)
    trainer.config.TRAIN.update(MIXUP=0.4 * mix, CUTMIX=1.0 * mix)
    trainer.mixup_active = mix
    trainer.grad_accum = accum
    trainer.tx = jopt.build_optimizer(base.state.params, "SGD",
                                      lr=base.lr_schedule)
    trainer.state = base.state.replace(
        opt_state=trainer.tx.init(base.state.params))
    trainer.grad_mask = jax_trainable_mask(base.state.params, False)
    trainer._build_train_step()
    return trainer


def _port_sup_trainer(triplet: bool, accum: int, mix: bool):
    cfg = default_config(_sup_overrides(
        triplet, GRAD_ACCUM=accum, MIXUP=0.4 * mix, CUTMIX=1.0 * mix))
    model = build_model(cfg)
    base = _jax_sup_base(triplet).state
    model.load_state_dict(_port_state(base.params, base.batch_stats),
                          strict=True)
    trainer = SupLearning(model, "SGD", device="cpu")
    trainer.train_dl = None
    trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4], labeled_targets=LABELED)
    return trainer


def _step_batch(seed: int, triplet: bool):
    rng = np.random.default_rng(seed)
    n = 3 * B if triplet else B
    t = np.arange(B) % NUM_CLASSES
    rng.shuffle(t)
    return (rng.integers(0, 256, (n, CANON, CANON, 3)).astype(np.uint8),
            t.astype(np.int32))


def _inject_masks(port, masks):
    """The MLP head's keep-mask set to ``masks[i]`` for the trainer's i-th
    microbatch forward."""
    masks = iter(masks)
    forward_backward = port._forward_backward

    def with_mask(*args):
        port.state.model.fc.keep_mask = next(masks)
        return forward_backward(*args)

    port._forward_backward = with_mask


def _sup_step(triplet: bool, accum: int, mix: bool, seed: int):
    """One JAX ``_train_step`` and the port's step on the views, Mixup
    draws and dropout masks it drew; compares them."""
    u8, t = _step_batch(seed, triplet)
    w = jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)
    key = jax.random.key(seed)
    jt = _jax_sup_trainer(triplet, accum, mix)
    jstate, jloss, jaux = jt._train_step(jt.state, jnp.asarray(u8),
                                         jnp.asarray(t), jnp.asarray(w), key)
    if triplet:  # microbatch i gets (A_i, P_i, N_i)
        xs = u8.reshape(3, accum, -1, *u8.shape[1:]).swapaxes(0, 1).reshape(
            accum, -1, *u8.shape[1:])
    else:
        xs = u8.reshape(accum, -1, *u8.shape[1:])
    micro, masks = [], []
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    base = _jax_sup_base(triplet)
    for x_u8, t_m, k in zip(xs, t.reshape(accum, -1), keys):
        k_aug, k_drop = jax.random.split(k)
        x = _jax_labeled(jnp.asarray(x_u8), k_aug, IMG, jnp.float32)
        draws = None
        if triplet:
            (mask,) = _dropout_masks(_dropout_forward(base.model)(
                base.state.params, base.state.batch_stats, x, k_drop)[2])
            masks.append(torch.from_numpy(mask))
        if mix:
            draws = _jax_mix_draws(jax.random.split(k_drop)[0], IMG, IMG,
                                   0.4, 1.0)
        micro.append((torch.from_numpy(np.asarray(x)),
                      torch.from_numpy(t_m).long(), draws))
    port = _port_sup_trainer(triplet, accum, mix)
    if triplet:
        _inject_masks(port, masks)
    loss, aux = port._train_micro(micro, torch.from_numpy(w))
    _close(float(loss), float(jloss), rtol=1e-5, what="loss")
    assert len(aux) == len(jaux) == 2 * triplet
    for g, v in zip(aux, jaux):
        _close(float(g), float(v), rtol=1e-5, what="triplet distance")
    _compare_state(port, jstate, "SGD", (), base.state)


def check_supervised_steps_match_jax():
    """The plain, Mixup (CutMix and mixup switched) and triplet steps, at
    GRAD_ACCUM 1 and 2, against JAX ``_train_step``."""
    for triplet, mix in ((False, False), (False, True), (True, False)):
        for accum in (1, 2):
            _sup_step(triplet, accum, mix, seed=20 + 2 * accum + triplet)


class _Given:
    """A model for ``create_train_state`` whose ``init`` returns the given
    variables (no flax init compile)."""

    def __init__(self, variables):
        self.variables = variables

    def init(self, key, x, **kw):
        return self.variables


@functools.cache
def _jax_margin_trainer():
    """The JAX supervised trainer with ``MODEL.MARGIN: arcface`` (the
    bias-free head) under ``DATA.IS_REPROD`` (SGD; one compiled step),
    from the plain branch's initial state without the head's bias."""
    cfg = _jax_config(_sup_overrides())
    cfg.MODEL.MARGIN = "arcface"
    cfg.DATA.IS_REPROD = True
    base = _jax_sup_base(False).state
    params = dict(base.params)
    params["head"] = {"fc": {"kernel": base.params["head"]["fc"]["kernel"]}}
    trainer = JaxSupLearning(model=jax_build_model(cfg), opt_func="SGD")
    trainer.train_dl = trainer.valid_dl = None
    create = jax_state.create_train_state
    given = _Given({"params": params, "batch_stats": base.batch_stats})
    with mock.patch.object(jax_state, "create_train_state",
                           lambda model, *a, **k: create(given, *a, **k)):
        trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4],
                           labeled_targets=LABELED)
    return trainer


def _port_margin_trainer(jt):
    cfg = default_config(_sup_overrides())
    cfg.MODEL.MARGIN = "arcface"
    cfg.DATA.IS_REPROD = True
    model = build_model(cfg)
    assert model.head.fc.bias is None
    model.load_state_dict(_port_state(jt.state.params, jt.state.batch_stats),
                          strict=True)
    trainer = SupLearning(model, "SGD", device="cpu")
    trainer.train_dl = None
    trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4], labeled_targets=LABELED)
    return cfg, trainer


def check_margin_reproduce_step_matches_jax():
    """One supervised step of the margin branch (arcface on the backbone's
    features and the bias-free head's kernel, class weights) under
    ``DATA.IS_REPROD`` against JAX ``_train_step``, on the reproduce view
    JAX drew: the loss 1e-5 relative, the state at ``train.py``'s step
    bounds. The port's ``_train_step`` takes the reproduce view under
    ``IS_REPROD``; the other trainers refuse it, as in JAX."""
    u8, t = _step_batch(31, False)
    w = jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)
    key = jax.random.key(31)
    jt = _jax_margin_trainer()
    start = jt.state
    jstate, jloss, _ = jt._train_step(start, jnp.asarray(u8), jnp.asarray(t),
                                      jnp.asarray(w), key)
    k_aug, _ = jax.random.split(key)
    x = jviews.reproduce_train_view(jnp.asarray(u8), k_aug, IMG, jnp.float32)
    cfg, port = _port_margin_trainer(jt)
    loss, aux = port._train_micro(
        [(torch.from_numpy(np.array(x)), torch.from_numpy(t).long(), None)],
        torch.from_numpy(w))
    assert aux == ()
    _close(float(loss), float(jloss), rtol=1e-5, what="margin loss")
    _compare_state(port, jstate, "SGD", (), start)

    calls = []
    view = supervised_mod.reproduce_train_view
    with mock.patch.object(supervised_mod, "reproduce_train_view",
                           lambda *a, **k: calls.append(1) or view(*a, **k)), \
            mock.patch.object(supervised_mod, "labeled_train_view",
                              None):
        loss, _ = port._train_step(u8, t, torch.from_numpy(w))
    assert calls == [1] and np.isfinite(float(loss))
    with pytest.raises(ValueError, match="IS_REPROD"):
        FixMatch(build_model(cfg), "SGD", device="cpu").get_config(
            cfg, labeled_targets=LABELED)


def check_reproduce_artifact_matches_jax():
    """The artifact of a model trained under ``DATA.IS_REPROD`` (the margin
    trainer's, bias-free head) serves the reproduce eval view: its
    probabilities within 1e-5 of the JAX ``make_infer_fn(...,
    is_reprod=True)`` from the same weights, and of the port trainer's
    evaluation forward."""
    jt = _jax_margin_trainer()
    cfg, port = _port_margin_trainer(jt)
    u8 = np.random.default_rng(9).integers(0, 256, (5, CANON, CANON, 3)
                                           ).astype(np.uint8)
    ref = jexport.make_infer_fn(jt.model, jt.state.params,
                                jt.state.batch_stats, IMG, jnp.float32,
                                is_reprod=True)
    want = np.asarray(jax.jit(ref)(jnp.asarray(u8)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.pt")
        export.export_model(cfg, port.state.model.state_dict(), path)
        infer = export.load_exported(path, device="cpu")
        got = infer(u8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    _, _, probs = port._eval_step(port.state.model.eval(), u8,
                                  np.zeros(5, np.int64), np.ones(5, bool))
    np.testing.assert_allclose(probs.numpy(), want, rtol=0, atol=1e-5)


def check_triplet_batch_matches_jax():
    """``_build_triplet_batch`` over a loader's epoch (the loader's
    ``rng`` shared with its index stream, as both packages share it):
    the same rows as the JAX trainer's; every positive has its anchor's
    class and every negative another."""
    from endoscopy_tpu_torch.data.manifest import Manifest
    from endoscopy_tpu_torch.data.pipeline import CanonicalLoader

    targets = np.random.default_rng(17).integers(0, NUM_CLASSES, 40)
    images = np.arange(40, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.uint8)

    class Rows(CanonicalLoader):
        def decode(self, paths):
            return images[np.asarray(paths, np.int64)]

    out = []
    for trainer in (JaxSupLearning(model=None), SupLearning(device="cpu")):
        trainer.train_dl = Rows(Manifest(np.arange(40), targets), B, 2, seed=0)
        it = iter(trainer.train_dl)
        rows = []
        for _ in range(12):  # across the loader's epoch boundaries
            u8, t = next(it)
            rows.append(trainer._build_triplet_batch(u8, t)[:, 0, 0, 0])
        out.append(np.stack(rows))
    np.testing.assert_array_equal(out[0], out[1])
    for r in out[1]:
        a, p, n = r.reshape(3, B)
        assert (targets[p] == targets[a]).all()
        assert (targets[n] != targets[a]).all()


# -- fit ----------------------------------------------------------------------


# (valid loss, macro-F1) per epoch: a first save, a save on both improving,
# worse loss, worse F1, both equal, better loss at an equal F1 (neither a
# save nor a count), then worse until the count passes 5 after epoch 10
SCRIPT = {1: (0.9, 0.5), 2: (0.8, 0.6), 3: (0.85, 0.7), 4: (0.7, 0.55),
          5: (0.8, 0.6), 6: (0.7, 0.6), 7: (0.95, 0.4), 8: (0.99, 0.3),
          9: (0.99, 0.3), 10: (0.99, 0.3), 11: (0.5, 0.9), 12: (0.4, 0.95)}
FIT_CASES = {  # (EPOCHS, FREQ_EVAL, resumed at the final epoch): events
    (12, 1, False): ([("train", 1), ("eval", 1), ("save", 1), ("train", 2),
                      ("eval", 2), ("save", 2)]
                     + [e for ep in range(3, 11)
                        for e in (("train", ep), ("eval", ep))]),
    (4, 2, True): [("eval", 0)],
}


def _scripted_fit(trainer, meter, cfg, epochs, freq, resumed):
    """``fit`` with ``train_one``, ``evaluate_one`` and
    ``save_checkpoint`` recording their calls and ``evaluate_one``
    returning :data:`SCRIPT`'s values; returns ``(events,
    best_valid_perf)``."""
    events = []

    def train_one(epoch):
        with trace.epoch():  # as every trainer's train_one
            events.append(("train", epoch))
            m = meter()
            m.update(1.0 / epoch, 4)
        return m

    def evaluate_one():
        events.append(("eval", trainer.epoch))
        loss, f1 = SCRIPT.get(trainer.epoch, (1.0, 0.5))
        m = meter()
        m.update(loss, 4)
        return m, {"macro/f1": f1, "sen/spec": None}

    cfg.TRAIN.update(EPOCHS=epochs, FREQ_EVAL=freq, SAVE_CP="x", LOG_DIR="")
    trainer.config, trainer.is_triplet, trainer.n_iter_per_epoch = (
        cfg, False, 1)
    trainer.best_valid_perf = 1.25
    if resumed:
        trainer._resumed, trainer.epoch_start = True, epochs
    trainer.train_one, trainer.evaluate_one = train_one, evaluate_one
    trainer.save_checkpoint = lambda folder: events.append(
        ("save", trainer.epoch))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.fit()
    return events, trainer.best_valid_perf


def check_supervised_fit_matches_jax():
    """The JAX and the port's ``fit`` on one scripted sequence: the same
    epochs trained, evaluations, saves (loss and F1 both better) and the
    early stop, ``best_valid_perf`` untouched; a resume at the final
    epoch evaluates and does nothing else."""
    for (epochs, freq, resumed), want in FIT_CASES.items():
        got = [_scripted_fit(JaxSupLearning(model=None), JaxMeter,
                             _jax_config(_sup_overrides()), epochs, freq,
                             resumed),
               _scripted_fit(SupLearning(device="cpu"), AverageMeter,
                             default_config(_sup_overrides()), epochs, freq,
                             resumed)]
        assert got[0] == got[1] == (want, 1.25), (epochs, got)


# -- the CLIs -----------------------------------------------------------------


def _write_config(tmp, thres: float):
    import yaml

    over = _sup_overrides(THRES=thres, OPT_NAME="SGD")
    over["DATA"].update(_data_overrides(True))
    over["TRAIN"]["SAVE_CP"] = ""
    path = os.path.join(tmp, "sup.yaml")
    Path(path).write_text(yaml.safe_dump(over))
    return path


def _macro_f1(stdout: str) -> str:
    return re.search(r"^macro-F1: (\S+)$", stdout, re.M).group(1)


def check_evaluate_and_pseudo_label_clis_match_jax():
    """A JAX supervised checkpoint (the shared initial state after one SGD
    step) through the JAX CLIs and, dumped to ``.npz`` (its SGD momentum
    as torch's ``momentum_buffer``, equal), through the port's in a
    subprocess with ``--device cpu``: the same macro-F1, the same
    misclassified rows and the same pseudo-labels (THRES between the
    pool's max-probabilities, so some rows pass and some do not)."""
    u8, t = _step_batch(30, False)
    w = jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)
    jt = _jax_sup_trainer(False, 1, False)
    state = jt._train_step(jt.state, jnp.asarray(u8), jnp.asarray(t),
                           jnp.asarray(w), jax.random.key(30))[0]
    _, (_, _, unl_root, unanno) = _dataset()
    create = jax_state.create_train_state
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = jax_orbax_io.save_checkpoint(
            tmp, "epoch_1", state, {"epoch": 1, "best_valid_perf": None,
                                    "trainer": "SupLearning",
                                    "img_size": IMG}, block=True)
        npz = os.path.join(tmp, "state.npz")
        _orbax_to_npz()(ckpt, npz)
        # SGD's Nesterov trace arrives as torch's momentum buffer, by name
        (trace,) = [s.trace for s in jax.tree.leaves(
            state.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)]
        want = _port_params(trace)
        got = train_state_from_npz(npz)[0]["optimizer"]
        assert set(got) == set(want) and any(v.any() for v in want.values())
        for k, v in want.items():
            assert torch.equal(got[k]["momentum_buffer"], v), k
        cfg = _write_config(tmp, thres=0.3)
        args = {side: (["--config", cfg, "--misclassified",
                        os.path.join(tmp, f"{side}_mis.csv")],
                       ["--config", cfg, "--unlabeled-csv", unanno,
                        "--unlabeled-root", unl_root, "--out",
                        os.path.join(tmp, f"{side}_pl.csv")])
                for side in ("jax", "port")}
        # the port's CLIs run in their own processes while the JAX ones run
        # here
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        procs = [subprocess.Popen(
            [sys.executable, "-m", f"endoscopy_tpu_torch.cli.{mod}", *a,
             "--checkpoint", npz, "--device", "cpu"], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for mod, a in zip(("evaluate", "pseudo_label"), args["port"])]
        buf = io.StringIO()
        stdout = {"port": ""}
        try:
            with mock.patch.object(jax_state, "create_train_state",
                                   lambda model, *a, **k: create(
                                       _JitInit(model), *a, **k)), \
                    contextlib.redirect_stdout(buf):
                jax_evaluate.main(args["jax"][0] + ["--checkpoint", ckpt])
                jax_pseudo_label.main(args["jax"][1] + ["--checkpoint",
                                                        ckpt])
            for proc in procs:
                out, err = proc.communicate(timeout=300)
                assert proc.returncode == 0, err[-3000:]
                stdout["port"] += out
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        stdout["jax"] = buf.getvalue()
        outs = {}
        for side in ("jax", "port"):
            with open(os.path.join(tmp, f"{side}_mis.csv")) as f:
                rows = list(csv.reader(f))
            outs[side] = (_macro_f1(stdout[side]), rows, pd.read_csv(
                os.path.join(tmp, f"{side}_pl.csv"))["pred"].tolist())
    assert outs["port"] == outs["jax"], outs
    preds = outs["port"][2]
    assert 0 < preds.count(0) < len(preds), preds
    assert len(outs["port"][1]) > 1  # a header and misclassified rows


def check_path_e_configs_match_yaml():
    """``chip_smoke.py``'s path E writes the two supervised configs'
    fields out (``torch_port_checks/path_e.py``): each equals the file's
    value, and every field the file sets is there, but data paths, the
    pretrained checkpoint (path E starts from fresh weights) and the
    checkpoint directory."""
    import yaml

    from endoscopy_tpu.config.loader import get_config as jax_get_config

    skip = {"PATH", "ANNO", "UNANNO_PATH", "UNANNO", "PRE_TRAIN",
            "PRE_TRAIN_PATH", "PRE_TRAIN_RESUME", "SAVE_CP"}
    for name, over in (("kaggle_supervised_patho", path_e.PATHO),
                       ("kaggle_supervised_ezbm", path_e.EZBM)):
        path = str(ROOT / "configs" / f"{name}.yaml")
        cfg = jax_get_config(path)
        raw = yaml.safe_load(Path(path).read_text())
        for section, values in over.items():
            for k, v in values.items():
                assert cfg[section][k] == v, (name, section, k)
        for section, values in raw.items():
            for k in values:
                assert k in skip or k in over.get(section, {}), (name, k)
