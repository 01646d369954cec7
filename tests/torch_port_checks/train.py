"""Port checks: the FixMatch training step against the JAX package.

float32 on the CPU, inputs from numpy seeds. The trainer cases run
``resnet_tiny`` at 32 px with B=8, MU=2 (the pattern of
``tests/test_grad_accum.py``), both trainers starting from the JAX
trainer's initial weights (``ckpt/convert.py``) and fed the views the JAX
package builds, so each step compares like with like. Tolerances, and why:

- losses, schedules, optimizers and the EMA: a few float32 roundings, so
  1e-6 relative (schedules 2**-22: XLA contracts a product and a sum
  into one rounding);
- BN running statistics of a train-mode forward: 1e-4 relative (flax takes
  the variance as ``mean(x**2) - mean(x)**2``, torch in another order);
- the labeled view: pixel-exact before its normalize, except images whose
  Paeth shear shifts differ because XLA's float32 ``tan``/``sin`` and the
  port's (float64, rounded) differ in the last bit at a near-tie; those are
  named. After the normalize, 2**-21 (XLA fuses it differently);
- one step: loss, lx, lu, mask_mean 1e-5 relative; BN statistics 1e-4
  relative; EMA 1e-6. The updates are looser, because float32 gradients of
  this tiny model differ between two correct float32 runs by up to several
  percent of a tensor's largest. A ReLU input within float32 noise of 0
  (at layer4, 1x1 pixels) lands on the other side in one of them, and BN,
  which couples the batch, moves every backbone gradient with it; the
  port's float32 run and its float64 run differ alike. flax's one-pass BN
  variance ``mean(x**2) - mean(x)**2`` adds float32 error of the same size
  to the JAX step. A wrong loss weight, a missing division by the
  microbatch count or a dropped freeze mask is off by far more. So SGD's
  update from zero momentum, ``-1.9 lr (g + 0.05 p)``, linear in the
  gradient, agrees per tensor within 0.1 of its largest. Adam's first
  update is about ``-lr sign(g)``: an element off by more than 1e-3 lr (a
  sign that flipped) must have a gradient under 0.1 of its tensor's
  largest, inside the float32 error above.
"""

import copy
import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from endoscopy_tpu.aug import views as jviews
from endoscopy_tpu.config.loader import default_config as jax_default_config
from endoscopy_tpu.config.loader import get_config as jax_get_config
from endoscopy_tpu.losses import classification as jcls
from endoscopy_tpu.losses import consistency as jcons
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu.optim import optimizers as jopt
from endoscopy_tpu.optim import schedules as jsched
from endoscopy_tpu.ssl_state import ema as jema
from endoscopy_tpu.train import state as jax_state
from endoscopy_tpu.train.common import trainable_mask as jax_trainable_mask
from endoscopy_tpu.train.fixmatch import FixMatch as JaxFixMatch
from endoscopy_tpu_torch.aug import ops, views
from endoscopy_tpu_torch.aug.views import labeled_train_view
from endoscopy_tpu_torch.ckpt.convert import from_jax_params
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.losses import (balanced_class_weights, ce_loss,
                                        consistency_loss, cross_entropy,
                                        poly_loss, soft_ce_loss)
from endoscopy_tpu_torch.models import build_model, resnet
from endoscopy_tpu_torch.optim import build_optimizer, build_schedule, set_lr
from endoscopy_tpu_torch.ssl_state.ema import ema_init, ema_tensors, ema_update
from endoscopy_tpu_torch.train.fixmatch import FixMatch

ROOT = Path(__file__).resolve().parents[2]
IMG, CANON = 32, int(32 * 1.2)
B, MU, NUM_CLASSES = 8, 2, 4
LABELED = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])  # the dataset's labels
# puts the first batch's mask mean strictly between 0 and 1
THRES = 0.3
OVERRIDES = {"DATA": {"IMG_SIZE": IMG, "BATCH_SIZE": B, "MU": MU},
             "MODEL": {"NAME": "resnet_tiny", "NUM_CLASSES": NUM_CLASSES},
             "TRAIN": {"DTYPE": "float32", "EVAL_STEP": 2, "THRES": THRES,
                       "MESH_DATA": 1}}
F32 = np.float32


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _jax_config(overrides):
    cfg = jax_default_config()
    for section, values in overrides.items():
        for k, v in values.items():
            cfg[section][k] = v
    return cfg


# -- losses, schedules, optimizers, EMA, BN ---------------------------------


def check_losses_match_jax():
    """Random logits with a repeated row and a tied argmax, an absent class
    (weight 0), a mask strictly between 0 and 1; values and gradients."""
    rng = np.random.default_rng(0)
    n, c = 16, 6
    weak = rng.normal(0, 2, (n, c)).astype(F32)
    weak[3] = weak[2]
    weak[5, [1, 4]] = weak[5].max() + 1.0  # a tie for the argmax
    strong = rng.normal(0, 2, (n, c)).astype(F32)
    targets = rng.integers(0, c - 1, n)
    targets[:c - 1] = np.arange(c - 1)  # every class but the last
    weights = balanced_class_weights(targets, num_classes=c)
    np.testing.assert_array_equal(
        weights, jcls.balanced_class_weights(targets, num_classes=c))
    assert weights[c - 1] == 0.0
    np.testing.assert_array_equal(balanced_class_weights(targets),
                                  jcls.balanced_class_weights(targets))
    probs = np.exp(weak) / np.exp(weak).sum(1, keepdims=True)
    cutoff = float(np.median(probs.max(1)))

    tw, ts, tt = torch.tensor(weak), torch.tensor(strong), torch.tensor(targets)
    jw, js, jt = jnp.asarray(weak), jnp.asarray(strong), jnp.asarray(targets)
    w_t = torch.tensor(weights, dtype=torch.float32)
    w_j = jnp.asarray(weights, jnp.float32)
    soft_t, soft_j = torch.softmax(tw, -1), jax.nn.softmax(jw, -1)
    pairs = []
    for red in ("none", "mean", "sum"):
        for wt, wj in ((None, None), (w_t, w_j)):
            pairs.append((cross_entropy(ts, tt, wt, red),
                          jcls.cross_entropy(js, jt, wj, red)))
            pairs.append((poly_loss(ts, tt, 2.0, wt, red),
                          jcls.poly_loss(js, jt, 2.0, wj, red)))
    pairs.append((soft_ce_loss(ts, soft_t), jcls.soft_ce_loss(js, soft_j)))
    pairs.append((ce_loss(ts, tt, w_t, reduction="mean", type_loss="poly"),
                  jcls.ce_loss(js, jt, w_j, reduction="mean",
                               type_loss="poly")))
    pairs.append((ce_loss(ts, soft_t, use_hard_labels=False),
                  jcls.ce_loss(js, soft_j, use_hard_labels=False)))
    for hard, T in ((True, 1.0), (False, 0.5)):
        lu, mask = consistency_loss(tw, ts, T=T, p_cutoff=cutoff,
                                    use_hard_labels=hard)
        jlu, jmask = jcons.consistency_loss(jw, js, T=T, p_cutoff=cutoff,
                                            use_hard_labels=hard)
        assert 0.0 < float(mask) < 1.0
        pairs += [(lu, jlu), (mask, jmask)]
    for got, want in pairs:
        _close(got.numpy(), want, rtol=1e-6, atol=1e-7)

    # gradients of the step's total: the weak logits get none
    def total_j(w_, s_, x_):
        lx = jcls.ce_loss(x_, jt, w_j, reduction="mean", type_loss="poly")
        lu, _ = jcons.consistency_loss(w_, s_, p_cutoff=cutoff)
        return lx + 2.0 * lu

    gj = jax.grad(total_j, argnums=(0, 1, 2))(jw, js, js)
    leaves = [t.clone().requires_grad_(True) for t in (tw, ts, ts)]
    lx = ce_loss(leaves[2], tt, w_t, reduction="mean", type_loss="poly")
    lu, _ = consistency_loss(leaves[0], leaves[1], p_cutoff=cutoff)
    (lx + 2.0 * lu).backward()
    assert leaves[0].grad is None and not np.asarray(gj[0]).any()
    for leaf, g in zip(leaves[1:], gj[1:]):
        _close(leaf.grad.numpy(), g, rtol=1e-6, atol=1e-7)
    for kw in ({"type_loss": "focal"}, {"type_loss": "ldam",
                                        "cls_num_list": [1] * c}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ce_loss(ts, tt, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        consistency_loss(tw, ts, margin_loss_fn=lambda *a: 0.0)


def check_schedules_match_jax():
    """All three schedules over warmup (10 steps), the step decay's
    boundaries (every 10) and past the end (40)."""
    for name in ("cosine", "linear", "step"):
        over = {"TRAIN": {"SCH_NAME": name, "EPOCHS": 4, "WARMUP_EPOCHS": 1,
                          "DECAY_EPOCHS": 1, "BASE_LR": 1e-3,
                          "WARMUP_LR": 5e-4, "LR_DECAY": 0.8}}
        port = build_schedule(default_config(over), 10)
        ref = jax.jit(jax.vmap(jsched.build_schedule(_jax_config(over), 10)))
        steps = np.arange(46)
        want = np.asarray(ref(jnp.asarray(steps, jnp.int32)))
        got = np.array([port(int(s)) for s in steps], F32)
        assert got[0] == F32(5e-4)  # step 0 runs at WARMUP_LR
        # near the cosine's end 1 + cos(x) cancels, so a last-bit
        # difference in cos is about 1e-6 of BASE_LR
        _close(got, want, rtol=2 ** -22, atol=1e-9, what=name)


def check_optimizers_match_optax():
    """Adam, AdamW and SGD for 3 steps on a tree with a 4-D and a 1-D leaf
    (decay only on the 4-D one), at the warmup schedule's rates."""
    rng = np.random.default_rng(1)
    tree = {"kernel": rng.normal(size=(4, 3, 3, 3)).astype(F32),
            "bias": rng.normal(size=(4,)).astype(F32)}
    grads = [{k: rng.normal(size=v.shape).astype(F32) for k, v in tree.items()}
             for _ in range(3)]
    over = {"TRAIN": {"WARMUP_EPOCHS": 1}}
    sched, jsch = (build_schedule(default_config(over), 2),
                   jsched.build_schedule(_jax_config(over), 2))
    for name in ("Adam", "AdamW", "SGD"):
        tx = jopt.build_optimizer(tree, name, lr=jsch)
        jp = {k: jnp.asarray(v) for k, v in tree.items()}
        jstate = tx.init(jp)
        params = {k: nn.Parameter(torch.tensor(v)) for k, v in tree.items()}
        opt = build_optimizer(params.items(), name, lr=sched(0))
        decayed = {id(p) for p in opt.param_groups[0]["params"]}
        assert decayed == {id(params["kernel"])}
        for step, g in enumerate(grads):
            updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                        jstate, jp)
            jp = optax.apply_updates(jp, updates)
            for k, p in params.items():
                p.grad = torch.tensor(g[k])
            set_lr(opt, sched(step))
            opt.step()
            for k, p in params.items():
                _close(p.detach().numpy(), jp[k], rtol=1e-6, atol=1e-7,
                       what=f"{name} step {step} {k}")


def check_ema_covers_params_and_bn_statistics():
    model = build_model(default_config(OVERRIDES))
    ema = ema_init(model)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in ema_tensors(model):
            t.add_(torch.randn(t.shape, generator=gen))
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    tensors = ema_tensors(ema)
    assert len(tensors) == len(list(model.parameters())) + 2 * n_bn
    before = [t.numpy().copy() for t in tensors]
    ema_update(ema, model, 0.999)
    want = jema.ema_update(
        before, [t.detach().numpy() for t in ema_tensors(model)], 0.999)
    for got, w in zip(ema_tensors(ema), want):
        _close(got.numpy(), w, rtol=1e-6, atol=1e-7)
    assert all(int(m.num_batches_tracked) == 0 for m in ema.modules()
               if isinstance(m, nn.BatchNorm2d))


def check_bn_running_statistics_match_flax():
    """One train-mode forward: every BN's running mean and variance as flax
    moves them. torch's own BatchNorm2d (the unbiased variance) misses at
    layer4, where a batch of 4 at 1x1 gives n = 4 per channel."""
    base = _jax_base()
    rng = np.random.default_rng(3)
    params = jax.tree.map(np.asarray, base.state.params)
    stats = {"backbone": jax.tree.map(  # running statistics away from 0, 1
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(F32),
        base.state.batch_stats["backbone"])}
    x = rng.normal(0, 1, (4, IMG, IMG, 3)).astype(F32)
    _, mut = jax.jit(lambda v, x: base.model.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    want = _port_state(params, mut["batch_stats"])

    def port_stats():
        port = build_model(default_config(OVERRIDES))
        port.load_state_dict(from_jax_params(params, stats), strict=True)
        port.train()
        with torch.no_grad():
            port(torch.from_numpy(x).permute(0, 3, 1, 2))
        return port.state_dict()

    got = port_stats()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 17
    for k in keys:
        _close(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6, what=k)
    with mock.patch.object(resnet, "_flax_running_var",
                           lambda model, forward, x: forward(x)):
        plain = port_stats()  # torch's own update
    k = "backbone.layer4.0.bn3.running_var"
    gap = np.abs(plain[k].numpy() / want[k].numpy() - 1).max()
    assert gap > 1e-2, gap


# -- the labeled view -------------------------------------------------------


def _labeled_draws(key, n):
    """What jax labeled_train_view draws from ``key`` (aug/views.py:212)."""
    hf, vf, angles, factors, orders = [], [], [], [], []
    for k in jax.random.split(key, n):
        k_h, k_v, k_rot, k_jit = jax.random.split(k, 4)
        hf.append(bool(jax.random.uniform(k_h) < 0.3))
        vf.append(bool(jax.random.uniform(k_v) < 0.3))
        angles.append(jax.random.uniform(k_rot, (), minval=-20.0, maxval=20.0))
        k_perm, k_b, k_c, k_s, _ = jax.random.split(k_jit, 5)
        factors.append([jax.random.uniform(kk, (), jnp.float32, 1 - 0.2, 1 + 0.2)
                        for kk in (k_b, k_c, k_s)])
        orders.append(np.asarray(jax.random.permutation(k_perm, 4)))
    return (np.array(hf), np.array(vf), np.array(angles, F32),
            np.array(factors, F32), np.array(orders))


def _shear_shifts(coef, n):
    c = torch.arange(n, dtype=torch.float32) + 0.5 - n / 2.0
    return torch.floor(ops.fma(torch.tensor(coef)[:, None], c, 0.5)).int()


def _near_ties(angles, size):
    """Images whose shear shifts differ between XLA's float32 tan/sin and
    the port's: an angle where one of them lands next to an integer."""
    theta = angles * F32(np.pi / 180)
    ja, jb = jax.jit(lambda t: (-jnp.tan(t / 2.0), jnp.sin(t)))(theta)
    pa = (-np.tan(np.float64(theta / F32(2.0)))).astype(F32)
    pb = np.sin(np.float64(theta)).astype(F32)
    return {i for i in range(len(angles)) if not (
        torch.equal(_shear_shifts(np.asarray(ja)[i:i + 1], size),
                    _shear_shifts(pa[i:i + 1], size))
        and torch.equal(_shear_shifts(np.asarray(jb)[i:i + 1], size),
                        _shear_shifts(pb[i:i + 1], size)))}


_jax_labeled = jax.jit(jviews.labeled_train_view, static_argnums=(2, 3))
_jax_fixmatch = jax.jit(jviews.fixmatch_views, static_argnums=(2, 3))


def check_labeled_view_matches_jax():
    """Both flips taken and not, rotations of both signs, several op
    orders: the same pixels as the JAX view's before its normalize, on the
    same draws, and the normalized view within a few float32 steps (XLA
    evaluates this normalize, fused after the jitter, as
    ``fma(img, 1/255, -mean) * (1/std)``; the port divides)."""
    u8 = np.random.default_rng(4).integers(0, 256, (B, CANON, CANON, 3)
                                           ).astype(np.uint8)
    for seed in range(50):
        key = jax.random.key(seed)
        draws = _labeled_draws(key, B)
        hf, vf, angles, _, orders = draws
        if (hf.any() and not hf.all() and vf.any() and not vf.all()
                and (angles > 0).any() and (angles < 0).any()
                and len({tuple(o) for o in orders}) >= 4):
            break
    pixels = jax.jit(jax.vmap(functools.partial(jviews._labeled_train_one,
                                                img_size=IMG)))(
        jnp.asarray(u8, jnp.float32), jax.random.split(key, B))
    got = views._labeled_pixels(torch.from_numpy(u8).float(), IMG, *draws)
    off = {i for i in range(B)
           if not np.array_equal(got[i].numpy(), np.asarray(pixels[i]))}
    ties = _near_ties(angles, CANON)
    assert off <= ties, (f"images {sorted(off - ties)} differ (near-ties "
                         f"{sorted(ties)})")
    ref = np.asarray(_jax_labeled(jnp.asarray(u8), key, IMG, jnp.float32))
    view = labeled_train_view(u8, IMG, torch.float32, device="cpu",
                              hflips=hf, vflips=vf, angles=angles,
                              factors=draws[3], orders=orders).numpy()
    assert view.shape == (B, IMG, IMG, 3)
    keep = [i for i in range(B) if i not in ties]
    _close(view[keep], ref[keep], rtol=2 ** -21, atol=2 ** -21)


# -- the step ---------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=0, static_argnames="train")
def _module_init(model, key, x, train=False):
    return model.init(key, x, train=train)


class _JitInit:
    """The model for ``create_train_state`` with ``init`` compiled: run
    eagerly, op by op, flax's init takes some 15 s of this test. Flax
    modules hash by their fields, so every trainer of one architecture
    (the CLI checks build several) shares one compiled init."""

    def __init__(self, model):
        self.model = model

    def init(self, key, x, **kw):
        return _module_init(self.model, key, x, **kw)


@functools.cache
def _jax_base():
    """The JAX trainer whose initial state every step case starts from."""
    cfg = _jax_config(OVERRIDES)
    trainer = JaxFixMatch(model=jax_build_model(cfg), opt_func="SGD")
    trainer.train_dl = trainer.valid_dl = None
    create = jax_state.create_train_state
    with mock.patch.object(jax_state, "create_train_state",
                           lambda model, *a, **k: create(_JitInit(model), *a,
                                                         **k)):
        trainer.get_config(cfg, labeled_targets=LABELED)
    return trainer


def _jax_trainer(opt: str, accum: int = 1, freeze: bool = False):
    """The JAX trainer from the shared initial state, rebuilt for this
    optimizer, accumulation and freeze mask."""
    base = _jax_base()
    trainer = copy.copy(base)
    trainer.grad_accum = accum
    trainer.tx = jopt.build_optimizer(base.state.params, opt,
                                      lr=base.lr_schedule)
    trainer.state = base.state.replace(
        opt_state=trainer.tx.init(base.state.params))
    trainer.grad_mask = jax_trainable_mask(base.state.params, freeze)
    trainer._build_train_step()
    return trainer


def _port_state(params, batch_stats):
    return from_jax_params(jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, batch_stats))


def _port_trainer(opt: str, accum: int = 1, freeze: bool = False):
    cfg = default_config(OVERRIDES)
    cfg.TRAIN.GRAD_ACCUM = accum
    cfg.TRAIN.IS_FREEZE = freeze
    model = build_model(cfg)
    base = _jax_base().state
    model.load_state_dict(_port_state(base.params, base.batch_stats),
                          strict=True)
    trainer = FixMatch(model, opt, device="cpu")
    trainer.get_config(cfg, labeled_targets=LABELED)
    return trainer


def _batch(seed: int, b: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, CANON, CANON, 3)).astype(np.uint8),
            rng.integers(0, NUM_CLASSES, b).astype(np.int32),
            rng.integers(0, 256, (b * MU, CANON, CANON, 3)).astype(np.uint8))


def _jax_views(x_u8, u_u8, key):
    """The views jax ``_train_step`` builds from ``key`` (one microbatch)."""
    k_lb, k_views, _ = jax.random.split(key, 3)
    x = _jax_labeled(jnp.asarray(x_u8), k_lb, IMG, jnp.float32)
    u_w, u_s = _jax_fixmatch(jnp.asarray(u_u8), k_views, IMG, jnp.float32)
    return x, u_w, u_s


@functools.cache
def _core_inputs():
    x_u8, t, u_u8 = _batch(5, B)
    return _jax_views(x_u8, u_u8, jax.random.key(5)), t


def _weights():
    return balanced_class_weights(LABELED, num_classes=NUM_CLASSES).astype(F32)


def _compare_step(port, jax_out, got, opt, frozen=(), start=None):
    """Losses, parameters, BN statistics and EMA after one step from the
    JAX state ``start`` (default: the shared initial state)."""
    jstate, jloss, jaux = jax_out
    for g, w, name in zip((got[0], *got[1]), (jloss, *jaux),
                          ("loss", "lx", "lu", "mask_mean")):
        _close(float(g), float(w), rtol=1e-5, what=name)
    assert 0.0 < float(got[1][2]) < 1.0
    _compare_state(port, jstate, opt, frozen,
                   _jax_base().state if start is None else start)


def _compare_state(port, jstate, opt, frozen, start, l2_bound=None,
                   skip=()):
    """Parameters, BN statistics and EMA after one step from the JAX
    state ``start``, at ``_compare_step``'s bounds. Both took one update,
    whatever GRAD_ACCUM. With ``l2_bound`` each tensor's update is held
    to that relative L2 error in place of the optimizer's element bound
    (an Adam update after the first, no longer about ``-lr sign(g)``).
    Tensors whose names end with one of ``skip`` are left to the caller."""
    assert port.state.step == int(jstate.step) == int(start.step) + 1
    init = _port_state(start.params, start.batch_stats)
    want = _port_state(jstate.params, jstate.batch_stats)
    now = port.state.model.state_dict()
    params = dict(port.state.model.named_parameters())
    lr = port.lr_schedule(int(start.step))
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", *skip)):
            continue
        d_got = (now[k] - init[k]).numpy()
        d_want = (w - init[k]).numpy()
        if k.endswith(("running_mean", "running_var")):
            _close(now[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6, what=k)
        elif k.startswith(frozen):
            assert torch.equal(now[k], init[k]) and not d_want.any(), k
        elif l2_bound is not None:
            err = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert err <= l2_bound, (k, err)
        elif opt == "SGD":
            err = np.abs(d_got - d_want).max()
            assert err <= 0.1 * np.abs(d_want).max(), (k, err)
        else:
            g = np.abs(params[k].grad.numpy())
            off = np.abs(d_got - d_want) > 1e-3 * lr
            assert (g[off] < 0.1 * g.max()).all(), (k, g[off].max() / g.max())
    ema_want = _port_state(jstate.ema_params, jstate.ema_batch_stats)
    ema_now = port.state.ema.state_dict()
    for k, w in ema_want.items():
        if not k.endswith(("num_batches_tracked", *skip)):
            _close(ema_now[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-6,
                   what=f"ema {k}")


def _cores(opt: str, freeze: bool = False):
    """One ``_train_core`` step of each trainer on the same views."""
    (x, u_w, u_s), t = _core_inputs()
    w = _weights()
    jt = _jax_trainer(opt, freeze=freeze)
    jax_out = jax.jit(jt._train_core)(
        jt.state, x, u_w, u_s, jnp.asarray(t), jnp.asarray(w),
        jax.random.key(0))
    port = _port_trainer(opt, freeze=freeze)
    got = port._train_core(
        *(torch.from_numpy(np.asarray(v)) for v in (x, u_w, u_s)),
        torch.from_numpy(t).long(), torch.from_numpy(w))
    return port, jax_out, got


def check_train_core_matches_jax():
    """One ``_train_core`` step (fixmatch.py:114) from identical state and
    views, with SGD (the update exposes the gradients) and with Adam."""
    for opt in ("SGD", "Adam"):
        _compare_step(*_cores(opt), opt)


def check_grad_accum_step_matches_jax():
    """GRAD_ACCUM=2: jax ``_train_step`` against the port's microbatched
    step on the views rebuilt from the same key splits (fixmatch.py:146)."""
    x_u8, t, u_u8 = _batch(6, 2 * B)
    w = _weights()
    key = jax.random.key(6)
    jt = _jax_trainer("SGD", accum=2)
    jax_out = jt._train_step(
        jt.state, jnp.asarray(x_u8), jnp.asarray(t), jnp.asarray(u_u8),
        jnp.asarray(w), key)
    micro = []
    for m, k in enumerate(jax.random.split(key, 2)):
        views = _jax_views(x_u8[m * B:(m + 1) * B],
                           u_u8[m * B * MU:(m + 1) * B * MU], k)
        micro.append((*(torch.from_numpy(np.asarray(v)) for v in views),
                      torch.from_numpy(t[m * B:(m + 1) * B]).long()))
    port = _port_trainer("SGD", accum=2)
    got = port._train_micro(micro, torch.from_numpy(w))
    _compare_step(port, jax_out, got, "SGD")


def check_freeze_keeps_backbone_and_moves_bn_statistics():
    """IS_FREEZE with Adam: the backbone's parameters are bit-identical,
    every BN running statistic moved, the head moved, all as in jax."""
    port, jax_out, got = _cores("Adam", freeze=True)
    _compare_step(port, jax_out, got, "Adam", frozen=("backbone.",))
    base = _jax_base().state
    before = _port_state(base.params, base.batch_stats)
    for k, v in port.state.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")) or k.startswith("head."):
            assert not torch.equal(v, before[k]), f"{k} did not move"


def check_train_one_runs_from_its_generator():
    """``train_one`` at GRAD_ACCUM=2 draws its views from the trainer's
    generator: two steps, one update each, a finite mean loss, and the
    same losses from the same seed."""
    def run():
        port = _port_trainer("Adam", accum=2)
        x_u8, t, u_u8 = _batch(7, B)
        port.get_dataloader((iter([(x_u8, t)] * 2), iter([(u_u8, t)] * 2)),
                            None)
        return port, port.train_one(1)

    (port, meter), (_, again) = run(), run()
    assert port.state.step == 2 and meter.count == 2 * B
    assert np.isfinite(meter.avg) and meter.avg == again.avg
    with pytest.raises(ValueError, match="GRAD_ACCUM"):
        x_u8, t, u_u8 = _batch(8, B - 1)
        port._train_step(x_u8, t, u_u8, torch.ones(NUM_CLASSES))


def check_path_c_configs_match_yaml():
    """``chip_smoke.py``'s path C writes the two configs' fields out
    (``torch_port_checks/path_c.py``; the card's machine has no PyYAML):
    each override equals the file's value, and every field the file sets
    is overridden, except data paths, the pretrained checkpoint (path C
    starts from seeded random weights) and the checkpoint directory."""
    import yaml

    from torch_port_checks import path_c

    skip = {"PATH", "ANNO", "UNANNO_PATH", "UNANNO", "PRE_TRAIN",
            "PRE_TRAIN_PATH", "PRE_TRAIN_RESUME", "SAVE_CP"}
    for name, over in (("kaggle_semisupervised_real_3_1", path_c.REAL_3_1),
                       ("kaggle_semisupervised_real_3", path_c.REAL_3)):
        path = str(ROOT / "configs" / f"{name}.yaml")
        cfg = jax_get_config(path)
        with open(path) as f:
            raw = yaml.safe_load(f)
        for section, values in over.items():
            for k, v in values.items():
                assert cfg[section][k] == v, (name, section, k)
        for section, values in raw.items():
            for k in values:
                assert k in skip or k in over.get(section, {}), (name, k)


def check_unported_settings_point_to_roadmap():
    cfg = default_config(OVERRIDES)
    cfg.DATA.IS_REPROD = True
    trainer = FixMatch(build_model(cfg), "Adam", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        trainer.get_config(cfg)
