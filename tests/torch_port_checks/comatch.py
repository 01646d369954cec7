"""Port checks: the CoMatch trainer and what it stands on, against the JAX package.

float32 on the CPU, ``resnet_tiny`` under ``ModelwEmb`` at 32 px (canonical
38) with B=8, MU=1 and four classes (``train.py``'s setting), inputs from
numpy seeds, weights converted from the JAX CoMatch trainer's initial state
(``_JitInit``). Tolerances, and why:

- ``grayscale`` and ``adjust_hue``: pixel for pixel (the port writes out
  XLA's folded reciprocals and its two fused multiply-adds);
- ``comatch_views``: pixel for pixel in float32 against the JAX views on
  their Pallas path (the kernel in interpret mode) on the same draws;
- three steps with the smoothing gate closed, closed, open, each from
  the JAX state it starts at, on the views JAX's own ``comatch_views``
  makes from ``train_step``'s key split, with its dropout mask: ``lx``,
  ``lu``, ``lc`` and the total 1e-4 relative (the scaled head's logits
  are O(10), and the float32 forwards agree within 1e-4 of an output's
  largest magnitude); parameters, BN statistics
  and EMA at ``train.py``'s step bounds (SGD's update within 0.1 of a
  tensor's largest; Adam's first update off only where the gradient is
  under 0.1 of its tensor's largest; its later ones, no longer about
  ``-lr sign(g)``, within 0.05 relative L2 per tensor: read 0.02 at most,
  where an element whose first moment nears 0 moves most, while a wrong
  loss term moves a tensor's update by its order); the ``CoMatchState`` pointers and
  count exactly, its floats within 1e-4 of each field's largest
  magnitude (the heads' forward bound of ``supervised.py``). With SGD at the reference's
  ``queue_batch`` 5 (the bank stays zero) and with Adam at ``queue_batch``
  1 (``n == queue_size``: the bank is written every step and the third
  step smooths with it). The head is scaled so that some weak rows pass
  THRES and some pseudo-label pairs reach ``Q >= 0.8``; both thresholds
  are checked to lie 1e-4 or more from every value they compare;
- the ``GRAD_ACCUM`` refusal: the reference's message;
- ``run_config`` on a tiny CoMatch config: one update a step, a finite
  loss, checkpoints and an evaluation;
- ``path_f.py``'s fields against both YAML files: equal;
- a plain-head donor grafted into ``ModelwEmb``: the JAX package's state
  bit for bit (the backbone copied, the heads fresh).
"""

import contextlib
import copy
import functools
import io
import os
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.aug import ops as jops
from endoscopy_tpu.aug import views as jviews
from endoscopy_tpu.ckpt import orbax_io as jax_orbax_io
from endoscopy_tpu.ckpt import transfer as jtransfer
from endoscopy_tpu.config.loader import get_config as jax_get_config
from endoscopy_tpu.losses import classification as jcls
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu.ops import randaugment_kernel as rk
from endoscopy_tpu.optim import optimizers as jopt
from endoscopy_tpu.ssl_state.comatch_state import CoMatchState as JaxCoMatchState
from endoscopy_tpu.train import comatch as jcomatch
from endoscopy_tpu.train import state as jax_state
from endoscopy_tpu.train.comatch import CoMatch as JaxCoMatch
from endoscopy_tpu.train.common import trainable_mask as jax_trainable_mask
from endoscopy_tpu_torch.aug import ops, views
from endoscopy_tpu_torch.ckpt import transfer
from endoscopy_tpu_torch.ckpt.convert import _optimizer_state, write_npz
from endoscopy_tpu_torch.cli import learn
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.ssl_state.comatch_state import CoMatchState
from endoscopy_tpu_torch.train.comatch import CoMatch
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from torch_port_checks import path_d, path_f
from torch_port_checks.learn import _donor, _no_counts
from torch_port_checks.supervised import _dropout_forward, _dropout_masks
from torch_port_checks.train import (CANON, IMG, NUM_CLASSES, OVERRIDES, ROOT,
                                     _close, _compare_state, _jax_config,
                                     _jax_labeled, _JitInit, _port_state)

F32 = np.float32
B, MU = 8, 1
LABELED = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])
HEAD_SCALE = 4.0  # the MLP head's last kernel, scaled: confident rows
THRES = 0.76  # one smoothed weak row of the third SGD step falls below it
MARGIN = 1e-4
LOSS_RTOL = 1e-4
ADAM_LATER_L2 = 0.05


def _overrides():
    over = copy.deepcopy(OVERRIDES)
    over["DATA"]["MU"] = MU
    over["MODEL"].update(TYPE_SEMI="CoMatch", LOW_DIM=16)
    over["TRAIN"].update(LAMBDA_C=2.0, THRES=THRES)
    return over


# -- ops and views -------------------------------------------------------------


def check_grayscale_and_adjust_hue_match_jax():
    """Random images, a gray one, ones near the hue's wrap (red with a
    little blue or green), black and white; hue shifts ±0.1, 0 and
    random in between: every pixel equal, float32."""
    rng = np.random.default_rng(0)
    n = 32
    x = rng.integers(0, 256, (n, 24, 24, 3)).astype(F32)
    x[0] = x[0, :, :, :1]  # gray
    # red with a little blue (hue just below 1) and a little green (just
    # above 0): the shift wraps
    for i, small in ((1, 2), (2, 1)):
        x[i, ..., 0] = 255
        x[i, ..., small] = rng.integers(0, 3, (24, 24))
        x[i, ..., 3 - small] = 0
    x[3], x[4] = 0, 255
    hues = rng.uniform(-0.1, 0.1, n).astype(F32)
    hues[:6] = [0.1, -0.1, 0.0, 0.1, -0.1, 0.0]
    want = jax.jit(jax.vmap(jops.adjust_hue))(jnp.asarray(x), jnp.asarray(hues))
    got = ops.adjust_hue(torch.from_numpy(x), torch.from_numpy(hues))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gray = jax.jit(jax.vmap(jops.grayscale))(jnp.asarray(x))
    np.testing.assert_array_equal(ops.grayscale(torch.from_numpy(x)).numpy(),
                                  np.asarray(gray))


@functools.partial(jax.jit, static_argnums=1)
def _comatch_draw_fn(key, n=B * MU):
    """What jax ``comatch_views`` draws from ``key`` for ``n`` images
    (aug/views.py:188-203), but ``(pi, pf)``."""
    kw, k0, k1 = jax.random.split(key, 3)
    k0_pre, k0_ra = jax.random.split(k0)

    def s1(k):
        k_jit_p, k_jit, k_gray, k_flip = jax.random.split(k, 4)
        k_perm, k_b, k_c, k_s, k_h = jax.random.split(k_jit, 5)
        factors = jnp.stack(
            [jax.random.uniform(kk, (), jnp.float32, 0.6, 1.4)
             for kk in (k_b, k_c, k_s)]
            + [jax.random.uniform(k_h, (), jnp.float32, -0.1, 0.1)])
        return (jax.random.uniform(k_jit_p) < 0.8, factors,
                jax.random.permutation(k_perm, 4),
                jax.random.uniform(k_gray) < 0.2,
                jax.random.uniform(k_flip) < 0.5)

    def flip(k):
        return jax.random.uniform(k) < 0.5

    jit_p, factors, orders, grays, flips1 = jax.vmap(s1)(
        jax.random.split(k1, n))
    return {"weak_flips": jax.vmap(flip)(jax.random.split(kw, n)),
            "strong0_flips": jax.vmap(flip)(jax.random.split(k0_pre, n)),
            "jitters": jit_p, "factors": factors, "orders": orders,
            "grays": grays, "strong1_flips": flips1}, k0_ra


def _comatch_draws(key, n, img=IMG):
    draws, k_ra = _comatch_draw_fn(key, n)
    draws = {k: np.array(v) for k, v in draws.items()}
    pi, pf = rk.sample_randaugment_params(k_ra, n, img, img)
    draws.update(pi=np.array(pi), pf=np.array(pf))
    return draws


def check_comatch_views_match_jax():
    """The three views on the same draws, float32, against JAX
    ``comatch_views`` on its Pallas path (interpret mode), every draw's
    both outcomes present; the generator's draws are seeded."""
    n = B * MU
    u8 = np.random.default_rng(1).integers(
        0, 256, (n, CANON, CANON, 3)).astype(np.uint8)
    for seed in range(100):
        key = jax.random.key(seed)
        draws = _comatch_draws(key, n)
        if all(draws[k].any() and not draws[k].all() for k in (
                "weak_flips", "strong0_flips", "jitters", "grays",
                "strong1_flips")) and (draws["factors"][:, 3] < 0).any():
            break
    orig = rk.randaugment_mc_pallas
    with mock.patch.object(jviews, "USE_PALLAS_RANDAUG", True), \
            mock.patch.object(rk, "randaugment_mc_pallas",
                              lambda *a, **k: orig(*a, interpret=True, **k)):
        want = jviews.comatch_views(jnp.asarray(u8), key, IMG, jnp.float32)
    got = views.comatch_views(u8, IMG, torch.float32, device="cpu", **draws)
    for g, w, name in zip(got, want, ("weak", "strong0", "strong1")):
        assert g.shape == (n, IMG, IMG, 3) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    gens = [views.comatch_views(u8, IMG, torch.float32,
                                torch.Generator().manual_seed(s),
                                device="cpu") for s in (3, 3, 4)]
    assert all(torch.equal(a, b) for a, b in zip(gens[0], gens[1]))
    assert not torch.equal(gens[0][2], gens[2][2])
    with pytest.raises(ValueError, match="Generator"):
        views.comatch_views(u8, IMG, device="cpu")


# -- the step -------------------------------------------------------------------


@functools.cache
def _jax_base():
    """The JAX CoMatch trainer whose initial state the step cases start
    from, its MLP head's last kernel scaled by ``HEAD_SCALE``."""
    cfg = _jax_config(_overrides())
    trainer = JaxCoMatch(model=jax_build_model(cfg), opt_func="SGD")
    trainer.train_dl = trainer.valid_dl = None
    create = jax_state.create_train_state
    with mock.patch.object(jax_state, "create_train_state",
                           lambda model, *a, **k: create(_JitInit(model), *a,
                                                         **k)):
        trainer.get_config(cfg, labeled_targets=LABELED)
    params = jax.tree.map(np.array, trainer.state.params)
    params["fc"]["fc2"]["kernel"] *= HEAD_SCALE
    trainer.state = trainer.state.replace(params=params, ema_params=params)
    return trainer


@contextlib.contextmanager
def _patch_views():
    """JAX ``train_step`` traced under this takes precomputed views in
    place of the uint8 batches: ``x_u8`` the labeled view, ``u_canon_u8``
    the three unlabeled views stacked."""
    with mock.patch.object(jcomatch, "labeled_train_view",
                           lambda x, *a: x), \
            mock.patch.object(jcomatch, "comatch_views",
                              lambda u, *a: (u[0], u[1], u[2])):
        yield


def _jax_trainer(opt: str, queue_batch: int):
    """The JAX trainer from the shared initial state for this optimizer,
    as a subclass with this ``queue_batch`` (its ``queue_size`` with it)."""
    base = _jax_base()
    trainer = copy.copy(base)
    trainer.__class__ = type("JaxCoMatchQ", (JaxCoMatch,),
                             {"queue_batch": queue_batch})
    trainer.queue_size = queue_batch * (MU + 1) * B
    trainer.comatch_state = jcomatch.comatch_state_init(
        trainer.queue_size, trainer.low_dim, trainer.num_classes)
    trainer.tx = jopt.build_optimizer(base.state.params, opt,
                                      lr=base.lr_schedule)
    trainer.state = base.state.replace(
        opt_state=trainer.tx.init(base.state.params))
    trainer.grad_mask = jax_trainable_mask(base.state.params, False)
    trainer._build_train_step()
    return trainer


_jax_comatch_views = jax.jit(jviews.comatch_views, static_argnums=(2, 3))


def _step_inputs(seed: int, st):
    """A step's batches, its JAX views from ``train_step``'s key split and
    its dropout keep-mask, read off the JAX forward from the state ``st``
    the step starts at (a dropped element reads 0, and so does a kept one
    whose input is 0)."""
    rng = np.random.default_rng(seed)
    x_u8 = rng.integers(0, 256, (B, CANON, CANON, 3)).astype(np.uint8)
    t = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
    u_u8 = rng.integers(0, 256, (B * MU, CANON, CANON, 3)).astype(np.uint8)
    key = jax.random.key(seed)
    k_lb, k_views, k_drop = jax.random.split(key, 3)
    x = _jax_labeled(jnp.asarray(x_u8), k_lb, IMG, jnp.float32)
    u = _jax_comatch_views(jnp.asarray(u_u8), k_views, IMG, jnp.float32)
    imgs = jnp.concatenate([x, *u])
    (mask,) = _dropout_masks(_dropout_forward(_jax_base().model)(
        st.params, st.batch_stats, imgs, k_drop)[2])
    return x, u, t, key, torch.from_numpy(mask)


def _adam_or_sgd(opt_state):
    """optax's Adam moments or SGD trace, as ``convert._optimizer_state``
    reads them from a dump."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu") or hasattr(n, "trace")):
        if hasattr(node, "mu"):
            return {"adam": {"mu": node.mu, "nu": node.nu,
                             "count": np.asarray(node.count)}}
        if hasattr(node, "trace"):
            return {"sgd": {"trace": node.trace}}
    raise AssertionError("no Adam or SGD state")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cstate(cs) -> CoMatchState:
    return CoMatchState(
        **{k: torch.from_numpy(np.array(getattr(cs, k))).to(
            torch.long if k.endswith(("ptr", "count")) else torch.float32)
           for k in CoMatchState.__dataclass_fields__})


def _port_trainer(opt: str, queue_batch: int):
    cfg = default_config(_overrides())
    base = _jax_base().state
    model = build_model(cfg)
    model.load_state_dict(_port_state(base.params, base.batch_stats),
                          strict=True)
    sub = type("CoMatchQ", (CoMatch,), {"queue_batch": queue_batch})
    trainer = sub(model, opt, device="cpu")
    trainer.get_config(cfg, labeled_targets=LABELED)
    return trainer


def _load_jax_state(port, st, cs) -> None:
    """The port trainer at the JAX trainer's state ``st`` and CoMatch
    state ``cs``."""
    port.state.load_state_dict({
        "step": int(st.step),
        "model": _port_state(_np(st.params), _np(st.batch_stats)),
        "ema": _port_state(_np(st.ema_params), _np(st.ema_batch_stats)),
        "optimizer": _optimizer_state(_np(_adam_or_sgd(st.opt_state)))})
    port.comatch_state = _port_cstate(cs)


def _compare_cstate(got: CoMatchState, want: JaxCoMatchState, what: str):
    for k in CoMatchState.__dataclass_fields__:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if k.endswith(("ptr", "count")):
            assert int(g) == int(w), (what, k)
        else:
            _close(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                   what=f"{what} {k}")


def _steps(opt: str, queue_batch: int):
    """Three steps (gate closed, closed, open) of both trainers, the port
    from the JAX state each step starts at; compares each."""
    jt = _jax_trainer(opt, queue_batch)
    port = _port_trainer(opt, queue_batch)
    w = jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)
    st, cs = jt.state, jt.comatch_state
    thresholds = []
    for i, use_queue in enumerate((False, False, True)):
        x, u, t, key, mask = _step_inputs(30 + i, st)
        _load_jax_state(port, st, cs)
        port.state.model.fc.keep_mask = mask
        probe = _probe(port, x, u, t, w, use_queue)
        thresholds.append(probe)
        with _patch_views():
            new_st, new_cs, loss, aux = jt._train_step(
                st, cs, x, jnp.asarray(t), jnp.stack(u), jnp.asarray(w),
                jnp.asarray(use_queue), key)
        _load_jax_state(port, st, cs)
        got = port._train_core(*(torch.from_numpy(np.array(v))
                                 for v in (x, *u)),
                               torch.from_numpy(t).long(),
                               torch.from_numpy(w), use_queue)
        what = f"{opt} queue_batch {queue_batch} step {i}"
        for g, v, name in zip((got[0], *got[1]), (loss, *aux),
                              ("loss", "lx", "lu", "lc")):
            _close(float(g), float(v), rtol=LOSS_RTOL, what=f"{what} {name}")
        # Adam's first update is about -lr sign(g) (train.py's criterion);
        # a later one is a smooth function of the gradient and the moments
        later = opt == "Adam" and int(st.step) > 0
        _compare_state(port, new_st, opt, (), st,
                       l2_bound=ADAM_LATER_L2 if later else None)
        _compare_cstate(port.comatch_state, new_cs, what)
        st, cs = new_st, new_cs
    return port, cs, thresholds


@torch.no_grad()
def _probe(port, x, u, t, w, use_queue):
    """The no-grad block's mask and ``Q`` on this step's forward, from a
    copy of the trainer: (mask mean, off-diagonal Q >= 0.8 count,
    distance of the nearest weak max-probability from THRES, of the
    nearest off-diagonal Q entry from 0.8)."""
    probe = copy.deepcopy(port)
    model = probe.state.model.train()
    xs = [torch.from_numpy(np.array(v)) for v in (x, *u)]
    logits, _, low = model(torch.cat(xs).permute(0, 3, 1, 2))
    n = B * MU
    probs, mask = probe._pseudo_and_state(
        logits[B:B + n], low[B:B + n], low[:B], torch.from_numpy(t).long(),
        use_queue)
    q = probs @ probs.T
    off = q[~torch.eye(n, dtype=torch.bool)]
    return (float(mask.mean()), int((off >= probe.contrast_th).sum()),
            float((probs.amax(1) - probe.thres).abs().min()),
            float((off - probe.contrast_th).abs().min()))


def check_comatch_steps_match_jax():
    """SGD at the reference's queue_batch (the bank stays zero), Adam at
    queue_batch 1 (written every step, smoothing the third); each
    threshold away from its values, and each mask neither empty nor
    full at least once."""
    port, cs, probes = _steps("SGD", 5)
    assert not np.asarray(cs.queue_feats).any() and int(cs.da_count) == 3
    port, cs, more = _steps("Adam", 1)
    assert np.asarray(cs.queue_feats).any() and int(cs.queue_ptr) == 0
    # the queue as written: the last step's weak and labeled embeddings
    assert np.abs(np.asarray(cs.queue_probs)[B * MU:].sum(1) - 1).max() < 1e-6
    probes += more
    assert all(p[2] > MARGIN and p[3] > MARGIN for p in probes), probes
    assert any(0 < p[0] < 1 for p in probes) and any(p[1] for p in probes), probes


def check_queue_write_matches_jax():
    """The port's queue write (``_write_rows``) against
    ``lax.dynamic_update_slice`` at a pointer inside, at and past the end
    (clamped so the rows fit)."""
    from endoscopy_tpu_torch.train.comatch import _write_rows

    rng = np.random.default_rng(2)
    buf = rng.normal(size=(12, 3)).astype(F32)
    rows = rng.normal(size=(4, 3)).astype(F32)
    for ptr in (0, 5, 8, 11):
        want = jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(rows),
                                            (jnp.int32(ptr), 0))
        got = _write_rows(torch.from_numpy(buf), torch.from_numpy(rows),
                          torch.tensor(ptr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the rest -------------------------------------------------------------------


def check_grad_accum_is_refused_like_jax():
    jcfg = _jax_config(_overrides())
    jcfg.TRAIN.GRAD_ACCUM = 2
    with pytest.raises(ValueError) as want:
        JaxCoMatch(model=None, opt_func="SGD").get_config(jcfg)
    cfg = default_config(_overrides())
    cfg.TRAIN.GRAD_ACCUM = 2
    with pytest.raises(ValueError) as got:
        CoMatch(build_model(cfg), "SGD", device="cpu").get_config(cfg)
    assert str(got.value) == str(want.value) and "GRAD_ACCUM" in str(got.value)


def check_comatch_run_config_trains():
    """``cli/learn.py::run_config`` on a tiny CoMatch config (2 epochs of
    3 steps, an evaluation and a checkpoint each): one update a step, the
    DA ring filled once a step, a finite loss, ``B (1 + 3 MU)`` images a
    step."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = default_config(_overrides())
        cfg.TRAIN.update(EPOCHS=2, EVAL_STEP=3, FREQ_EVAL=1, SAVE_CP=tmp,
                         IS_SSL=True, CLS_WEIGHT=True)
        data = path_d.synthetic_data(cfg, (16, 16, 8), seed=0)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            trainer, _ = learn.run_config(cfg, device="cpu", data=data)
        assert type(trainer).__name__ == "CoMatch"
        assert trainer.state.step == 6 and int(trainer.comatch_state.da_count) == 6
        assert trainer._images_per_step() == B * (1 + 3 * MU)
        assert sorted(os.listdir(tmp)) == ["epoch_1", "epoch_2"]
        assert "Valid Loss" in out.getvalue() and "nan" not in out.getvalue()


def check_path_f_configs_match_yaml():
    """``chip_smoke.py``'s path F writes real_1's and real_1_1's fields out
    (``torch_port_checks/path_f.py``): each equals the file's value, and
    every field the file sets is overridden, except data paths, the
    pretrained checkpoint and the checkpoint directory."""
    import yaml

    skip = {"PATH", "ANNO", "UNANNO_PATH", "UNANNO", "PRE_TRAIN",
            "PRE_TRAIN_PATH", "PRE_TRAIN_RESUME", "SAVE_CP"}
    for name, over in (("kaggle_semisupervised_real_1", path_f.REAL_1),
                       ("kaggle_semisupervised_real_1_1", path_f.REAL_1_1)):
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


def check_plain_head_donor_grafts_into_modelwemb_like_jax():
    """real_1's ``PRE_TRAIN_PATH`` is a plain-head ResNet checkpoint: from
    an orbax directory (JAX) and from a port checkpoint and a ``.npz``
    (the port), ``ModelwEmb``'s backbone takes the donor's tensors bit
    for bit, ``fc`` and ``head_emb`` keep their fresh weights, the EMA
    is re-synced; the port's state equals the JAX package's."""
    params, stats = _donor(2, seed=23)
    base = _jax_base()
    init = _port_state(_np(base.state.params), _np(base.state.batch_stats))
    with tempfile.TemporaryDirectory() as tmp:
        orbax_dir = os.path.join(tmp, "orbax")
        jax_orbax_io.save_checkpoint(orbax_dir, "epoch_1",
                                     {"params": params, "batch_stats": stats},
                                     {}, block=True)
        jt = copy.copy(base)
        jcfg = copy.deepcopy(base.config)
        jcfg.MODEL.PRE_TRAIN_PATH = os.path.join(orbax_dir, "epoch_1")
        with contextlib.redirect_stdout(io.StringIO()):
            assert jtransfer.apply_pretrain(jt, jcfg)
        want = _no_counts(_port_state(_np(jt.state.params),
                                      _np(jt.state.batch_stats)))
        donor = _no_counts(_port_state(params, stats))
        npz = os.path.join(tmp, "donor.npz")
        write_npz(npz, params, stats)
        donor_cfg = default_config(OVERRIDES)
        donor_cfg.MODEL.NUM_CLASSES = 2
        donor_t = FixMatch(build_model(donor_cfg), "Adam", device="cpu")
        donor_t.get_config(donor_cfg)
        donor_t.state.model.load_state_dict(_port_state(params, stats))
        with contextlib.redirect_stdout(io.StringIO()):
            port_dir = donor_t.save_checkpoint(os.path.join(tmp, "port"))
        for path in (port_dir, npz):
            port = _port_trainer("Adam", 5)
            cfg = default_config(_overrides())
            cfg.MODEL.PRE_TRAIN_PATH = path
            with contextlib.redirect_stdout(io.StringIO()):
                assert transfer.apply_pretrain(port, cfg)
            got = port.state.model.state_dict()
            assert set(_no_counts(got)) == set(want)
            for k, v in want.items():
                assert torch.equal(got[k], v), (path, k)
                src = donor if k.startswith("backbone.") else init
                assert torch.equal(got[k], src[k]), (path, k)
            for k, v in port.state.ema.state_dict().items():
                assert torch.equal(v, got[k]), ("ema", k)
