"""Port checks: the Conformer and the SemiFormer trainer, against the JAX package.

float32 on the CPU: the tiny Conformer of ``tests/test_semiformer_ezbm.py``
(embed 24, depth 3, 2 heads, ``mlp_ratio`` 2) at 32 px (canonical 38),
B=8, MU=1, four classes, inputs from numpy seeds, both trainers from one
initial state (the port's fresh weights, handed to the JAX trainers in
flax's tree). Tolerances, and why:

- the eval forward from converted weights: 1e-5 of each head's largest
  logit (float32 in another summation order; read 1.3e-6); the train-mode
  forward 1e-4 (flax's one-pass BN variance; read 1.2e-5) and its BN
  running statistics 1e-4 relative (``train.py``'s bound; read 8.9e-7);
- the conversion: a strict ``load_state_dict`` and equal parameter
  counts, at the tiny size and at Conformer-Ti's (from flax's shapes);
- fresh weights: each kernel's variance × fan_in within five standard
  errors of 1 and of a draw of flax's own ``lecun_normal``, none past its
  truncation; every bias 0, LN and BN scales 1 and offsets 0;
  ``cls_token``'s std within five standard errors of 0.02 · 0.8796 =
  0.0176 and of flax's own ``truncated_normal(0.02)`` draw, none past
  0.04;
- the warmup step and the FixMatch-phase step (GRAD_ACCUM 1 and 2, SGD)
  on the views that JAX builds (the unlabeled ones through the Pallas
  kernel in interpret mode) fed to JAX ``_warmup_step``/``_fixmatch_step``
  and to the port: ``train.py``'s step bounds (losses 1e-5 relative, SGD's
  update per tensor within 0.1 of its largest, BN statistics 1e-4, EMA
  1e-6), but for the tensors whose gradient is 0 in exact arithmetic: the
  bias of each ``FCUUp`` 1x1 convolution, which a BN follows, and in the
  supervised step (the conv head's loss alone) the last ViT block's last
  bias, whose shift of every patch token that BN removes too.
  The port's gradient of each is under 1e-6 of the model's largest, and
  with SGD both packages' updates are under 1e-6 of the learning rate
  (Adam turns rounding into ±lr in both);
- ``_eval_step``: the summed CE 1e-5 relative, the probabilities 1e-5
  against JAX and 1e-6 against ``softmax(conv + trans)`` of a direct
  forward;
- ``run_config`` across ``EVAL_STEP_SUP`` in both packages, and the
  port's resume past it: the same phases, step counts, checkpoints and
  meta (JAX's steps and evaluation stood in, as ``learn.py`` stands in
  JAX epochs);
- the supervised trainer on the Conformer (Adam): the loss 1e-5,
  ``train.py``'s Adam bound, and the trans head and ``trans_norm``
  bit-identical in both packages while the conv head moves;
- a JAX supervised Conformer's train state through orbax,
  ``orbax_to_npz.py`` and ``load_checkpoint`` (``train_state_from_npz``):
  exact;
- a reference-layout Conformer ``.pth``: the JAX package's state bit for
  bit, the trunk the donor's, both heads fresh;
- ``path_g.py``'s fields against the three YAML files: equal.
"""

import contextlib
import copy
import functools
import io
import json
import os
import signal
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.aug import views as jviews
from endoscopy_tpu.ckpt import orbax_io as jax_orbax_io
from endoscopy_tpu.ckpt import transfer as jtransfer
from endoscopy_tpu.cli import learn as jax_learn
from endoscopy_tpu.config.loader import get_config as jax_get_config
from endoscopy_tpu.losses import classification as jcls
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu.models.conformer import Conformer as JaxConformer
from endoscopy_tpu.ops import randaugment_kernel as rk
from endoscopy_tpu.train import semiformer as jsemiformer
from endoscopy_tpu.train import state as jax_state
from endoscopy_tpu.train import supervised as jsupervised
from endoscopy_tpu.train.supervised import SupLearning as JaxSupLearning
from endoscopy_tpu_torch.aug.views import eval_view
from endoscopy_tpu_torch.ckpt import transfer
from endoscopy_tpu_torch.ckpt.convert import from_jax_params
from endoscopy_tpu_torch.cli import learn
from endoscopy_tpu_torch.config.loader import default_config, get_config
from endoscopy_tpu_torch.models import build_model, create_backbone
from endoscopy_tpu_torch.models.conformer import Conformer
from endoscopy_tpu_torch.train.semiformer import SemiFormer
from endoscopy_tpu_torch.train.supervised import SupLearning
from torch_port_checks import path_c, path_d, path_g
from torch_port_checks.train import (ROOT, _close, _compare_state,
                                     _jax_config, _jax_labeled, _port_state)

F32 = np.float32
IMG, CANON = 32, int(32 * 1.2)
B, MU, NUM_CLASSES = 8, 1, 4
LABELED = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])
TINY = {"EMBED_DIM": 24, "DEPTH": 3, "NUM_HEADS": 2, "MLP_RATIO": 2.0}
THRES = 0.57  # 2 and 1 of the two microbatches' 4 weak rows pass it, by 0.03 or more
OVERRIDES = {"DATA": {"IMG_SIZE": IMG, "BATCH_SIZE": B, "MU": MU},
             "MODEL": {"NAME": "conformer", "NUM_CLASSES": NUM_CLASSES,
                       "TYPE_SEMI": "SemiFormer", **TINY},
             "TRAIN": {"DTYPE": "float32", "IS_SSL": True, "EVAL_STEP": 2,
                       "EVAL_STEP_SUP": 1, "THRES": THRES, "MESH_DATA": 1}}
_KEY = jax.random.key(31)  # the steps' key: their views come precomputed
TI_PARAMS = 22_886_556  # Conformer-Ti at 6 classes
# the bias of each FCUUp's 1x1 convolution: a BN follows it
BIAS_BEFORE_BN = ".expand_block.conv_project.bias"


def _overrides(**train):
    over = copy.deepcopy(OVERRIDES)
    over["TRAIN"].update(train)
    return over


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _no_counts(sd):
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


@functools.cache
def _fresh_variables():
    """The JAX trainers' initial variables: the port's fresh tiny Conformer
    (seed 0) in flax's tree, ``from_jax_params`` run backwards. Flax's own
    initializer is held to the port's by
    ``check_fresh_weights_follow_flax_initializer``; compiling it here
    would add some 8 s to this module."""
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in
          build_model(default_config(_overrides())).state_dict().items()}
    shapes = jax.eval_shape(
        functools.partial(jax_build_model(_jax_config(_overrides())).init,
                          train=False),
        jax.random.key(0), jax.ShapeDtypeStruct((2, IMG, IMG, 3), F32))
    names = {"scale": "weight", "mean": "running_mean", "var": "running_var"}

    def leaf(path, shape):
        *module, name = (p.key for p in path[1:])
        key = ".".join(module + [names.get(name, name)])
        if name != "kernel":
            return sd[key]
        w = sd[key.replace(".kernel", ".weight")]
        w = np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4 else w.T
        assert w.shape == shape.shape, key
        return w

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def _port_init():
    """JAX trainers built under this start from ``_fresh_variables``."""
    create = jax_state.create_train_state
    fresh = types.SimpleNamespace(init=lambda *a, **k: _fresh_variables())
    with mock.patch.object(jax_state, "create_train_state",
                           lambda model, *a, **k: create(fresh, *a, **k)):
        yield


@functools.cache
def _jax_base():
    """The JAX SemiFormer trainer (SGD) whose initial state every case
    starts from."""
    cfg = _jax_config(_overrides())
    trainer = jsemiformer.SemiFormer(model=jax_build_model(cfg),
                                     opt_func="SGD")
    trainer.train_dl = trainer.valid_dl = None
    with _port_init():
        trainer.get_config(cfg, labeled_targets=LABELED)
    return trainer


def _port_trainer(accum: int = 1, cls=SemiFormer, **train):
    cfg = default_config(_overrides(GRAD_ACCUM=accum, **train))
    model = build_model(cfg)
    base = _jax_base().state
    model.load_state_dict(_port_state(base.params, base.batch_stats),
                          strict=True)
    trainer = cls(model, cfg.TRAIN.OPT_NAME if cls is SupLearning else "SGD",
                  device="cpu")
    if cls is SupLearning:
        trainer.train_dl = None
        trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4],
                           labeled_targets=LABELED)
    else:
        trainer.get_config(cfg, labeled_targets=LABELED)
    return trainer


def _weights():
    return jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)


# -- the model ------------------------------------------------------------------


def check_conformer_forward_matches_flax():
    """The eval forward of both heads and the train-mode forward with its
    BN running statistics, from converted weights; the conversion strict,
    with equal parameter counts."""
    base = _jax_base()
    params = _np(base.state.params)
    rng = np.random.default_rng(0)
    stats = jax.tree.map(  # running statistics away from 0 and 1
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(F32),
        _np(base.state.batch_stats))
    variables = {"params": params, "batch_stats": stats}
    port = build_model(default_config(_overrides()))
    port.load_state_dict(from_jax_params(params, stats), strict=True)
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    x = rng.normal(0, 1, (B, IMG, IMG, 3)).astype(F32)
    with ThreadPoolExecutor(2) as pool:  # the two XLA compiles side by side
        evals, trains = [pool.submit(jax.jit(functools.partial(
            base.model.apply, train=train,
            mutable=["batch_stats"] if train else False)).lower(
                variables, x).compile) for train in (False, True)]
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = port.eval()(xt)
        for g, w in zip(got, evals.result()(variables, x)):
            assert g.dtype == torch.float32
            w = np.asarray(w)
            _close(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        train_port = copy.deepcopy(port).train()
        with torch.no_grad():
            got = train_port(xt)
        want, mut = trains.result()(variables, x)
    for g, w in zip(got, want):
        w = np.asarray(w)
        _close(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    moved = from_jax_params(params, _np(mut["batch_stats"]))
    now = train_port.state_dict()
    keys = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(1 for k in moved if k.endswith("running_mean"))
    for k in keys:
        _close(now[k].numpy(), moved[k].numpy(), rtol=1e-4, atol=1e-6, what=k)


def check_conformer_ti_converts_strictly():
    """Conformer-Ti's flax tree (shapes from ``jax.eval_shape``) converts
    onto ``build_model``'s Conformer with a strict load: every name and
    shape, 22,886,556 parameters in both; ``create_backbone`` gives the
    same module tree (``serve.py`` serves its conv head)."""
    shapes = jax.eval_shape(lambda: JaxConformer(
        num_classes=6, dtype=jnp.float32).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    with torch.device("meta"):  # names and shapes, no fresh weights
        model = build_model(default_config({"MODEL": {"NAME": "conformer",
                                                      "NUM_CLASSES": 6}}))
        alias = create_backbone("conformer")
    model.load_state_dict(from_jax_params(zeros["params"],
                                          zeros["batch_stats"]), strict=True,
                          assign=True)
    n_flax = sum(a.size for a in jax.tree.leaves(zeros["params"]))
    assert n_flax == sum(p.numel() for p in model.parameters()) == TI_PARAMS
    assert isinstance(alias, Conformer)
    assert list(alias.state_dict()) == list(model.state_dict())


def check_fresh_weights_follow_flax_initializer():
    """Conformer-Ti's fresh weights, as flax draws them."""
    from flax.linen.initializers import lecun_normal, truncated_normal

    torch.manual_seed(0)
    model = build_model(default_config({"MODEL": {"NAME": "conformer",
                                                  "NUM_CLASSES": 6}}))
    draw = jax.jit(lambda key, fan_in, n: lecun_normal()(key, (fan_in, n)),
                   static_argnums=(1, 2))
    drawn = {"conv1", "trans_patch_conv", "conv_trans_7.trans_block.attn.qkv",
             "conv_cls_head"}
    n_kernels, biased = 0, set()
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.LayerNorm,
                          torch.nn.modules.batchnorm._BatchNorm)):
            assert torch.all(m.weight == 1) and not m.bias.any(), name
            continue
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            continue
        if m.bias is not None:
            assert not m.bias.any(), name
            biased.add(name.rsplit(".", 1)[-1])
        p = m.weight.detach().double()
        fan_in, n = p[0].numel(), p.numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        ratio = float(p.var(unbiased=False)) * fan_in
        assert abs(ratio - 1.0) <= 5 * (2 / n) ** 0.5, (name, ratio)
        assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), name
        if name in drawn:
            w = np.asarray(draw(jax.random.key(n_kernels), fan_in,
                                n // fan_in), np.float64)
            assert abs(ratio - w.var() * fan_in) <= 5 * (4 / n) ** 0.5, name
        n_kernels += 1
    # stem, patch conv, 12 conv blocks' 3-4 convs, 11 FCUs' 2 1x1 convs,
    # 12 ViT blocks' 4 dense layers, the two heads
    assert n_kernels == 1 + 1 + (4 + 11 * 6 + 3) + 11 * 2 + 12 * 4 + 2
    assert biased == {"conv_project", "trans_patch_conv", "qkv", "proj",
                      "fc1", "fc2", "conv_cls_head", "trans_cls_head"}
    cls = model.cls_token.detach().double().flatten()
    flax_cls = np.asarray(truncated_normal(0.02)(
        jax.random.key(1), (1, 1, cls.numel()), jnp.float32), np.float64)
    se = 0.0176 / (2 * cls.numel()) ** 0.5
    assert abs(float(cls.std()) - 0.02 * 0.87962566) <= 5 * se, cls.std()
    assert abs(float(cls.std()) - flax_cls.std()) <= 5 * 2 ** 0.5 * se
    assert float(cls.abs().max()) <= 0.04 and np.abs(flax_cls).max() <= 0.04


# -- the steps ------------------------------------------------------------------


@contextlib.contextmanager
def _precomputed_views():
    """JAX steps traced under this take precomputed views in place of the
    uint8 batches: ``x_u8`` the labeled view, ``u_canon_u8`` the weak and
    strong views stacked on the channel axis."""
    with mock.patch.object(jsemiformer, "labeled_train_view",
                           lambda x, *a: x), \
            mock.patch.object(jsemiformer, "fixmatch_views",
                              lambda u, *a: (u[..., :3], u[..., 3:])):
        yield


def _jax_unlabeled_views(u8, key):
    """JAX ``fixmatch_views`` on its Pallas (crop-fused) path, the kernel
    in interpret mode."""
    orig = rk.randaugment_mc_pallas
    with mock.patch.object(jviews, "USE_PALLAS_RANDAUG", True), \
            mock.patch.object(rk, "randaugment_mc_pallas",
                              lambda *a, **k: orig(*a, interpret=True, **k)):
        return jviews.fixmatch_views(jnp.asarray(u8), key, IMG, jnp.float32)


@functools.cache
def _step_batch():
    rng = np.random.default_rng(30)
    return (rng.integers(0, 256, (B, CANON, CANON, 3)).astype(np.uint8),
            rng.integers(0, 256, (B * MU, CANON, CANON, 3)).astype(np.uint8))


@functools.cache
def _jax_outputs():
    """JAX's ``(state, loss)`` after its warmup step, its FixMatch-phase
    step at GRAD_ACCUM 1 and 2 (on precomputed views) and the supervised
    Adam step, from ``_step_inputs``. Each program is traced from abstract
    inputs while the views are drawn in a thread, and its XLA compile,
    which leaves Python free, runs in a thread while the next is traced.
    Only this function calls ``_step_inputs`` before it returns."""
    def f32(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)

    t, w, key = jax.ShapeDtypeStruct((B,), jnp.int32), _weights(), _KEY
    base, sup = _jax_base(), _jax_sup()
    pool, steps = ThreadPoolExecutor(5), {}
    inputs = pool.submit(_step_inputs)
    with _precomputed_views():
        for accum in (1, 2):
            jt = copy.copy(base)
            jt.grad_accum = accum
            jt._build_train_steps()
            if accum == 1:
                steps["warmup"] = pool.submit(jt._warmup_step.lower(
                    base.state, f32(B, IMG, IMG, 3), t, w, key).compile)
            n = B * accum // 2
            steps[accum] = pool.submit(jt._fixmatch_step.lower(
                base.state, f32(n, IMG, IMG, 3), t.update(shape=(n,)),
                f32(n * MU, IMG, IMG, 6), w, key).compile)
    steps["sup"] = pool.submit(sup._train_step.lower(
        sup.state, f32(B, IMG, IMG, 3), t, w, key).compile)
    micro, t, key = inputs.result()
    x = np.array(_labeled_view())
    out = {"warmup": steps["warmup"].result()(base.state, x, t, w, key),
           "sup": steps["sup"].result()(sup.state, x, t, w, key)[:2]}
    for accum in (1, 2):
        parts = micro[:accum]
        x = np.concatenate([p[0] for p in parts])
        u = np.concatenate([np.concatenate(p[1:], axis=-1) for p in parts])
        out[accum] = steps[accum].result()(
            base.state, x, t[:len(x)], u, w,
            key if accum == 2 else jax.random.split(key, 2)[0])
    pool.shutdown()
    return out


@functools.cache
def _step_inputs():
    """A FixMatch-phase batch's targets, its key, and each of its two
    microbatches' views: the labeled view sliced, the unlabeled ones as
    JAX ``_fixmatch_step`` draws them at GRAD_ACCUM 2 from its key, each
    through the Pallas kernel (microbatch 0's are also the GRAD_ACCUM 1
    step's, on its half)."""
    x_u8, u_u8 = _step_batch()
    t = (np.arange(B) % NUM_CLASSES).astype(np.int32)
    np.random.default_rng(31).shuffle(t)
    key = _KEY
    x = np.array(_labeled_view())
    micro = []
    for m, k in enumerate(jax.random.split(key, 2)):
        w, s = _jax_unlabeled_views(
            u_u8[m * B * MU // 2:(m + 1) * B * MU // 2],
            jax.random.split(k, 3)[1])
        micro.append((x[m * B // 2:(m + 1) * B // 2], np.array(w),
                      np.array(s)))
    return micro, t, key


@functools.cache
def _labeled_view():
    """The JAX labeled train view of the whole labeled batch: the warmup
    step's, and sliced, each microbatch's (the JAX steps take precomputed
    views, so which key drew them does not matter to the comparison)."""
    return _jax_labeled(jnp.asarray(_step_batch()[0]), _KEY, IMG,
                        jnp.float32)


def _zero_grads_checked(port, zero) -> None:
    """The port's gradient of each tensor named by ``zero`` (suffixes) is
    at rounding level: under 1e-6 of the model's largest gradient."""
    grads = {k: float(p.grad.abs().max())
             for k, p in port.state.model.named_parameters()}
    names = [k for k in grads if k.endswith(zero)]
    assert names
    for k in names:
        assert grads[k] <= 1e-6 * max(grads.values()), (k, grads[k])


def _compare(port, jax_out, got, opt="SGD", start=None,
             zero=(BIAS_BEFORE_BN,)):
    """Losses and state after one step from ``start`` (the shared initial
    state by default), at ``train.py``'s bounds. The tensors named by
    ``zero`` have a gradient of 0 in exact arithmetic: the port's is at
    rounding level, and with SGD both packages' updates are under 1e-6 of
    the learning rate (Adam turns rounding into ±lr in both, so there
    they are not compared)."""
    jstate, jloss = jax_out
    _close(float(got), float(jloss), rtol=1e-5, what="loss")
    start = _jax_base().state if start is None else start
    _zero_grads_checked(port, zero)
    if opt == "SGD":
        init = _port_state(start.params, start.batch_stats)
        lr = port.lr_schedule(int(start.step))
        now = port.state.model.state_dict()
        want = _port_state(jstate.params, jstate.batch_stats)
        for k in (k for k in want if k.endswith(zero)):
            for sd in (want, now):
                assert float((sd[k] - init[k]).abs().max()) <= 1e-6 * lr, k
    _compare_state(port, jstate, opt, (), start, skip=zero)


def check_warmup_step_matches_jax():
    """One warmup step (both heads' class-weighted CE) on the labeled
    batch against JAX ``_warmup_step`` on its labeled view."""
    jax_out = _jax_outputs()["warmup"]
    t = _step_inputs()[1]
    x = np.array(_labeled_view())
    port = _port_trainer()
    got = port._warmup_core(torch.from_numpy(x), torch.from_numpy(t).long(),
                            torch.from_numpy(_weights()))
    _compare(port, jax_out, got)


def check_fixmatch_phase_steps_match_jax():
    """The FixMatch-phase step at GRAD_ACCUM 1 (microbatch 0's half) and
    2 (the whole batch) against JAX ``_fixmatch_step`` on the same views;
    the mask mean strictly between 0 and 1."""
    jax_outs = _jax_outputs()
    micro, t, _ = _step_inputs()
    w = _weights()
    for accum in (1, 2):
        parts = micro[:accum]
        x = np.concatenate([p[0] for p in parts])
        port = _port_trainer(accum)
        ts = torch.from_numpy(t[:len(x)]).long()
        loss, aux = port._train_micro(
            [(*(torch.from_numpy(v) for v in p), tm)
             for p, tm in zip(parts, ts.chunk(accum))], torch.from_numpy(w))
        assert 0.0 < float(aux[2]) < 1.0, float(aux[2])
        _compare(port, jax_outs[accum], loss)


# -- evaluation -----------------------------------------------------------------


def check_eval_step_sums_both_heads():
    """``_eval_step`` (the EMA teacher, eval mode) against JAX
    ``_eval_step`` from the same weights on a padded batch; its
    probabilities are ``softmax(conv + trans)`` of a direct forward, and
    ``inference`` thresholds them."""
    rng = np.random.default_rng(40)
    u8 = rng.integers(0, 256, (B, CANON, CANON, 3)).astype(np.uint8)
    t = (np.arange(B) % NUM_CLASSES).astype(np.int64)
    mask = np.arange(B) < B - 2
    jt = _jax_base()
    jsum, jcount, jprobs = jt._eval_step(jt.state.params, jt.state.batch_stats,
                                         u8, t, mask)
    port = _port_trainer()
    model = port._eval_model()
    psum, pcount, probs = port._eval_step(model, u8, t, mask)
    _close(float(psum), float(jsum), rtol=1e-5, what="summed CE")
    assert float(pcount) == float(jcount) == B - 2
    _close(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-5)
    with torch.no_grad():
        conv, trans = model(eval_view(u8, IMG, device="cpu").permute(0, 3, 1, 2))
    direct = torch.softmax(conv + trans, -1)
    _close(probs.numpy(), direct.numpy(), rtol=0, atol=1e-6)
    assert not np.allclose(probs.numpy(), torch.softmax(conv, -1).numpy(),
                           atol=1e-3)  # the trans head counts
    port.config.TRAIN.THRES = float(np.median(probs.numpy().max(1)))
    preds = port.inference([(u8, t, np.ones(B, bool))])
    p = probs.numpy()
    want = p.argmax(1) * (p.max(1) > port.config.TRAIN.THRES)
    assert [preds[i] for i in range(B)] == want.tolist()


# -- cli/learn.py -----------------------------------------------------------------


def _run_cfg(save: str, resume=None):
    cfg = _overrides(EPOCHS=3, EVAL_STEP_SUP=2, EVAL_STEP=2, FREQ_EVAL=1,
                     SAVE_CP=save, CLS_WEIGHT=True, LOG_DIR="")
    if resume is not None:
        cfg["MODEL"]["PRE_TRAIN_RESUME"] = resume
    return cfg


def _jax_run(cfg_over, data, events):
    """JAX ``run_config`` on ``data`` (the port's loaders; JAX reads the
    same arrays) with its two steps stood in, each recording ``(epoch,
    phase)`` and counting the update, and its evaluation stood in."""
    def stand_ins(self):
        def step(phase):
            def run(state, *args):
                events.append((self.epoch, phase))
                return state.replace(step=state.step + 1), jnp.float32(1.0)
            return run
        self._warmup_step, self._fixmatch_step = step("warmup"), step("fixmatch")

    def eval_stand_in(self):
        self._eval_step = lambda params, stats, u8, t, mask: (
            jnp.sum(mask.astype(jnp.float32)), jnp.sum(mask.astype(
                jnp.float32)), jnp.full((len(t), NUM_CLASSES), 0.25))

    cfg = _jax_config(cfg_over)
    with mock.patch.object(jax_learn, "build_data", lambda *a, **k: data), \
            mock.patch.object(jsemiformer.SemiFormer, "_build_train_steps",
                              stand_ins), \
            mock.patch.object(jsemiformer.SemiFormer, "_build_eval_step",
                              eval_stand_in), _port_init(), \
            contextlib.redirect_stdout(io.StringIO()):
        trainer, _ = jax_learn.run_config(cfg)
    jax_orbax_io.wait_until_finished()
    return trainer


def _port_run(cfg_over, data, events):
    """The port's ``run_config`` on ``data``, its steps run and recorded."""
    warmup, fixmatch = SemiFormer._warmup_step, SemiFormer._train_step

    def record(phase, step):
        def run(self, *args):
            events.append((self.epoch, phase))
            return step(self, *args)
        return run

    with mock.patch.object(SemiFormer, "_warmup_step",
                           record("warmup", warmup)), \
            mock.patch.object(SemiFormer, "_train_step",
                              record("fixmatch", fixmatch)), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        trainer, _ = learn.run_config(default_config(cfg_over), device="cpu",
                                      data=data)
    assert "nan" not in out.getvalue()
    return trainer


def check_run_config_crosses_eval_step_sup_like_jax():
    """``run_config`` with EVAL_STEP_SUP 2 over 3 epochs: epoch 1 sweeps
    the labeled set (3·B images: 3 warmup steps), epochs 2-3 take
    EVAL_STEP (2) FixMatch-phase steps; the same sequence, step count,
    checkpoints and meta as the JAX package's; a resume from epoch 2
    restarts there, in the FixMatch phase: the JAX run's epochs 2-3."""
    with tempfile.TemporaryDirectory() as tmp:
        over = _run_cfg(os.path.join(tmp, "port"))
        data = path_d.synthetic_data(default_config(over), (3 * B, 2 * B, B),
                                     seed=0)
        jax_over = _run_cfg(os.path.join(tmp, "jax"))
        events, jevents = [], []
        torch.manual_seed(0)
        port = _port_run(over, data, events)
        jt = _jax_run(jax_over, data, jevents)
        expect = ([(1, "warmup")] * 3 + [(2, "fixmatch")] * 2
                  + [(3, "fixmatch")] * 2)
        assert events == jevents == expect, (events, jevents)
        assert port.state.step == int(jt.state.step) == 7
        dirs = [f"epoch_{e}" for e in (1, 2, 3)]
        for side in ("port", "jax"):
            assert sorted(os.listdir(os.path.join(tmp, side))) == dirs, side
        for d in dirs:
            got, want = (json.loads(Path(tmp, side, d, "meta.json").read_text())
                         for side in ("port", "jax"))
            for k in ("epoch", "trainer", "img_size"):
                assert got[k] == want[k], (d, k)
            assert got["trainer"] == "SemiFormer"
        # a resume restarts at the saved epoch (the JAX package's rule,
        # held for FixMatch by learn.py): JAX's own epochs from 2 on
        events = []
        _port_run(_run_cfg(os.path.join(tmp, "port2"),
                           os.path.join(tmp, "port", "epoch_2")), data, events)
        assert events == [e for e in jevents if e[0] >= 2], events


def check_learn_builds_semiformer_on_cuda_by_default():
    """``kaggle_semisupervised_real_2.yaml`` through ``prepare_trainer``
    (its pretrained path dropped: the repository has no weights): the
    Conformer-Ti and the SemiFormer trainer on ``cpu`` when asked; without
    a device and a card it raises. ``--config`` names the first stage."""
    cfg = get_config(str(ROOT / "configs" / "kaggle_semisupervised_real_2.yaml"))
    cfg.MODEL.PRE_TRAIN_PATH = "None"
    small = copy.deepcopy(cfg)  # loaders of small images: none is read
    small.DATA.IMG_SIZE = IMG
    data = path_d.synthetic_data(small, (32, 192, 32), seed=1)
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="device='cpu'"):
        learn.prepare_trainer(cfg, data=data)
    trainer = learn.prepare_trainer(cfg, data=data, device="cpu")
    assert type(trainer) is SemiFormer and trainer.eval_step_sup == 15
    assert isinstance(trainer.state.model, Conformer)
    assert sum(p.numel() for p in trainer.state.model.parameters()) == TI_PARAMS
    assert trainer._images_per_step() == 32 * (1 + 2 * 6) == 416
    handler = signal.getsignal(signal.SIGTERM)
    try:
        with mock.patch.object(learn, "run_config", return_value=(
                None, torch.nn.Linear(1, 1))) as run, \
                contextlib.redirect_stdout(io.StringIO()):
            learn.main(["--config", str(ROOT / "configs" /
                                        "kaggle_semisupervised_real_2.yaml"),
                        "--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, handler)
    (config,), kw = run.call_args
    assert config.MODEL.TYPE_SEMI == "SemiFormer" and kw["device"] == "cpu"


# -- the supervised trainer and the transfer ------------------------------------


@functools.cache
def _jax_sup():
    """The JAX supervised trainer (Adam) on the same initial state, its
    ``_train_step`` taking a precomputed labeled view."""
    cfg = _jax_config(_overrides(IS_SSL=False, OPT_NAME="Adam"))
    trainer = JaxSupLearning(model=jax_build_model(cfg), opt_func="Adam")
    trainer.train_dl = trainer.valid_dl = None
    with _port_init(), mock.patch.object(jsupervised, "labeled_train_view",
                                        lambda x, *a: x):
        trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4],
                           labeled_targets=LABELED)
    return trainer


def check_supervised_trainer_on_conformer_matches_jax():
    """``kaggle_supervised_paper``'s trainer on the Conformer: one Adam
    step against JAX ``_train_step``. ``model_logits`` keeps the conv
    head, so in both packages the trans head and ``trans_norm`` stay
    bit-identical (their zero gradient still goes through Adam) while the
    conv head moves; IS_FREEZE freezes nothing (no ``backbone.``)."""
    jt = _jax_sup()
    t = _step_inputs()[1]
    w = _weights()
    x = np.array(_labeled_view())
    jstate, jloss = _jax_outputs()["sup"]
    port = _port_trainer(cls=SupLearning, IS_SSL=False, OPT_NAME="Adam")
    loss, _ = port._train_core(torch.from_numpy(x), torch.from_numpy(t).long(),
                               torch.from_numpy(w))
    # with the conv head's loss alone the last ViT block's last bias
    # shifts every patch token alike, which the next FCUUp's BN removes
    _compare(port, (jstate, jloss), loss, "Adam", jt.state,
             zero=(BIAS_BEFORE_BN,
                   f"conv_trans_{TINY['DEPTH']}.trans_block.mlp.fc2.bias"))
    start = _port_state(jt.state.params, jt.state.batch_stats)
    for sd in (port.state.model.state_dict(),
               _port_state(jstate.params, jstate.batch_stats)):
        for k, v in sd.items():
            if k.startswith(("trans_cls_head.", "trans_norm.")):
                assert torch.equal(v, start[k]), k
            elif k.startswith("conv_cls_head."):
                assert not torch.equal(v, start[k]), k
    assert all(port.grad_mask.values())
    from endoscopy_tpu_torch.train.common import trainable_mask
    assert all(trainable_mask(port.state.model, True).values())


def check_conformer_train_state_npz_loads_in_the_port():
    """The JAX supervised Conformer's state after its Adam step, saved by
    orbax and dumped by ``tools/torch_port/orbax_to_npz.py``, through
    ``load_checkpoint``: parameters, BN statistics, EMA, Adam's moments
    and count, and the step equal the mapped JAX state exactly."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", ROOT / "tools" / "torch_port" / "orbax_to_npz.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    st = _jax_outputs()["sup"][0]
    with tempfile.TemporaryDirectory() as tmp:
        jax_orbax_io.save_checkpoint(
            tmp, "epoch_3", st, {"epoch": 3, "best_valid_perf": 0.5,
                                 "trainer": "SupLearning", "img_size": IMG},
            block=True)
        npz = os.path.join(tmp, "state.npz")
        tool.orbax_to_npz(os.path.join(tmp, "epoch_3"), npz)
        port = _port_trainer(cls=SupLearning, IS_SSL=False, OPT_NAME="Adam")
        port.load_checkpoint(npz, is_train=True)
    assert port.state.step == 1 and port.epoch_start == 3
    sd = port.state.state_dict()
    for part, (p, b) in (("model", (st.params, st.batch_stats)),
                         ("ema", (st.ema_params, st.ema_batch_stats))):
        want = _no_counts(_port_state(p, b))
        assert set(want) == set(_no_counts(sd[part])), part
        for k, v in want.items():
            assert torch.equal(sd[part][k], v), (part, k)
    adam = st.opt_state[0]
    mu, nu = (dict(from_jax_params(_np(t), {})) for t in (adam.mu, adam.nu))
    assert set(sd["optimizer"]) == set(mu)
    for k, s in sd["optimizer"].items():
        assert torch.equal(s["exp_avg"], mu[k]), k
        assert torch.equal(s["exp_avg_sq"], nu[k]), k
        assert float(s["step"]) == int(adam.count) == 1


def check_conformer_pth_grafts_like_jax():
    """A reference-layout Conformer ``.pth`` (``module.`` prefix,
    ``num_batches_tracked``, heads of the same shape) grafts its trunk by
    identity and skips both heads, as the JAX import does: the port's
    state equals the JAX package's bit for bit, the trunk the donor's,
    both heads fresh, the EMA re-synced."""
    torch.manual_seed(7)
    donor = build_model(default_config(_overrides()))
    with torch.no_grad():
        for name, b in donor.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                b.uniform_(0.5, 1.5)
    donor_sd = _no_counts(donor.state_dict())
    base = _jax_base()
    init = _port_state(base.state.params, base.state.batch_stats)
    heads = ("conv_cls_head.", "trans_cls_head.")
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "sup_conformer.pth")
        torch.save({"model_state_dict": {f"module.{k}": v for k, v in
                                         donor.state_dict().items()}}, pth)
        jt = copy.copy(base)
        jcfg = copy.deepcopy(base.config)
        jcfg.MODEL.PRE_TRAIN_PATH = pth
        with contextlib.redirect_stdout(io.StringIO()):
            assert jtransfer.apply_pretrain(jt, jcfg)
        want = _no_counts(_port_state(_np(jt.state.params),
                                      _np(jt.state.batch_stats)))
        port = _port_trainer()
        cfg = default_config(_overrides())
        cfg.MODEL.PRE_TRAIN_PATH = pth
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert transfer.apply_pretrain(port, cfg)
        assert "torch import (conformer)" in out.getvalue()
    got = port.state.model.state_dict()
    assert set(_no_counts(got)) == set(want) == set(donor_sd)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        src = init if k.startswith(heads) else donor_sd
        assert torch.equal(got[k], src[k]), k
    for k, v in port.state.ema.state_dict().items():
        assert torch.equal(v, got[k]), ("ema", k)


def check_path_g_configs_match_yaml():
    """``chip_smoke.py``'s path G writes real_2's, real_2_1's and
    kaggle_supervised_paper's fields out (``torch_port_checks/path_g.py``):
    each equals the file's value, and every field the file sets is
    overridden, except data paths, the pretrained checkpoint and the
    checkpoint directory."""
    import yaml

    skip = {"PATH", "ANNO", "UNANNO_PATH", "UNANNO", "PRE_TRAIN",
            "PRE_TRAIN_PATH", "PRE_TRAIN_RESUME", "SAVE_CP"}
    for name, over in (("kaggle_semisupervised_real_2", path_g.REAL_2),
                       ("kaggle_semisupervised_real_2_1", path_g.REAL_2_1),
                       ("kaggle_supervised_paper", path_g.SUP_PAPER)):
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
    assert path_g.images_per_step(path_c.train_config(path_g.REAL_2)) == 416
    assert path_g.images_per_step(path_c.train_config(path_g.REAL_2_1)) == 312
