"""Port checks: the rest of the model zoo against the JAX package.

Each family at a tiny width, float32 on the CPU, its flax model's weights
drawn with numpy by leaf name (kernels of variance 1 / fan-in; every BN
and LayerNorm scale and offset, bias, BN statistic and zero-initialized
table away from flax's 0 and 1, so that each leaf shows in the outputs)
and converted through ``ckpt/convert.py``, the same seeded numpy input
through both:

- SE-ResNeXt (the SE gate and the grouped ``conv2``), the CBAM and the
  shuffle-attention ResNets: ``resnet_tiny``'s four one-block stages at
  32 px;
- DenseNet: growth 4, blocks (2, 2), 8 stem features at 32 px;
- Swin and SwinMLP: embed 16, depths (2, 2), heads (2, 4), window 4 at
  64 px (a shifted block in each stage; the second stage's 8x8 keeps its
  shift), as ``tests/test_model_zoo.py`` builds them;
- CoAtNet: one block a stage, channels (8, 12, 16, 24, 32) at 64 px;
- ViT-LSA: patch 8, dim 32, depth 2, 2 heads of 8 at 32 px;
- HaloAttention alone: dim 32, block 4, halo 2, 4 heads of 8 on 8x8
  (every block an edge block: the padding mask in play).

Tolerances, and why:

- eval logits: atol 1e-5 (float32 in another summation order, logits of
  order 1); train-mode logits: 1e-4 of the largest (``train.py``'s
  bound: flax's one-pass batch variance over 4 images, read 2.7e-5 on
  SE-ResNeXt's); BN running statistics after the train forward: atol
  1e-5;
- one supervised step (``SupLearning._forward_backward``, weighted CE,
  train mode) against ``jax.value_and_grad`` of the JAX package's
  ``ce_loss`` on the same view: the loss 1e-5 relative; the gradients by
  path E3's bound, relative L2 within three times the port's own float32
  distance from its float64 step, plus 1e-3;
- Swin's shift mask, relative index, window partition and roll: the JAX
  functions' values bit for bit;
- the reference ``.pth`` maps: each family's reference-named state dict
  (random values, a head, the skipped buffers) lands every tensor where
  the JAX package's ``import_torch_state`` lands it, exactly, SwinMLP's
  grouped ``Conv1d`` and the shuffle gate's ``(1, C, 1, 1)`` weights
  reshaped; none unmapped, the heads fresh;
- ``path_k.py``'s and ``path_l.py``'s fields against the YAML files:
  equal, but ``MODEL.NAME``; path M's names are every new one but K's and
  L's.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from endoscopy_tpu.ckpt.torch_import import import_torch_state as jax_import
from endoscopy_tpu.losses import classification as jcls
from endoscopy_tpu.models import swin as jswin
from endoscopy_tpu.models.attention import HaloAttention as JaxHalo
from endoscopy_tpu.models.coatnet import CoAtNet as JaxCoAtNet
from endoscopy_tpu.models.densenet import DenseNet as JaxDenseNet
from endoscopy_tpu.models.heads import ClassifierHead as JaxClassifierHead
from endoscopy_tpu.models.heads import build_head as jax_build_head
from endoscopy_tpu.models.resnet import ResNet as JaxResNet
from endoscopy_tpu.models.swin import SwinTransformer as JaxSwin
from endoscopy_tpu.models.swin_mlp import SwinMLP as JaxSwinMLP
from endoscopy_tpu.models.vit_lsa import ViTLSA as JaxViTLSA
from endoscopy_tpu_torch.ckpt import transfer
from endoscopy_tpu_torch.ckpt.convert import from_jax_params
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.models import swin
from endoscopy_tpu_torch.models.attention import HaloAttention
from endoscopy_tpu_torch.models.coatnet import CoAtNet
from endoscopy_tpu_torch.models.densenet import DenseNet
from endoscopy_tpu_torch.models.heads import ClassifierHead, build_head
from endoscopy_tpu_torch.models.resnet import ResNet
from endoscopy_tpu_torch.models.swin_mlp import SwinMLP
from endoscopy_tpu_torch.models.vit_lsa import ViTLSA
from endoscopy_tpu_torch.train.supervised import SupLearning
from endoscopy_tpu_torch.utils import trace
from torch_port_checks import path_k, path_l
from torch_port_checks.train import OVERRIDES, ROOT, _close

F32 = np.float32
NUM_CLASSES = 4
LABELED = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3])
ATOL = 1e-5
_SWIN = dict(patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
             window_size=4)
_RESNET = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)
# family → (flax backbone, port backbone, side, a registry name of its .pth
# family)
FAMILIES = {
    "seresnext": (
        lambda: JaxResNet(**_RESNET, use_se=True, groups=2, base_width=16,
                          dtype=jnp.float32),
        lambda s: ResNet(**_RESNET, use_se=True, groups=2, base_width=16),
        32, "seresnext50"),
    "cbam": (lambda: JaxResNet(**_RESNET, attn="cbam", dtype=jnp.float32),
             lambda s: ResNet(**_RESNET, attn="cbam"), 32, "resnet50cbam"),
    "sa": (lambda: JaxResNet(**_RESNET, attn="sa", dtype=jnp.float32),
           lambda s: ResNet(**_RESNET, attn="sa"), 32, "resnet50sa"),
    "densenet": (
        lambda: JaxDenseNet(growth_rate=4, block_config=(2, 2),
                            num_init_features=8, dtype=jnp.float32),
        lambda s: DenseNet(growth_rate=4, block_config=(2, 2),
                           num_init_features=8), 32, "densenet161"),
    "swin": (lambda: JaxSwin(**_SWIN, dtype=jnp.float32),
             lambda s: swin.SwinTransformer(s, **_SWIN), 64,
             "swin_tiny_patch4_window7_224"),
    "swin_mlp": (lambda: JaxSwinMLP(**_SWIN, dtype=jnp.float32),
                 lambda s: SwinMLP(s, **_SWIN), 64, "swin_mlp"),
    "coatnet": (
        lambda: JaxCoAtNet(num_blocks=(1, 1, 1, 1, 1),
                           channels=(8, 12, 16, 24, 32), dtype=jnp.float32),
        lambda s: CoAtNet(s, num_blocks=(1, 1, 1, 1, 1),
                          channels=(8, 12, 16, 24, 32)), 64, "coatnet"),
    "vit_lsa": (
        lambda: JaxViTLSA(patch_size=8, dim=32, depth=2, heads=2, dim_head=8,
                          mlp_dim=64, dtype=jnp.float32),
        lambda s: ViTLSA(s, patch_size=8, dim=32, depth=2, heads=2,
                         dim_head=8, mlp_dim=64), 32, "vit_lsa"),
}
def _fan_in_normal(r, shape):
    """A kernel's draw: a normal of variance 1 / fan_in (every axis but the
    last; SwinMLP's per-head ``(heads, n, n)`` weight mixes over ``n``)."""
    return r.normal(0, np.prod(shape[:-1]) ** -0.5, shape)


# each leaf's draw by its name, away from flax's 0 and 1 so that each
# shows in the outputs (flax's own init would compile for some 30 s)
_DRAWS = {"kernel": _fan_in_normal,
          "weight": lambda r, s: r.normal(0, s[-1] ** -0.5, s),
          "scale": lambda r, s: r.uniform(0.5, 1.5, s),
          "cbias": lambda r, s: r.uniform(0.5, 1.5, s),
          "sbias": lambda r, s: r.uniform(0.5, 1.5, s),
          "bias": lambda r, s: r.normal(0, 0.2, s),
          "mean": lambda r, s: r.normal(0, 0.2, s),
          "var": lambda r, s: r.uniform(0.5, 1.5, s),
          "cweight": lambda r, s: r.normal(0, 1.0, s),
          "sweight": lambda r, s: r.normal(0, 1.0, s),
          "relative_bias_table": lambda r, s: r.normal(0, 0.5, s),
          "relative_position_bias_table": lambda r, s: r.normal(0, 0.5, s),
          "temperature": lambda r, s: np.log(8 ** -0.5) + r.normal(0, 0.1, s),
          "pos_embedding": lambda r, s: r.normal(0, 1.0, s),
          "cls_token": lambda r, s: r.normal(0, 1.0, s),
          "rel_height": lambda r, s: r.normal(0, 0.5, s),
          "rel_width": lambda r, s: r.normal(0, 0.5, s)}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, F32), tree)


def _draw(shapes, rng):
    """Every leaf of a flax tree of shapes drawn by its name."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(_DRAWS[path[-1].key](rng, a.shape), F32),
        shapes)


@functools.cache
def _pair(family: str):
    """(flax ``ClassifierHead``, its params, batch_stats, its jitted
    outputs, the port's ``ClassifierHead`` with the same weights, the
    input side)."""
    jax_bb, port_bb, side, _ = FAMILIES[family]
    model = JaxClassifierHead(backbone=jax_bb(),
                              head=jax_build_head(NUM_CLASSES))
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.key(3), jnp.zeros((2, side, side, 3)))
    rng = np.random.default_rng(4)
    params = _draw(shapes["params"], rng)
    stats = _draw(shapes.get("batch_stats", {}), rng)
    bb = port_bb(side)
    port = ClassifierHead(bb, build_head(bb.num_features, NUM_CLASSES))
    port.load_state_dict(from_jax_params(params, stats), strict=True)

    @jax.jit
    def outputs(params, stats, x, t, w):
        v = {"params": params, "batch_stats": stats}
        ev = model.apply(v, x, train=False)

        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
            return (jcls.ce_loss(out, t, class_weights=w, reduction="mean"),
                    (out, mut))

        (loss, (tr, mut)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return ev, tr, mut.get("batch_stats", {}), loss, grads

    return model, params, stats, outputs, port, side


def _inputs(side: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, side, side, 3)).astype(F32)
    t = np.array([0, 1, 2, 3], np.int32)
    w = jcls.balanced_class_weights(LABELED, NUM_CLASSES).astype(F32)
    return x, t, w


def _port_step(port, x, t, w, dtype=torch.float32):
    """The supervised trainer's forward and backward on the view ``x``
    (NHWC); returns (loss, logits, {name: gradient})."""
    cfg = default_config({**OVERRIDES, "TRAIN": {**OVERRIDES["TRAIN"],
                                                 "IS_SSL": False}})
    trainer = SupLearning(port.to(dtype), "SGD", device="cpu")
    trainer.train_dl = None
    trainer.get_config(cfg, cls_num_list=[3, 2, 1, 4],
                       labeled_targets=LABELED)
    net = trainer.state.model
    if dtype == torch.float64:  # features handed over in float64
        net.forward = lambda v: net.head(net.backbone(v).double())
    loss = trainer._forward_backward(torch.from_numpy(x).to(dtype),
                                     torch.from_numpy(t).long(),
                                     torch.from_numpy(w).to(dtype))[0]
    return float(loss), {k: p.grad.double()
                         for k, p in net.named_parameters()}


def _l2(a, b):
    num = sum(float((a[k] - b[k]).pow(2).sum()) for k in b)
    return (num / sum(float(b[k].pow(2).sum()) for k in b)) ** 0.5


def check_zoo_forward_bn_and_step_match_flax():
    """For each family: eval logits, train-mode logits and BN running
    statistics against flax, then one supervised step's loss and
    gradients against ``jax.value_and_grad``."""
    import copy

    for family in FAMILIES:
        model, params, stats, outputs, port, side = _pair(family)
        x, t, w = _inputs(side, seed=5)
        ev, tr, moved, jloss, jgrads = outputs(params, stats, jnp.asarray(x),
                                               jnp.asarray(t), jnp.asarray(w))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        net = copy.deepcopy(port)
        with torch.no_grad():
            got = net.eval()(xt).numpy()
            _close(got, np.asarray(ev), rtol=0, atol=ATOL,
                   what=f"{family} eval")
            got, tr = net.train()(xt).numpy(), np.asarray(tr)
            _close(got, tr, rtol=0, atol=1e-4 * np.abs(tr).max(),
                   what=f"{family} train")
        want = from_jax_params(params, _np(moved))
        now = net.state_dict()
        for k in want:
            if k.endswith(("running_mean", "running_var")):
                _close(now[k].numpy(), want[k].numpy(), rtol=0, atol=ATOL,
                       what=f"{family} {k}")
        loss, grads = _port_step(copy.deepcopy(port), x, t, w)
        _, g64 = _port_step(copy.deepcopy(port), x, t, w, torch.float64)
        jg = {k: v.double() for k, v in from_jax_params(
            _np(jgrads), None).items()}
        assert set(jg) == set(grads), family
        _close(loss, float(jloss), rtol=1e-5, what=f"{family} loss")
        bound = 3 * _l2(grads, g64) + 1e-3
        err = _l2(grads, jg)
        assert err <= bound, (family, err, bound)


def check_halo_attention_matches_flax():
    """HaloAttention alone on 8x8 (every block an edge block), with the
    polarity-corrected padding mask."""
    x = np.random.default_rng(6).normal(0, 1, (2, 8, 8, 32)).astype(F32)
    mod = JaxHalo(32, block_size=4, halo_size=2, dim_head=8, heads=4,
                  dtype=jnp.float32)
    params = _draw(jax.eval_shape(mod.init, jax.random.key(7),
                                  jnp.asarray(x)), np.random.default_rng(8))
    want = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x)))
    port = HaloAttention(32, block_size=4, halo_size=2, dim_head=8, heads=4)
    port.load_state_dict(from_jax_params(params["params"], None),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=ATOL,
           what="halo")


def check_swin_mask_and_windows_match_jax_exactly():
    """The shift mask and the bias index equal the JAX functions' values;
    the roll and the window partition/reverse of a shifted block move the
    same elements."""
    for h, ws, shift in ((16, 4, 2), (56, 7, 3), (28, 7, 3), (8, 4, 2)):
        np.testing.assert_array_equal(swin.shift_attn_mask(h, h, ws, shift),
                                      jswin.shift_attn_mask(h, h, ws, shift))
        np.testing.assert_array_equal(swin.relative_position_index(ws),
                                      jswin.relative_position_index(ws))
        y = np.random.default_rng(h).normal(0, 1, (2, h, h, 3)).astype(F32)
        want = jswin.window_partition(jnp.roll(jnp.asarray(y), (-shift, -shift),
                                               axis=(1, 2)), ws)
        got = swin.window_partition(torch.roll(torch.from_numpy(y),
                                               (-shift, -shift), (1, 2)), ws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = swin.window_reverse(got, ws, h, h)
        np.testing.assert_array_equal(
            torch.roll(back, (shift, shift), (1, 2)).numpy(), y)
    assert swin.stage_window(7, 7, 7, 3) == (7, 0)


def _old_window_attention(m, x, mask):
    """``WindowAttention._forward`` as the port computed it before the
    window-attention op: the gather, the permuted ``q, k, v`` and
    ``layers.attention`` with the scale, bias and mask in its logits."""
    from endoscopy_tpu_torch.models.layers import attention, wide

    bnw, n, c = x.shape
    heads = m.num_heads
    hd = c // heads
    bias = m.relative_position_bias_table[
        m.relative_position_index.reshape(-1)].reshape(n, n, heads)
    bias = bias.permute(2, 0, 1)
    q, k, v = m.qkv(x).reshape(bnw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)

    def logits(a):
        a = a * hd ** -0.5 + wide(bias)
        if mask is None:
            return a
        nw = mask.shape[0]
        return (a.reshape(bnw // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(bnw, heads, n, n)

    out = attention(q, k, v, logits).transpose(1, 2).reshape(bnw, n, c)
    return m.proj(out)


def check_window_attention_plain_is_the_old_math_bit_for_bit():
    """``ops/window_attention.py``'s plain path, through
    ``WindowAttention``, gives the old module's output and gradients bit
    for bit, in float32 and float64, shifted (a 4-window mask) and not."""
    for dtype in (torch.float32, torch.float64):
        for shifted in (False, True):
            torch.manual_seed(3)
            m = swin.WindowAttention(16, 2, 4).to(dtype)
            with torch.no_grad():
                m.relative_position_bias_table.normal_(0, 0.5)
            mask = (torch.from_numpy(swin.shift_attn_mask(8, 8, 4, 2))
                    .to(dtype) if shifted else None)
            x = torch.randn(3 * 4, 16, 16, dtype=dtype)
            dy = torch.randn(3 * 4, 16, 16, dtype=dtype)
            outs = []
            for fn in (m, functools.partial(_old_window_attention, m)):
                m.zero_grad()
                xi = x.clone().requires_grad_(True)
                y = fn(xi, mask)
                y.backward(dy)
                outs.append([y.detach(), xi.grad] + [
                    p.grad.clone() for p in m.parameters()])
            for got, want in zip(*outs):
                assert got.dtype == dtype
                assert torch.equal(got, want), (dtype, shifted)


def check_swin_on_the_cpu_takes_the_plain_path():
    """A tiny Swin's forward on the CPU: no pass through the kernel
    (``window_attention/fused`` unmoved), the logits' bytes counted, the
    output the old module's bit for bit; and the dispatch rule and the
    kernel's shape checks, which need no card."""
    from endoscopy_tpu_torch.ops import window_attention as wa

    torch.manual_seed(4)
    model = swin.SwinTransformer(32, patch_size=4, embed_dim=16,
                                 depths=(2, 2), num_heads=(2, 4),
                                 window_size=4)
    x = torch.randn(2, 3, 32, 32)
    before = trace.totals()
    with torch.no_grad():
        got = model(x)
    moved = trace.since(before)["counters"]
    assert "window_attention/fused" not in moved, moved
    assert moved["swin/window_logit_bytes"] > 0
    old = swin.WindowAttention._forward
    try:
        swin.WindowAttention._forward = _old_window_attention
        with torch.no_grad():
            want = model(x)
    finally:
        swin.WindowAttention._forward = old
    assert torch.equal(got, want)

    qkv = torch.zeros(4, 49, 3, 3, 32, dtype=torch.bfloat16)
    assert not wa.takes_kernel(qkv) and not wa.takes_kernel(qkv.float())
    bias = torch.zeros(3, 49, 49)
    wa.check(qkv, bias, torch.zeros(4, 49, 49))
    for bad, args in (
            ("over the kernel's tile",
             (torch.zeros(4, 81, 3, 3, 32), torch.zeros(3, 81, 81), None)),
            ("head width", (torch.zeros(4, 49, 3, 3, 16), bias, None)),
            ("mask must be", (qkv, bias, torch.zeros(3, 49, 49))),
            ("16 bytes", (torch.zeros(4, 49, 3, 3, 36)[..., :32], bias,
                          None)),
            ("16 bytes", (torch.zeros(4 * 49 * 9 * 32 + 1)[1:].view(
                4, 49, 3, 3, 32), bias, None))):
        try:
            wa.check(*args)
        except ValueError as exc:
            assert bad in str(exc), (bad, exc)
        else:
            raise AssertionError(f"check() passed a case it must refuse: {bad}")
    assert wa.per_block(480 * 64, 64) == wa.MAX_PER_BLOCK
    assert wa.per_block(3 * 64, 64) == 3
    assert wa.per_block(1, 1) == 1
    # the bytes the kernel needs at Swin-T's shapes: 4.61 ms at 3.35 TB/s
    total = sum(wa.bytes_moved(480 * (side // 7) ** 2, 49, heads) * blocks
                for side, heads, blocks in ((56, 3, 2), (28, 6, 2),
                                            (14, 12, 6), (7, 24, 2)))
    assert total == 480 * 912 * (11 * 49 * 32 * 2 + 2 * 49 * 8)


def _reference_key(family: str, key: str) -> str:
    """A port backbone key → the reference's name for it (the inverse of
    the family's renames)."""
    subs = {
        "seresnext": ((r"\.se\.fc_(down|up)", r".conv_\1"),),
        "cbam": ((r"\.cbam\.mlp_fc1", ".cbam.ChannelGate.mlp.1"),
                 (r"\.cbam\.mlp_fc2", ".cbam.ChannelGate.mlp.3"),
                 (r"\.cbam\.spatial_(conv|bn)", r".cbam.SpatialGate.spatial.\1")),
        "sa": (),
        "densenet": ((r"^block(\d+)_layer(\d+)\.",
                      r"features.denseblock\1.denselayer\2."),
                     (r"^transition", "features.transition"),
                     (r"^norm_final", "features.norm5"),
                     (r"^(conv0|norm0)", r"features.\1")),
        "swin": ((r"^patch_embed\.", "patch_embed.proj."),
                 (r"^patch_norm", "patch_embed.norm"),
                 (r"^stage(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
                 (r"^merge(\d+)\.", r"layers.\1.downsample."),
                 (r"\.mlp_fc(\d)", r".mlp.fc\1")),
        "coatnet": ((r"^s0_conv(\d+)", r"s0.\1.0"), (r"^s0_bn(\d+)", r"s0.\1.1"),
                    (r"_block(\d+)\.pre_bn", r".\1.conv.norm"),
                    (r"_block(\d+)\.pw_linear", r".\1.conv.fn.7"),
                    (r"_block(\d+)\.pw\.", r".\1.conv.fn.0."),
                    (r"_block(\d+)\.bn1", r".\1.conv.fn.1"),
                    (r"_block(\d+)\.dw", r".\1.conv.fn.3"),
                    (r"_block(\d+)\.bn2", r".\1.conv.fn.4"),
                    (r"_block(\d+)\.se_fc1", r".\1.conv.fn.6.fc.0"),
                    (r"_block(\d+)\.se_fc2", r".\1.conv.fn.6.fc.2"),
                    (r"_block(\d+)\.bn3", r".\1.conv.fn.8"),
                    (r"_block(\d+)\.attn_norm", r".\1.attn.1.norm"),
                    (r"_block(\d+)\.attn\.to_out", r".\1.attn.1.fn.to_out.0"),
                    (r"_block(\d+)\.attn\.", r".\1.attn.1.fn."),
                    (r"_block(\d+)\.ff_norm", r".\1.ff.1.norm"),
                    (r"_block(\d+)\.ff(\d)", lambda m: f".{m.group(1)}.ff.1.fn."
                     f"net.{0 if m.group(2) == '1' else 3}"),
                    (r"_block(\d+)\.proj", r".\1.proj")),
        "vit_lsa": ((r"^to_patch_embedding\.norm",
                     "to_patch_embedding.to_patch_tokens.1"),
                    (r"^to_patch_embedding\.proj",
                     "to_patch_embedding.to_patch_tokens.2"),
                    (r"^norm1_(\d+)", r"transformer.layers.\1.0.norm"),
                    (r"^attn_(\d+)\.to_out", r"transformer.layers.\1.0.fn.to_out.0"),
                    (r"^attn_(\d+)", r"transformer.layers.\1.0.fn"),
                    (r"^norm2_(\d+)", r"transformer.layers.\1.1.norm"),
                    (r"^mlp1_(\d+)", r"transformer.layers.\1.1.fn.net.0"),
                    (r"^mlp2_(\d+)", r"transformer.layers.\1.1.fn.net.3")),
    }
    subs["swin_mlp"] = subs["swin"]
    for pattern, repl in subs[family]:
        key = re.sub(pattern, repl, key)
    return key


# the reference's shapes where they hold the port's elements differently
_RESHAPED = {"spatial_mlp.weight": lambda s: (s[0] * s[1], s[2], 1),
             "spatial_mlp.bias": lambda s: (s[0] * s[1],),
             "sa.cweight": lambda s: (1, s[0], 1, 1),
             "sa.sweight": lambda s: (1, s[0], 1, 1),
             "sa.cbias": lambda s: (1, s[0], 1, 1),
             "sa.sbias": lambda s: (1, s[0], 1, 1)}
# buffers a reference checkpoint holds and both maps skip
_BUFFERS = {"swin": ("layers.0.blocks.1.attn_mask",
                     "layers.0.blocks.0.attn.relative_position_index"),
            "coatnet": ("s3.0.attn.1.fn.relative_index",)}
_HEADS = {"vit_lsa": "mlp_head.1", "swin": "head", "swin_mlp": "head",
          "coatnet": "fc2", "densenet": "classifier"}


def check_zoo_pth_maps_match_jax():
    """Each family's reference-named state dict (random values): the port's
    ``ckpt/transfer.py`` and the JAX package's ``import_torch_state`` import
    the same tensors to the same places, every trunk tensor, none
    unmapped; the head and the buffers skipped, the head left fresh."""
    for family, (_, _, _, name) in FAMILIES.items():
        model, params, stats, _, port, _ = _pair(family)
        dst = port.state_dict()
        g = torch.Generator().manual_seed(9)
        sd = {}
        for k, v in dst.items():
            if not k.startswith("backbone."):
                continue
            k = k[len("backbone."):]
            shape = next((f(tuple(v.shape)) for end, f in _RESHAPED.items()
                          if k.endswith(end)), tuple(v.shape))
            sd[_reference_key(family, k)] = (
                v.clone() if k.endswith("num_batches_tracked") else
                torch.rand(shape, generator=g) + 0.5)
        for buf in _BUFFERS.get(family, ()):
            sd[buf] = torch.zeros(3)
        head = _HEADS.get(family, "fc")
        sd[f"{head}.weight"] = torch.ones(3, port.backbone.num_features)
        sd[f"{head}.bias"] = torch.ones(3)
        new, n, mismatch, unmapped = transfer.import_torch_state(dst, sd, name)
        jp, jb, report = jax_import(
            params, stats, {k: v.numpy() for k, v in sd.items()},
            transfer.arch_for_model(name), backbone_scope="backbone",
            strict=True)
        want = from_jax_params(_np(jp), _np(jb))
        trunk = [k for k in sd if not k.endswith("num_batches_tracked")
                 and not k.startswith(head) and k not in
                 _BUFFERS.get(family, ())]
        assert n == report.imported == len(trunk), (family, n,
                                                    report.summary())
        assert not mismatch and not unmapped and not report.shape_mismatch
        assert set(new) == set(want), family
        for k, v in want.items():
            assert torch.equal(new[k], v), (family, k)
            if not k.startswith("backbone."):
                assert torch.equal(v, dst[k]), k  # the head stays fresh


def check_paths_k_l_configs_match_yaml():
    """``chip_smoke.py``'s paths K and L write their presets' fields out
    with ``MODEL.NAME`` swapped: every other field equals the file's, and
    every field the file sets is there, but data paths, the pretrained
    checkpoint and the checkpoint directory. Path M covers the names this
    slice ports but K's and L's."""
    from pathlib import Path

    import yaml

    from endoscopy_tpu.config.loader import get_config as jax_get_config
    from endoscopy_tpu.models.registry import list_models

    skip = {"PATH", "ANNO", "UNANNO_PATH", "UNANNO", "PRE_TRAIN",
            "PRE_TRAIN_PATH", "PRE_TRAIN_RESUME", "SAVE_CP"}
    for presets, name in ((path_k.PRESETS, "densenet161"),
                          (path_l.PRESETS, "swin_tiny_patch4_window7_224")):
        for preset, over in presets.items():
            path = str(ROOT / "configs" / f"{preset}.yaml")
            cfg = jax_get_config(path)
            raw = yaml.safe_load(Path(path).read_text())
            assert over["MODEL"]["NAME"] == name
            for section, values in over.items():
                for k, v in values.items():
                    if (section, k) != ("MODEL", "NAME"):
                        assert cfg[section][k] == v, (preset, section, k)
            for section, values in raw.items():
                for k in values:
                    assert k in skip or k in over.get(section, {}), (preset,
                                                                     k)
    ported_before = {"resnet_tiny", "resnet50", "resnet50sasa",
                     "efficientnet_b0", "efficientnet_b1", "conformer"}
    assert set(path_l.M_NAMES) == set(list_models()) - ported_before - {
        "densenet161", "swin_tiny_patch4_window7_224"}
