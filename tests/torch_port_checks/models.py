"""Port checks: ResNet, EfficientNet, SASA, heads and the flax → torch weight conversion.

The flax ``ClassifierHead`` of the JAX package and the port's model get the
same weights through ``ckpt/convert.py``; their eval logits agree at
atol 1e-4 in float32 (float32 convolutions on the CPU, summed in a
different order by XLA and by PyTorch). The tiny EfficientNet and the tiny
SASA ResNet (randomized BN scales, statistics and every bias) are held at
1e-4 of the largest logit in eval and train mode, and their BN running statistics
after the train forward at 1e-4 relative (``train.py``'s bound: flax's
one-pass batch variance). The reference ``.pth`` maps (timm 0.5.4's
EfficientNet names, the reference's SASA ResNet names) land every tensor
where the JAX package's ``ckpt/torch_import.py`` lands it, exactly. Every
preset under ``configs/`` builds in the port with the JAX ``build_model``'s
parameter count (flax's under ``jax.eval_shape``, the port's on the meta
device: shapes only), and the flax tree converts onto it with a strict
load; so does every name of ``list_models()``, the same list in both
packages.
"""

import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.ckpt.torch_import import import_torch_state as jax_import
from endoscopy_tpu.config.loader import default_config as jax_default_config
from endoscopy_tpu.config.loader import get_config as jax_get_config
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu.models.registry import create_backbone as jax_create_backbone
from endoscopy_tpu.models.registry import list_models as jax_list_models
from endoscopy_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from endoscopy_tpu.models.heads import ClassifierHead as JaxClassifierHead
from endoscopy_tpu.models.heads import build_head as jax_build_head
from endoscopy_tpu.models.resnet import ResNet as JaxResNet
from endoscopy_tpu_torch.ckpt import transfer
from endoscopy_tpu_torch.ckpt.convert import from_jax_params, read_npz, write_npz
from endoscopy_tpu_torch.config.loader import default_config, get_config
from endoscopy_tpu_torch.models import (build_model, create_backbone,
                                        list_models)
from endoscopy_tpu_torch.models.efficientnet import EfficientNet
from endoscopy_tpu_torch.models.heads import ClassifierHead, build_head
from endoscopy_tpu_torch.models.registry import _SIZED
from endoscopy_tpu_torch.models.resnet import ResNet

S = 32
NUM_CLASSES = 4
ROOT = Path(__file__).resolve().parents[2]


def _configs(name="resnet_tiny"):
    jcfg = jax_default_config()
    jcfg.MODEL.NAME = name
    jcfg.MODEL.NUM_CLASSES = NUM_CLASSES
    jcfg.TRAIN.DTYPE = "float32"
    cfg = default_config({"MODEL": {"NAME": name, "NUM_CLASSES": NUM_CLASSES},
                          "TRAIN": {"DTYPE": "float32"}})
    return jcfg, cfg


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def flax_tiny(seed=0):
    """A flax resnet_tiny classifier with randomized BN affine and running
    statistics, so the conversion of every leaf shows in the logits."""
    jcfg, _ = _configs()
    model = jax_build_model(jcfg)
    variables = model.init(jax.random.key(seed), jnp.zeros((1, S, S, 3)))
    rng = np.random.default_rng(seed)
    params = _to_numpy(variables["params"])
    stats = _to_numpy(variables["batch_stats"])

    def jitter(path, a):
        name = getattr(path[-1], "key", "")
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(jitter, params)
    stats = jax.tree_util.tree_map_with_path(jitter, stats)
    return model, params, stats


def check_tiny_eval_logits_match_flax():
    model, params, stats = flax_tiny()
    x = np.random.default_rng(1).normal(0, 1, (3, S, S, 3)).astype(np.float32)
    ref = np.asarray(model.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=False))
    port = build_model(_configs()[1])
    port.load_state_dict(from_jax_params(params, stats), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, NUM_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def check_resnet50_structure_matches_flax():
    """Every flax ResNet-50 leaf lands on a port parameter of the same
    shape: a strict load of the converted full-width tree (shapes only, no
    forward)."""
    jcfg, cfg = _configs("resnet50")
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_jax_params(zeros["params"], zeros["batch_stats"])
    port = build_model(cfg)
    port.load_state_dict(state, strict=True)
    n_flax = len(jax.tree.leaves(shapes["params"])) + len(
        jax.tree.leaves(shapes["batch_stats"]))
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    assert len(state) == n_flax + n_bn  # + one num_batches_tracked per BN


def check_npz_roundtrip():
    _, params, stats = flax_tiny(seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tiny.npz")
        write_npz(path, params, stats)
        p2, s2 = read_npz(path)
    a, b = from_jax_params(params, stats), from_jax_params(p2, s2)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def check_unported_models_point_to_roadmap():
    """``MODEL.MARGIN`` builds the plain classifier with the bias-free
    linear head, as the JAX registry does; an unknown backbone raises, as
    the JAX registry does (every name of it is ported); CoMatch's model,
    ``ModelwEmb``, is built."""
    margin = build_model(default_config({"MODEL": {
        "NAME": "resnet_tiny", "MARGIN": "ArcFace"}}))
    assert type(margin.head).__name__ == "LinearHead"
    assert margin.head.fc.bias is None
    assert build_model(default_config({"MODEL": {
        "NAME": "resnet_tiny"}})).head.fc.bias is not None
    with pytest.raises(ValueError, match="unknown model 'densenet169'"):
        build_model(default_config({"MODEL": {"NAME": "densenet169"}}))
    comatch = build_model(default_config({"MODEL": {
        "NAME": "resnet_tiny", "TYPE_SEMI": "CoMatch"}}))
    assert type(comatch).__name__ == "ModelwEmb"


def check_resnet_conventions():
    """Stride on conv2, a downsample on layer1.0, BN momentum/eps, pooled
    float32 features."""
    port = build_model(default_config())
    bb = port.backbone
    assert bb.layer2[0].conv2.stride == (2, 2)
    assert bb.layer2[0].conv1.stride == (1, 1)
    assert bb.layer1[0].downsample is not None
    assert bb.layer1[1].downsample is None
    assert bb.maxpool.padding == 1
    bn = bb.bn1
    assert bn.momentum == pytest.approx(0.1) and bn.eps == pytest.approx(1e-5)
    with torch.no_grad():
        fts = bb.eval()(torch.zeros(1, 3, 64, 64))
    assert fts.dtype == torch.float32 and fts.shape == (1, 2048)


# -- EfficientNet and the SASA ResNet ------------------------------------------

# a three-stage EfficientNet (a depthwise-separable first stage, then
# inverted residuals with 3x3 and 5x5 windows)
TINY_STAGES = ((1, 8, 1, 1, 3), (6, 16, 2, 2, 3), (6, 24, 2, 2, 5))
TINY_SIDE = 64  # the SASA layers' windows: 4x4 (even: the asymmetric pad), 2x2


def _tiny_pair(kind: str, seed: int):
    """(flax ``ClassifierHead``, its params, randomized batch_stats, the
    port's model with the same weights) for ``kind`` 'efficientnet' or
    'sasa'."""
    from torch_port_checks.train import _module_init

    if kind == "efficientnet":
        fb = JaxEfficientNet(stages=TINY_STAGES, stem_channels=8,
                             head_channels=32, dtype=jnp.float32)
        pb = EfficientNet(stages=TINY_STAGES, stem_channels=8,
                          head_channels=32)
    else:
        fb = JaxResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                       sasa_stages=(2, 3), dtype=jnp.float32)
        pb = ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                    sasa_stages=(2, 3), img_size=TINY_SIDE)
    model = JaxClassifierHead(backbone=fb, head=jax_build_head(NUM_CLASSES))
    variables = _module_init(model, jax.random.key(seed),
                             jnp.zeros((1, TINY_SIDE, TINY_SIDE, 3)))
    rng = np.random.default_rng(seed)
    params = _to_numpy(variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape)
                         if path[-1].key == "var"
                         else rng.normal(0, 0.2, a.shape)).astype(np.float32),
        _to_numpy(variables["batch_stats"]))
    # every BN scale and every bias (BN, SE, SASA's q/k/v, the head) away
    # from flax's 1 and 0, so each shows in the outputs
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: ({"scale": rng.uniform(0.5, 1.5, a.shape),
                          "bias": rng.normal(0, 0.2, a.shape)}.get(
                              path[-1].key, a)).astype(np.float32), params)
    port = ClassifierHead(pb, build_head(pb.num_features, NUM_CLASSES))
    port.load_state_dict(from_jax_params(params, stats), strict=True)
    return model, params, stats, port


def check_tiny_efficientnet_and_sasa_match_flax():
    """Eval logits, then train-mode logits and every BN's running
    statistics after one forward, both models at 64 px; the structure
    (depthwise convolutions, SE biases, BN eps 1e-3; SASA's ``conv2``
    with biased q/k/v and its encodings)."""
    x = np.random.default_rng(5).normal(0, 1, (3, TINY_SIDE, TINY_SIDE, 3)
                                        ).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for kind in ("efficientnet", "sasa"):
        model, params, stats, port = _tiny_pair(kind, seed=6)
        v = {"params": params, "batch_stats": stats}
        want = np.asarray(jax.jit(lambda v, x: model.apply(v, x))(
            v, jnp.asarray(x)))
        with torch.no_grad():
            got = port.eval()(xt).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=kind)
        want, mut = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        with torch.no_grad():
            got = port.train()(xt).numpy()
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{kind} train")
        moved = from_jax_params(params, _to_numpy(mut["batch_stats"]))
        now = port.state_dict()
        keys = [k for k in moved if k.endswith(("running_mean",
                                                 "running_var"))]
        for k in keys:
            np.testing.assert_allclose(now[k].numpy(), moved[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        if kind == "efficientnet":
            blk = port.backbone.stage2_block1
            assert blk.dw_conv.groups == blk.dw_conv.in_channels == 48
            assert blk.se_reduce.bias is not None and blk.residual is False
            assert port.backbone.stem_bn.eps == pytest.approx(1e-3)
            assert len(keys) == 2 * 16  # stem, 2 + 6 + 6 in the blocks, head
        else:
            sasa = port.backbone.layer3[0].conv2
            assert (sasa.ks, port.backbone.layer4[0].conv2.ks) == (4, 2)
            assert sasa.rel_encoding_h.shape == (16, 4, 1)
            assert port.backbone.layer2[0].conv1.stride == (2, 2)
            assert port.backbone.layer2[0].conv2.stride == (1, 1)


def _timm_key(key: str) -> str:
    """A port EfficientNet backbone key → timm 0.5.4's name for it."""
    for port_name, timm_name in (("stem_conv", "conv_stem"),
                                 ("stem_bn", "bn1"), ("head_conv", "conv_head"),
                                 ("head_bn", "bn2")):
        if key.startswith(port_name + "."):
            return timm_name + key[len(port_name):]
    s, b, name, leaf = re.fullmatch(r"stage(\d+)_block(\d+)\.(\w+)\.(\w+)",
                                    key).groups()
    names = ({"dw_conv": "conv_dw", "dw_bn": "bn1", "project_conv": "conv_pw",
              "project_bn": "bn2"} if s == "1" else
             {"expand_conv": "conv_pw", "expand_bn": "bn1",
              "dw_conv": "conv_dw", "dw_bn": "bn2",
              "project_conv": "conv_pwl", "project_bn": "bn3"})
    names.update(se_reduce="se.conv_reduce", se_expand="se.conv_expand")
    return f"blocks.{int(s) - 1}.{int(b) - 1}.{names[name]}.{leaf}"


def check_pth_maps_match_jax():
    """A timm 0.5.4 EfficientNet state dict and a reference SASA ResNet
    one (random values, with a classifier head and BN counters), keyed by
    the reference's names: the port's ``ckpt/transfer.py`` and the JAX
    package's ``import_torch_state`` import the same tensors to the same
    places, every trunk tensor, none unmapped, the heads left fresh."""
    for kind, name, rename in (("efficientnet", "efficientnet_b1", _timm_key),
                               ("sasa", "resnet50sasa", lambda k: k)):
        model, params, stats, port = _tiny_pair(kind, seed=7)
        dst = port.state_dict()
        g = torch.Generator().manual_seed(8)
        sd = {}
        for k, v in dst.items():
            if k.startswith("backbone."):
                sd[rename(k[len("backbone."):])] = (
                    v.clone() if k.endswith("num_batches_tracked") else
                    torch.rand(v.shape, generator=g) + 0.5)
        head = "classifier" if kind == "efficientnet" else "fc"
        sd[f"{head}.weight"] = torch.ones(3, port.backbone.num_features)
        sd[f"{head}.bias"] = torch.ones(3)
        new, n, mismatch, unmapped = transfer.import_torch_state(dst, sd, name)
        jp, jb, report = jax_import(params, stats, {
            k: v.numpy() for k, v in sd.items()},
            "efficientnet" if kind == "efficientnet" else "resnet",
            backbone_scope="backbone", strict=True)
        want = from_jax_params(_to_numpy(jp), _to_numpy(jb))
        trunk = [k for k in sd if not k.endswith("num_batches_tracked")
                 and not k.startswith(head)]
        assert n == report.imported == len(trunk), (kind, n, report.summary())
        assert not mismatch and not unmapped and not report.shape_mismatch
        assert set(new) == set(want)
        for k, v in want.items():
            assert torch.equal(new[k], v), (kind, k)
            if k.startswith("backbone.") and not k.endswith(
                    "num_batches_tracked"):
                assert torch.equal(v, sd[rename(k[len("backbone."):])]), k
            elif not k.startswith("backbone."):
                assert torch.equal(v, dst[k]), k  # the head stays fresh


def check_every_preset_builds_with_jax_parameter_counts():
    """``build_model`` for every ``configs/*.yaml`` in the port (on the
    meta device: shapes only) has the JAX ``build_model``'s parameter
    count at the config's ``IMG_SIZE``, and the flax tree of its shapes
    (zeros) converts onto it with a strict load; so does every backbone of
    ``list_models()`` (under a linear head), equal in both packages, at
    224 px and, for the ones built for their side, at 112 px, where Swin
    and SwinMLP refuse in both (an odd stage side to merge). Each distinct
    flax model is traced once."""
    traced = {}

    def flax_zeros(jmodel, side):
        if (jmodel, side) not in traced:
            shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                    jnp.zeros((1, side, side, 3)))
            traced[jmodel, side] = jax.tree.map(
                lambda s: np.zeros(s.shape, np.float32), shapes)
        return traced[jmodel, side]

    def holds(port, variables, what):
        n_flax = sum(a.size for a in jax.tree.leaves(variables["params"]))
        n_port = sum(p.numel() for p in port.parameters())
        assert n_port == n_flax, (what, n_port, n_flax)
        port.load_state_dict(from_jax_params(
            variables["params"], variables.get("batch_stats", {})),
            strict=True, assign=True)

    paths = sorted((ROOT / "configs").glob("*.yaml"))
    assert len(paths) >= 21
    names = set()
    for path in paths:
        with torch.device("meta"):
            port = build_model(get_config(str(path)))
        jcfg = jax_get_config(str(path))
        holds(port, flax_zeros(jax_build_model(jcfg),
                               int(jcfg.DATA.IMG_SIZE)), path.name)
        names.add(jcfg.MODEL.NAME)
    assert {"efficientnet_b1", "resnet50sasa", "conformer"} <= names
    assert list_models() == jax_list_models()
    for name in list_models():
        if name == "conformer":  # its presets above
            continue
        for side in (224, 112) if name in _SIZED else (224,):
            jmodel = jax_create_backbone(name, jnp.float32)
            if name.startswith("swin") and side == 112:
                with pytest.raises(ValueError, match="even side"):
                    create_backbone(name, side)
                with pytest.raises(TypeError):
                    flax_zeros(jmodel, side)
                continue
            with torch.device("meta"):
                bb = create_backbone(name, side)
                port = ClassifierHead(bb, build_head(bb.num_features,
                                                     NUM_CLASSES))
            v = flax_zeros(jmodel, side)
            head = {"fc": {"kernel": np.zeros((bb.num_features, NUM_CLASSES),
                                              np.float32),
                           "bias": np.zeros(NUM_CLASSES, np.float32)}}
            holds(port, {"params": {"backbone": v["params"], "head": head},
                         "batch_stats": {"backbone": v.get("batch_stats",
                                                           {})}},
                  (name, side))
