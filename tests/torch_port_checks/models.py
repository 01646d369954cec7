"""Port checks: ResNet, heads and the flax → torch weight conversion.

The flax ``ClassifierHead`` of the JAX package and the port's model get the
same weights through ``ckpt/convert.py``; their eval logits agree at
atol 1e-4 in float32 (float32 convolutions on the CPU, summed in a
different order by XLA and by PyTorch).
"""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.config.loader import default_config as jax_default_config
from endoscopy_tpu.models import build_model as jax_build_model
from endoscopy_tpu_torch.ckpt.convert import from_jax_params, read_npz, write_npz
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.models import build_model

S = 32
NUM_CLASSES = 4


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
    for override in ({"MODEL": {"NAME": "densenet121"}},
                     {"MODEL": {"TYPE_SEMI": "CoMatch"}},
                     {"MODEL": {"MARGIN": "ArcFace"}}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_model(default_config(override))


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
