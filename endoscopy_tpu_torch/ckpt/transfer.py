"""Transfer-weight initialization (port of ``endoscopy_tpu/ckpt/transfer.py``).

The reference trains its trunk in hops (ImageNet → a 2-class "abnormal"
classifier → the N-class pathology model), each hop loading the donor's
whole state and keeping a fresh classification head. ``MODEL.
PRE_TRAIN_PATH`` names the donor:

- a checkpoint directory of the port (``<dir>/state.pt``, ``ckpt/io.py``);
- a ``.npz`` of flax trees (``ckpt/convert.py::read_npz``);
- a torch ``.pth`` in the timm / torchvision ResNet layout or the
  reference's Conformer layout (the reference's own checkpoints,
  ``{'model_state_dict': ...}`` included).

Every tensor whose name and shape match is copied; a head of another class
count keeps its fresh initialization (the reference's head surgery).
``MODEL.PRE_TRAIN`` without a path would download ImageNet weights in the
reference; there is no network here, so it warns and training starts from
the model's own initialization. After the graft the EMA teacher is
re-synced to the model, as the reference's EMA copies the model after the
transfer load.

Of ``ckpt/torch_import.py`` the ResNet, Conformer and EfficientNet maps
are ported. The port's ResNet keeps torchvision's module names, so its
key map is the ``backbone.`` prefix; the SASA ResNet's attention layer is
named ``conv2`` with the reference's ``q_conv``/``k_conv``/``v_conv`` and
``rel_encoding_h/w``, so the same prefix carries it. The port's Conformer
keeps the reference's names, so its map is the identity. The port's
EfficientNet keeps flax's names, so timm 0.5.4's module paths are renamed
with the JAX package's rules, in their order, then prefixed. Each skips
its heads (the ResNet's ``fc``/``head``/``classifier``; the Conformer's
``conv_cls_head``, ``trans_cls_head`` and ``pooling``; the EfficientNet's
``classifier``), whatever their shape. A ``.pth`` for another architecture
raises (ROADMAP.md).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt.convert import from_jax_params, read_npz
from endoscopy_tpu_torch.config.loader import is_none

# a torch ModelwEmb checkpoint aliases every backbone tensor as
# 'backbone.<idx>.<key>' (an nn.Sequential view) besides 'model.<key>'
_ALIAS_RE = re.compile(r"^backbone\.\d+\.")
# timm 0.5.4 EfficientNet module paths → the port's (flax's) names, applied
# in order: blocks.0.* are DepthwiseSeparableConv (conv_pw IS the
# projection), later stages InvertedResidual (conv_pw expands, conv_pwl
# projects); stage{S}_block{B} count from 1
_EFFICIENTNET_RENAMES = (
    (r"^blocks\.0\.(\d+)\.conv_dw", r"blocks.0.\1.dw_conv"),
    (r"^blocks\.0\.(\d+)\.bn1", r"blocks.0.\1.dw_bn"),
    (r"^blocks\.0\.(\d+)\.conv_pw", r"blocks.0.\1.project_conv"),
    (r"^blocks\.0\.(\d+)\.bn2", r"blocks.0.\1.project_bn"),
    (r"^blocks\.(\d+)\.(\d+)\.conv_pwl", r"blocks.\1.\2.project_conv"),
    (r"^blocks\.(\d+)\.(\d+)\.bn3", r"blocks.\1.\2.project_bn"),
    (r"^blocks\.(\d+)\.(\d+)\.conv_pw", r"blocks.\1.\2.expand_conv"),
    (r"^blocks\.(\d+)\.(\d+)\.bn1", r"blocks.\1.\2.expand_bn"),
    (r"^blocks\.(\d+)\.(\d+)\.conv_dw", r"blocks.\1.\2.dw_conv"),
    (r"^blocks\.(\d+)\.(\d+)\.bn2", r"blocks.\1.\2.dw_bn"),
    (r"\.se\.conv_reduce", r".se_reduce"),
    (r"\.se\.conv_expand", r".se_expand"),
    (r"^blocks\.(\d+)\.(\d+)\.",
     lambda m: f"stage{int(m.group(1)) + 1}_block{int(m.group(2)) + 1}."),
    (r"^conv_stem", r"stem_conv"),
    (r"^bn1", r"stem_bn"),
    (r"^conv_head", r"head_conv"),
    (r"^bn2", r"head_bn"),
)
# model family → (the prefix of its port names, its heads, the renames of
# its module paths)
_TORCH_MAPS = {
    "resnet": ("backbone.", re.compile(r"^(fc|head|classifier)\b"), ()),
    "conformer": ("", re.compile(r"^(conv_cls_head|trans_cls_head|pooling)\b"),
                  ()),
    "efficientnet": ("backbone.", re.compile(r"^classifier\b"),
                     _EFFICIENTNET_RENAMES),
}


def graft_tree(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], int, List[str]]:
    """Every tensor of ``dst`` whose name is in ``src`` with the same shape
    is replaced by ``src``'s. Returns ``(new state, n_copied, names whose
    shapes differ)``: the head surgery's tensors, or anything structural."""
    new, copied, mismatched = dict(dst), 0, []
    for name, leaf in dst.items():
        if name in src:
            if tuple(src[name].shape) == tuple(leaf.shape):
                new[name] = src[name]
                copied += 1
            else:
                mismatched.append(name)
    return new, copied, mismatched


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict on the CPU; ``{'model_state_dict': ...}`` is
    unwrapped. Read with ``weights_only=True``: tensors and plain
    containers only, no code from the file runs."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return ckpt


def _torch_map(model_name: str):
    for family, spec in _TORCH_MAPS.items():
        if str(model_name).startswith(family):
            return family, spec
    raise NotImplementedError(
        f"no torch import key map for '{model_name}' in endoscopy_tpu_torch "
        f"yet ({', '.join(_TORCH_MAPS)} only); see the port queue in "
        "ROADMAP.md")


def import_torch_state(dst: Mapping[str, torch.Tensor],
                       state_dict: Mapping[str, torch.Tensor],
                       model_name: str = "resnet"):
    """A reference state dict onto the port's names: ``module.`` and
    ``model.`` wrappers stripped, heads, ``num_batches_tracked`` and
    aliases skipped, the family's module renames applied, its prefix
    prepended. Returns ``(new state, imported, shape mismatches, unmapped
    keys)``."""
    _, (prefix, head_re, renames) = _torch_map(model_name)
    mapped, mismatch, unmapped = {}, [], []
    for tkey, value in state_dict.items():
        key = tkey
        for wrap in ("module.", "model."):
            if key.startswith(wrap):
                key = key[len(wrap):]
        if (_ALIAS_RE.match(key) or key.endswith("num_batches_tracked")
                or head_re.match(key)):
            continue
        module, _, leaf = key.rpartition(".")
        for pattern, repl in renames:
            module = re.sub(pattern, repl, module)
        name = prefix + (f"{module}.{leaf}" if module else leaf)
        if name not in dst:
            unmapped.append(tkey)
        elif tuple(value.shape) != tuple(dst[name].shape):
            mismatch.append(tkey)
        else:
            mapped[name] = value
    new, imported, _ = graft_tree(dst, mapped)
    return new, imported, mismatch, unmapped


def load_pretrained_into(model: nn.Module, path: str, model_name: str) -> str:
    """Graft the donor at ``path`` into ``model`` in place; returns a report
    line. Raises when nothing was copied (a wrong file or architecture)."""
    dst = model.state_dict()
    if os.path.isdir(path) or path.endswith(".npz"):
        donor = (from_jax_params(*read_npz(path)) if path.endswith(".npz")
                 else ckpt_io.restore_checkpoint(path, "cpu")[0]["model"])
        new, n, miss = graft_tree(dst, donor)
        if n == 0:
            raise ValueError(f"transfer from '{path}' grafted 0 tensors: the "
                             f"donor does not match model '{model_name}'")
        report = (f"graft: {n} tensors copied, {len(miss)} shape-mismatched "
                  f"(head surgery): {miss[:4]}")
    else:
        family, _ = _torch_map(model_name)
        new, n, miss, unmapped = import_torch_state(
            dst, load_torch_checkpoint(path), model_name)
        if n == 0:
            raise ValueError(f"torch transfer from '{path}' imported 0 "
                             f"tensors; unmapped keys e.g. {unmapped[:8]}")
        if unmapped:
            print(f"WARNING: torch import left {len(unmapped)} keys "
                  f"unmapped, e.g. {unmapped[:8]}")
        report = (f"torch import ({family}): {n} tensors, {len(miss)} shape "
                  f"mismatches, {len(unmapped)} unmapped")
    model.load_state_dict(new, strict=True)
    return report


def _sync_ema(trainer) -> None:
    if trainer.state.ema is not None:
        trainer.state.ema.load_state_dict(trainer.state.model.state_dict())


def apply_pretrain(trainer, config) -> bool:
    """Consume ``MODEL.PRE_TRAIN`` / ``MODEL.PRE_TRAIN_PATH`` on a
    configured trainer; True when weights were loaded."""
    path = config.MODEL.get("PRE_TRAIN_PATH")
    pre_train = config.MODEL.get("PRE_TRAIN")
    if is_none(path):
        if pre_train and not is_none(pre_train):
            print("WARNING: MODEL.PRE_TRAIN is set but MODEL.PRE_TRAIN_PATH "
                  "is None; there is no network to download ImageNet "
                  "weights from. Point PRE_TRAIN_PATH at a local .pth, .npz "
                  "or checkpoint directory. Training starts from the "
                  "model's own initialization.")
        return False
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"MODEL.PRE_TRAIN_PATH '{path}' does not exist")
    report = load_pretrained_into(trainer.state.model, path,
                                  config.MODEL.NAME)
    _sync_ema(trainer)
    print(f"Loaded checkpoint abnormal/pretrained: {report}")
    return True


def carry_stage_weights(trainer, prev_state: Mapping[str, torch.Tensor]
                        ) -> None:
    """Progressive-resizing handoff: the previous stage's final model state
    (parameters and BN statistics) into this stage's freshly built state;
    the EMA restarts from the carried weights."""
    model = trainer.state.model
    new, n, miss = graft_tree(model.state_dict(), prev_state)
    if n == 0:
        raise ValueError("progressive-resize carry grafted 0 tensors")
    if miss:
        print(f"WARNING: progressive-resize carry skipped {len(miss)} "
              f"size-dependent tensors: {miss[:4]}")
    model.load_state_dict(new, strict=True)
    _sync_ema(trainer)
