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

Every family map of ``ckpt/torch_import.py`` is ported (``_ARCHES``,
chosen by :func:`arch_for_model`). The port's ResNet keeps torchvision's
module names, so its map is the ``backbone.`` prefix and the gates'
renames: the reference's SE convolutions (``conv_down``/``conv_up`` on the
block, or under ``selayer``) to ``se.fc_down``/``se.fc_up``, CBAM's
``ChannelGate.mlp.{1,3}`` and ``SpatialGate.spatial.{conv,bn}`` to flax's
names; the SASA layer is named ``conv2`` with the reference's names, and
the shuffle gate's ``sa.*`` map as they are. The port's Conformer keeps
the reference's names, so its map is the identity. Every other port model
(EfficientNet, DenseNet, Swin, SwinMLP, CoAtNet, ViT-LSA) keeps flax's
names, so the reference's module paths (timm 0.5.4's, MSR Swin's, the
reference's own) are renamed with the JAX package's rules, in their order,
then prefixed. Where the reference holds the same elements in another
shape (SwinMLP's grouped ``Conv1d`` ``spatial_mlp``, ``(heads · ws², ws²,
1)``; the shuffle gate's ``(1, C, 1, 1)`` weights) the tensor is reshaped
to the port's (``_RESHAPE_PATHS``). Each family skips its heads (the
ResNet's ``fc``/``head``/``classifier``, the Conformer's
``conv_cls_head``, ``trans_cls_head`` and ``pooling``, ...) whatever their
shape, and the buffers the port rebuilds (Swin's
``relative_position_index`` and ``attn_mask``, CoAtNet's
``relative_index``).
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
# timm 0.5.4 / MSR Swin and SwinMLP
_SWIN_RENAMES = (
    (r"^patch_embed\.proj", r"patch_embed"),
    (r"^patch_embed\.norm", r"patch_norm"),
    (r"^layers\.(\d+)\.blocks\.(\d+)\.", r"stage\1_block\2."),
    (r"^layers\.(\d+)\.downsample\.", r"merge\1."),
    (r"\.mlp\.fc1", r".mlp_fc1"),
    (r"\.mlp\.fc2", r".mlp_fc2"),
)
_SWIN_HEADS = (r"^head\b", r"^fc1\b", r"^fc2\b", r"^bn\b",
               r"^absolute_pos_embed$")
# family → (the prefix of its port names, its skips (heads, and buffers
# the port rebuilds), the renames of its module paths); the JAX package's
# ckpt/torch_import.py::_ARCHES
_ARCHES = {
    "resnet": ("backbone.", (r"^fc\b", r"^head\b", r"^classifier\b"), (
        (r"^(layer\d+\.\d+)\.selayer\.conv_down", r"\1.se.fc_down"),
        (r"^(layer\d+\.\d+)\.selayer\.conv_up", r"\1.se.fc_up"),
        (r"^(layer\d+\.\d+)\.conv_down", r"\1.se.fc_down"),
        (r"^(layer\d+\.\d+)\.conv_up", r"\1.se.fc_up"),
        (r"\.cbam\.ChannelGate\.mlp\.1", r".cbam.mlp_fc1"),
        (r"\.cbam\.ChannelGate\.mlp\.3", r".cbam.mlp_fc2"),
        (r"\.cbam\.SpatialGate\.spatial\.conv", r".cbam.spatial_conv"),
        (r"\.cbam\.SpatialGate\.spatial\.bn", r".cbam.spatial_bn"),
    )),
    "vit_lsa": ("backbone.", (r"^mlp_head\b",), (
        (r"^to_patch_embedding\.to_patch_tokens\.1",
         r"to_patch_embedding.norm"),
        (r"^to_patch_embedding\.to_patch_tokens\.2",
         r"to_patch_embedding.proj"),
        (r"^transformer\.layers\.(\d+)\.0\.norm", r"norm1_\1"),
        (r"^transformer\.layers\.(\d+)\.0\.fn\.to_out\.0", r"attn_\1.to_out"),
        (r"^transformer\.layers\.(\d+)\.0\.fn\.to_qkv", r"attn_\1.to_qkv"),
        (r"^transformer\.layers\.(\d+)\.0\.fn", r"attn_\1"),
        (r"^transformer\.layers\.(\d+)\.1\.norm", r"norm2_\1"),
        (r"^transformer\.layers\.(\d+)\.1\.fn\.net\.0", r"mlp1_\1"),
        (r"^transformer\.layers\.(\d+)\.1\.fn\.net\.3", r"mlp2_\1"),
    )),
    "coatnet": ("backbone.", (r"^fc1\b", r"^fc2\b", r"relative_index$"), (
        (r"^s0\.(\d+)\.0", r"s0_conv\1"),
        (r"^s0\.(\d+)\.1", r"s0_bn\1"),
        (r"^s(\d)\.(\d+)\.conv\.norm", r"s\1_block\2.pre_bn"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.0", r"s\1_block\2.pw"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.1", r"s\1_block\2.bn1"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.3", r"s\1_block\2.dw"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.4", r"s\1_block\2.bn2"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.6\.fc\.0", r"s\1_block\2.se_fc1"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.6\.fc\.2", r"s\1_block\2.se_fc2"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.7", r"s\1_block\2.pw_linear"),
        (r"^s(\d)\.(\d+)\.conv\.fn\.8", r"s\1_block\2.bn3"),
        (r"^s(\d)\.(\d+)\.attn\.1\.norm", r"s\1_block\2.attn_norm"),
        (r"^s(\d)\.(\d+)\.attn\.1\.fn\.to_out\.0", r"s\1_block\2.attn.to_out"),
        (r"^s(\d)\.(\d+)\.attn\.1\.fn", r"s\1_block\2.attn"),
        (r"^s(\d)\.(\d+)\.ff\.1\.norm", r"s\1_block\2.ff_norm"),
        (r"^s(\d)\.(\d+)\.ff\.1\.fn\.net\.0", r"s\1_block\2.ff1"),
        (r"^s(\d)\.(\d+)\.ff\.1\.fn\.net\.3", r"s\1_block\2.ff2"),
        (r"^s(\d)\.(\d+)\.proj", r"s\1_block\2.proj"),
    )),
    "densenet": ("backbone.", (r"^classifier\b",), (
        (r"^features\.denseblock(\d+)\.denselayer(\d+)\.",
         r"block\1_layer\2."),
        (r"^features\.transition(\d+)\.", r"transition\1."),
        (r"^features\.norm5", r"norm_final"),
        (r"^features\.", r""),
    )),
    "swin": ("backbone.", _SWIN_HEADS + (r"relative_position_index$",
                                         r"attn_mask$"), _SWIN_RENAMES),
    "swin_mlp": ("backbone.", _SWIN_HEADS, _SWIN_RENAMES),
    "conformer": ("", (r"^conv_cls_head\b", r"^trans_cls_head\b",
                       r"^pooling\b"), ()),
    "efficientnet": ("backbone.", (r"^classifier\b",), _EFFICIENTNET_RENAMES),
}
# renamed module paths whose reference tensors hold the port's elements in
# another shape, matched against the path's last component
_RESHAPE_PATHS = {"swin_mlp": re.compile(r"^spatial_mlp$"),
                  "resnet": re.compile(r"^sa$")}


def arch_for_model(name: str) -> str:
    """``MODEL.NAME`` → its family in ``_ARCHES``."""
    name = str(name)
    for prefixes, arch in ((("resnet", "seresnext"), "resnet"),
                           (("densenet",), "densenet"),
                           (("swin_mlp",), "swin_mlp"), (("swin",), "swin"),
                           (("conformer",), "conformer"),
                           (("efficientnet",), "efficientnet"),
                           (("vit",), "vit_lsa"), (("coatnet",), "coatnet")):
        if name.startswith(prefixes):
            return arch
    raise NotImplementedError(
        f"no torch import key map for '{name}'; supported families: "
        f"{sorted(_ARCHES)}")


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


def import_torch_state(dst: Mapping[str, torch.Tensor],
                       state_dict: Mapping[str, torch.Tensor],
                       model_name: str = "resnet"):
    """A reference state dict onto the port's names: ``module.`` and
    ``model.`` wrappers stripped, heads, buffers, ``num_batches_tracked``
    and aliases skipped, the family's module renames applied, its prefix
    prepended, a reshaped path's tensor reshaped to the port's shape.
    Returns ``(new state, imported, shape mismatches, unmapped keys)``."""
    arch = arch_for_model(model_name)
    prefix, skips, renames = _ARCHES[arch]
    reshape = _RESHAPE_PATHS.get(arch)
    mapped, mismatch, unmapped = {}, [], []
    for tkey, value in state_dict.items():
        key = tkey
        for wrap in ("module.", "model."):
            if key.startswith(wrap):
                key = key[len(wrap):]
        if (_ALIAS_RE.match(key) or key.endswith("num_batches_tracked")
                or any(re.search(skip, key) for skip in skips)):
            continue
        module, _, leaf = key.rpartition(".")
        for pattern, repl in renames:
            module = re.sub(pattern, repl, module)
        name = prefix + (f"{module}.{leaf}" if module else leaf)
        if name not in dst:
            unmapped.append(tkey)
            continue
        if (reshape is not None and reshape.match(module.rpartition(".")[2])
                and value.numel() == dst[name].numel()):
            value = value.reshape(dst[name].shape)
        if tuple(value.shape) != tuple(dst[name].shape):
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
        family = arch_for_model(model_name)
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
