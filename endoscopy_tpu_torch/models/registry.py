"""``build_model`` for the port (subset of ``endoscopy_tpu/models/registry.py``).

``resnet50``, ``resnet50sasa`` (its SASA layers sized for
``DATA.IMG_SIZE``), ``efficientnet_b0``/``b1`` and ``resnet_tiny`` under
the plain classifier or, for CoMatch and ``MODEL.IS_TRIPLET``, under
``ModelwEmb``; ``conformer``, the dual-head Conformer with its own heads
(Conformer-Ti, or the
``MODEL.{EMBED_DIM,DEPTH,NUM_HEADS,MLP_RATIO,PATCH_SIZE,CHANNEL_RATIO}``
overrides). Every backbone a preset under ``configs/`` names is here; the
rest of the zoo (DenseNet, Swin, CoAtNet, the SE and gated ResNets, ...)
and the bias-free margin head raise and point at the port queue in
ROADMAP.md.
"""

from __future__ import annotations

from torch import nn

from endoscopy_tpu_torch.config.loader import is_none
from endoscopy_tpu_torch.models import conformer, efficientnet, resnet
from endoscopy_tpu_torch.models.heads import ClassifierHead, build_head
from endoscopy_tpu_torch.models.modelwemb import ModelwEmb

_REGISTRY = {
    "resnet50": resnet.resnet50,
    "resnet50sasa": resnet.resnet50sasa,
    "efficientnet_b0": efficientnet.efficientnet_b0,
    "efficientnet_b1": efficientnet.efficientnet_b1,
    "resnet_tiny": resnet.resnet_tiny,
    "conformer": conformer.conformer_tiny,
}

# MODEL key → Conformer field
_CONFORMER_FIELDS = (("EMBED_DIM", "embed_dim"), ("DEPTH", "depth"),
                     ("NUM_HEADS", "num_heads"), ("MLP_RATIO", "mlp_ratio"),
                     ("PATCH_SIZE", "patch_size"),
                     ("CHANNEL_RATIO", "channel_ratio"))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to endoscopy_tpu_torch yet; see the port "
        "queue in ROADMAP.md")


# backbones whose parameters depend on the input side (flax sizes them at
# init): SASA's relative encodings
_SIZED = {"resnet50sasa"}


def create_backbone(name: str, img_size: int = 224) -> nn.Module:
    if name not in _REGISTRY:
        raise _not_ported(f"model '{name}' (ported: {sorted(_REGISTRY)})")
    if name in _SIZED:
        return _REGISTRY[name](img_size=img_size)
    return _REGISTRY[name]()


def build_model(config) -> nn.Module:
    """The config's model with float32 parameters: the Conformer with its
    two heads, ``ModelwEmb`` for CoMatch and the triplet branch, else
    backbone + linear head."""
    num_classes = int(config.MODEL.NUM_CLASSES)
    if config.MODEL.NAME == "conformer":
        overrides = {attr: config.MODEL[key] for key, attr in _CONFORMER_FIELDS
                     if not is_none(config.MODEL.get(key))}
        return conformer.Conformer(num_classes=num_classes, **overrides)
    backbone = create_backbone(config.MODEL.NAME,
                               int(config.DATA.IMG_SIZE))
    if config.MODEL.TYPE_SEMI == "CoMatch" or bool(config.MODEL.IS_TRIPLET):
        return ModelwEmb(backbone, num_classes, int(config.MODEL.LOW_DIM))
    if not is_none(config.MODEL.MARGIN):
        raise _not_ported("the bias-free margin head")
    return ClassifierHead(backbone, build_head(backbone.num_features,
                                               num_classes))
