"""``build_model`` for the port (subset of ``endoscopy_tpu/models/registry.py``).

``resnet50`` and ``resnet_tiny`` under the plain classifier or, for
CoMatch and ``MODEL.IS_TRIPLET``, under ``ModelwEmb``. Every other backbone
and the bias-free margin head raise and point at the port queue in
ROADMAP.md.
"""

from __future__ import annotations

from torch import nn

from endoscopy_tpu_torch.config.loader import is_none
from endoscopy_tpu_torch.models import resnet
from endoscopy_tpu_torch.models.heads import ClassifierHead, build_head
from endoscopy_tpu_torch.models.modelwemb import ModelwEmb

_REGISTRY = {
    "resnet50": resnet.resnet50,
    "resnet_tiny": resnet.resnet_tiny,
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to endoscopy_tpu_torch yet; see the port "
        "queue in ROADMAP.md")


def create_backbone(name: str) -> nn.Module:
    if name not in _REGISTRY:
        raise _not_ported(f"model '{name}' (ported: {sorted(_REGISTRY)})")
    return _REGISTRY[name]()


def build_model(config) -> nn.Module:
    """The config's model with float32 parameters: ``ModelwEmb`` for
    CoMatch and the triplet branch, else backbone + linear head."""
    num_classes = int(config.MODEL.NUM_CLASSES)
    backbone = create_backbone(config.MODEL.NAME)
    if config.MODEL.TYPE_SEMI == "CoMatch" or bool(config.MODEL.IS_TRIPLET):
        return ModelwEmb(backbone, num_classes, int(config.MODEL.LOW_DIM))
    if not is_none(config.MODEL.MARGIN):
        raise _not_ported("the bias-free margin head")
    return ClassifierHead(backbone, build_head(backbone.num_features,
                                               num_classes))
