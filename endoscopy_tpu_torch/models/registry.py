"""``build_model`` for the port (subset of ``endoscopy_tpu/models/registry.py``).

Only the plain classifier over ``resnet50`` and ``resnet_tiny`` is ported;
every other backbone or wrapper raises and points at the port queue in
ROADMAP.md.
"""

from __future__ import annotations

from torch import nn

from endoscopy_tpu_torch.config.loader import is_none
from endoscopy_tpu_torch.models import resnet
from endoscopy_tpu_torch.models.heads import ClassifierHead, LinearHead

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


def build_model(config) -> ClassifierHead:
    """Backbone + linear head for a config, with float32 parameters."""
    if config.MODEL.TYPE_SEMI == "CoMatch" or bool(config.MODEL.IS_TRIPLET):
        raise _not_ported("the ModelwEmb wrapper (CoMatch / triplet)")
    if not is_none(config.MODEL.MARGIN):
        raise _not_ported("the bias-free margin head")
    backbone = create_backbone(config.MODEL.NAME)
    head = LinearHead(backbone.num_features, int(config.MODEL.NUM_CLASSES))
    return ClassifierHead(backbone, head)
