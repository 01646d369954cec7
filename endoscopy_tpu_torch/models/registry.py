"""``build_model`` for the port (port of ``endoscopy_tpu/models/registry.py``).

Every name of the JAX registry: the ResNets (``resnet50``, ``resnet101``,
the SE-ResNets, ``seresnext50``, ``resnet50cbam``, ``resnet50sa``,
``resnet50sasa``, ``resnet_tiny``), DenseNet-121/161, EfficientNet-B0/B1,
Swin-T (also ``swin`` and ``swin_tiny_patch4_window7_224``) and Swin-S,
SwinMLP (``swin_mlp``), CoAtNet-0 (``coatnet``), ViT-LSA (``vit_lsa``),
under the plain classifier or, for CoMatch and ``MODEL.IS_TRIPLET``,
under ``ModelwEmb``; and ``conformer``, the dual-head Conformer with its
own heads (Conformer-Ti, or the
``MODEL.{EMBED_DIM,DEPTH,NUM_HEADS,MLP_RATIO,PATCH_SIZE,CHANNEL_RATIO}``
overrides). The backbones in ``_SIZED`` are built for ``DATA.IMG_SIZE``:
flax sizes their parameters or constants from the input at init. With
``MODEL.MARGIN`` the plain classifier's linear head is bias-free (the
margin losses' fc).
"""

from __future__ import annotations

from torch import nn

from endoscopy_tpu_torch.config.loader import is_none
from endoscopy_tpu_torch.models import (coatnet, conformer, densenet,
                                        efficientnet, resnet, swin, swin_mlp,
                                        vit_lsa)
from endoscopy_tpu_torch.models.heads import ClassifierHead, build_head
from endoscopy_tpu_torch.models.modelwemb import ModelwEmb

_REGISTRY = {
    "resnet_tiny": resnet.resnet_tiny,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet50se": resnet.resnet50se,
    "resnet101se": resnet.resnet101se,
    "resnet152se": resnet.resnet152se,
    "seresnext50": resnet.seresnext50,
    "resnet50cbam": resnet.resnet50cbam,
    "resnet50sa": resnet.resnet50sa,
    "resnet50sasa": resnet.resnet50sasa,
    "densenet121": densenet.densenet121,
    "densenet161": densenet.densenet161,
    "efficientnet_b0": efficientnet.efficientnet_b0,
    "efficientnet_b1": efficientnet.efficientnet_b1,
    "swin": swin.swin_tiny,
    "swin_tiny_patch4_window7_224": swin.swin_tiny,
    "swin_small": swin.swin_small,
    "swin_mlp": swin_mlp.swin_mlp_tiny,
    "coatnet": coatnet.coatnet_0,
    "vit_lsa": vit_lsa.vit_lsa_small,
    "conformer": conformer.conformer_tiny,
}

# MODEL key → Conformer field
CONFORMER_FIELDS = (("EMBED_DIM", "embed_dim"), ("DEPTH", "depth"),
                     ("NUM_HEADS", "num_heads"), ("MLP_RATIO", "mlp_ratio"),
                     ("PATCH_SIZE", "patch_size"),
                     ("CHANNEL_RATIO", "channel_ratio"))


# backbones built for the input side (flax sizes them from the input at
# init): SASA's relative encodings, Swin's and SwinMLP's windows (and
# Swin's masks), CoAtNet's bias tables, ViT-LSA's position embedding
_SIZED = {"resnet50sasa", "swin", "swin_tiny_patch4_window7_224",
          "swin_small", "swin_mlp", "coatnet", "vit_lsa"}


def list_models():
    return sorted(_REGISTRY)


def create_backbone(name: str, img_size: int = 224) -> nn.Module:
    if name not in _REGISTRY:
        raise ValueError(f"unknown model '{name}'; known: {list_models()}")
    if name in _SIZED:
        return _REGISTRY[name](img_size=img_size)
    return _REGISTRY[name]()


def build_model(config) -> nn.Module:
    """The config's model with float32 parameters: the Conformer with its
    two heads, ``ModelwEmb`` for CoMatch and the triplet branch, else
    backbone + linear head."""
    num_classes = int(config.MODEL.NUM_CLASSES)
    if config.MODEL.NAME == "conformer":
        overrides = {attr: config.MODEL[key] for key, attr in CONFORMER_FIELDS
                     if not is_none(config.MODEL.get(key))}
        return conformer.Conformer(num_classes=num_classes, **overrides)
    backbone = create_backbone(config.MODEL.NAME,
                               int(config.DATA.IMG_SIZE))
    if config.MODEL.TYPE_SEMI == "CoMatch" or bool(config.MODEL.IS_TRIPLET):
        return ModelwEmb(backbone, num_classes, int(config.MODEL.LOW_DIM))
    return ClassifierHead(backbone, build_head(
        backbone.num_features, num_classes,
        use_bias=is_none(config.MODEL.MARGIN)))
