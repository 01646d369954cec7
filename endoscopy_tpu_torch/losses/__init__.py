from endoscopy_tpu_torch.losses.classification import (
    balanced_class_weights, ce_loss, cross_entropy, poly_loss, soft_ce_loss)
from endoscopy_tpu_torch.losses.consistency import consistency_loss

__all__ = ["balanced_class_weights", "ce_loss", "consistency_loss",
           "cross_entropy", "poly_loss", "soft_ce_loss"]
