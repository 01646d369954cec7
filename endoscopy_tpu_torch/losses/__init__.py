from endoscopy_tpu_torch.losses.classification import (
    balanced_class_weights, ce_loss, cross_entropy, effective_number_weights,
    poly_loss, rdw_weights, soft_ce_loss)
from endoscopy_tpu_torch.losses.consistency import consistency_loss
from endoscopy_tpu_torch.losses.triplet import triplet_loss

__all__ = ["balanced_class_weights", "ce_loss", "consistency_loss",
           "cross_entropy", "effective_number_weights", "poly_loss",
           "rdw_weights", "soft_ce_loss", "triplet_loss"]
