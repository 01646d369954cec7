from endoscopy_tpu_torch.losses.classification import (
    balanced_class_weights, ce_loss, cross_entropy, effective_number_weights,
    focal_loss, label_smoothing_loss, ldam_loss, poly_bce_loss, poly_loss,
    rdw_weights, soft_ce_loss)
from endoscopy_tpu_torch.losses.consistency import consistency_loss
from endoscopy_tpu_torch.losses.margin import angular_penalty_loss, g_theta
from endoscopy_tpu_torch.losses.triplet import triplet_loss

__all__ = ["balanced_class_weights", "ce_loss", "cross_entropy",
           "effective_number_weights", "focal_loss", "label_smoothing_loss",
           "ldam_loss", "poly_bce_loss", "poly_loss", "rdw_weights",
           "soft_ce_loss", "consistency_loss", "angular_penalty_loss",
           "g_theta", "triplet_loss"]
