from endoscopy_tpu_torch.models.registry import build_model, create_backbone

__all__ = ["build_model", "create_backbone"]
