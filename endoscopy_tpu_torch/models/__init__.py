from endoscopy_tpu_torch.models.registry import (build_model, create_backbone,
                                                 list_models)

__all__ = ["build_model", "create_backbone", "list_models"]
