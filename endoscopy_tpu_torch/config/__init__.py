from endoscopy_tpu_torch.config.loader import (AttrDict, default_config,
                                               get_config, is_none)

__all__ = ["AttrDict", "default_config", "get_config", "is_none"]
