from endoscopy_tpu_torch.optim.optimizers import build_optimizer, set_lr
from endoscopy_tpu_torch.optim.schedules import build_schedule

__all__ = ["build_optimizer", "build_schedule", "set_lr"]
