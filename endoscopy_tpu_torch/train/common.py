"""Shared trainer machinery (subset of ``endoscopy_tpu/train/common.py``).

The trainer protocol is the reference's: ``__init__(model, opt_func)`` →
``get_dataloader(...)`` → ``get_config(config)`` → ``train_one(epoch)``.
Evaluation, checkpoints and ``fit`` are the next slice (ROADMAP.md).

- The model arrives with its weights (torch's initializers, or weights
  loaded by the caller); ``TRAIN.SEED`` seeds the trainer's
  ``torch.Generator`` on the device, which draws every view.
- "Freeze backbone" (``TRAIN.IS_FREEZE``) gives the backbone's parameters
  zero gradients; they still go through the optimizer, and their BN running
  statistics still update in train mode, as in the reference.
- On the card the step computes in bf16 autocast with ``channels_last``
  (``TRAIN.DTYPE``); on the CPU always in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from endoscopy_tpu_torch.device import resolve_device, resolve_dtype
from endoscopy_tpu_torch.losses import balanced_class_weights
from endoscopy_tpu_torch.optim import build_optimizer, build_schedule
from endoscopy_tpu_torch.ssl_state.ema import ema_init
from endoscopy_tpu_torch.train.state import TrainState


def model_logits(out):
    """Logits of a model's output: ``ModelwEmb`` returns ``(logits, fts,
    fts_low)``, a plain classifier its logits."""
    if isinstance(out, tuple):
        return out[0]
    return out


def trainable_mask(model: nn.Module, freeze_backbone: bool
                   ) -> Dict[str, bool]:
    """Parameter name → trainable. With ``freeze_backbone`` only the head's
    parameters (names outside ``backbone.``) train."""
    return {name: not (freeze_backbone and name.startswith("backbone."))
            for name, _ in model.named_parameters()}


@torch.no_grad()
def mask_grads(model: nn.Module, mask: Dict[str, bool]) -> None:
    """Zero the gradients of the parameters the mask freezes."""
    frozen = [p.grad for name, p in model.named_parameters()
              if not mask[name] and p.grad is not None]
    if frozen:
        torch._foreach_zero_(frozen)


class BaseTrainer:
    """Common state and config plumbing."""

    def __init__(self, model: Optional[nn.Module] = None,
                 opt_func: str = "Adam", device=None):
        self.device = resolve_device(device)
        self.model = model
        self.opt_func = opt_func
        self.state: Optional[TrainState] = None

    def get_dataloader(self, train_dl, valid_dl, test_dl=None) -> None:
        self.train_dl = train_dl
        self.valid_dl = valid_dl
        self.test_dl = test_dl

    def _setup_common(self, config, n_iter_per_epoch: int,
                      labeled_targets: Optional[np.ndarray]) -> None:
        self.config = config
        if bool(config.DATA.get("IS_REPROD", False)):
            raise NotImplementedError(
                "DATA.IS_REPROD (the paper-reproduction views) is not ported "
                "to endoscopy_tpu_torch yet; see the port queue in "
                "ROADMAP.md")
        self.img_size = int(config.DATA.IMG_SIZE)
        self.dtype = resolve_dtype(self.device,
                                   config.TRAIN.get("DTYPE", "bfloat16"))
        self.lr_schedule = build_schedule(config, n_iter_per_epoch)
        self.use_ema = bool(config.TRAIN.USE_EMA)
        self.ema_decay = float(config.TRAIN.EMA_DECAY)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.TRAIN.get("SEED", 42)))

        if config.TRAIN.CLS_WEIGHT and labeled_targets is not None:
            # balanced weights over the classes present
            self.class_weights = torch.as_tensor(
                balanced_class_weights(
                    labeled_targets,
                    num_classes=int(config.MODEL.NUM_CLASSES)),
                dtype=torch.float32, device=self.device)
        else:
            self.class_weights = None

    def _init_state(self) -> None:
        """The model on the device, its optimizer (built with the
        schedule's ``lr(0)``), the EMA copy and the freeze mask."""
        model = self.model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        optimizer = build_optimizer(model.named_parameters(), self.opt_func,
                                    lr=self.lr_schedule(0))
        self.state = TrainState(
            step=0, model=model, optimizer=optimizer,
            ema=ema_init(model) if self.use_ema else None)
        self.grad_mask = trainable_mask(model,
                                        bool(self.config.TRAIN.IS_FREEZE))

    @staticmethod
    def _drain_pending(pending: list, summary_loss, batch_size: int,
                       keep: int = 2) -> None:
        """Fetch all but the last ``keep`` deferred device losses into the
        meter. Fetching step N-2's loss waits until it ran, so at most
        about ``keep`` steps queue on the device while the host prepares
        the next; ``keep=0`` drains everything (epoch end)."""
        while len(pending) > keep:
            for loss in pending.pop(0).detach().flatten().tolist():
                summary_loss.update(float(loss), batch_size)
