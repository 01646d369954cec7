"""FixMatch trainer (port of ``endoscopy_tpu/train/fixmatch.py``).

One step: the labeled train view and the weak and strong views from two
canonical uint8 batches on the device (the strong view through the CUDA
RandAugment kernel), **one** forward over ``cat([x_lb, u_weak,
u_strong])`` so that BN statistics span all the step's images, poly-CE on
the labeled logits, the masked consistency loss, ``lx + LAMBDA_U * lu``,
backward, the freeze mask, the optimizer at the scheduled learning rate,
and the EMA teacher update.

``TRAIN.GRAD_ACCUM`` > 1 splits the step into that many microbatches, each
with its own views; BN running statistics thread through them, gradients
sum in float32 and are divided by the count, loss and aux are averaged,
and one optimizer and EMA update follows (the step count moves by one).

``TRAIN.STEPS_PER_CALL`` has no counterpart here: it amortizes the JAX
package's dispatch with a ``lax.scan`` over steps, which eager PyTorch has
no use for, so it is ignored. An MLP head (``ModelwEmb``) draws its
dropout from the trainer's generator (``BaseTrainer._init_state``); a
linear head makes no draw.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from endoscopy_tpu_torch.aug.views import (fixmatch_draws, fixmatch_views,
                                           labeled_draws, labeled_train_view)
from endoscopy_tpu_torch.losses import ce_loss, consistency_loss
from endoscopy_tpu_torch.models.heads import model_logits
from endoscopy_tpu_torch.train.common import BaseTrainer
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter

Micro = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class FixMatch(BaseTrainer):
    """``get_dataloader((labeled_loader, unlabeled_loader), valid_dl)``,
    each train loader yielding ``(canonical uint8 NHWC batch, targets)``,
    then ``get_config(config, labeled_targets)`` and ``train_one(epoch)``."""

    trainer_name = "FixMatch"

    def get_config(self, config,
                   labeled_targets: Optional[np.ndarray] = None) -> None:
        self._setup_common(config, int(config.TRAIN.EVAL_STEP),
                           labeled_targets)
        self.lambda_u = float(config.TRAIN.LAMBDA_U)
        self.thres = float(config.TRAIN.THRES)
        self.T = float(config.TRAIN.T)
        self.grad_accum = max(1, int(config.TRAIN.get("GRAD_ACCUM", 1)))
        self._init_state()

    # -- the step ----------------------------------------------------------

    def _views(self, x_lb_u8, u_canon_u8):
        """(x_lb, u_weak, u_strong) on the device, drawn from the
        trainer's generator for the global batch (this rank's rows in a
        group); the span ``step/views``."""
        g, world = self.generator, self.group.world
        with trace.span("step/views"):
            x_lb = labeled_train_view(
                x_lb_u8, self.img_size, self.dtype, device=self.device,
                **self._rank_draws(labeled_draws(g, world * len(x_lb_u8))))
            u_weak, u_strong = fixmatch_views(
                u_canon_u8, self.img_size, self.dtype, device=self.device,
                **self._rank_draws(fixmatch_draws(g, world * len(u_canon_u8),
                                                  self.img_size)))
        return x_lb, u_weak, u_strong

    def _forward_backward(self, x_lb, u_weak, u_strong, targets,
                          weights) -> torch.Tensor:
        """One concat forward, the losses and the backward; gradients add
        into ``.grad``. Returns the detached ``[loss, lx, lu, mask_mean]``."""
        model = self.state.model
        bs_lb, btu = x_lb.shape[0], u_weak.shape[0]
        self._layout(bs_lb, btu, btu)
        inputs = torch.cat([x_lb, u_weak, u_strong]).permute(0, 3, 1, 2)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = model(inputs)
        logits = model_logits(out)
        logits = logits.float()
        lx = ce_loss(logits[:bs_lb], targets, class_weights=weights,
                     reduction="mean", type_loss="poly")
        lu, mask_mean = consistency_loss(logits[bs_lb:bs_lb + btu],
                                         logits[bs_lb + btu:], T=self.T,
                                         p_cutoff=self.thres)
        loss = lx + self.lambda_u * lu
        self._backward(loss)
        return torch.stack([loss, lx, lu, mask_mean]).detach()

    def _train_micro(self, micro: Iterable[Micro], weights):
        """Forward and backward over each microbatch, then one update on
        the mean gradient. Returns ``(loss, (lx, lu, mask_mean))``,
        device tensors averaged over the microbatches."""
        total = self._accumulate(((*m, weights) for m in micro),
                                 self._forward_backward)
        return total[0], (total[1], total[2], total[3])

    def _train_core(self, x_lb, u_weak, u_strong, targets, weights):
        """Everything after the views: one step on precomputed views."""
        return self._train_micro([(x_lb, u_weak, u_strong, targets)],
                                 weights)

    def _train_step(self, x_lb_u8, targets, u_canon_u8, weights):
        """One step from the canonical uint8 batches, in ``grad_accum``
        microbatches, each with its own views."""
        accum = self.grad_accum
        x = torch.as_tensor(x_lb_u8)
        u = torch.as_tensor(u_canon_u8)
        t = self._to_device(targets)
        if x.shape[0] % accum or u.shape[0] % accum:
            raise ValueError(f"TRAIN.GRAD_ACCUM={accum} does not divide the "
                             f"batches ({x.shape[0]} labeled, {u.shape[0]} "
                             "unlabeled)")

        def micro():
            for x_m, t_m, u_m in zip(x.chunk(accum), t.chunk(accum),
                                     u.chunk(accum)):
                yield (*self._views(x_m, u_m), t_m)

        return self._train_micro(micro(), weights)

    def train_one(self, epoch: int) -> AverageMeter:
        """``TRAIN.EVAL_STEP`` steps (``BaseTrainer._run_steps``)."""
        weights = self._step_weights()
        return self._run_steps(
            self._batches(int(self.config.TRAIN.EVAL_STEP), *self.train_dl),
            lambda lb, ul: self._train_step(*lb, ul[0], weights)[0],
            int(self.config.DATA.BATCH_SIZE))
