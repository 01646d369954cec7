"""SemiFormer trainer (port of ``endoscopy_tpu/train/semiformer.py``).

FixMatch for the dual-head Conformer (``models/conformer.py``), in two
phases:

- warmup, epochs before ``TRAIN.EVAL_STEP_SUP``: the labeled train view,
  then the class-weighted CE of both heads summed; an epoch sweeps the
  labeled set once, in ``len(labeled) // BATCH_SIZE`` steps (at least
  one). ``TRAIN.GRAD_ACCUM`` never splits it;
- the FixMatch phase, later epochs of ``TRAIN.EVAL_STEP`` steps: the
  labeled view and ``fixmatch_views`` (the strong view through the CUDA
  RandAugment kernel, crop-fused with the reflect pad in its load) feed
  **one** forward over ``cat([x_lb, u_weak, u_strong])``; pseudo-labels
  come from the **conv** head's weak logits and drive the consistency loss
  on both heads' strong logits; the loss is ``lx_conv + lx_trans +
  LAMBDA_U · (lu_conv + lu_trans)``. ``GRAD_ACCUM`` splits this phase as
  it splits FixMatch's step (``train/fixmatch.py``), whose view, microbatch
  and update machinery this trainer shares.

Both phases end in the same update: the freeze mask, the optimizer at the
scheduled rate and the EMA (``BaseTrainer._apply_grads``). Evaluation takes
the softmax of ``conv + trans`` and the loss ``ce(conv) + ce(trans)``;
``evaluate_one``, ``test_one``, ``inference`` and the ``evaluate`` and
``pseudo_label`` CLIs reach it through the base class. The Conformer has
no dropout, so a step's only draws are its views'.

Reference behaviour kept: ``fit`` logs images/s as ``EVAL_STEP`` steps of
``B · (1 + 2 · MU)`` images in warmup epochs too, where an epoch really
takes ``len(labeled) // B`` steps of ``B`` images.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from endoscopy_tpu_torch.aug.views import labeled_draws, labeled_train_view
from endoscopy_tpu_torch.losses import ce_loss, consistency_loss, cross_entropy
from endoscopy_tpu_torch.train.common import sweep_steps
from endoscopy_tpu_torch.train.fixmatch import FixMatch
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter


class SemiFormer(FixMatch):
    """``get_dataloader((labeled_loader, unlabeled_loader), valid_dl)``,
    each train loader yielding ``(canonical uint8 NHWC batch, targets)``
    (the labeled one with a ``manifest`` for the warmup's step count), then
    ``get_config(config, labeled_targets)`` and ``train_one(epoch)``."""

    trainer_name = "SemiFormer"

    def get_config(self, config,
                   labeled_targets: Optional[np.ndarray] = None) -> None:
        super().get_config(config, labeled_targets)
        self.eval_step_sup = int(config.TRAIN.EVAL_STEP_SUP)

    # -- the steps ---------------------------------------------------------

    def _heads(self, x: torch.Tensor):
        """``(conv, trans)`` float32 logits of an NHWC batch, train mode."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            conv, trans = self.state.model(x.permute(0, 3, 1, 2))
        return conv.float(), trans.float()

    @staticmethod
    def _lx(conv, trans, targets, weights) -> torch.Tensor:
        """The class-weighted CE of both heads, summed."""
        return (ce_loss(conv, targets, class_weights=weights, reduction="mean")
                + ce_loss(trans, targets, class_weights=weights,
                          reduction="mean"))

    def _warmup_forward_backward(self, x, targets, weights) -> torch.Tensor:
        loss = self._lx(*self._heads(x), targets, weights)
        self._backward(loss)
        return loss.detach()[None]

    def _warmup_core(self, x, targets, weights) -> torch.Tensor:
        """One warmup step on a precomputed labeled view; the loss."""
        return self._accumulate([(x, targets, weights)],
                                self._warmup_forward_backward)[0]

    def _warmup_step(self, x_lb_u8, targets, weights) -> torch.Tensor:
        """One warmup step from the canonical uint8 batch."""
        with trace.span("step/views"):
            draws = labeled_draws(self.generator,
                                  self.group.world * len(x_lb_u8))
            x = labeled_train_view(x_lb_u8, self.img_size, self.dtype,
                                   device=self.device,
                                   **self._rank_draws(draws))
        return self._warmup_core(x, self._to_device(targets), weights)

    def _forward_backward(self, x_lb, u_weak, u_strong, targets,
                          weights) -> torch.Tensor:
        """The FixMatch phase's forward, losses and backward. Returns the
        detached ``[loss, lx, lu_conv + lu_trans, mask_mean]``."""
        bs_lb, btu = x_lb.shape[0], u_weak.shape[0]
        conv, trans = self._heads(torch.cat([x_lb, u_weak, u_strong]))
        lx = self._lx(conv[:bs_lb], trans[:bs_lb], targets, weights)
        conv_weak = conv[bs_lb:bs_lb + btu]
        lu_conv, _ = consistency_loss(conv_weak, conv[bs_lb + btu:], T=self.T,
                                      p_cutoff=self.thres)
        lu_trans, mask_mean = consistency_loss(
            conv_weak, trans[bs_lb + btu:], T=self.T, p_cutoff=self.thres)
        lu = lu_conv + lu_trans
        loss = lx + self.lambda_u * lu
        self._backward(loss)
        return torch.stack([loss, lx, lu, mask_mean]).detach()

    @staticmethod
    def _eval_loss_probs(out, targets):
        """``ce(conv) + ce(trans)`` per row and ``softmax(conv + trans)``."""
        conv, trans = out[0].float(), out[1].float()
        return (cross_entropy(conv, targets, reduction="none")
                + cross_entropy(trans, targets, reduction="none"),
                torch.softmax(conv + trans, -1))

    def train_one(self, epoch: int) -> AverageMeter:
        """A warmup sweep of the labeled set before ``EVAL_STEP_SUP``, else
        ``EVAL_STEP`` FixMatch-phase steps (``BaseTrainer._run_steps``)."""
        if epoch >= self.eval_step_sup:
            return super().train_one(epoch)
        weights = self._step_weights()
        labeled = self.train_dl[0]
        bs = int(self.config.DATA.BATCH_SIZE)
        return self._run_steps(
            self._batches(sweep_steps(labeled, bs, self.device), labeled),
            lambda lb: self._warmup_step(*lb, weights), bs)
