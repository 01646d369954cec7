"""CoMatch trainer (port of ``endoscopy_tpu/train/comatch.py``).

One step: the labeled train view and CoMatch's three views of the
unlabeled batch on the device (weak; strong-0 through the CUDA
RandAugment kernel in plain mode; strong-1, the colour jitter), **one**
forward of ``ModelwEmb`` over ``cat([x, u_w, u_s0, u_s1])`` so that BN
statistics span all the step's images, then:

- poly-CE with the class weights on the labeled logits;
- without gradient: softmax of the weak logits, distribution alignment
  over the filled rows of the 32-row ring, renormalize, memory smoothing
  ``alpha · probs + (1 - alpha) · softmax(feats · queue_featsᵀ / T) ·
  queue_probs`` when the gate is open, the THRES mask, and the queue write
  under ``n == queue_size`` (``ssl_state/comatch_state.py``);
- the graph loss: the two strong views' embeddings at temperature 0.2
  against ``Q = probs · probsᵀ`` with its diagonal set to 1, masked at
  ``Q >= 0.8`` and row-normalized;
- the focal unsupervised CE (gamma 2) of the strong-0 logits on ``probs``
  under the mask;
- ``lx + LAMBDA_U · lu + LAMBDA_C · lc``, backward, the freeze mask, the
  optimizer at the scheduled rate and the EMA teacher update.

The weak logits and the labeled and weak embeddings are detached; the two
strong views' embeddings carry the gradient. ``ModelwEmb``'s heads run in
float32 with autocast off, and its MLP head draws its dropout from the
trainer's generator.

Reference behaviour kept as it is: the queue write fires only when one
step's ``(MU + 1) · B`` rows equal the whole queue, ``queue_batch · (MU +
1) · B``; with ``queue_batch`` 5 it never does, the bank stays zero, and
open smoothing scales the probabilities by ``alpha``. The smoothing gate
is ``epoch > 0 or batch_idx > queue_batch``; ``fit`` counts epochs from
1, so there it is always open. ``TRAIN.GRAD_ACCUM`` > 1 is refused (the
graph loss couples the whole batch). ``TRAIN.STEPS_PER_CALL`` is ignored,
as in ``train/fixmatch.py``. The CoMatch state is not checkpointed.

In a process group the batch-wide numbers span the global batch: the DA
ring takes the global mean of the weak probabilities, the pseudo-label
graph and the strong embeddings' similarity have a column for every
unlabeled row of the global batch (the strong-1 embeddings gathered with
their gradient), the queue's gate counts the global rows and the write is
the global rows in rank order, so every rank holds the same state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.aug.views import (comatch_draws, comatch_views,
                                           labeled_draws, labeled_train_view)
from endoscopy_tpu_torch.losses import ce_loss
from endoscopy_tpu_torch.parallel import (all_gather_rows, batch_mean,
                                          global_mean)
from endoscopy_tpu_torch.ssl_state.comatch_state import (CoMatchState,
                                                         comatch_state_init)
from endoscopy_tpu_torch.train.common import BaseTrainer
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, start: torch.Tensor
                ) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, rows, (start, 0))``: the start
    clamped so that the rows fit."""
    n = rows.shape[0]
    start = torch.clamp(start, 0, buf.shape[0] - n)
    idx = start + torch.arange(n, device=buf.device)
    return buf.index_copy(0, idx, rows)


class CoMatch(BaseTrainer):
    """``get_dataloader((labeled_loader, unlabeled_loader), valid_dl)``,
    each train loader yielding ``(canonical uint8 NHWC batch, targets)``,
    then ``get_config(config, labeled_targets)`` and ``train_one(epoch)``."""

    trainer_name = "CoMatch"

    # fixed hyperparameters of the reference
    queue_batch = 5
    alpha = 0.9
    temperature = 0.2
    contrast_th = 0.8
    gamma = 2.0

    def _images_per_step(self) -> int:
        """The labeled batch and three views of the unlabeled one."""
        return int(self.config.DATA.BATCH_SIZE) * (
            1 + 3 * int(self.config.DATA.MU))

    def get_config(self, config,
                   labeled_targets: Optional[np.ndarray] = None) -> None:
        self._setup_common(config, int(config.TRAIN.EVAL_STEP),
                           labeled_targets)
        self.lambda_u = float(config.TRAIN.LAMBDA_U)
        self.lambda_c = float(config.TRAIN.LAMBDA_C)
        self.thres = float(config.TRAIN.THRES)
        self.low_dim = int(config.MODEL.LOW_DIM)
        self.num_classes = int(config.MODEL.NUM_CLASSES)
        self.queue_size = self.queue_batch * (
            int(config.DATA.MU) + 1) * int(config.DATA.BATCH_SIZE)
        if int(config.TRAIN.get("GRAD_ACCUM", 1)) > 1:
            raise ValueError(
                "TRAIN.GRAD_ACCUM > 1 is not supported for CoMatch: the "
                "graph-contrastive loss couples the whole batch. Use it with "
                "SupLearning / FixMatch / SemiFormer, or lower BATCH_SIZE.")
        self._init_state()
        self.comatch_state = comatch_state_init(
            self.queue_size, self.low_dim, self.num_classes, self.device)

    # -- the step ----------------------------------------------------------

    def _views(self, x_lb_u8, u_canon_u8):
        """(x_lb, u_weak, u_strong0, u_strong1) on the device, drawn from
        the trainer's generator for the global batch (this rank's rows in
        a group); the span ``step/views``."""
        g, world = self.generator, self.group.world
        with trace.span("step/views"):
            x_lb = labeled_train_view(
                x_lb_u8, self.img_size, self.dtype, device=self.device,
                **self._rank_draws(labeled_draws(g, world * len(x_lb_u8))))
            return (x_lb, *comatch_views(
                u_canon_u8, self.img_size, self.dtype, device=self.device,
                **self._rank_draws(comatch_draws(g, world * len(u_canon_u8),
                                                 self.img_size))))

    @torch.no_grad()
    def _pseudo_and_state(self, logits_u_w, feats_u_w, feats_x, targets,
                          use_queue: bool):
        """DA → memory smoothing → the THRES mask → the queue write.
        Returns ``(probs, mask)`` and moves ``comatch_state`` on."""
        cs = self.comatch_state
        probs = torch.softmax(logits_u_w, dim=-1)

        da_buffer = _write_rows(cs.da_buffer, global_mean(probs)[None],
                                cs.da_ptr)
        da_len = da_buffer.shape[0]
        da_count = torch.clamp(cs.da_count + 1, max=da_len)
        da_ptr = (cs.da_ptr + 1) % da_len
        filled = (torch.arange(da_len, device=da_buffer.device)
                  < da_count)[:, None]
        prob_avg = (da_buffer * filled).sum(0) / torch.clamp(da_count, min=1)
        probs = probs / prob_avg
        probs = probs / probs.sum(1, keepdim=True)
        probs_orig = probs

        if use_queue:
            a = torch.exp(feats_u_w @ cs.queue_feats.T / self.temperature)
            a = a / a.sum(1, keepdim=True)
            probs = (self.alpha * probs
                     + (1 - self.alpha) * (a @ cs.queue_probs))
        mask = (probs.amax(1) >= self.thres).float()

        queue_feats, queue_probs, queue_ptr = (cs.queue_feats,
                                               cs.queue_probs, cs.queue_ptr)
        n = self.group.world * (feats_u_w.shape[0] + feats_x.shape[0])
        if n == self.queue_size:  # the global rows, in rank order
            feats_w = torch.cat([all_gather_rows(feats_u_w),
                                 all_gather_rows(feats_x)])
            onehot = F.one_hot(all_gather_rows(targets),
                               self.num_classes).float()
            queue_feats = _write_rows(queue_feats, feats_w, queue_ptr)
            queue_probs = _write_rows(
                queue_probs, torch.cat([all_gather_rows(probs_orig), onehot]),
                queue_ptr)
            queue_ptr = (queue_ptr + n) % self.queue_size
        self.comatch_state = CoMatchState(
            queue_feats=queue_feats, queue_probs=queue_probs,
            queue_ptr=queue_ptr, da_buffer=da_buffer, da_ptr=da_ptr,
            da_count=da_count)
        return probs, mask

    def _losses(self, logits, fts_low, bt: int, targets, weights,
                use_queue: bool) -> torch.Tensor:
        """``[loss, lx, lu, lc]`` from the step's float32 logits and
        embeddings (rows: ``bt`` labeled, then weak, strong-0, strong-1);
        runs the no-grad block, which moves ``comatch_state`` on."""
        btu = (logits.shape[0] - bt) // 3
        logits_x = logits[:bt]
        logits_u_w = logits[bt:bt + btu].detach()
        logits_u_s0 = logits[bt + btu:bt + 2 * btu]
        feats_x = fts_low[:bt].detach()
        feats_u_w = fts_low[bt:bt + btu].detach()
        feats_u_s0 = fts_low[bt + btu:bt + 2 * btu]
        feats_u_s1 = fts_low[bt + 2 * btu:]

        lx = ce_loss(logits_x, targets, class_weights=weights,
                     reduction="mean", type_loss="poly")
        probs, mask = self._pseudo_and_state(logits_u_w, feats_u_w, feats_x,
                                             targets, use_queue)

        # the embedding graph against the pseudo-label graph: this rank's
        # rows, a column for every unlabeled row of the global batch
        sim = torch.exp(feats_u_s0 @ all_gather_rows(feats_u_s1).T
                        / self.temperature)
        sim_probs = sim / sim.sum(1, keepdim=True)
        q = probs @ all_gather_rows(probs).T
        rows = torch.arange(btu, device=q.device)
        q[rows, rows + self.group.rank * btu] = 1.0  # the diagonal
        q = q * (q >= self.contrast_th).float()
        q = q / q.sum(1, keepdim=True)
        lc = batch_mean(-torch.sum(torch.log(sim_probs + 1e-7) * q, dim=1))

        # focal unsupervised CE
        logp = -torch.sum(F.log_softmax(logits_u_s0, dim=1) * probs,
                          dim=1) * mask
        p = torch.exp(-logp)
        lu = batch_mean((1 - p) ** self.gamma * logp)

        loss = lx + self.lambda_u * lu + self.lambda_c * lc
        return torch.stack([loss, lx, lu, lc])

    def _forward(self, x, u_w, u_s0, u_s1):
        """One ``ModelwEmb`` forward over ``cat([x, u_w, u_s0, u_s1])``:
        float32 ``(logits, fts_low)``."""
        inputs = torch.cat([x, u_w, u_s0, u_s1]).permute(0, 3, 1, 2)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            logits, _, fts_low = self.state.model(inputs)
        return logits.float(), fts_low.float()

    def _forward_backward(self, x, u_w, u_s0, u_s1, targets, weights,
                          use_queue: bool) -> torch.Tensor:
        """The forward, the losses and the backward; gradients add into
        ``.grad``. Returns the detached ``[loss, lx, lu, lc]``."""
        self._layout(x.shape[0], u_w.shape[0], u_w.shape[0], u_w.shape[0])
        logits, fts_low = self._forward(x, u_w, u_s0, u_s1)
        losses = self._losses(logits, fts_low, x.shape[0], targets, weights,
                              use_queue)
        self._backward(losses[0])
        return losses.detach()

    def _train_core(self, x, u_w, u_s0, u_s1, targets, weights,
                    use_queue: bool):
        """Everything after the views: one step, one update. Returns
        ``(loss, (lx, lu, lc))`` as device tensors."""
        total = self._accumulate(
            [(x, u_w, u_s0, u_s1, targets, weights, use_queue)],
            self._forward_backward)
        return total[0], (total[1], total[2], total[3])

    def _train_step(self, x_lb_u8, targets, u_canon_u8, weights,
                    use_queue: bool):
        """One step from the canonical uint8 batches."""
        return self._train_core(*self._views(x_lb_u8, u_canon_u8),
                                self._to_device(targets), weights, use_queue)

    def train_one(self, epoch: int) -> AverageMeter:
        """``TRAIN.EVAL_STEP`` steps (``BaseTrainer._run_steps``) with the
        smoothing gate ``epoch > 0 or batch_idx > queue_batch``."""
        weights = self._step_weights()

        def step(batch_idx, batches):
            (x_lb, targets), (u_canon, _) = batches
            use_queue = epoch > 0 or batch_idx > self.queue_batch
            return self._train_step(x_lb, targets, u_canon, weights,
                                    use_queue)[0]

        return self._run_steps(
            enumerate(self._batches(int(self.config.TRAIN.EVAL_STEP),
                                    *self.train_dl)),
            step, int(self.config.DATA.BATCH_SIZE))
