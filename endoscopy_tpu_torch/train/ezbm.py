"""EZBM trainer (port of ``endoscopy_tpu/train/ezbm.py``): two-stage
balanced feature mixing on ``ModelwEmb``.

``get_dataloader(train_loader, valid_dl)`` (a ``CanonicalLoader``: its
manifest sets the steps of a stage-1 epoch, ``len(manifest) //
BATCH_SIZE`` or 1, and the triplet batch samples through its ``sample``
and ``rng``), then ``get_config(config, cls_num_list, labeled_targets)``,
then ``fit()``.

- Stage 1: the supervised trainer's triplet step, with the triplet loss
  (alpha 0.7) on the L2-normalized low-dimensional ``fts_low`` and poly-CE
  on the anchors' logits (the class weights, or ones without
  ``CLS_WEIGHT``), ``ce + LAMBDA_C · triplet``. Each step memorizes the
  anchors' pooled features of its train-mode forward and their targets;
  the memory stays on the device and is rebuilt every epoch.
- Stage 2: the ``fc`` head alone trains on memorized feature pairs. The
  sampler draws on the host with ``np.random.default_rng(SEED + epoch)``,
  in the JAX package's order: the primary's class uniform over the classes
  present, the dual's uniform (``EXPANSION: 'balance'``) or from the
  reversed class frequencies (``'reverse'``, drawn again while empty),
  then a row of each class; ``lam = n_i / (n_i + n_j)``, 0.5 for
  ``balance`` and ``1 - lam`` for ``reverse``; ``B · MU`` pairs a step and
  ``max(len // (B · MU), 1)`` steps an epoch. A step runs the head twice in
  train mode, on the features and on ``lam · f + (1 - lam) · f_dual``,
  with one dropout mask and the BN statistics moving twice, and the loss
  ``CE(out_o, y) + LAMBDA_C · (CE(out_s, y) + CE(out_s, y_dual)) / 2``.
  Every parameter outside ``fc`` gets a zero gradient, as optax updates
  every leaf: SGD's weight decay still moves them, Adam does not.
- ``fit``: stage 1 with an evaluation every ``FREQ_EVAL`` epochs (the
  loss ∧ F1 gate, no save), a stop after more than 5 misses, and a return
  on preemption; then a fresh optimizer over every parameter, whose
  schedule (stage 1's, ``n_iter_per_epoch`` steps an epoch) restarts at
  count 0, and stage 2 from ``epoch_start`` again, saving through the gate
  and stopping after more than 10 misses. The stage-2 optimizer lives
  outside ``self.state``: a checkpoint holds stage 1's moments.

``TRAIN.GRAD_ACCUM`` > 1 raises: the stage-2 pairs span the whole batch.

In a process group stage 1 is the triplet step of the supervised trainer
in a group, and at the end of each epoch the anchors' features and
targets are gathered in the global batch's row order, so every rank holds
the same memory. Stage 2 draws the global batch's pairs with numpy from
the same seed on every rank, each rank trains on its rows of them (the
head's BN over the global batch, the dropout mask drawn for it), and
``fc``'s gradients are summed over ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from endoscopy_tpu_torch.aug.views import (labeled_draws, labeled_train_view,
                                           rows_on_device)
from endoscopy_tpu_torch.losses import ce_loss, triplet_loss
from endoscopy_tpu_torch.models.heads import KEEP
from endoscopy_tpu_torch.optim import build_optimizer, set_lr
from endoscopy_tpu_torch.parallel import (all_gather_rows, all_reduce_sum,
                                          in_group, sync_grads)
from endoscopy_tpu_torch.ssl_state.ema import ema_update
from endoscopy_tpu_torch.train.common import BaseTrainer, sweep_steps
from endoscopy_tpu_torch.train.supervised import TRIPLET_ALPHA, SupLearning
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter


class EZBM(BaseTrainer):
    trainer_name = "EZBM"

    _build_triplet_batch = SupLearning._build_triplet_batch

    def get_config(self, config, cls_num_list: Optional[list] = None,
                   labeled_targets: Optional[np.ndarray] = None) -> None:
        n_iter = sweep_steps(self.train_dl, int(config.DATA.BATCH_SIZE),
                             self.device)
        self._setup_common(config, n_iter, labeled_targets)
        self.n_iter_per_epoch = n_iter
        self.cls_num_list = list(cls_num_list or [])
        self.lambda_c = float(config.TRAIN.LAMBDA_C)
        self.expansion = str(config.TRAIN.get("EXPANSION", "balance"))
        if int(config.TRAIN.get("GRAD_ACCUM", 1)) > 1:
            raise ValueError(
                "TRAIN.GRAD_ACCUM > 1 is not supported for EZBM: balanced "
                "mixing pairs samples across the whole batch. Use it with "
                "SupLearning / FixMatch / SemiFormer, or lower BATCH_SIZE.")
        self._init_state()
        self.mem_features, self.mem_targets = [], []
        self._opt2, self._opt2_count = None, 0

    # -- stage 1 ------------------------------------------------------------

    def _stage1_forward_backward(self, x, targets, weights):
        """One forward of the view ``x`` (NHWC, ``[A; P; N]``), the loss and
        the backward; keeps the anchors' features in ``self._anchor_fts``.
        Returns the detached ``[loss]``."""
        self._layout(*(x.shape[0] // 3,) * 3)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            logits, fts, fts_low = self.state.model(x.permute(0, 3, 1, 2))
        bs = x.shape[0] // 3
        low = fts_low.float()
        tl, _, _ = triplet_loss(low[:bs], low[bs:2 * bs], low[2 * bs:],
                                alpha=TRIPLET_ALPHA)
        cl = ce_loss(logits[:bs].float(), targets, class_weights=weights,
                     reduction="mean", type_loss="poly",
                     cls_num_list=self.cls_num_list or None)
        loss = cl + self.lambda_c * tl
        self._backward(loss)
        self._anchor_fts = fts[:bs].detach()
        return loss.detach()[None]

    def _stage1_core(self, x, targets, weights):
        """One stage-1 update on a precomputed view. Returns ``(loss,
        the anchors' features)``, device tensors."""
        loss = self._accumulate([(x, targets, weights)],
                                self._stage1_forward_backward)
        return loss[0], self._anchor_fts

    def _stage1_step(self, x3_u8, targets, weights):
        """One stage-1 step from the canonical uint8 ``[A; P; N]`` batch
        (this rank's anchors, positives and negatives in the global one)."""
        with trace.span("step/views"):
            x = rows_on_device(x3_u8, self.device)
            n = self.group.world * x.shape[0]
            draws = self._rank_draws(labeled_draws(self.generator, n),
                                     *(n // 3,) * 3)
            view = labeled_train_view(x, self.img_size, self.dtype,
                                      device=self.device, **draws)
        return self._stage1_core(view, self._to_device(targets), weights)

    def train_one_stage_1(self, epoch: int) -> AverageMeter:
        """``n_iter_per_epoch`` triplet steps (``BaseTrainer._run_steps``);
        the memory is rebuilt from this epoch's anchors."""
        weights = self._step_weights()
        self.mem_features, self.mem_targets = [], []

        def step(labeled):
            batch_u8, targets = labeled
            x3 = self._build_triplet_batch(batch_u8, targets)
            loss, anchor_fts = self._stage1_step(x3, targets, weights)
            self.mem_features.append(anchor_fts)
            self.mem_targets.append(np.asarray(targets))
            return loss

        summary_loss = self._run_steps(
            self._batches(self.n_iter_per_epoch, self.train_dl), step,
            int(self.config.DATA.BATCH_SIZE))
        if in_group():
            self._gather_memory()
        return summary_loss

    def _gather_memory(self) -> None:
        """Every rank's memorized anchors in the global batch's row order:
        step by step, the ranks' anchors in rank order."""
        fts = torch.stack(self.mem_features)  # (steps, n, F)
        t = torch.as_tensor(np.stack(self.mem_targets)).to(self.device)
        steps, world = fts.shape[0], self.group.world

        def gathered(a):
            a = all_gather_rows(a.flatten(0, 1))
            return a.view(world, steps, -1, *a.shape[1:]).transpose(
                0, 1).flatten(0, 2)

        self.mem_features = [gathered(fts)]
        self.mem_targets = [gathered(t).cpu().numpy()]

    # -- stage 2 ------------------------------------------------------------

    def _sample_stage2_batch(self, targets: np.ndarray, batch_size: int,
                             rng: np.random.Generator):
        """``(primary rows, dual rows)`` of the memory, drawn as the JAX
        trainer draws them (module docstring)."""
        num_classes = len(self.cls_num_list)
        by_class = [np.nonzero(targets == c)[0] for c in range(num_classes)]
        avail = [c for c in range(num_classes) if len(by_class[c])]
        counts = np.asarray(self.cls_num_list, dtype=np.float64)
        rev_prob = (counts / counts.sum())[::-1]
        idx = np.empty(batch_size, np.int64)
        dual = np.empty(batch_size, np.int64)
        for i in range(batch_size):
            c = rng.choice(avail)
            idx[i] = rng.choice(by_class[c])
            if self.expansion == "reverse":
                cd = int(rng.choice(num_classes, p=rev_prob))
                while not len(by_class[cd]):
                    cd = int(rng.choice(num_classes, p=rev_prob))
            else:
                cd = rng.choice(avail)
            dual[i] = rng.choice(by_class[cd])
        return idx, dual

    def _stage2_lam(self, y: np.ndarray, y_dual: np.ndarray) -> np.ndarray:
        """The mixing coefficient per pair, float32 ``(n, 1)``."""
        counts = np.asarray(self.cls_num_list, dtype=np.float64)
        lam = counts[y] / (counts[y] + counts[y_dual])
        if self.expansion == "balance":
            lam = 0.5 * np.ones_like(lam)
        elif self.expansion == "reverse":
            lam = 1.0 - lam
        return np.asarray(lam[:, None], np.float32)

    def _stage2_core(self, feats, targets, feats_dual, targets_dual, lam,
                     keep_mask=None):
        """One stage-2 update of the ``fc`` head on device tensors; the
        head's dropout keep-mask is ``keep_mask``, else one draw from the
        trainer's generator for the global batch (this rank's rows), the
        same for both passes. Returns the detached loss (the global one,
        in a group)."""
        st = self.state
        model, fc = st.model.train(), st.model.fc
        if keep_mask is None:
            g = self.generator
            keep_mask = torch.rand(
                (self.group.world * feats.shape[0], fc.fc1.out_features),
                generator=g, device=g.device) < KEEP
            keep_mask = self._own_rows(keep_mask)
        self._opt2.zero_grad(set_to_none=True)
        fc.keep_mask = keep_mask
        try:
            out_o = model.classify_features(feats)
            mix = lam * feats + (1.0 - lam) * feats_dual
            out_s = model.classify_features(mix)
        finally:
            fc.keep_mask = None
        l_o = ce_loss(out_o, targets, reduction="mean")
        l_s = (0.5 * ce_loss(out_s, targets, reduction="mean")
               + 0.5 * ce_loss(out_s, targets_dual, reduction="mean"))
        loss = l_o + self.lambda_c * l_s
        self._backward(loss)
        with trace.span("step/update"), torch.no_grad():
            for name, p in model.named_parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif not name.startswith("fc."):
                    p.grad.zero_()
            sync_grads(fc)
            set_lr(self._opt2, self.lr_schedule(self._opt2_count))
            self._opt2.step()
            self._opt2_count += 1
            st.step += 1
            if st.ema is not None:
                ema_update(st.ema, model, self.ema_decay)
        return all_reduce_sum(loss.detach())

    def _new_stage2_optimizer(self) -> None:
        """A fresh optimizer over every parameter; its schedule count
        restarts at 0."""
        self._opt2 = build_optimizer(self.state.model.named_parameters(),
                                     self.opt_func, lr=self.lr_schedule(0))
        self._opt2_count = 0

    def train_one_stage_2(self, epoch: int) -> AverageMeter:
        """Stage-2 steps over this epoch's memory (``BaseTrainer.
        _run_steps``); each step draws its pairs on the host for the global
        batch and gathers this rank's rows on the device."""
        feats = torch.cat(self.mem_features)
        targets = np.concatenate(self.mem_targets)
        bs2 = int(self.config.DATA.BATCH_SIZE) * int(self.config.DATA.MU)
        num_steps = max(len(targets) // bs2, 1)
        rng = np.random.default_rng(
            int(self.config.TRAIN.get("SEED", 42)) + epoch)
        dev = self._to_device

        def step():
            idx, dual = (self._own_rows(a) for a in
                         self._sample_stage2_batch(targets, bs2, rng))
            y, yd = targets[idx], targets[dual]
            lam = self._stage2_lam(y, yd)
            return self._stage2_core(feats[dev(idx)], dev(y),
                                     feats[dev(dual)], dev(yd),
                                     dev(lam, torch.float32))

        return self._run_steps([()] * num_steps, step, bs2)

    # -- fit ------------------------------------------------------------------

    def fit(self) -> None:
        """Stage 1 with its early stop, then the fresh optimizer and stage
        2 (module docstring)."""
        print("-" * 10, "Stage 1", "-" * 10)
        self.best_valid_loss = self.best_valid_score = None
        count_early_stop = 0
        for epoch in range(self.epoch_start, int(self.config.TRAIN.EPOCHS) + 1):
            if count_early_stop > 5:
                print("Early stopping stage 1")
                break
            self.epoch = epoch
            loss = self.train_one_stage_1(epoch)
            if epoch % int(self.config.TRAIN.FREQ_EVAL) == 0:
                vl, vm = self.evaluate_one()
                count_early_stop = self._update_best(vl, vm, count_early_stop,
                                                     save=False)
                print(f"s1 ep {epoch}: train {loss.avg:.3f} valid "
                      f"{vl.avg:.3f} F1 {vm['macro/f1']:.4f}")
            if self._preempt_break(epoch):
                return

        print("-" * 10, "Stage 2 (fc only, fresh optimizer)", "-" * 10)
        self._new_stage2_optimizer()
        count_early_stop = 0
        for epoch in range(self.epoch_start, int(self.config.TRAIN.EPOCHS) + 1):
            if count_early_stop > 10:
                print("Early stopping stage 2")
                break
            self.epoch = epoch
            loss = self.train_one_stage_2(epoch)
            if epoch % int(self.config.TRAIN.FREQ_EVAL) == 0:
                vl, vm = self.evaluate_one()
                count_early_stop = self._update_best(vl, vm, count_early_stop,
                                                     save=True)
                print(f"s2 ep {epoch}: train {loss.avg:.3f} valid "
                      f"{vl.avg:.3f} F1 {vm['macro/f1']:.4f}")
            if self._preempt_break(epoch):
                break

    def _update_best(self, valid_loss, valid_metric, count_early_stop: int,
                     save: bool) -> int:
        """The loss ∧ macro-F1 gate: both better (or the first evaluation)
        is a new best, saved when ``save`` and ``SAVE_CP``; either worse
        counts a miss. Returns the miss count."""
        f1 = float(valid_metric["macro/f1"])
        loss = valid_loss.avg
        if self.best_valid_loss is not None and self.best_valid_score is not None:
            if self.best_valid_loss > loss and self.best_valid_score < f1:
                self.best_valid_loss, self.best_valid_score = loss, f1
                if save and self.config.TRAIN.get("SAVE_CP"):
                    self.save_checkpoint(self.config.TRAIN.SAVE_CP)
            elif self.best_valid_loss < loss or self.best_valid_score > f1:
                count_early_stop += 1
        else:
            self.best_valid_loss, self.best_valid_score = loss, f1
            if save and self.config.TRAIN.get("SAVE_CP"):
                self.save_checkpoint(self.config.TRAIN.SAVE_CP)
        return count_early_stop
