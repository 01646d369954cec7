"""Supervised trainer (port of ``endoscopy_tpu/train/supervised.py``).

``get_dataloader(train_loader, valid_dl)`` with the train loader yielding
``(canonical uint8 NHWC batch, targets)`` (a ``CanonicalLoader``: its
manifest sets the steps of an epoch, ``len(manifest) // BATCH_SIZE`` or 1,
and the triplet branch samples through its ``sample`` and ``rng``), then
``get_config(config, cls_num_list, labeled_targets)``, then ``fit()``.

A step is the labeled train view of the batch on the device (the
paper-reproduction view under ``DATA.IS_REPROD``, with its eval view in
evaluation), then one of three loss branches:

- plain: weighted CE on the float32 logits; with ``TRAIN.MIXUP`` or
  ``TRAIN.CUTMIX`` above 0, the view is mixed (``aug/mixup.py``) and the
  loss is the soft CE on the mixed targets;
- margin (``MODEL.MARGIN`` one of arcface, sphereface, cosface, acloss):
  the backbone's float32 features and the bias-free head's weight through
  ``losses/margin.py::angular_penalty_loss`` with the class weights; the
  head itself does not run, and Mixup is not applied;
- triplet (``MODEL.IS_TRIPLET``, ``ModelwEmb``): the batch is
  ``[anchors; positives; negatives]`` (:meth:`_build_triplet_batch`), one
  forward over all of it, the triplet loss (alpha 0.7) on the pooled
  features, poly-CE on the anchors' logits, ``ce + LAMBDA_C · triplet``.

``TRAIN.GRAD_ACCUM`` > 1 splits the step into microbatches with their own
views, gradients summed in float32 and one update on their mean (the
trainer's ``_accumulate``); the triplet batch is split block by block, so
microbatch *i* holds matched ``(A_i, P_i, N_i)``, and Mixup pairs images
within a microbatch. ``TRAIN_RULE: 'RDW'`` (exactly) re-weights the
classes per epoch (``losses.rdw_weights``).

``fit`` keeps the reference's gate: a checkpoint only when the valid loss
and the macro-F1 both improve (the first evaluation always saves), a
count of evaluations where either got worse, and a stop at the start of
an epoch once that count passes 5; ``best_valid_perf`` is not updated.
Every 5 epochs the triplet branch logs the last step's mean anchor-positive
and anchor-negative distances to the JSONL log and draws their histogram to
``LOG_DIR/triplet_dist_epoch<N>.png`` (``eval/visualize.py::
show_triplet_dist``; no PNG without matplotlib or ``LOG_DIR``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from endoscopy_tpu_torch.aug.mixup import mixup_cutmix
from endoscopy_tpu_torch.aug.views import (labeled_draws, labeled_train_view,
                                           reproduce_draws,
                                           reproduce_train_view,
                                           rows_on_device)
from endoscopy_tpu_torch.config.loader import is_none
from endoscopy_tpu_torch.losses import (angular_penalty_loss, ce_loss,
                                        rdw_weights, soft_ce_loss,
                                        triplet_loss)
from endoscopy_tpu_torch.models.heads import model_logits
from endoscopy_tpu_torch.parallel import batch_mean
from endoscopy_tpu_torch.train.common import BaseTrainer, sweep_steps
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter

TRIPLET_ALPHA = 0.7


class SupLearning(BaseTrainer):
    """The supervised trainer with its plain, margin and triplet branches."""

    trainer_name = "SupLearning"
    _supports_reprod = True

    def get_config(self, config, cls_num_list: Optional[list] = None,
                   labeled_targets: Optional[np.ndarray] = None) -> None:
        n_iter = sweep_steps(self.train_dl, int(config.DATA.BATCH_SIZE),
                             self.device)
        self._setup_common(config, n_iter, labeled_targets)
        self.n_iter_per_epoch = n_iter
        self.cls_num_list = cls_num_list
        self.lambda_c = float(config.TRAIN.LAMBDA_C)
        self.is_triplet = bool(config.MODEL.IS_TRIPLET)
        self.margin = (None if is_none(config.MODEL.MARGIN)
                       else str(config.MODEL.MARGIN))
        tr = config.TRAIN
        self.mixup_kw = dict(
            num_classes=int(config.MODEL.NUM_CLASSES),
            mixup_alpha=float(tr.get("MIXUP", 0.0)),
            cutmix_alpha=float(tr.get("CUTMIX", 0.0)),
            prob=float(tr.get("MIXUP_PROB", 1.0)),
            switch_prob=float(tr.get("MIXUP_SWITCH_PROB", 0.5)),
            label_smoothing=float(tr.get("LABEL_SMOOTHING", 0.1)))
        self.mixup_active = (self.mixup_kw["mixup_alpha"] > 0
                             or self.mixup_kw["cutmix_alpha"] > 0)
        self.grad_accum = max(1, int(tr.get("GRAD_ACCUM", 1)))
        self._last_triplet_dist = None
        self._init_state()

    # -- the step ----------------------------------------------------------

    def _forward_backward(self, x, targets, weights,
                          mix_draws=None) -> torch.Tensor:
        """One forward of the view ``x`` (NHWC), the active branch's loss
        and the backward; gradients add into ``.grad``. ``mix_draws``
        (Mixup's) override the trainer's generator. Returns the detached
        ``[loss]``, or ``[loss, d_ap, d_an]`` for the triplet branch."""
        if self.margin is not None and not self.is_triplet:
            return self._margin_forward_backward(x, targets, weights)
        if self.mixup_active and not self.is_triplet:
            x, soft = mixup_cutmix(x, targets, generator=self.generator,
                                   draws=mix_draws, **self.mixup_kw)
        self._layout(*((x.shape[0] // 3,) * 3 if self.is_triplet
                       else (x.shape[0],)))
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.state.model(x.permute(0, 3, 1, 2))
        if self.is_triplet:
            logits, fts, _ = out
            bs = x.shape[0] // 3
            tl, d_ap, d_an = triplet_loss(fts[:bs], fts[bs:2 * bs],
                                          fts[2 * bs:], alpha=TRIPLET_ALPHA)
            cl = ce_loss(logits[:bs].float(), targets, class_weights=weights,
                         reduction="mean", type_loss="poly")
            loss = cl + self.lambda_c * tl
            stats = [loss, d_ap, d_an]
        else:
            logits = model_logits(out).float()
            if self.mixup_active:
                loss = batch_mean(soft_ce_loss(logits, soft))
            else:
                loss = ce_loss(logits, targets, class_weights=weights,
                               reduction="mean")
            stats = [loss]
        self._backward(loss)
        return torch.stack(stats).detach()

    def _margin_forward_backward(self, x, targets, weights) -> torch.Tensor:
        """The margin branch: the backbone's features (the head does not
        run) and the bias-free head's weight through the angular-penalty
        loss, in float32."""
        model = self.state.model
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            fts = model.backbone(x.permute(0, 3, 1, 2))
        loss = angular_penalty_loss(fts.float(), targets,
                                    model.head.fc.weight.float(),
                                    loss_type=self.margin,
                                    cls_weight=weights)
        self._backward(loss)
        return loss.detach()[None]

    def _train_micro(self, micro, weights):
        """``(view, targets[, mix_draws])`` microbatches
        through one update. Returns ``(loss, aux)``: aux is ``(d_ap,
        d_an)`` for the triplet branch, else empty."""
        total = self._accumulate(
            ((m[0], m[1], weights, *m[2:]) for m in micro),
            self._forward_backward)
        return total[0], tuple(total[1:])

    def _train_core(self, x, targets, weights, mix_draws=None):
        """One step on a precomputed view."""
        return self._train_micro([(x, targets, mix_draws)], weights)

    def _micro_indices(self, n: int):
        """Each microbatch's rows of a batch of ``n`` rows: consecutive
        chunks, or for the triplet batch ``[A; P; N]`` the i-th chunk of
        each block."""
        accum = self.grad_accum
        rows = torch.arange(n)
        if self.is_triplet:
            return rows.view(3, accum, -1).transpose(0, 1).reshape(accum, -1)
        return rows.view(accum, -1)

    def _train_step(self, batch_u8, targets, weights):
        """One step from the canonical uint8 batch (``[A; P; N]`` for the
        triplet branch, ``targets`` the anchors'), in ``grad_accum``
        microbatches, each with its own view, drawn for the microbatch's
        global rows (this rank's: its anchors, positives and negatives in
        the global ``[A; P; N]``); the copy of the batch and the views are
        the span ``step/views``."""
        accum = self.grad_accum
        with trace.span("step/views"):
            x = rows_on_device(batch_u8, self.device)
        t = self._to_device(targets)
        if t.shape[0] % accum:
            raise ValueError(f"TRAIN.GRAD_ACCUM={accum} does not divide the "
                             f"batch of {t.shape[0]}")
        rows = self._micro_indices(x.shape[0])
        world = self.group.world
        blocks = 3 if self.is_triplet else 1
        view, draw = ((reproduce_train_view, reproduce_draws)
                      if self.is_reprod else
                      (labeled_train_view, labeled_draws))

        def micro():
            for i, t_m in enumerate(t.chunk(accum)):
                x_m = x if accum == 1 else x[rows[i].to(x.device)]
                n = world * len(x_m)
                with trace.span("step/views"):
                    draws = self._rank_draws(draw(self.generator, n),
                                             *(n // blocks,) * blocks)
                    x_v = view(x_m, self.img_size, self.dtype,
                               device=self.device, **draws)
                yield x_v, t_m

        return self._train_micro(micro(), weights)

    def _build_triplet_batch(self, batch_u8, targets) -> np.ndarray:
        """``[anchors; positives; negatives]``: for each anchor a
        same-class and an other-class row of the loader's manifest, drawn
        with the loader's ``rng`` and read with one ``sample`` call."""
        loader = self.train_dl
        if not hasattr(loader, "sample"):
            raise TypeError(
                f"MODEL.IS_TRIPLET requires a loader with sample(indices); "
                f"{type(loader).__name__} has none")
        t = np.asarray(loader.manifest.targets)
        rng = getattr(loader, "rng", None)
        if rng is None:
            rng = self._triplet_rng = getattr(
                self, "_triplet_rng", np.random.default_rng(0))
        pos_idx = np.empty(len(targets), np.int64)
        neg_idx = np.empty(len(targets), np.int64)
        for i, y in enumerate(np.asarray(targets)):
            pos_idx[i] = rng.choice(np.nonzero(t == y)[0])
            neg_idx[i] = rng.choice(np.nonzero(t != y)[0])
        both = loader.sample(np.concatenate([pos_idx, neg_idx]))
        if isinstance(both, torch.Tensor):  # the native loader on the card
            return torch.cat([torch.as_tensor(batch_u8).to(both.device),
                              both])
        return np.concatenate([np.asarray(batch_u8), both], axis=0)

    def _epoch_weights(self, epoch: int) -> torch.Tensor:
        """The class weights of this epoch: RDW's when ``TRAIN_RULE`` is
        exactly ``'RDW'`` (``'DRW'`` never matches, as in the reference),
        else ``_step_weights``."""
        if self.config.TRAIN.get("TRAIN_RULE") == "RDW" and self.cls_num_list:
            return torch.as_tensor(rdw_weights(epoch, self.cls_num_list),
                                   dtype=torch.float32, device=self.device)
        return self._step_weights()

    def train_one(self, epoch: int) -> AverageMeter:
        """``n_iter_per_epoch`` steps (``BaseTrainer._run_steps``); the
        triplet distances of the last step are read once, at the end."""
        weights = self._epoch_weights(epoch)
        aux = ()

        def step(labeled):
            nonlocal aux
            batch_u8, targets = labeled
            if self.is_triplet:
                batch_u8 = self._build_triplet_batch(batch_u8, targets)
            loss, aux = self._train_step(batch_u8, targets, weights)
            return loss

        summary_loss = self._run_steps(
            self._batches(self.n_iter_per_epoch, self.train_dl), step,
            int(self.config.DATA.BATCH_SIZE))
        if self.is_triplet and aux:
            self._last_triplet_dist = tuple(float(a) for a in aux)
            if epoch % 5 == 0:
                self._log_triplet_dist(epoch)
        return summary_loss

    def _log_triplet_dist(self, epoch: int) -> None:
        """The last step's distances: their histogram PNG under
        ``LOG_DIR`` and their means in the JSONL log."""
        from endoscopy_tpu_torch.eval.visualize import show_triplet_dist

        d_ap, d_an = self._last_triplet_dist
        log_dir = self.config.TRAIN.get("LOG_DIR")
        save = (f"{log_dir}/triplet_dist_epoch{epoch}.png"
                if log_dir and self.group.rank == 0 else None)
        show_triplet_dist(d_ap=d_ap, d_an=d_an, save_path=save)
        self._metric_logger().log({"triplet/d_ap_mean": float(np.mean(d_ap)),
                                   "triplet/d_an_mean": float(np.mean(d_an))},
                                  epoch=epoch)

    def _images_per_step(self) -> int:
        bs = int(self.config.DATA.BATCH_SIZE)
        return 3 * bs if self.is_triplet else bs

    # -- fit ------------------------------------------------------------------

    def fit(self) -> None:
        """Train with the loss ∧ macro-F1 checkpoint gate and early stop
        (module docstring). A resume at the final epoch only evaluates."""
        if self._evaluated_resume():
            return
        logger = self._metric_logger()
        count_early_stop = 0
        self.best_valid_loss = self.best_valid_score = None
        for epoch in range(self.epoch_start, int(self.config.TRAIN.EPOCHS) + 1):
            if count_early_stop > 5:
                print("Early stopping")
                break
            print(f"Training epoch: {epoch}")
            self._train_epoch(epoch, logger)
            saved_this_epoch = False
            if epoch % int(self.config.TRAIN.FREQ_EVAL) == 0:
                before = trace.totals()
                valid_loss, valid_metric = self.evaluate_one()
                loss, f1 = valid_loss.avg, float(valid_metric["macro/f1"])
                improved = (self.best_valid_loss is None
                            or (self.best_valid_loss > loss
                                and self.best_valid_score < f1))
                if improved:
                    self.best_valid_loss, self.best_valid_score = loss, f1
                    if self.config.TRAIN.get("SAVE_CP"):
                        self.save_checkpoint(self.config.TRAIN.SAVE_CP)
                        saved_this_epoch = True
                elif self.best_valid_loss < loss or self.best_valid_score > f1:
                    count_early_stop += 1
                self._log_valid(logger, epoch, valid_loss, valid_metric,
                                trace.since(before))
            if self._preempt_break(epoch, saved_this_epoch):
                break
