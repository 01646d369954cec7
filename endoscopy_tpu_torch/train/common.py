"""Shared trainer machinery (port of ``endoscopy_tpu/train/common.py``).

The trainer protocol is the reference's: ``__init__(model, opt_func)`` →
``get_dataloader(...)`` → ``get_config(config)`` → optional
``load_checkpoint(path, is_train)`` → ``fit()``; plus ``evaluate_one()``,
``test_one()``, ``inference(dl)`` and ``save_checkpoint(dir)``.

- The model arrives with its weights (torch's initializers, or weights
  loaded by the caller); ``TRAIN.SEED`` seeds the trainer's
  ``torch.Generator`` on the device, which draws every view.
- "Freeze backbone" (``TRAIN.IS_FREEZE``) gives the backbone's parameters
  zero gradients; they still go through the optimizer, and their BN running
  statistics still update in train mode, as in the reference.
- On the card the step computes in bf16 autocast with ``channels_last``
  (``TRAIN.DTYPE``); on the CPU always in float32. Evaluation runs the
  model (the EMA teacher when ``TRAIN.USE_EMA``) in eval mode the same way,
  on ``eval_view`` at ``IMG_SIZE``, and fetches its results once, after
  the last batch.
- Checkpoints (``ckpt/io.py``) hold ``TrainState.state_dict()`` and the
  meta fields ``epoch``, ``best_valid_perf``, ``trainer``, ``img_size``;
  ``load_checkpoint`` also takes a JAX train state dumped to ``.npz``
  (``tools/torch_port/orbax_to_npz.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from endoscopy_tpu_torch.aug.views import eval_view
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt.convert import train_state_from_npz
from endoscopy_tpu_torch.device import resolve_device, resolve_dtype
from endoscopy_tpu_torch.eval.metrics import calculate_metrics, confusion_matrix
from endoscopy_tpu_torch.losses import balanced_class_weights, cross_entropy
from endoscopy_tpu_torch.models.heads import MLPHead
from endoscopy_tpu_torch.optim import build_optimizer, build_schedule, set_lr
from endoscopy_tpu_torch.ssl_state.ema import ema_init, ema_update
from endoscopy_tpu_torch.train import preempt
from endoscopy_tpu_torch.train.state import TrainState
from endoscopy_tpu_torch.utils.logging import MetricLogger, Throughput
from endoscopy_tpu_torch.utils.meters import AverageMeter


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
    """Common state, config plumbing, evaluation, checkpoints and ``fit``."""

    trainer_name = "Base"

    def __init__(self, model: Optional[nn.Module] = None,
                 opt_func: str = "Adam", device=None):
        self.device = resolve_device(device)
        self.model = model
        self.opt_func = opt_func
        self.state: Optional[TrainState] = None
        self.epoch_start = 1
        self.best_valid_perf: Optional[float] = None
        self.epoch = 0
        self._resumed = False

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
        schedule's ``lr(0)``), the EMA copy, the freeze mask, and the
        trainer's generator on every head that draws dropout."""
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
        for m in model.modules():
            if isinstance(m, MLPHead):
                m.generator = self.generator

    # -- the update ---------------------------------------------------------

    def _apply_grads(self) -> None:
        """The freeze mask, the optimizer at the scheduled learning rate
        (the schedule at the count before this update), then the EMA over
        the updated parameters and BN statistics."""
        st = self.state
        mask_grads(st.model, self.grad_mask)
        set_lr(st.optimizer, self.lr_schedule(st.step))
        st.optimizer.step()
        st.step += 1
        if st.ema is not None:
            ema_update(st.ema, st.model, self.ema_decay)

    def _accumulate(self, micro: Iterable[tuple], forward_backward
                    ) -> torch.Tensor:
        """``forward_backward(*m)`` over each microbatch ``m`` (gradients
        add into ``.grad``, BN running statistics thread through), then
        one update on the mean gradient. Returns the mean of the detached
        statistics ``forward_backward`` returns."""
        st = self.state
        st.model.train()
        st.optimizer.zero_grad(set_to_none=True)
        total, count = None, 0
        for m in micro:
            stats = forward_backward(*m)
            total = stats if total is None else total + stats
            count += 1
        if count > 1:
            grads = [p.grad for p in st.model.parameters()
                     if p.grad is not None]
            torch._foreach_div_(grads, float(count))
            total = total / count
        # a parameter outside the loss (ModelwEmb's projection in the
        # triplet branch) gets a zero gradient, as under optax, so weight
        # decay, momentum and Adam's moments still move it
        for p in st.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._apply_grads()
        return total

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

    # -- evaluation ---------------------------------------------------------

    def _eval_model(self) -> nn.Module:
        """The EMA teacher when enabled, else the model; in eval mode."""
        st = self.state
        model = st.ema if self.use_ema and st.ema is not None else st.model
        return model.eval()

    @staticmethod
    def _eval_loss_probs(out, targets):
        """Per-row CE and softmax probabilities of a model's eval output."""
        logits = model_logits(out).float()
        return (cross_entropy(logits, targets, reduction="none"),
                torch.softmax(logits, -1))

    @torch.inference_mode()
    def _eval_step(self, model, batch_u8, targets, mask):
        """``(sum of CE × mask, sum of mask, softmax probabilities)`` of one
        padded batch, on the device (:meth:`_eval_loss_probs`)."""
        x = eval_view(batch_u8, self.img_size, self.dtype, device=self.device)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = model(x.permute(0, 3, 1, 2))
        t = torch.as_tensor(targets).to(self.device, torch.long,
                                        non_blocking=True)
        m = torch.as_tensor(mask).to(self.device, torch.float32,
                                     non_blocking=True)
        ce, probs = self._eval_loss_probs(out, t)
        return torch.sum(ce * m), torch.sum(m), probs

    def _eval_pass(self, batches):
        """Every batch through :meth:`_eval_step`, fetched to the host once
        at the end: ``(per-batch [loss_sum, count] rows, probabilities,
        targets, mask)``, the last three per row. ``batches`` yields
        ``(u8, targets, mask)``."""
        model = self._eval_model()
        sums, probs, targets, masks = [], [], [], []
        for batch_u8, t, mask in batches:
            loss_sum, count, p = self._eval_step(model, batch_u8, t, mask)
            sums.append(torch.stack([loss_sum, count]))
            probs.append(p)
            targets.append(np.asarray(t))
            masks.append(np.asarray(mask, bool))
        return (torch.stack(sums).cpu().numpy(), torch.cat(probs).cpu().numpy(),
                np.concatenate(targets), np.concatenate(masks))

    def evaluate_one(self, show_metric: bool = False,
                     show_report: bool = False):
        """``(loss meter, metric dict)`` over the validation loader."""
        summary_loss = AverageMeter()
        sums, probs, targets, keep = self._eval_pass(self.valid_dl)
        for loss_sum, count in sums:
            n = int(count)
            if n:
                summary_loss.update(float(loss_sum) / n, n)
        preds = probs[keep].argmax(axis=1)
        targets = targets[keep]
        metric = calculate_metrics(preds, targets, self.config)
        if show_metric:
            print("Metric:")
            print(metric)
        if show_report:
            print(confusion_matrix(targets, preds,
                                   int(self.config.MODEL.NUM_CLASSES)))
        return summary_loss, metric

    def test_one(self) -> np.ndarray:
        """Boolean mask of the misclassified validation samples."""
        _, probs, targets, keep = self._eval_pass(self.valid_dl)
        return probs[keep].argmax(axis=1) != targets[keep]

    def inference(self, dl_test) -> Dict[int, int]:
        """Thresholded pseudo-labels for an unlabeled pool: ``pred = argmax
        * [max_prob > THRES]``, keyed by the row's place among the kept
        rows. ``dl_test`` yields ``(u8, targets, mask)`` or ``(u8,
        targets)``."""
        def batches():
            for batch in dl_test:
                u8 = batch[0]
                mask = (batch[2] if len(batch) == 3
                        else np.ones(len(u8), bool))
                yield u8, np.zeros(len(u8), np.int64), mask

        _, probs, _, keep = self._eval_pass(batches())
        probs = probs[keep]
        preds = probs.argmax(axis=1) * (probs.max(axis=1)
                                        > float(self.config.TRAIN.THRES))
        return {i: int(p) for i, p in enumerate(preds)}

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self, foldname: str) -> str:
        meta = {"epoch": int(self.epoch),
                "best_valid_perf": self.best_valid_perf,
                "trainer": self.trainer_name,
                "img_size": self.img_size}
        path = ckpt_io.save_checkpoint(foldname, f"epoch_{int(self.epoch)}",
                                       self.state.state_dict(), meta)
        print("Saved checkpoint:", path)
        return path

    def load_checkpoint(self, checkpoint: str, is_train: bool = False) -> None:
        """Restore a checkpoint directory of the port's, or a JAX train
        state dumped to ``.npz``. The freeze mask is reapplied only when
        ``is_train``."""
        if checkpoint.endswith(".npz"):
            state, meta = train_state_from_npz(checkpoint)
        else:
            state, meta = ckpt_io.restore_checkpoint(checkpoint, self.device)
        self.state.load_state_dict(state)
        self._resumed = True
        self.epoch_start = int(meta.get("epoch", 1))
        self.best_valid_perf = meta.get("best_valid_perf")
        self.grad_mask = trainable_mask(
            self.state.model, bool(self.config.TRAIN.IS_FREEZE) and is_train)

    # -- fit ------------------------------------------------------------------

    def train_one(self, epoch: int) -> AverageMeter:
        raise NotImplementedError

    def _preempt_break(self, epoch: int, saved_this_epoch: bool = False) -> bool:
        """True when a preemption signal arrived (``train/preempt.py``):
        saves a resume checkpoint, unless this epoch's evaluation already
        saved one, and tells ``fit`` to stop."""
        if not preempt.requested():
            return False
        if self.config.TRAIN.get("SAVE_CP") and not saved_this_epoch:
            self.save_checkpoint(self.config.TRAIN.SAVE_CP)
        print(f"[preempt] stopping after epoch {epoch}", flush=True)
        return True

    def _metric_logger(self) -> MetricLogger:
        if not hasattr(self, "_logger"):
            self._logger = MetricLogger(
                self.config.TRAIN.get("LOG_DIR"),
                run_name=self.trainer_name.lower(),
                use_wandb=bool(self.config.TRAIN.get("USE_WANDB", False)))
        return self._logger

    def _images_per_step(self) -> int:
        """Images a step consumes; SSL: the labeled batch and two views of
        the unlabeled one."""
        bs = int(self.config.DATA.BATCH_SIZE)
        if self.config.TRAIN.IS_SSL:
            return bs * (1 + 2 * int(self.config.DATA.MU))
        return bs

    def _evaluated_resume(self) -> bool:
        """A resume at the final epoch only evaluates: True when this was
        one and the evaluation ran."""
        if not (self._resumed
                and self.epoch_start == int(self.config.TRAIN.EPOCHS)):
            return False
        valid_loss, valid_metric = self.evaluate_one()
        print(f"\tValid Loss: {valid_loss.avg:.3f}")
        print(f"\tMetric: {valid_metric}")
        return True

    def _train_epoch(self, epoch: int, tput: Throughput,
                     logger: MetricLogger) -> AverageMeter:
        """``train_one(epoch)``, timed over the steps it takes (the
        supervised trainer's ``n_iter_per_epoch``, else ``EVAL_STEP``);
        logs the train loss, images/s and the epoch's seconds."""
        self.epoch = epoch
        tput.reset()
        t0 = time.perf_counter()
        train_loss = self.train_one(epoch)
        epoch_s = time.perf_counter() - t0
        tput.step(getattr(self, "n_iter_per_epoch",
                          int(self.config.TRAIN.EVAL_STEP)))
        imgs_per_sec = tput.images_per_sec
        print(f"\tTrain Loss: {train_loss.avg:.3f} | {imgs_per_sec:.0f} img/s")
        logger.log({"loss/train": train_loss.avg,
                    "throughput/images_per_sec": imgs_per_sec,
                    "time/epoch_s": epoch_s}, epoch=epoch)
        return train_loss

    @staticmethod
    def _log_valid(logger: MetricLogger, epoch: int, valid_loss,
                   valid_metric) -> None:
        print(f"\tValid Loss: {valid_loss.avg:.3f}")
        print(f"\tMetric: { {k: v for k, v in valid_metric.items() if k != 'sen/spec'} }")
        logger.log({"loss/valid": valid_loss.avg,
                    "metric/macro_f1": float(valid_metric["macro/f1"])},
                   epoch=epoch)

    def fit(self) -> None:
        """Train from ``epoch_start`` to ``TRAIN.EPOCHS``, evaluating and
        saving every ``FREQ_EVAL`` epochs. A resume at the final epoch only
        evaluates."""
        if self._evaluated_resume():
            return
        logger = self._metric_logger()
        tput = Throughput(self._images_per_step())
        for epoch in range(self.epoch_start, int(self.config.TRAIN.EPOCHS) + 1):
            best = (f"{float(self.best_valid_perf):.3f}"
                    if self.best_valid_perf is not None else "inf")
            print(f"Training epoch: {epoch} | The best loss: {best}")
            self._train_epoch(epoch, tput, logger)
            saved_this_epoch = False
            if epoch % int(self.config.TRAIN.FREQ_EVAL) == 0:
                valid_loss, valid_metric = self.evaluate_one()
                if (self.best_valid_perf is None
                        or self.best_valid_perf > valid_loss.avg):
                    self.best_valid_perf = valid_loss.avg
                if self.config.TRAIN.get("SAVE_CP"):
                    self.save_checkpoint(self.config.TRAIN.SAVE_CP)
                    saved_this_epoch = True
                self._log_valid(logger, epoch, valid_loss, valid_metric)
            if self._preempt_break(epoch, saved_this_epoch):
                break
