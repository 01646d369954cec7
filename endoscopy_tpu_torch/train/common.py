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
  on ``eval_view`` at ``IMG_SIZE`` (``reproduce_eval_view`` under
  ``DATA.IS_REPROD``, which only the supervised trainer takes), and
  fetches its results once, after the last batch.
- Checkpoints (``ckpt/io.py``) hold ``TrainState.state_dict()`` and the
  meta fields ``epoch``, ``best_valid_perf``, ``trainer``, ``img_size``;
  ``load_checkpoint`` also takes a JAX train state dumped to ``.npz``
  (``tools/torch_port/orbax_to_npz.py``).

In a process group (``parallel/``: one process per card under
``torchrun``) each rank trains on its rows of the global batch
(``DATA.BATCH_SIZE`` stays the global batch), and a step's numbers are
those of the 1-process step on that global batch:

- the generator's seed is the same on every rank, and every draw is made
  for the global batch, each rank taking its rows' (:meth:`_rank_draws`;
  the MLP head's dropout through :meth:`_layout`); so an image gets the
  pixels it gets in one process and the generators stay in step;
- rank 0's weights go to every rank after init and after a restore;
- BN normalizes with the global batch's statistics
  (``models/resnet.py``), each loss is the rank's share of the global loss
  (``losses/``), the gradients are summed over ranks before the mean over
  microbatches and the update, and the logged losses are the sums of the
  shares. ``DistributedDataParallel`` is not used: it averages, where the
  shares must add, and it does not fit the microbatch loop or the zero
  gradients of parameters outside the loss;
- under ``TRAIN.GRAD_ACCUM`` microbatch ``j`` is every rank's ``j``-th
  chunk, so it needs no exchange of images; its draws are made over
  microbatch ``j``'s global rows (the JAX package's microbatch ``j`` is
  rows ``[j·B/K, (j+1)·B/K)`` of its global batch);
- every rank evaluates the whole validation set (as the JAX package's
  hosts do), rank 0 alone writes checkpoints and the metric log, and a
  preemption on any rank stops every rank at the same epoch boundary.

Every trainer's ``train_one`` is one :meth:`BaseTrainer._run_steps`: the
epoch loop, inside ``utils/trace.py``'s ``epoch()``, which reads each
step's loss two steps late. The trainers take their batches through
:meth:`BaseTrainer._batches` (span ``loader/next``), their labels through
:meth:`BaseTrainer._to_device` and their class weights from
:meth:`BaseTrainer._step_weights`; their rows reach the card through
``aug/views.py::rows_on_device``. Each step, from the last batch's return
to the end of its drain, is a ``train/step`` span, whose children are
``step/views``, ``step/forward_backward`` (with ``step/backward``, the
:meth:`BaseTrainer._backward` of the loss), ``step/update`` and
``step/drain`` (the counters ``drain/fetches`` and ``drain/waited``).
``fit`` writes each epoch's record to the run log.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from endoscopy_tpu_torch.aug.views import eval_view, reproduce_eval_view
from endoscopy_tpu_torch.ckpt import io as ckpt_io
from endoscopy_tpu_torch.ckpt.convert import train_state_from_npz
from endoscopy_tpu_torch.device import resolve_device, resolve_dtype
from endoscopy_tpu_torch.eval.metrics import calculate_metrics, confusion_matrix
from endoscopy_tpu_torch.losses import balanced_class_weights, cross_entropy
from endoscopy_tpu_torch.models.heads import MLPHead, model_logits
from endoscopy_tpu_torch.optim import build_optimizer, build_schedule, set_lr
from endoscopy_tpu_torch.parallel import (all_reduce_max, all_reduce_min,
                                          all_reduce_sum, broadcast_state,
                                          current_group, group_size,
                                          in_group, local_rows,
                                          mesh_from_config, sync_grads)
from endoscopy_tpu_torch.ssl_state.ema import ema_init, ema_update
from endoscopy_tpu_torch.train import preempt
from endoscopy_tpu_torch.train.state import TrainState
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.logging import MetricLogger
from endoscopy_tpu_torch.utils.meters import AverageMeter


def trainable_mask(model: nn.Module, freeze_backbone: bool
                   ) -> Dict[str, bool]:
    """Parameter name → trainable. With ``freeze_backbone`` only the head's
    parameters (names outside ``backbone.``) train."""
    return {name: not (freeze_backbone and name.startswith("backbone."))
            for name, _ in model.named_parameters()}


def sweep_steps(loader, batch_size: int, device) -> int:
    """Steps of one sweep over a loader's manifest (at least one): its
    rows over the rank's batch, the fewest of any rank in a group."""
    steps = len(getattr(loader, "manifest", [])) // (
        batch_size // group_size()) or 1
    if in_group():
        steps = int(all_reduce_min(torch.tensor(steps, device=device)))
    return steps


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
    # True in the trainers whose step takes the DATA.IS_REPROD views
    _supports_reprod = False

    def __init__(self, model: Optional[nn.Module] = None,
                 opt_func: str = "Adam", device=None):
        self.device = resolve_device(device)
        self.group = current_group(self.device)
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
        self.group = mesh_from_config(config, current_group(self.device))
        self.is_reprod = bool(config.DATA.get("IS_REPROD", False))
        if self.is_reprod and not self._supports_reprod:
            raise ValueError(
                "DATA.IS_REPROD selects the supervised paper-reproduction "
                f"transforms; trainer {type(self).__name__} does not "
                "implement them (train/eval views would silently mismatch)")
        self.img_size = int(config.DATA.IMG_SIZE)
        self.dtype = resolve_dtype(self.device,
                                   config.TRAIN.get("DTYPE", "bfloat16"))
        self.lr_schedule = build_schedule(config, n_iter_per_epoch)
        self.use_ema = bool(config.TRAIN.USE_EMA)
        self.ema_decay = float(config.TRAIN.EMA_DECAY)
        # the same seed on every rank: every draw is the global batch's
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
        schedule's ``lr(0)``), the EMA copy (both rank 0's in a group), the
        freeze mask, and the trainer's generator on every head that draws
        dropout."""
        model = self.model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        optimizer = build_optimizer(model.named_parameters(), self.opt_func,
                                    lr=self.lr_schedule(0))
        self.state = TrainState(
            step=0, model=model, optimizer=optimizer,
            ema=ema_init(model) if self.use_ema else None)
        broadcast_state(self.state.model, self.state.ema)
        self.grad_mask = trainable_mask(model,
                                        bool(self.config.TRAIN.IS_FREEZE))
        self._dropout_heads = [m for m in model.modules()
                               if isinstance(m, MLPHead)]
        for m in self._dropout_heads:
            m.generator = self.generator

    # -- host data on the device ---------------------------------------------

    def _to_device(self, a, dtype=torch.long) -> torch.Tensor:
        """Host labels (or another small host array, as ``dtype``) on the
        trainer's device, copied without blocking."""
        return torch.as_tensor(a).to(self.device, dtype, non_blocking=True)

    def _step_weights(self) -> torch.Tensor:
        """A step's class weights: the balanced ones under
        ``TRAIN.CLS_WEIGHT``, else ones."""
        if self.class_weights is not None:
            return self.class_weights
        return torch.ones(int(self.config.MODEL.NUM_CLASSES),
                          device=self.device)

    # -- the rows of a rank ---------------------------------------------------

    @staticmethod
    def _own_rows(x, *blocks: int):
        """In a group, this rank's rows of ``x`` (a tensor or an array
        made for the global batch), laid out as ``blocks`` (global row
        counts, each split over the ranks; default one block of every
        row); outside a group ``x`` itself."""
        if not in_group():
            return x
        rows = local_rows(*(blocks or (len(x),)))
        return x[rows.to(x.device)] if torch.is_tensor(x) else x[rows.numpy()]

    def _rank_draws(self, draws: dict, *blocks: int) -> dict:
        """:meth:`_own_rows` of each of the views' draws."""
        return {k: self._own_rows(v, *blocks) for k, v in draws.items()}

    def _layout(self, *local_sizes: int) -> None:
        """In a group, tell every dropout head the next forward's layout:
        blocks of ``local_sizes`` rows on this rank, each a share of a
        global block of ``world`` times as many."""
        if not (in_group() and self._dropout_heads):
            return
        blocks = [self.group.world * n for n in local_sizes]
        rows = (sum(blocks), local_rows(*blocks, device=self.device))
        for m in self._dropout_heads:
            m.rows = rows

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
        statistics ``forward_backward`` returns. In a group the gradients
        and the statistics, the ranks' shares, are summed over ranks
        first. Spans: ``step/forward_backward`` around each
        ``forward_backward``, ``step/update`` around the rest (the views a
        lazy ``micro`` computes between them are ``step/views``)."""
        st = self.state
        with trace.span("step/update"):
            st.model.train()
            st.optimizer.zero_grad(set_to_none=True)
        total, count = None, 0
        for m in micro:
            with trace.span("step/forward_backward"):
                stats = forward_backward(*m)
            total = stats if total is None else total + stats
            count += 1
        with trace.span("step/update"):
            # a parameter outside the loss (ModelwEmb's projection in the
            # triplet branch) gets a zero gradient, as under optax, so
            # weight decay, momentum and Adam's moments still move it
            for p in st.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            sync_grads(st.model)
            total = all_reduce_sum(total)
            if count > 1:
                torch._foreach_div_([p.grad for p in st.model.parameters()],
                                    float(count))
                total = total / count
            self._apply_grads()
        return total

    @staticmethod
    def _backward(loss: torch.Tensor) -> None:
        """``loss.backward()``, timed as ``step/backward``."""
        with trace.span("step/backward"):
            loss.backward()

    # -- the epoch loop ------------------------------------------------------

    @staticmethod
    def _next(it):
        """The next batch of a train loader's iterator, timed as
        ``loader/next``."""
        with trace.span("loader/next"):
            return next(it)

    def _batches(self, steps: int, *loaders):
        """``steps`` tuples of one batch of each loader, taken in turn
        through :meth:`_next` (the labeled batch before the unlabeled
        one)."""
        its = [iter(dl) for dl in loaders]
        for _ in range(steps):
            yield tuple(self._next(it) for it in its)

    def _run_steps(self, batches: Iterable[tuple],
                   step: Callable[..., torch.Tensor],
                   batch_size: int) -> AverageMeter:
        """One epoch, inside ``trace.epoch()``: for each ``batch`` (taken
        at the ``for``, outside the step) the span ``train/step`` runs
        ``step(*batch)``, which returns the step's loss. Each loss is read
        two steps late, through its own event (:meth:`_defer`), so the host
        prepares the next step while the card still runs the two before
        it; the epoch end reads the rest. Returns the meter of the losses,
        ``batch_size`` rows each."""
        meter, pending = AverageMeter(), []
        with trace.epoch():
            for batch in batches:
                with trace.span("train/step"):
                    self._defer(pending, step(*batch))
                    self._drain_pending(pending, meter, batch_size)
            self._drain_pending(pending, meter, batch_size, keep=0)
        return meter

    @staticmethod
    def _defer(pending: list, loss: torch.Tensor) -> None:
        """Queue a step's detached loss for :meth:`_drain_pending`. A loss
        on the card is copied without blocking into page-locked host
        memory, and an event recorded on its stream right after the copy
        marks when that step's loss has arrived; a loss on the CPU goes in
        as it is."""
        loss = loss.detach()
        if not loss.is_cuda:
            pending.append((loss, None))
            return
        host = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
        host.copy_(loss, non_blocking=True)
        arrived = torch.cuda.Event()
        arrived.record(torch.cuda.current_stream(loss.device))
        pending.append((host, arrived))

    @staticmethod
    def _drain_pending(pending: list, summary_loss, batch_size: int,
                       keep: int = 2) -> None:
        """Read all but the last ``keep`` deferred losses (:meth:`_defer`)
        into the meter, oldest first; ``keep=0`` drains everything (epoch
        end). A card entry waits on its own event, so only for the step
        that made it, never for the steps queued behind it. Counters:
        ``drain/fetches`` one an entry, ``drain/waited`` an entry whose
        step the card had not yet finished. Timed as ``step/drain``, the
        epoch end's as ``train/drain``."""
        with trace.span("step/drain" if keep else "train/drain"):
            while len(pending) > keep:
                host, arrived = pending.pop(0)
                trace.count("drain/fetches")
                if arrived is not None and not arrived.query():
                    trace.count("drain/waited")
                    arrived.synchronize()
                for loss in host.flatten().tolist():
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
        view = reproduce_eval_view if self.is_reprod else eval_view
        x = view(batch_u8, self.img_size, self.dtype, device=self.device)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = model(x.permute(0, 3, 1, 2))
        t, m = self._to_device(targets), self._to_device(mask, torch.float32)
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
        """``(loss meter, metric dict)`` over the validation loader; the
        pass is the span ``eval/pass``."""
        summary_loss = AverageMeter()
        with trace.span("eval/pass"):
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
        with trace.span("ckpt/save"):
            path = ckpt_io.save_checkpoint(
                foldname, f"epoch_{int(self.epoch)}", self.state.state_dict(),
                meta)
        if self.group.rank == 0:
            print("Saved checkpoint:", path)
        return path

    def load_checkpoint(self, checkpoint: str, is_train: bool = False) -> None:
        """Restore a checkpoint directory of the port's, or a JAX train
        state dumped to ``.npz``, on every rank (then rank 0's weights go
        to all). The freeze mask is reapplied only when ``is_train``."""
        if checkpoint.endswith(".npz"):
            state, meta = train_state_from_npz(checkpoint)
        else:
            state, meta = ckpt_io.restore_checkpoint(checkpoint, self.device)
        self.state.load_state_dict(state)
        broadcast_state(self.state.model, self.state.ema)
        self._resumed = True
        self.epoch_start = int(meta.get("epoch", 1))
        self.best_valid_perf = meta.get("best_valid_perf")
        self.grad_mask = trainable_mask(
            self.state.model, bool(self.config.TRAIN.IS_FREEZE) and is_train)

    # -- fit ------------------------------------------------------------------

    def train_one(self, epoch: int) -> AverageMeter:
        raise NotImplementedError

    def _preempt_break(self, epoch: int, saved_this_epoch: bool = False) -> bool:
        """True when a preemption signal arrived (``train/preempt.py``), on
        any rank of a group (the flag is all-reduced, and set on every
        rank): saves a resume checkpoint, unless this epoch's evaluation
        already saved one, and tells ``fit`` to stop."""
        flag = preempt.requested()
        if in_group():
            flag = bool(all_reduce_max(torch.tensor(float(flag),
                                                    device=self.device)))
            if flag:
                preempt.request()
        if not flag:
            return False
        if self.config.TRAIN.get("SAVE_CP") and not saved_this_epoch:
            self.save_checkpoint(self.config.TRAIN.SAVE_CP)
        print(f"[preempt] stopping after epoch {epoch}", flush=True)
        return True

    def _metric_logger(self) -> MetricLogger:
        if not hasattr(self, "_logger"):
            self._logger = MetricLogger(  # rank 0 alone writes it
                self.config.TRAIN.get("LOG_DIR") if self.group.rank == 0
                else None,
                run_name=self.trainer_name.lower(),
                use_wandb=(bool(self.config.TRAIN.get("USE_WANDB", False))
                           and self.group.rank == 0))
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

    def _train_epoch(self, epoch: int, logger: MetricLogger) -> AverageMeter:
        """``train_one(epoch)``; logs the train loss, the epoch's seconds
        (its ``train/epoch`` span), images/s over the steps it takes (the
        supervised trainer's ``n_iter_per_epoch``, else ``EVAL_STEP``) and
        the epoch's spans and counters a step (``trace.per_step``)."""
        self.epoch = epoch
        train_loss = self.train_one(epoch)  # runs inside trace.epoch()
        record = trace.last_epoch()
        epoch_s = record["spans"]["train/epoch"][0] / 1e9
        steps = getattr(self, "n_iter_per_epoch",
                        int(self.config.TRAIN.EVAL_STEP))
        imgs_per_sec = steps * self._images_per_step() / max(epoch_s, 1e-9)
        print(f"\tTrain Loss: {train_loss.avg:.3f} | {imgs_per_sec:.0f} img/s")
        logger.log({"loss/train": train_loss.avg,
                    "throughput/images_per_sec": imgs_per_sec,
                    "time/epoch_s": epoch_s, **trace.per_step(record)},
                   epoch=epoch)
        return train_loss

    @staticmethod
    def _log_valid(logger: MetricLogger, epoch: int, valid_loss,
                   valid_metric, record: dict) -> None:
        """The evaluation's loss and macro-F1, and the seconds of the
        ``eval/pass`` and ``ckpt/save`` spans in ``record`` (a
        ``trace.since``)."""
        print(f"\tValid Loss: {valid_loss.avg:.3f}")
        print(f"\tMetric: { {k: v for k, v in valid_metric.items() if k != 'sen/spec'} }")
        logger.log({"loss/valid": valid_loss.avg,
                    "metric/macro_f1": float(valid_metric["macro/f1"]),
                    **{f"time/{name}_s": v[0] / 1e9
                       for name, v in record["spans"].items()
                       if name in ("eval/pass", "ckpt/save")}},
                   epoch=epoch)

    def fit(self) -> None:
        """Train from ``epoch_start`` to ``TRAIN.EPOCHS``, evaluating and
        saving every ``FREQ_EVAL`` epochs. A resume at the final epoch only
        evaluates."""
        if self._evaluated_resume():
            return
        logger = self._metric_logger()
        for epoch in range(self.epoch_start, int(self.config.TRAIN.EPOCHS) + 1):
            best = (f"{float(self.best_valid_perf):.3f}"
                    if self.best_valid_perf is not None else "inf")
            print(f"Training epoch: {epoch} | The best loss: {best}")
            self._train_epoch(epoch, logger)
            saved_this_epoch = False
            if epoch % int(self.config.TRAIN.FREQ_EVAL) == 0:
                before = trace.totals()
                valid_loss, valid_metric = self.evaluate_one()
                if (self.best_valid_perf is None
                        or self.best_valid_perf > valid_loss.avg):
                    self.best_valid_perf = valid_loss.avg
                if self.config.TRAIN.get("SAVE_CP"):
                    self.save_checkpoint(self.config.TRAIN.SAVE_CP)
                    saved_this_epoch = True
                self._log_valid(logger, epoch, valid_loss, valid_metric,
                                trace.since(before))
            if self._preempt_break(epoch, saved_this_epoch):
                break
