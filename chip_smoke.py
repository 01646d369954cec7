#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``endoscopy_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device check: no CUDA means exit 1; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. builds the RandAugment kernel's extension (``endoscopy_tpu_torch/ops/
   csrc``) and prints the build, nvcc's register and shared-memory report
   included, then the launch's cluster size, shared memory per block,
   registers and ``cudaOccupancyMaxActiveClusters``, at 224 and 112 px;
3. holds the kernel against its plain PyTorch version on the card at 224 px
   and at 112 px (path C's side: clusters of 2), 224 images each, in
   float32 and bf16 I/O, in plain mode, crop mode on a padded input
   (``pad=0``) and crop mode with the reflect pad resolved in the load
   (``pad`` = side / 8): every op forced into slot 1 and fully sampled ``(pi,
   pf)``; the crop-fused launch against crop-then-launch and the
   pad-fused launch against reflect-pad-then-launch, both exact.
   Tolerance 0, except images that ran sharpness (0.51 in float32, the JAX
   package's own bar; 1.0 in bf16, one bf16 step at 128..255) or contrast
   (1.0 in float32: a contrast mean that rounds the other way at a near-tie
   moves a pixel by at most 1 - factor < 1; 2.0 in bf16);
4. path B: ``fixmatch_views`` on the flagship unlabeled batch, B*MU = 32*7
   = 224 canonical 268 px uint8 images in bf16, with ``reflect_pad`` made
   to fail (the card path must not pad); checks the strong view against
   the plain version on the same draws, and times the kernel's launch as
   ``fixmatch_views`` makes it with CUDA events, and per op;
5. path A: exports ResNet-50 (``configs/kaggle_semisupervised_real_3.yaml``:
   224 px, 268 px canonical, 6 classes, bf16) with seeded random weights,
   serves it with ``make_server`` on a localhost port, sends 64 concurrent
   raw requests from a client process, and checks every probability row
   against a direct batched forward (bf16, atol 0.02) and two rows against
   a float32 CPU forward of the same artifact (atol 0.05); then times the
   same requests through the same HTTP front with a 0 ms model, and one
   bucket-32 call outside the server. Path A2: the same model exported
   with weight-only int8 kernels (``serve/quantize.py``): the artifact's
   bytes beside the unquantized one's, its probabilities on the card
   against the unquantized artifact's (atol 0.03, the same argmax on every
   row) and two rows against its float32 CPU forward (atol 0.05), a
   bucket-32 call's time, and ``cli/infer.py::predict`` over the 64 images
   with and without ``--thres`` equal to direct calls of the artifact.
   Path A3: artifacts of models built for their side and of the
   Conformer: ``kaggle_semisupervised_real_5``'s SASA ResNet-50 exported
   at 112 px loads on the card (its encodings sized for 112) and serves
   64 images within atol 0.02 of a direct bf16 eval forward; a
   Conformer-Ti artifact (``kaggle_supervised_paper``'s fields, 23
   classes, its ``MODEL`` fields in the artifact) serves
   ``softmax(conv head)`` of a direct bf16 eval forward within 0.02, the
   same argmax on every row;
6. path C: the FixMatch trainer (``endoscopy_tpu_torch/train/fixmatch.py``)
   on ``configs/kaggle_semisupervised_real_3_1.yaml``'s fields (ResNet-50,
   112 px, B=32, MU=7, bf16, Adam, EMA; seeded random weights and seeded
   uint8 batches in pinned host memory): (1) for three seeds, one SGD step
   at B=4, MU=1 from one seeded state (each block's last BN scale 0.1) and
   the same draws on the card (float32 without TF32, then bf16) against
   the CPU's float32 step, THRES set in the widest gap between the weak
   max-probabilities that float32 and bf16 agree on (mask mean 0.25, 0.5
   or 0.75), and a bf16 control step without the strong view
   that the check must refuse; (2) ``train_one`` at full width, 480 images
   a step, 3 warm-up and 12 timed steps: step ms from CUDA events,
   images/s, peak memory, the model-FLOP share of the bf16 peak, the
   kernel launched once a step, the kernel against its plain version on
   the step's own input, and a CUDA-event split (labeled view,
   ``fixmatch_views`` and the kernel alone, forward+backward with and
   without the flax BN running variance and that repair alone,
   optimizer+EMA, and the host's enqueue time of each); (3) GRAD_ACCUM=2:
   two launches and one update a step; (4) two steps of
   ``kaggle_semisupervised_real_3.yaml`` (224 px, IS_FREEZE): the backbone
   bit-identical, every BN running statistic and the head moved;
7. path D: ``cli/learn.py`` end to end (``tests/torch_port_checks/
   path_d.py``): seeded six-class colour-separable images at the canonical
   size (a numpy copy of the JAX package's ``data/synthetic.py``), served
   by the port's ``CanonicalLoader``/``EvalLoader`` with only the decode
   swapped for a lookup. D1: ``run_config`` on ``kaggle_semisupervised_
   real_3_1``'s fields at full width (ResNet-50 with torch's initialization
   under ``torch.manual_seed``, 112 px, 480 images a step, 1,536 labeled,
   7,168 unlabeled and 1,024 valid images), cut to 3
   epochs of 16 steps, an evaluation and a checkpoint after each epoch, EMA
   decay 0.9; gates: the kernel launched once a step, the train loss lower
   in epoch 3 than in epoch 1, macro-F1 >= 0.9 after the last epoch,
   checkpoints ``epoch_1..3``; prints per-epoch wall seconds and images/s,
   the evaluation's ms per 1,024 images and images/s, ``save_checkpoint``
   ms and bytes, restore ms and peak memory. D2: a fresh trainer resumes
   ``latest_checkpoint`` as ``MODEL.PRE_TRAIN_RESUME`` does; gates: every
   parameter, BN statistic, EMA tensor, Adam moment and the step count
   bit-identical, ``epoch_start`` and ``best_valid_perf`` from
   ``meta.json``, the same evaluation bit for bit; then ``EPOCHS`` 4
   trains epochs 3 and 4 (a resume restarts at the saved epoch, as the
   reference does), and a resume at the final epoch only evaluates. D3:
   the 224 px stage (``kaggle_semisupervised_real_3``'s fields, IS_FREEZE;
   cut to one epoch of 2 steps) through ``run_config``'s steps with stage
   1's final weights carried; gates: the weights at entry equal stage 1's,
   after it the backbone is bit-identical and the head and every BN
   statistic moved, the kernel ran at 224 px (clusters of 4) once a step;
   prints the 224 px evaluation time.

8. path E: the supervised trainer (``endoscopy_tpu_torch/train/
   supervised.py``; configs and helpers in ``tests/torch_port_checks/
   path_e.py``) on path D's seeded 268 px images of known class (1,024
   train, 1,024 valid). E1: ``run_config`` on
   ``configs/kaggle_supervised_patho.yaml``'s fields at full width
   (ResNet-50 from fresh weights with flax's initializer, 224 px, B=32,
   Adam, cosine, EMA, class weights), cut to 3 epochs of 32 steps with an
   evaluation each and EMA decay 0.9; gates: the train loss lower in epoch
   3 than in epoch 1, the teacher's macro-F1 >= 0.9 after the last epoch,
   the checkpoints those the loss and F1 gate selects; prints step ms
   (CUDA events and epoch wall / steps), images/s, the model-FLOP share
   of the bf16 peak, one step's host enqueue, evaluation ms per 1,024
   images and peak memory. E2: the triplet branch at
   ``kaggle_supervised_ezbm.yaml``'s width (96 images a step), 3 warm-up
   and 8 timed steps; gates: every positive of its anchor's class and
   every negative of another, the MLP head's BN statistics moved, finite
   losses, and at GRAD_ACCUM=2 matched A/P/N rows in each microbatch and
   one update a step. E3: one SGD step at B=4, 112 px, float32 without
   TF32, card against CPU, for the plain and the triplet branch (path C
   part 1's method: each block's last BN scale 0.1, the same dropout
   draws, three seeds), both devices on the card's view and on the CPU's
   view (the same draws; the two views within 1e-5); the updates' bound
   on the CPU's view is path C's, three times the CPU float32 step's
   distance from its float64 step plus 1e-3; on the card's view the
   larger of that distance and each device's own move between the two
   views takes its place (a ReLU near-tie on the card, PERF.md). E4:
   the chain:
   ``cli/evaluate.py::evaluate`` on E1's checkpoint gives that epoch's
   evaluation bit for bit; ``BaseTrainer.inference``, the work of
   ``cli/pseudo_label.py``, over the 1,024 train images equals ``argmax · [max > THRES]`` of a direct eval
   forward; the checkpoint grafted as ``MODEL.PRE_TRAIN_PATH`` into
   ``kaggle_semisupervised_real_3_1``'s FixMatch trainer arrives with its
   backbone bit-identical. No kernel runs on this path (0 launches).
9. path F: the CoMatch trainer (``endoscopy_tpu_torch/train/comatch.py``;
   configs and helpers in ``tests/torch_port_checks/path_f.py``) on
   ``configs/kaggle_semisupervised_real_1.yaml``'s fields (ResNet-50 under
   ``ModelwEmb``, LOW_DIM 64, 112 px, B=32, MU=5: 512 images a step, Adam,
   cosine, EMA, class weights, THRES 0.9). F1: for three seeds, one SGD
   step at B=4, MU=1 from a seeded state (each block's last BN scale 0.1,
   the MLP head's first bias 3 so that every unit is active) with the same
   draws and dropout keep-mask, on the card (float32 without TF32 on both
   devices' views, as E3; then bf16) against the CPU's float32 step at
   path C's bounds;
   THRES in the widest gap of the weak max-probabilities (after DA and
   smoothing) that float32 and bf16 agree on, no off-diagonal ``Q`` entry
   within their disagreement of 0.8, and a bf16 control whose strong-1
   view is strong-0 that the check must refuse. F2: ``train_one`` at full
   width, 3 warm-up and 12 timed steps: step ms, images/s, the FLOP share,
   peak memory, one kernel launch a step (plain mode, no crop), the kernel
   against its plain version on the step's own strong-0 input (0.0), a
   CUDA-event split (labeled view, ``comatch_views``, the kernel alone,
   forward+backward, the no-grad block and graph loss, optimizer+EMA, each
   with its host enqueue), ``da_count`` and the memory bank still zero
   (the reference's ``n == queue_size`` gate). F3: ``run_config`` on real_1's
   fields with path D's kind of seeded images (512 labeled, 1,280
   unlabeled, 512 valid at 134 px), cut to 3 epochs of 8 steps with an
   evaluation and a checkpoint each and EMA decay 0.9: one launch a step,
   a finite and falling train loss, the checkpoints and evaluations; then
   3 steps of ``kaggle_semisupervised_real_1_1``'s fields (SGD, MU=7, 704
   images a step).

10. path G: the SemiFormer trainer (``endoscopy_tpu_torch/train/
   semiformer.py``, the dual-head Conformer-Ti of ``models/conformer.py``;
   configs and helpers in ``tests/torch_port_checks/path_g.py``) on
   ``configs/kaggle_semisupervised_real_2.yaml``'s fields (224 px, B=32,
   MU=6: 416 images a FixMatch-phase step, Adam, step schedule, EMA, class
   weights, THRES 0.7, LAMBDA_U 2, GRAD_ACCUM 1). G1: for three seeds, one
   warmup step and one FixMatch-phase SGD step at 112 px, B=4, MU=1 from a
   seeded state (each conv block's last BN scale 0.1, both heads' kernels
   ×4: ``path_g.HEAD_SCALE``) with the same draws, float32 on the card on
   both devices' views against the CPU's float32 step (path F1's bounds,
   with a float64 reference), bf16 against it at 0.02 and 0.12, THRES in
   the widest gap of the conv head's weak max-probabilities, and a bf16
   control whose strong view is the weak one that each of the two bounds
   must refuse.
   G2: ``train_one`` in the FixMatch phase at full width, 3 warm-up and 12
   timed steps: step ms, images/s, the FLOP share (the counter counts a
   linear layer once per row and attention's two products), peak memory,
   one crop-fused kernel launch a step (``pad=28``), the kernel against
   its plain version on the step's own strong-view input (0.0), a split
   (labeled view, ``fixmatch_views``, the kernel, forward+backward,
   optimizer+EMA, each with its host enqueue) and the warmup step (32
   images). G3: ``kaggle_supervised_paper.yaml``'s Conformer (23 classes,
   224 px) one epoch through ``run_config`` on path D's stage-2 images,
   its checkpoint as real_2's ``PRE_TRAIN_PATH`` (the trunk bit-identical,
   both 6-class heads fresh), real_2 cut to 3 epochs of 8 steps
   (``EVAL_STEP_SUP`` 2: epoch 1 the warmup sweep of the labeled set)
   with an evaluation and a checkpoint each and EMA decay 0.9: launches 0
   in epoch 1 and one a step after it, a finite train loss, ``epoch_1..3``,
   the evaluation's probabilities ``softmax(conv + trans)`` of a direct
   EMA forward; then 3 FixMatch-phase steps of
   ``kaggle_semisupervised_real_2_1.yaml``'s fields (112 px, 312 images).

11. path H: the EZBM trainer (``endoscopy_tpu_torch/train/ezbm.py``;
   configs and helpers in ``tests/torch_port_checks/path_h.py``) on
   ``configs/kaggle_supervised_ezbm.yaml``'s fields (ResNet-50 under
   ``ModelwEmb``, 224 px, B=32, MU=6, Adam, step schedule, EMA, class
   weights, ``LAMBDA_C`` 4, ``EXPANSION`` balance). H1: for three seeds,
   a stage-1 SGD step at 112 px, B=4 (BN scale 0.1) by path E3's method,
   the memorized anchor features too; then a stage-2 step on the CPU's
   memorized features with the same draws (``reverse`` mode, so ``lam``
   is not 0.5) and dropout mask, card vs CPU (the loss, ``fc``'s SGD
   update, the head's BN statistics after both passes), and the same step
   under Adam on the card with every tensor outside ``fc`` unmoved. H2:
   stage 1 at full width (96 images a step), 3 warm-up and 8 timed steps,
   the memory on the card; stage 2 (192 features a step): the numpy
   sampler's host time, the step's CUDA-event time and enqueue, a step of
   ``train_one_stage_2`` on the host clock. H3: ``prepare_trainer`` and
   ``fit`` on ``configs/kvasir_capsule_transfer.yaml``'s fields (11
   classes, ``INPUT_NAME: path``) on seeded 11-class images, E1's latest
   checkpoint as ``PRE_TRAIN_PATH``, cut to 2 epochs a stage: the trunk
   bit-identical, ``fc`` and ``head_emb`` fresh, both stages, one fresh
   stage-2 optimizer at count 0, the checkpoints those the loss and F1
   gate selects in stage 2, finite losses. No kernel runs on it.
12. path I: EfficientNet-B1 (``endoscopy_tpu_torch/models/
   efficientnet.py``; ``tests/torch_port_checks/path_i.py``). I1: for
   three seeds, ``kaggle_supervised_abnorm``'s step (2 classes) at 112 px,
   B=4 by path E3's method; then bf16 on the card against the CPU's
   float32 step (losses 0.02, updates ``I1_TOL_BF16_UPDATE``) and a bf16
   control on the un-augmented eval view that the update bound must
   refuse. I2: 3 warm-up and 8 timed steps at ``kaggle_supervised_
   abnorm``'s width (32 images, 224 px, Adam, no EMA), then 3 of
   ``kaggle_supervised``'s (``ModelwEmb``, the triplet branch, 96
   images): step ms, images/s, the FLOP share, peak memory. No kernel
   runs on it.
13. path J: FixMatch on the SASA ResNet-50 (``endoscopy_tpu_torch/models/
   attention.py``; ``tests/torch_port_checks/path_j.py``) at
   ``configs/kaggle_semisupervised_real_5.yaml``'s fields (112 px, B=32,
   MU=6: 416 images a step, SGD nesterov, cosine, EMA, THRES 0.7,
   ``LAMBDA_U`` 2). J1: path C part 1 for three seeds, each SASA layer's
   q kernel ×0.1 (``J1_Q_SCALE``). J2: ``train_one`` at full width, 3
   warm-up and 12 timed steps: step ms, images/s, the FLOP share, peak
   memory, one kernel launch a step, crop-fused with ``pad=14`` on
   (192, 112, 112, 3) bf16, against its plain version on the step's own
   input (0.0), its ms beside its bytes bound.
14. path K: FixMatch on DenseNet-161 (``endoscopy_tpu_torch/models/
   densenet.py``; ``tests/torch_port_checks/path_k.py``) at
   ``kaggle_semisupervised_real_3_1``'s fields with ``MODEL.NAME:
   densenet161`` (112 px, B=32, MU=7: 480 images a step, Adam, step
   schedule, EMA). K1: path C part 1 for three seeds, the channels each
   dense block grew at BN scale 0.1 wherever they are read
   (``path_k.GROWN_SCALE``). K2: ``train_one`` at full
   width, 3 warm-up and 12 timed steps: step ms, images/s, the FLOP share,
   peak memory, one kernel launch a step, crop-fused with ``pad=14`` on
   (224, 112, 112, 3) bf16, against its plain version on the step's own
   input (0.0), its ms beside its bytes bound.
15. path L: Swin-T (``endoscopy_tpu_torch/models/swin.py``;
   ``tests/torch_port_checks/path_l.py``) in the supervised trainer at
   ``kaggle_supervised_patho``'s fields with ``MODEL.NAME:
   swin_tiny_patch4_window7_224`` (224 px, B=32, Adam, cosine, EMA). L1:
   path E3's method at 224 px (Swin's stage sides must be even: 112 px
   fails in both packages), B=2, seeds 0-2. L2: 3 warm-up and 8 timed
   steps: step ms, images/s, the FLOP share (the window attention's two
   products counted), peak memory. No kernel runs on it.
16. path M: every other registry name this slice ports
   (``path_l.M_NAMES``: the SE, grouped and gated ResNets, DenseNet-121,
   Swin-S, SwinMLP, CoAtNet-0, ViT-LSA) at ``kaggle_supervised_patho``'s
   width: built on the card, a float32 eval forward of 2 images within
   1e-4 of the largest logit of the CPU's, one warm-up and two timed bf16
   supervised steps (32 images at 224 px) with a finite loss, and the
   artifact through ``load_exported`` equal to a direct eval forward; a
   line a model with its step ms and peak memory. No kernel runs on it.

The last lines are the card's name and power limit, one ``{"kernels": ...}``
JSON line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_port_checks import (path_c, path_d, path_e, path_f,  # noqa: E402
                               path_g, path_h, path_i, path_j, path_k,
                               path_l)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)

IMG, CANON, PAD = 224, int(224 * 1.2), int(224 * 0.125)
BATCH = 32 * 7  # DATA.BATCH_SIZE * DATA.MU of the flagship config
N_REQUESTS = 64
TOL = {"float32": {"sharpness": 0.51, "contrast": 1.0},
       "bfloat16": {"sharpness": 1.0, "contrast": 2.0}}
SERVE_ATOL = 0.02  # probabilities, bucketed bf16 vs one batched bf16 forward
F32_ATOL = 0.05  # probabilities, bf16 on the card vs float32 on the CPU
# path A2: int8 weights against the unquantized artifact, both on the card
# (the JAX package's bar, tests/test_serve.py), and the same argmax
INT8_ATOL = 0.03

IMG_C = path_c.REAL_3_1["DATA"]["IMG_SIZE"]  # path C's full-width side
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 3, 12
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# path C part 1: one step at B=4, MU=1 on the card against the CPU's
# float32 step, from seeded states whose blocks' last BN scale is 0.1 (at
# 1 the random ResNet-50 is chaotic: its float32 step is 2.4e-2 from its
# float64 step, 7.5e-4 at 0.1), for three seeds. float32 without TF32
# sums in another order: 1e-4 on the losses; the updates' bound is
# measured in the run (three times the CPU float32 step's distance from
# its float64 step, plus 1e-3). bf16: the CPU's bf16 autocast step sat at
# 1.8e-3..2.7e-3 on the losses and 0.22..0.23 on the updates, its strong
# view replaced by the weak one (the kernel skipped) at 3.1e-2..0.41 and
# 0.86..0.92 (seeds 0-2); each run checks that this control fails.
PART1_SEEDS, PART1_RESIDUAL_GAMMA = 3, 0.1
TRIPLET_WARMUP_STEPS, TRIPLET_TIMED_STEPS = 3, 8  # path E2
# path E3: the labeled view on the card against the CPU's, normalized
# units: the last-bit roundings of its jitter's means and its normalize
# (7.2e-7 read on the H100), far below a wrong op or draw
E3_VIEW_TOL = 1e-5
TRAIN_TOL_F32_LOSS = 1e-4
TRAIN_TOL_BF16_LOSS, TRAIN_TOL_BF16_UPDATE = 0.02, 0.5
# path G1's bf16 bound on the updates: sound steps read 0.023..0.053 on the
# H100 (seeds 0-2, warmup and FixMatch phase), the weak-as-strong control
# 0.18..0.52, so 0.5 let the control through on the updates alone
G1_TOL_BF16_UPDATE = 0.12
# path H1's bound on fc's stage-2 SGD update, card vs CPU: a float32 MLP
# head on given features, no backbone (path C's additive term)
H1_STAGE2_TOL = 1e-3
# path I1's bf16 bound on the updates (EfficientNet-B1, B=4, 112 px): on
# the H100 the sound bf16 steps read 0.29-0.34 from the CPU's float32 step,
# the control on the un-augmented view 0.79-1.27 (seeds 0-2), while its
# losses (1.2e-2..0.20) mostly pass path C's 0.02; so the updates decide
I1_TOL_BF16_UPDATE = 0.5
# path J1's conditioning of the random SASA ResNet-50: its q kernels x 0.1.
# At 1, q·k is large enough to saturate the softmax: the CPU's float32
# step read 6.2e-3..3.0e-2 from float64 and bf16-rounded views moved it
# 1.2-1.5; at 0.1, 7.8e-4..3.1e-3 and 0.18 (seeds 0-1)
J1_Q_SCALE = 0.1
# path M, for each name: a float32 eval forward of M_IMAGES images on the
# card against the CPU's (relative to the largest logit: float32 in
# another summation order, no TF32), then M_WARMUP_STEPS + M_TIMED_STEPS
# bf16 supervised steps
M_IMAGES, M_EVAL_TOL = 2, 1e-4
M_WARMUP_STEPS, M_TIMED_STEPS = 1, 2


# 64 concurrent raw requests from one client process: argv = port, .npy
CLIENT = """
import json, sys, time, urllib.request
from concurrent.futures import ThreadPoolExecutor
import numpy as np
port, imgs = int(sys.argv[1]), np.load(sys.argv[2])
def post(img):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=img.tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    return body["probs"], (time.perf_counter() - t0) * 1e3
t0 = time.perf_counter()
with ThreadPoolExecutor(len(imgs)) as pool:
    replies = list(pool.map(post, imgs))
json.dump({"probs": [p for p, _ in replies], "ms": [m for _, m in replies],
           "wall_s": time.perf_counter() - t0}, sys.stdout)
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 3) -> float:
    """The host's time to enqueue one call, without waiting for the card:
    close to the call's CUDA-event time, the host sets the pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def ops_ran(pi, n_slots: int = 2):
    """Per image, the set of ops its applied slots ran."""
    pi = pi.tolist()
    return [{row[2 + 2 * s] for s in range(n_slots) if row[3 + 2 * s] == 1}
            for row in pi]


def image_tolerances(pi, dtype_name: str):
    import torch
    tol = TOL[dtype_name]
    return torch.tensor([max([0.0] + [tol["sharpness"] for o in ops if o == 8]
                             + [tol["contrast"] for o in ops if o == 3])
                         for ops in ops_ran(pi)])


def phase_compare(gen, img: int):
    """Kernel against plain version at ``img`` px (224 images, pad img/8)
    in the three modes; returns the max abs error."""
    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        NUM_OPS, randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.ops.randaugment_kernel import randaugment_mc

    reflect = int(img * 0.125)
    worst = 0.0
    side = img + 2 * reflect
    base = torch.randint(0, 256, (BATCH, side, side, 3), generator=gen)
    pi, pf = sample_randaugment_params(gen, BATCH, img, img)
    forced = pi.clone()
    forced[:, 2] = torch.arange(BATCH) % NUM_OPS
    forced[:, 3] = 1
    offs = torch.randint(0, 2 * reflect + 1, (BATCH, 2), generator=gen,
                         dtype=torch.int32)
    offs[:2] = torch.tensor([[0, 2 * reflect],
                             [2 * reflect, 0]])  # both mirrors
    pf = pf.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        padded = base.to(dtype).cuda()
        center = padded[:, reflect:reflect + img, reflect:reflect + img]
        for mode in ("crop", "pad", "plain"):
            # plain: a strided view (element loads); crop: the padded
            # input, pad 0; pad: the contiguous un-padded image, as
            # fixmatch_views hands it over (16-byte vector loads)
            crop = None if mode == "plain" else img
            pad = reflect if mode == "pad" else 0
            x = {"crop": padded, "pad": center.contiguous(),
                 "plain": center}[mode]
            for label, p in (("forced", forced), ("sampled", pi)):
                p = (torch.cat([p, offs], 1) if crop else p).cuda()
                got = randaugment_mc(x, p, pf, crop, pad)
                ref = randaugment_mc_plain(x, p, pf, crop, pad)
                torch.cuda.synchronize()
                if got.shape != (BATCH, img, img, 3) or got.dtype != dtype:
                    fail(f"kernel output {got.dtype} {tuple(got.shape)}")
                err = (got.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
                tol = image_tolerances(p, dname)
                worst = max(worst, float(err.max()))
                if label == "forced":
                    for op in range(NUM_OPS):
                        e, t = err[op::NUM_OPS], tol[op::NUM_OPS]
                        print(f"kernel-vs-plain {img} px {dname:8s} {mode:5s} "
                              f"op{op:<2d} max_abs_err={float(e.max())} "
                              f"tol={float(t.max())}", flush=True)
                else:
                    print(f"kernel-vs-plain {img} px {dname:8s} {mode:5s} "
                          f"sampled max_abs_err={float(err.max())} "
                          f"tol={float(tol.max())}", flush=True)
                bad = (err > tol).nonzero().flatten().tolist()
                if bad:
                    fail(f"{img} px {dname} {mode} {label}: images "
                         f"{bad[:8]} exceed their tolerance (errors {err[bad[:8]].tolist()})")
            p = torch.cat([pi, offs], 1).cuda()
            if mode == "crop":  # crop-fused == crop, then a plain launch
                fused = randaugment_mc(padded, p, pf, img)
                cropped = ops.crop_at(padded, img, offs[:, 0], offs[:, 1])
                unfused = randaugment_mc(cropped, pi.cuda(), pf)
                what = "crop-fused-vs-crop-then-kernel"
            elif mode == "pad":  # pad-fused == reflect pad, then pad 0
                fused = randaugment_mc(x, p, pf, img, reflect)
                unfused = randaugment_mc(ops.reflect_pad(x, reflect), p, pf, img)
                what = "pad-fused-vs-reflect-pad-then-kernel"
            else:
                continue
            torch.cuda.synchronize()
            e = float((fused.float() - unfused.float()).abs().max())
            print(f"{what} {img} px {dname} max_abs_err={e} tol=0.0",
                  flush=True)
            if e != 0.0:
                fail(f"{what}: the launches differ ({e})")
    return worst


def phase_views(gen, seed: int):
    """Path B: fixmatch_views on the flagship unlabeled batch."""
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.aug.views import eval_view, fixmatch_views, normalize
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    u8 = torch.randint(0, 256, (BATCH, CANON, CANON, 3), generator=gen,
                       dtype=torch.uint8).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    flips = torch.rand(BATCH, generator=g, device="cuda") < 0.5
    tops, lefts = ops.sample_crop_offsets(g, BATCH, 2 * PAD)
    pi, pf = sample_randaugment_params(g, BATCH, IMG, IMG)
    draws = dict(flips=flips, tops=tops, lefts=lefts, pi=pi, pf=pf)

    def no_pad(*_):
        raise AssertionError("fixmatch_views made a reflect-padded batch")

    torch.cuda.synchronize()
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(ops, "reflect_pad", no_pad):
        weak, strong = fixmatch_views(u8, IMG, torch.bfloat16, **draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    print(f"path B: fixmatch_views on {tuple(u8.shape)} uint8 -> weak/strong "
          f"{tuple(strong.shape)} {strong.dtype} in {first_s:.4f} s (first "
          f"call); randaugment_mc launches {launches}", flush=True)
    if launches < 1:
        fail("path B did not launch the RandAugment kernel")
    for name, v in (("weak", weak), ("strong", strong)):
        if v.shape != (BATCH, IMG, IMG, 3) or v.dtype != torch.bfloat16:
            fail(f"{name} view is {v.dtype} {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            fail(f"{name} view has non-finite values")
    if not torch.equal(weak, eval_view(u8, IMG, torch.bfloat16)):
        fail("weak view differs from the eval view (center crop + normalize)")

    # the same draws through the plain version; x is the kernel's input as
    # fixmatch_views makes it: the flipped 224 px image, not padded
    x = ops.center_crop(u8, IMG).to(torch.bfloat16)
    x = torch.where(flips.view(-1, 1, 1, 1), ops.hflip(x), x)
    pi_c = torch.cat([pi, tops[:, None], lefts[:, None]], 1)
    ref = normalize(randaugment_mc_plain(x, pi_c, pf, IMG, PAD),
                    torch.bfloat16)
    err = (strong.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
    # the pixel tolerances in normalized units (std >= 0.224), plus one
    # bf16 step of a normalized value (|v| < 4) where they are not 0
    tol = image_tolerances(pi_c, "bfloat16") / 255.0 / 0.224
    tol = torch.where(tol > 0, tol + 2.0 ** -6, tol)
    bad = (err > tol).nonzero().flatten().tolist()
    print(f"path B: strong view vs plain version on the same draws: "
          f"max_abs_err={float(err.max())} (normalized units)", flush=True)
    if bad:
        fail(f"strong view differs from the plain version on images {bad[:8]}")

    views_ms = cuda_ms(lambda: fixmatch_views(u8, IMG, torch.bfloat16,
                                              **draws), iters=10)
    ms = cuda_ms(lambda: rk.randaugment_mc(x, pi_c, pf, IMG, PAD), iters=50,
                 warmup=3)
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(x, pi_c, pf, IMG, PAD),
                       iters=2, warmup=1)
    per_op = []
    for op in [None] + list(range(14)):  # None: no op applied
        p = pi_c.clone()
        p[:, 3] = p[:, 5] = 0
        if op is not None:
            p[:, 2], p[:, 3] = op, 1
        per_op.append(cuda_ms(lambda: rk.randaugment_mc(x, p, pf, IMG, PAD),
                              iters=20))
    print("path B: randaugment_mc ms with every image running one op in "
          f"slot 1 (none, op0..op13): {[round(t, 4) for t in per_op]}",
          flush=True)
    # the bytes the kernel must move: each image's window read once, the
    # output written once, and the (pi, pf) rows
    window = BATCH * IMG * IMG * 3 * x.element_size()
    bytes_moved = 2 * window + pi_c.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"path B timing: fixmatch_views {views_ms:.4f} ms; randaugment_mc "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} "
          f"ms ({bytes_moved} B at {HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def seeded_resnet50(seed: int):
    """``kaggle_semisupervised_real_3``'s ResNet-50 for serving."""
    from endoscopy_tpu_torch.config.loader import default_config

    config = default_config({
        "DATA": {"IMG_SIZE": IMG, "IS_CROP": True},
        "MODEL": {"NAME": "resnet50", "NUM_CLASSES": 6},
        "TRAIN": {"DTYPE": "bfloat16"}})
    return config, path_c.seeded_model(config, seed)


def phase_serve(seed: int, out_dir: Path):
    """Path A: export, serve 64 concurrent raw requests, check them."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.serve.export import export_model, load_exported
    from endoscopy_tpu_torch.serve.server import ModelServer, make_server

    config, model = seeded_resnet50(seed)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "resnet50_seeded.pt")
    size, n_classes = export_model(config, model.state_dict(), path)
    imgs = np.random.default_rng(seed).integers(
        0, 256, (N_REQUESTS, size, size, 3)).astype(np.uint8)

    rk.randaugment_mc.launches = 0
    server = make_server(path, host="127.0.0.1", port=0, device="cuda",
                         log=lambda m: print(f"path A {m}", flush=True))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    npy = str(out_dir / "requests.npy")
    np.save(npy, imgs)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        # the clients run in a process of their own, as real clients do
        client = subprocess.run([sys.executable, "-c", CLIENT, str(port), npy],
                                capture_output=True, text=True, timeout=600)
        if client.returncode != 0:
            fail(f"client process failed:\n{client.stderr[-3000:]}")
        replies = json.loads(client.stdout)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.close()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("server thread did not stop")
    launches = rk.randaugment_mc.launches

    probs = np.asarray(replies["probs"])
    lat = np.sort(replies["ms"])
    print(f"path A: healthz {json.dumps(health)}", flush=True)
    print(f"path A: {N_REQUESTS} concurrent requests in "
          f"{replies['wall_s']:.3f} s; "
          f"latency p50 {lat[len(lat) // 2]:.2f} ms p99 "
          f"{lat[int(len(lat) * 0.99)]:.2f} ms; randaugment_mc launches "
          f"{launches} (none expected)", flush=True)
    print(f"path A: /stats {json.dumps(stats)}", flush=True)
    if probs.shape != (N_REQUESTS, n_classes) or not np.isfinite(probs).all():
        fail(f"served probabilities {probs.shape} are not finite "
             f"({N_REQUESTS}, {n_classes})")
    sums = np.abs(probs.sum(1) - 1.0).max()
    infer_dev = load_exported(path, device="cuda")
    direct = infer_dev(imgs)
    err = float(np.abs(probs - direct).max())
    cpu = load_exported(path, device="cpu")(imgs[:2])
    err32 = float(np.abs(probs[:2] - cpu).max())
    print(f"path A: |sum(probs) - 1| <= {sums:.2e}; served vs batched "
          f"forward max_abs_err={err} (atol {SERVE_ATOL}); vs float32 CPU "
          f"max_abs_err={err32} (atol {F32_ATOL}); probs[0]="
          f"{np.round(probs[0], 4).tolist()}", flush=True)
    if sums > 1e-4:
        fail(f"probability rows do not sum to 1 ({sums})")
    if err > SERVE_ATOL:
        fail(f"served probabilities differ from the batched forward ({err})")
    if err32 > F32_ATOL:
        fail(f"bf16 probabilities differ from the float32 forward ({err32})")
    if stats["requests"] != N_REQUESTS or stats["errors"]:
        fail(f"server stats {stats}")

    # the same requests through the same HTTP front with a 0 ms model:
    # what the host side alone costs
    stub = ModelServer(("127.0.0.1", 0),
                       lambda b: np.full((b.shape[0], n_classes),
                                         1.0 / n_classes, np.float32),
                       input_size=size, num_classes=n_classes,
                       buckets=health["buckets"], max_wait_ms=5.0,
                       backend="none")
    thread = threading.Thread(target=stub.serve_forever, daemon=True)
    thread.start()
    try:
        client = subprocess.run(
            [sys.executable, "-c", CLIENT, str(stub.server_address[1]), npy],
            capture_output=True, text=True, timeout=600)
    finally:
        stub.close()
        thread.join(timeout=60)
    if client.returncode != 0 or thread.is_alive():
        fail(f"0 ms model server run failed:\n{client.stderr[-3000:]}")
    host = json.loads(client.stdout)
    hl = np.sort(host["ms"])
    print(f"path A: the same {N_REQUESTS} requests, same HTTP front, 0 ms "
          f"model: {host['wall_s']:.3f} s; latency p50 "
          f"{hl[len(hl) // 2]:.2f} ms p99 {hl[int(len(hl) * 0.99)]:.2f} ms",
          flush=True)

    # where a bucket-32 call's time goes, outside the server
    batch = imgs[:32]
    t0 = time.perf_counter()
    for _ in range(10):
        infer_dev(batch)
    infer_ms = (time.perf_counter() - t0) * 100
    model = model.cuda().eval().to(memory_format=torch.channels_last)
    x = torch.zeros(32, 3, IMG, IMG, device="cuda").to(
        memory_format=torch.channels_last)
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        fwd_ms = cuda_ms(lambda: model(x), iters=20, warmup=3)
    print(f"path A: batch of 32 outside the server: infer (upload, view, "
          f"forward, softmax, download) {infer_ms:.2f} ms host clock; "
          f"ResNet-50 forward alone {fwd_ms:.2f} ms CUDA events", flush=True)


def step_loaders(config, seed: int, marks: list, n: int = 4):
    """(labeled, unlabeled) loaders cycling over ``n`` seeded canonical
    batches in pinned host memory, as a DataLoader with ``pin_memory``
    hands them over. The labeled one records a CUDA event into ``marks``
    each time a step takes its batch, so the events split the stream into
    steps."""
    import itertools

    import torch

    pinned = [(torch.from_numpy(x).pin_memory(), torch.from_numpy(t),
               torch.from_numpy(u).pin_memory())
              for x, t, u in path_c.canonical_batches(config, seed, n)]

    def labeled():
        for i in itertools.count():
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            marks.append(mark)
            yield pinned[i % n][0], pinned[i % n][1]

    def unlabeled():
        for i in itertools.count():
            yield pinned[i % n][2], pinned[i % n][1]

    return labeled(), unlabeled()


def _bf16_views(x, w, u):
    return tuple(v.bfloat16().to(v.dtype) for v in (x, w, u))


def _weak_as_strong(x, w, u):
    return x, w, w  # as if the kernel had left the strong view undone


def _step_errors(got, ref):
    """(mask mean equal, worst relative error of loss, lx, lu, relative L2
    error of the updates, worst tensor)."""
    (stats, upd), (ref_stats, ref_upd) = got, ref
    rel = max(abs(a - b) / abs(b) for a, b in zip(stats[:3], ref_stats[:3]))
    return (stats[3] == ref_stats[3], rel, *path_c.update_errors(upd, ref_upd))


def weak_max_probs(config, model, batch, device: str, seed: int):
    """The max softmax probability of each weak row of the step that
    ``path_c.step_once`` takes with these arguments, from the same
    train-mode forward over all the step's views, in the config's dtype."""
    import copy

    import torch

    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    trainer = FixMatch(copy.deepcopy(model), "SGD", device=device)
    trainer.get_config(config)
    trainer.generator = torch.Generator().manual_seed(seed)
    x, w, u = trainer._views(batch[0], batch[2])
    with torch.no_grad(), torch.autocast(
            device, torch.bfloat16, enabled=trainer.dtype == torch.bfloat16):
        logits = trainer.state.model.train()(
            torch.cat([x, w, u]).permute(0, 3, 1, 2)).float()
    b = x.shape[0]
    return torch.softmax(logits[b:b + w.shape[0]], -1).amax(-1).cpu()


def train_step_matches_cpu(seed: int, base=path_c.REAL_3_1,
                           label: str = "path C part 1", condition=None):
    """Path C, part 1, for one seed: one step of ``base``'s model (real_3_1's
    ResNet-50) at 112 px, B=4, MU=1, from one seeded state (``condition``
    applied to the model) and the same draws, on the card against the
    CPU's float32 step. All three card steps run before any of them is
    judged."""
    small = {"DATA": {"BATCH_SIZE": 4, "MU": 1}, "TRAIN": {"DTYPE": "float32"}}
    config = path_c.train_config(base, **small)
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD,
                                PART1_RESIDUAL_GAMMA)
    if condition is not None:
        condition(model)
    batch = path_c.canonical_batches(config, seed, 1)[0]

    # THRES in the gap between two of the four weak max-probabilities that
    # leaves the same rows above it in the CPU's float32 forward and in
    # the card's bf16 forward, the widest such gap: the mask mean is 0.25,
    # 0.5 or 0.75, and no precision moves a row across it
    p32 = weak_max_probs(config, model, batch, "cpu", seed)
    config.TRAIN.DTYPE = "bfloat16"
    p16 = weak_max_probs(config, model, batch, "cuda", seed)
    config.TRAIN.DTYPE = "float32"
    order = p32.sort(descending=True).values
    thres, margin = None, 0.0
    for k in (1, 2, 3):  # rows at or above THRES
        t = float(order[k - 1] + order[k]) / 2
        m = min(float((p32 - t).abs().min()), float((p16 - t).abs().min()))
        if int((p16 >= t).sum()) == k and m > margin:
            thres, margin = t, m
    print(f"{label}, seed {seed}: weak max-probabilities, float32 on "
          f"the CPU {p32.tolist()}, bf16 on the card {p16.tolist()}; THRES "
          f"{thres}, margin {margin:.3e}", flush=True)
    if thres is None:
        fail(f"{label}: no THRES splits the weak rows alike in float32 "
             "and bf16")
    config.TRAIN.THRES = thres

    def step(device, alter=None):
        return path_c.step_once(config, model, batch, device, seed, alter)

    ref = step("cpu")
    upd64 = path_c.step_float64(config, model, batch, seed)
    cpu_l2, cpu_worst = path_c.update_errors(ref[1], upd64)
    _, r_loss, r_l2, _ = _step_errors(step("cpu", _bf16_views), ref)
    print(f"{label}, seed {seed}: the CPU's float32 step against its "
          f"float64 step: updates relative L2 error {cpu_l2:.3e}, worst "
          f"tensor {cpu_worst:.3e}; against itself on views rounded to bf16: "
          f"losses {r_loss:.3e}, updates {r_l2:.3e}", flush=True)
    if not 0.2 < ref[0][3] < 0.8:
        fail(f"{label}: mask mean {ref[0][3]} is not strictly between 0.2 "
             "and 0.8")
    out = {"cpu_f32_vs_f64_l2": cpu_l2, "cpu_bf16_views_loss": r_loss,
           "cpu_bf16_views_l2": r_l2}
    # as close to the CPU's step as float32 allows: three times the CPU
    # float32 step's own distance from float64, and 1e-3
    bounds = {"float32": (TRAIN_TOL_F32_LOSS, 3 * cpu_l2 + 1e-3),
              "bfloat16": (TRAIN_TOL_BF16_LOSS, TRAIN_TOL_BF16_UPDATE)}
    failures = []
    for dtype, alter in (("float32", None), ("bfloat16", None),
                         ("bfloat16", _weak_as_strong)):
        config.TRAIN.DTYPE = dtype
        got = step("cuda", alter)
        same_mask, rel, l2, worst = _step_errors(got, ref)
        l2_64 = path_c.update_errors(got[1], upd64)[0]
        loss_bound, bound = bounds[dtype]
        what = dtype if alter is None else f"{dtype} control (weak as strong)"
        print(f"{label}, seed {seed}: {what} on the card vs float32 on "
              f"the CPU: [loss, lx, lu, mask_mean] {got[0]} vs {ref[0]}; "
              f"worst relative loss error {rel:.3e} (bound {loss_bound}); SGD "
              f"updates relative L2 error {l2:.3e} (bound {bound:.3e}), worst "
              f"tensor {worst:.3e}; against the CPU's float64 step "
              f"{l2_64:.3e}", flush=True)
        sound = same_mask and rel <= loss_bound and l2 <= bound
        if alter is not None:
            if sound:
                failures.append("the bf16 check passes a step without the "
                                "strong view")
            out["bfloat16_control"] = {"loss_rel_err": rel, "update_l2_err": l2}
            continue
        if not sound:
            failures.append(f"the {dtype} step on the card differs from the "
                            "CPU's")
        out[dtype] = {"loss_rel_err": rel, "update_l2_err": l2,
                      "update_worst_tensor_err": worst,
                      "update_l2_err_vs_f64": l2_64}
    if failures:
        fail(f"{label}: " + "; ".join(failures))
    return out


def phase_train_correctness(seed: int):
    """Path C, part 1, for ``PART1_SEEDS`` seeds from ``seed``."""
    return {s: train_step_matches_cpu(s)
            for s in range(seed, seed + PART1_SEEDS)}


def _attention_macs():
    """Multiply-adds of the attention layers' batched products, by layer
    type, from the layer and its input: ``q·kᵀ`` and ``attn·v`` (each
    ``heads · n² · head_dim`` a sample), SASA's ``q·k`` and ``weights·v``
    over each pixel's ``ks²`` window, SwinMLP's per-head ``n x n`` mixing
    of each window."""
    from endoscopy_tpu_torch.models.attention import SASALayer
    from endoscopy_tpu_torch.models.coatnet import RelAttention
    from endoscopy_tpu_torch.models.conformer import Attention
    from endoscopy_tpu_torch.models.swin import WindowAttention
    from endoscopy_tpu_torch.models.swin_mlp import SpatialMLP
    from endoscopy_tpu_torch.models.vit_lsa import LSA

    def products(inner):
        def macs(m, x):
            b, n, c = x.shape
            return 2 * b * n * n * inner(m, c)
        return macs

    return {
        SASALayer: lambda m, x: 2 * x.numel() * m.ks ** 2,
        Attention: products(lambda m, c: c),
        WindowAttention: products(lambda m, c: c),
        RelAttention: products(lambda m, c: m.heads * m.dim_head),
        LSA: products(lambda m, c: m.heads * m.dim_head),
        SpatialMLP: lambda m, x: x.shape[0] * x.shape[1] ** 2 * x.shape[2],
    }


def train_flops_per_image(model, img: int) -> int:
    """Model FLOPs of one training step per image from the convolution,
    linear and attention shapes: the forward, every layer's weight
    gradient and every layer's input gradient but the stem's (the first
    convolution: its input needs none); 2 FLOPs per multiply-add. A linear
    layer counts once per row it sees (one per image in a ResNet's head,
    one per token in a transformer block); the attention layers add their
    batched products (``_attention_macs``: the Conformer's, Swin's window
    attention, CoAtNet's, ViT-LSA's, SASA's; their gradients, two products
    each, make the factor 3 hold for them too). A grouped (depthwise)
    convolution counts its group's inputs, and the squeeze-excite branch
    its two 1x1 convolutions on the pooled pixel. BN, LN, activations,
    softmax, pooling and the loss are not counted."""
    import copy

    import torch
    from torch import nn

    attention = _attention_macs()
    macs = {}

    def count(name):
        def hook(m, inp, out):
            if isinstance(m, nn.Conv2d):
                per = (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]
                macs[name] = out.numel() * per
            elif isinstance(m, nn.Linear):
                macs[name] = out.numel() * m.in_features
            else:
                macs[name + ".products"] = attention[type(m)](m, inp[0])
        return hook

    probe = copy.deepcopy(model).cpu().float().eval()
    for name, m in probe.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, *attention)):
            m.register_forward_hook(count(name))
    with torch.no_grad():
        probe(torch.zeros(1, 3, img, img))
    fwd = sum(macs.values())
    stem = next(iter(macs))  # the first layer to run
    return 2 * (3 * fwd - macs[stem])


def timed_train_one(trainer, config, seed: int, path: str, epoch: int = 0):
    """``train_one(epoch)`` on ``step_loaders``: ``TRAIN_WARMUP_STEPS``
    warm-up steps, then ``train_one(epoch + 1)``'s ``TRAIN_TIMED_STEPS``
    steps with the kernel's count at 0, CUDA events between steps and the
    peak memory. Fails unless the kernel ran once a step and the mean loss
    is finite. Returns ``(step ms array, median, wall s, warm-up s, peak
    bytes, launches)``."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    marks = []
    trainer.get_dataloader(step_loaders(config, seed, marks), None)
    config.TRAIN.EVAL_STEP = TRAIN_WARMUP_STEPS
    t0 = time.perf_counter()
    trainer.train_one(epoch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    config.TRAIN.EVAL_STEP = TRAIN_TIMED_STEPS
    marks.clear()
    step0 = trainer.state.step
    torch.cuda.reset_peak_memory_stats()
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    meter = trainer.train_one(epoch + 1)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    peak = torch.cuda.max_memory_allocated()
    steps = trainer.state.step - step0
    step_ms = np.array([a.elapsed_time(z) for a, z in
                        zip(marks, marks[1:TRAIN_TIMED_STEPS] + [end])])
    if steps != TRAIN_TIMED_STEPS or launches != steps:
        fail(f"path {path}: {steps} steps launched the kernel {launches} "
             "times (once a step expected)")
    if not np.isfinite(meter.avg):
        fail(f"path {path}: mean loss {meter.avg}")
    return (step_ms, float(np.median(step_ms)), wall_s, warm_s, peak,
            launches, meter.avg)


def phase_train_full(seed: int):
    """Path C, part 2: ``train_one`` at real_3_1's full width."""
    import contextlib
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import ops
    from endoscopy_tpu_torch.aug.randaugment import (
        randaugment_mc_plain, sample_randaugment_params)
    from endoscopy_tpu_torch.aug.views import (fixmatch_views,
                                               labeled_train_view)
    from endoscopy_tpu_torch.models import resnet
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.ssl_state.ema import ema_update
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(path_c.REAL_3_1)
    img = int(config.DATA.IMG_SIZE)
    b, bu = int(config.DATA.BATCH_SIZE), int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    images = b + 2 * bu
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD)
    flops = train_flops_per_image(model, img) * images
    trainer = FixMatch(model, config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    step_ms, med, wall_s, warm_s, peak, launches, loss = timed_train_one(
        trainer, config, seed, "C")
    steps = TRAIN_TIMED_STEPS
    print(f"path C part 2: {steps} steps of {images} images (B={b}, B*MU={bu}, "
          f"{img} px, bf16) after {TRAIN_WARMUP_STEPS} warm-up steps "
          f"({warm_s:.2f} s); step ms (CUDA events between steps) median "
          f"{med:.3f}, min {step_ms.min():.3f}, max {step_ms.max():.3f}, all "
          f"{np.round(step_ms, 3).tolist()}; wall {wall_s:.3f} s, "
          f"{images * steps / wall_s:.1f} images/s; mean loss {loss:.4f}; "
          f"randaugment_mc launches {launches}; peak memory {peak} B",
          flush=True)

    # the step's parts, each at the step's shapes, CUDA events
    x_u8, t, u_u8 = path_c.canonical_batches(config, seed, 1)[0]
    x_dev, u_dev = torch.from_numpy(x_u8).cuda(), torch.from_numpy(u_u8).cuda()
    t_dev = torch.from_numpy(t).cuda()
    g = trainer.generator
    def lab_view():
        labeled_train_view(x_dev, img, torch.bfloat16, g, device="cuda")

    lab_ms = cuda_ms(lab_view, iters=10)
    lab_host_ms = host_ms(lab_view)
    views_ms = cuda_ms(lambda: fixmatch_views(
        u_dev, img, torch.bfloat16, g, device="cuda"), iters=10)
    # the kernel's launch as fixmatch_views makes it: the flipped center
    # crop, not padded, the crop offsets in pi
    pad = int(img * 0.125)
    xk = ops.center_crop(u_dev, img).to(torch.bfloat16)
    tops, lefts = ops.sample_crop_offsets(g, bu, 2 * pad)
    pi, pf = sample_randaugment_params(g, bu, img, img)
    pi_c = torch.cat([pi, tops[:, None], lefts[:, None]], 1)
    kern_ms = cuda_ms(lambda: rk.randaugment_mc(xk, pi_c, pf, img, pad),
                      iters=50, warmup=3)
    # the same inputs through the plain version, image by image at the
    # tolerances of phase 3
    got = rk.randaugment_mc(xk, pi_c, pf, img, pad)
    ref = randaugment_mc_plain(xk, pi_c, pf, img, pad)
    err = (got.float() - ref.float()).abs().amax(dim=(1, 2, 3)).cpu()
    bad = (err > image_tolerances(pi_c, "bfloat16")).nonzero().flatten()
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(xk, pi_c, pf, img, pad),
                       iters=2, warmup=1)
    print(f"path C part 2: randaugment_mc on the step's {tuple(xk.shape)} "
          f"bf16 input (pad {pad}) vs the plain version: max_abs_err="
          f"{float(err.max())}; plain {plain_ms:.2f} ms", flush=True)
    if len(bad):
        fail(f"path C: the kernel differs from the plain version on images "
             f"{bad[:8].tolist()}")
    views = trainer._views(x_dev, u_dev)
    weights = trainer.class_weights

    def fwd_bwd():
        trainer._forward_backward(*views, t_dev, weights)

    # with flax's running variance and with torch's own BN update, in turns
    # (flax, torch, torch, flax): what the repair costs a step, on the card
    # and in the host's enqueue
    def plain_bn():
        return mock.patch.object(resnet, "_flax_running_var",
                                 lambda model, forward, x: forward(x))

    fb, fb_plain = [], []
    for timings, patch in ((fb, contextlib.nullcontext), (fb_plain, plain_bn),
                           (fb_plain, plain_bn), (fb, contextlib.nullcontext)):
        with patch():
            timings.append((cuda_ms(fwd_bwd, iters=5), host_ms(fwd_bwd)))
    fb_ms, fb_host_ms = (float(v) for v in np.mean(fb, axis=0))
    fb_plain_bn_ms, fb_plain_bn_host_ms = (float(v) for v in
                                           np.mean(fb_plain, axis=0))
    # the repair's own work alone (the module walk, the snapshot and the
    # lerp over every BN, at the counts of the last forward): the turns
    # above differ by less than a host's spread
    backbone = trainer.state.model.backbone

    def repair():
        resnet._flax_running_var(backbone, lambda x: x, None)

    repair_ms, repair_host_ms = cuda_ms(repair, iters=20), host_ms(repair, 20)
    opt_ms = cuda_ms(trainer._apply_grads, iters=5)
    opt_host_ms = host_ms(trainer._apply_grads)
    st = trainer.state
    adam_ms = cuda_ms(st.optimizer.step, iters=5)
    ema_ms = cuda_ms(lambda: ema_update(st.ema, st.model, trainer.ema_decay),
                     iters=5)
    bytes_moved = 2 * xk.numel() * xk.element_size() + pi_c.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    print(f"path C part 2 split (ms, CUDA events): labeled_train_view "
          f"{lab_ms:.4f} (host enqueue {lab_host_ms:.4f}); fixmatch_views "
          f"{views_ms:.4f}, of which "
          f"randaugment_mc {kern_ms:.4f} (bound {bound_ms:.4f}: "
          f"{bytes_moved} B at {HBM_BYTES_PER_S:.3g} B/s); forward+backward "
          f"{fb_ms:.3f}, host enqueue {fb_host_ms:.3f} (with torch's own BN "
          f"update {fb_plain_bn_ms:.3f}, host enqueue "
          f"{fb_plain_bn_host_ms:.3f}: the flax running variance costs "
          f"{fb_ms - fb_plain_bn_ms:.3f} on the card's clock; alone "
          f"{repair_ms:.4f}, host enqueue {repair_host_ms:.4f}); "
          f"optimizer+EMA {opt_ms:.3f} (host enqueue {opt_host_ms:.3f}; "
          f"optimizer.step alone {adam_ms:.3f}, EMA alone {ema_ms:.3f}); sum "
          f"{lab_ms + views_ms + fb_ms + opt_ms:.3f} against the step's "
          f"{med:.3f}", flush=True)
    print(f"path C part 2: model FLOPs per step {flops} ({flops / images:.4e} "
          f"per image: convolutions and the head, forward + both "
          f"gradients); {flops / (med * 1e-3) / 1e12:.2f} TFLOP/s at the "
          f"median step, {share:.4f} of the {H100_BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s dense bf16 peak; floor {flops / H100_BF16_FLOPS * 1e3:.3f} "
          "ms", flush=True)
    return {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
            "step_ms_max": float(step_ms.max()),
            "images_per_s": images * steps / wall_s, "peak_bytes": peak,
            "flops_per_step": flops, "flop_share": share,
            "launches_per_step": launches / steps, "kernel_ms": kern_ms,
            "kernel_max_abs_err": float(err.max()), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "labeled_view_ms": lab_ms,
            "views_ms": views_ms, "fwd_bwd_ms": fb_ms,
            "fwd_bwd_plain_bn_ms": fb_plain_bn_ms, "opt_ema_ms": opt_ms,
            "fwd_bwd_host_ms": fb_host_ms,
            "fwd_bwd_plain_bn_host_ms": fb_plain_bn_host_ms,
            "bn_repair_ms": repair_ms, "bn_repair_host_ms": repair_host_ms,
            "labeled_view_host_ms": lab_host_ms, "opt_ema_host_ms": opt_host_ms,
            "adam_ms": adam_ms, "ema_ms": ema_ms}


def phase_train_accum(seed: int):
    """Path C, part 3: GRAD_ACCUM=2, a few steps: two launches and one
    update a step."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(path_c.REAL_3_1, TRAIN={"GRAD_ACCUM": 2})
    trainer = FixMatch(path_c.seeded_model(config, seed, path_c.HEAD_STD),
                       config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_dataloader(step_loaders(config, seed, []), None)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    config.TRAIN.EVAL_STEP = 3
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    meter = trainer.train_one(0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    print(f"path C part 3: GRAD_ACCUM=2, 3 steps in {wall_s:.3f} s (first "
          f"calls included): step count {trainer.state.step}, randaugment_mc "
          f"launches {launches}, mean loss {meter.avg:.4f}", flush=True)
    if trainer.state.step != 3 or launches != 6 or not np.isfinite(meter.avg):
        fail("path C GRAD_ACCUM=2: expected 3 updates, 6 kernel launches "
             "and a finite loss")


def phase_train_freeze(seed: int):
    """Path C, part 4: two steps of real_3's settings (224 px, IS_FREEZE):
    the backbone bit-identical, every BN running statistic and the head
    moved."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(path_c.REAL_3)
    trainer = FixMatch(path_c.seeded_model(config, seed, path_c.HEAD_STD),
                       config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_dataloader(step_loaders(config, seed, []), None)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    config.TRAIN.EVAL_STEP = 2
    model = trainer.state.model
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rk.randaugment_mc.launches = 0
    torch.cuda.reset_peak_memory_stats()
    meter = trainer.train_one(0)
    torch.cuda.synchronize()
    after = model.state_dict()
    frozen_moved = [k for k, _ in model.named_parameters()
                    if k.startswith("backbone.") and not torch.equal(after[k], before[k])]
    still = [k for k in after if (k.startswith("head.") or k.endswith(
        ("running_mean", "running_var"))) and torch.equal(after[k], before[k])]
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in after)
    print(f"path C part 4: IS_FREEZE at 224 px, 2 steps of 480 images: "
          f"backbone parameters moved {len(frozen_moved)}; BN statistics and "
          f"head tensors that did not move {len(still)} (of {n_stats} BN "
          f"statistics and 2 head tensors); randaugment_mc launches "
          f"{rk.randaugment_mc.launches}; peak memory "
          f"{torch.cuda.max_memory_allocated()} B; mean loss {meter.avg:.4f}",
          flush=True)
    if frozen_moved or still or rk.randaugment_mc.launches != 2:
        fail(f"path C freeze: moved {frozen_moved[:4]}, still {still[:4]}")


def _log_records(log_dir: Path, run: str = "fixmatch"):
    """The trainer's JSONL metric log (``utils/logging.py``), in order."""
    with open(log_dir / f"{run}.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_diff(a, b) -> list:
    """Names of the tensors where two ``TrainState.state_dict()`` differ,
    and of the entries only one of them has."""
    import torch

    fa, fb = path_d.flat_state(a), path_d.flat_state(b)
    return sorted(set(fa) ^ set(fb)) + sorted(
        k for k in set(fa) & set(fb) if not (
            fa[k].dtype == fb[k].dtype and torch.equal(fa[k].cpu(), fb[k].cpu())))


def _eval_timed(trainer):
    """``evaluate_one`` between CUDA events: (loss meter, metrics, ms)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loss, metric = trainer.evaluate_one()
    end.record()
    torch.cuda.synchronize()
    return loss, metric, start.elapsed_time(end)


def phase_learn(seed: int, out_dir: Path):
    """Path D: ``cli/learn.py`` on the card, D1-D3."""
    import shutil
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import views
    from endoscopy_tpu_torch.ckpt import io as ckpt_io
    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    shutil.rmtree(out_dir, ignore_errors=True)
    log_dir = out_dir / "log"
    cfg1, cfg2 = path_d.stage_configs(str(out_dir / "ckpt"), str(log_dir))
    t0 = time.perf_counter()
    data1 = path_d.synthetic_data(cfg1, path_d.STAGE1_SIZES, seed)
    print(f"path D: stage 1 data {path_d.STAGE1_SIZES} (labeled, unlabeled, "
          f"valid) at {data1[1].size} px made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    sides = []
    kernel = views.randaugment_mc

    def recording(x, *a, **k):
        sides.append(tuple(x.shape[1:3]))
        return kernel(x, *a, **k)

    # D1: run_config at full width
    epochs, steps = int(cfg1.TRAIN.EPOCHS), int(cfg1.TRAIN.EVAL_STEP)
    torch.cuda.reset_peak_memory_stats()
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    torch.manual_seed(seed)  # the model's own initialization, seeded
    with mock.patch.object(views, "randaugment_mc", recording):
        trainer1, _ = learn.run_config(cfg1, device="cuda", data=data1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    peak = torch.cuda.max_memory_allocated()
    log = _log_records(log_dir)
    train = [r for r in log if "loss/train" in r]
    valid = [r for r in log if "loss/valid" in r]
    images = trainer1._images_per_step()
    step_ms = [r["time/epoch_s"] * 1e3 / steps for r in train]
    print(f"path D1: run_config, {epochs} epochs of {steps} steps, {images} "
          f"images a step, in {fit_s:.2f} s; per epoch: wall s "
          f"{[round(r['time/epoch_s'], 3) for r in train]}, step ms "
          f"{[round(t, 3) for t in step_ms]}, images/s "
          f"{[round(r['throughput/images_per_sec'], 1) for r in train]}, "
          f"train loss {[round(r['loss/train'], 4) for r in train]}, valid "
          f"loss {[round(r['loss/valid'], 4) for r in valid]}, macro-F1 "
          f"{[r['metric/macro_f1'] for r in valid]}; randaugment_mc "
          f"launches {launches} at sides {sorted(set(sides))}; peak memory "
          f"{peak} B", flush=True)
    saved = sorted(p.name for p in (out_dir / "ckpt" / "stage1").iterdir())
    side1, side2 = int(cfg1.DATA.IMG_SIZE), int(cfg2.DATA.IMG_SIZE)
    if launches != epochs * steps or set(sides) != {(side1, side1)}:
        fail(f"path D1: {launches} kernel launches at {set(sides)} in "
             f"{epochs * steps} steps")
    if not train[-1]["loss/train"] < train[0]["loss/train"]:
        fail("path D1: the train loss did not fall from epoch 1 to "
             f"{epochs}")
    if len(valid) != epochs or valid[-1]["metric/macro_f1"] < 0.9:
        fail(f"path D1: macro-F1 {valid[-1]['metric/macro_f1']} after the "
             "last epoch (0.9 needed)")
    if saved != [f"epoch_{e}" for e in range(1, epochs + 1)]:
        fail(f"path D1: checkpoints {saved}")

    eval_runs = [_eval_timed(trainer1) for _ in range(3)]
    eval_ms = float(np.median([ms for _, _, ms in eval_runs]))
    n_valid = path_d.STAGE1_SIZES[2]
    t0 = time.perf_counter()
    timing_path = trainer1.save_checkpoint(str(out_dir / "timing"))
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = sum(f.stat().st_size for f in Path(timing_path).iterdir())
    t0 = time.perf_counter()
    ckpt_io.restore_checkpoint(timing_path, "cuda")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(out_dir / "timing")
    # one evaluation batch: its CUDA-event time against the host's time to
    # enqueue it, and the forward alone
    u8, t, m = next(iter(data1[1]))
    ev_model = trainer1._eval_model()

    def batch():
        trainer1._eval_step(ev_model, u8, t, m)

    x = views.eval_view(u8, int(cfg1.DATA.IMG_SIZE), trainer1.dtype,
                        device="cuda").permute(0, 3, 1, 2)

    @torch.inference_mode()
    def forward():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            ev_model(x)

    split = {"batch_ms": cuda_ms(batch, iters=10),
             "batch_host_ms": host_ms(batch, iters=10),
             "forward_ms": cuda_ms(forward, iters=10),
             "forward_host_ms": host_ms(forward, iters=10)}
    print(f"path D1: one evaluation batch of {len(t)} (CUDA events / host "
          f"enqueue, ms): _eval_step {split['batch_ms']:.3f} / "
          f"{split['batch_host_ms']:.3f}, the forward alone "
          f"{split['forward_ms']:.3f} / {split['forward_host_ms']:.3f}",
          flush=True)
    print(f"path D1: evaluate_one on {n_valid} images ({len(data1[1])} "
          f"batches, {trainer1.dtype}): "
          f"{eval_ms:.3f} ms median of {[round(ms, 3) for _, _, ms in eval_runs]}"
          f" (CUDA events), {n_valid / eval_ms * 1e3:.1f} images/s; "
          f"save_checkpoint {save_ms:.1f} ms, {ckpt_bytes} B; restore to the "
          f"card {restore_ms:.1f} ms", flush=True)

    # D2: resume the latest checkpoint in a fresh trainer
    latest = ckpt_io.latest_checkpoint(cfg1.TRAIN.SAVE_CP)
    cfg_resume = path_d.stage_configs(str(out_dir / "ckpt"), str(log_dir))[0]
    cfg_resume.TRAIN.EPOCHS = epochs + 1
    cfg_resume.MODEL.PRE_TRAIN_RESUME = latest
    trainer2 = learn.prepare_trainer(cfg_resume, device="cuda", data=data1)
    diff = _state_diff(trainer1.state.state_dict(),
                       trainer2.state.state_dict())
    loss1, metric1, _ = eval_runs[-1]
    loss2, metric2, _ = _eval_timed(trainer2)
    same_eval = (loss1.avg == loss2.avg and loss1.count == loss2.count
                 and {k: v for k, v in metric1.items() if k != "sen/spec"}
                 == {k: v for k, v in metric2.items() if k != "sen/spec"})
    print(f"path D2: resumed {Path(latest).name} in a fresh trainer: tensors "
          f"that differ {len(diff)} {diff[:4]}; step {trainer2.state.step} "
          f"(saved {trainer1.state.step}); epoch_start {trainer2.epoch_start}, "
          f"best_valid_perf {trainer2.best_valid_perf} (saved "
          f"{trainer1.best_valid_perf}); evaluation {loss2.avg!r} vs "
          f"{loss1.avg!r}, the same: {same_eval}", flush=True)
    if (diff or trainer2.epoch_start != epochs
            or trainer2.best_valid_perf != trainer1.best_valid_perf
            or not same_eval):
        fail("path D2: the resumed trainer differs from the saved one")
    step0 = trainer2.state.step
    rk.randaugment_mc.launches = 0
    trainer2.fit()
    torch.cuda.synchronize()
    more = rk.randaugment_mc.launches
    saved = sorted(p.name for p in (out_dir / "ckpt" / "stage1").iterdir())
    print(f"path D2: fit to EPOCHS {epochs + 1} from the resume: "
          f"{trainer2.state.step - step0} steps, randaugment_mc launches "
          f"{more}; checkpoints {saved}", flush=True)
    if (trainer2.state.step - step0 != 2 * steps or more != 2 * steps
            or saved[-1] != f"epoch_{epochs + 1}"):
        fail("path D2: the resumed fit did not train epochs "
             f"{epochs} and {epochs + 1}")
    cfg_final = path_d.stage_configs(str(out_dir / "ckpt"), str(log_dir))[0]
    cfg_final.TRAIN.EPOCHS = epochs + 1
    cfg_final.MODEL.PRE_TRAIN_RESUME = ckpt_io.latest_checkpoint(
        cfg1.TRAIN.SAVE_CP)
    rk.randaugment_mc.launches = 0
    trainer_f, model = learn.run_config(cfg_final, device="cuda", data=data1)
    torch.cuda.synchronize()
    print(f"path D2: a resume at the final epoch: randaugment_mc launches "
          f"{rk.randaugment_mc.launches}, step {trainer_f.state.step} "
          f"(restored {trainer2.state.step})", flush=True)
    if rk.randaugment_mc.launches or trainer_f.state.step != trainer2.state.step:
        fail("path D2: a resume at the final epoch trained")

    # D3: the 224 px stage on stage 1's final weights
    t0 = time.perf_counter()
    data2 = path_d.synthetic_data(cfg2, path_d.STAGE2_SIZES, seed + 1)
    gen2_s = time.perf_counter() - t0
    carried = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer3 = learn.prepare_trainer(cfg2, model=model,
                                     carry_state=model.state_dict(),
                                     device="cuda", data=data2)
    entry = trainer3.state.model.state_dict()
    at_entry = [k for k in carried if not torch.equal(entry[k], carried[k])]
    ema_entry = [k for k, v in trainer3.state.ema.state_dict().items()
                 if not torch.equal(v, carried[k])]
    sides.clear()
    rk.randaugment_mc.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(views, "randaugment_mc", recording):
        trainer3.fit()
    torch.cuda.synchronize()
    fit2_s = time.perf_counter() - t0
    launches2 = rk.randaugment_mc.launches
    steps2 = int(cfg2.TRAIN.EVAL_STEP) * int(cfg2.TRAIN.EPOCHS)
    after = trainer3.state.model.state_dict()
    frozen_moved = [k for k, _ in trainer3.state.model.named_parameters()
                    if k.startswith("backbone.")
                    and not torch.equal(after[k], carried[k])]
    still = [k for k in after if (k.startswith("head.") or k.endswith(
        ("running_mean", "running_var"))) and torch.equal(after[k], carried[k])]
    _, metric3, eval2_ms = _eval_timed(trainer3)
    eval2_ms = min(eval2_ms, _eval_timed(trainer3)[2])
    print(f"path D3: stage 2 data {path_d.STAGE2_SIZES} at "
          f"{data2[1].size} px made in {gen2_s:.2f} s; tensors not carried "
          f"{at_entry[:4]}, EMA tensors not synced {ema_entry[:4]}; fit "
          f"{steps2} steps at {side2} px, IS_FREEZE, in {fit2_s:.2f} s: backbone "
          f"parameters moved {len(frozen_moved)}, head and BN statistics "
          f"that did not move {len(still)}; randaugment_mc launches "
          f"{launches2} at sides {sorted(set(sides))} (clusters of "
          f"{rk.build().randaugment_mc_info(side2, True)[0]}); peak memory "
          f"{torch.cuda.max_memory_allocated()} B; evaluate_one on "
          f"{path_d.STAGE2_SIZES[2]} images at {side2} px {eval2_ms:.3f} ms "
          f"(the faster of two), macro-F1 {metric3['macro/f1']}", flush=True)
    if at_entry or ema_entry:
        fail("path D3: stage 2 did not start from stage 1's final weights")
    if frozen_moved or still:
        fail(f"path D3: moved {frozen_moved[:4]}, still {still[:4]}")
    cluster = rk.build().randaugment_mc_info(side2, True)[0]
    if launches2 != steps2 or set(sides) != {(side2, side2)} or cluster != 4:
        fail(f"path D3: {launches2} launches at {set(sides)} in {steps2} "
             f"steps, clusters of {cluster}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return data2, {"launches": launches, "steps": epochs * steps,
            "launches_per_step": launches / (epochs * steps),
            "step_ms": step_ms, "eval_ms": eval_ms, "save_ms": save_ms,
            "ckpt_bytes": ckpt_bytes, "restore_ms": restore_ms,
            "peak_bytes": peak, "macro_f1": valid[-1]["metric/macro_f1"],
            "stage2_side": side2,
            "stage2_launches_per_step": launches2 / steps2,
            "stage2_eval_ms": eval2_ms, "eval_split": split}


def _same_eval(a, b) -> bool:
    """Two ``evaluate_one`` results bit for bit (the table of sensitivity
    and specificity aside)."""
    (la, ma), (lb, mb) = a, b
    return (la.avg == lb.avg and la.count == lb.count
            and {k: v for k, v in ma.items() if k != "sen/spec"}
            == {k: v for k, v in mb.items() if k != "sen/spec"})


def supervised_fit(seed: int, out_dir: Path, data2):
    """Path E1: ``run_config`` on kaggle_supervised_patho's fields, its
    steps marked with CUDA events and its evaluations recorded. Returns
    ``(trainer, data, evaluations, step marks, fit seconds)``."""
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.train.supervised import SupLearning

    cfg = path_e.patho_config(str(out_dir / "ckpt"), str(out_dir / "log"))
    data = path_e.supervised_data(cfg, data2)
    marks, evals = [], []
    step, evaluate = SupLearning._train_step, SupLearning.evaluate_one

    def marked_step(self, *a, **k):
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append((self.epoch, mark))
        return step(self, *a, **k)

    def recorded_eval(self, *a, **k):
        out = evaluate(self, *a, **k)
        evals.append((self.epoch, out))
        return out

    torch.manual_seed(seed)  # the fresh weights, seeded
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(SupLearning, "_train_step", marked_step), \
            mock.patch.object(SupLearning, "evaluate_one", recorded_eval):
        trainer, _ = learn.run_config(cfg, device="cuda", data=data)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    marks.append((None, end))
    return trainer, data, evals, marks, time.perf_counter() - t0


def supervised_chain(trainer1, data, evals):
    """Path E4: ``evaluate`` on E1's checkpoint, ``cli/pseudo_label.py``'s
    ``inference`` over the train images against a direct eval forward, and
    the checkpoint as real_3_1's ``PRE_TRAIN_PATH``."""
    import contextlib
    import io

    import torch

    from endoscopy_tpu_torch.aug.views import eval_view
    from endoscopy_tpu_torch.ckpt import io as ckpt_io
    from endoscopy_tpu_torch.cli import evaluate as evaluate_cli
    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.data.manifest import Manifest
    from endoscopy_tpu_torch.data.pipeline import EvalLoader
    from endoscopy_tpu_torch.models import build_model
    from endoscopy_tpu_torch.train.common import model_logits

    cfg = trainer1.config
    latest = ckpt_io.latest_checkpoint(cfg.TRAIN.SAVE_CP)
    epoch = int(Path(latest).name.split("_")[1])
    trainer = learn.make_trainer(cfg, build_model(cfg), device="cuda")
    learn.configure(trainer, cfg, data)
    trainer.load_checkpoint(latest)
    with contextlib.redirect_stdout(io.StringIO()):
        got = evaluate_cli.evaluate(trainer)
    want = dict(evals)[epoch]
    same = _same_eval(got, want)
    print(f"path E4: cli/evaluate.py on {Path(latest).name}: valid loss "
          f"{got[0].avg!r} vs {want[0].avg!r} in E1, macro-F1 "
          f"{got[1]['macro/f1']} vs {want[1]['macro/f1']}; the same bit for "
          f"bit: {same}", flush=True)
    if not same:
        fail("path E4: cli/evaluate.py differs from E1's evaluation")

    train = data[0]
    bs, size = int(cfg.DATA.BATCH_SIZE), train.size
    pool = path_d.array_loader(EvalLoader, train.images)(
        Manifest(np.arange(len(train.images)),
                 np.zeros(len(train.images), np.int64)), bs, size)
    t0 = time.perf_counter()
    preds = list(trainer.inference(pool).values())
    pseudo_s = time.perf_counter() - t0
    model, thres = trainer._eval_model(), float(cfg.TRAIN.THRES)
    direct = []
    with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
        for u8, _, keep in pool:
            x = eval_view(u8, int(cfg.DATA.IMG_SIZE), trainer.dtype,
                          device="cuda").permute(0, 3, 1, 2)
            probs = torch.softmax(model_logits(model(x)).float(), -1).cpu()
            pred = probs.argmax(1) * (probs.amax(1) > thres)
            direct += pred[torch.from_numpy(keep)].tolist()
    passed = sum(p != 0 for p in preds)
    print(f"path E4: cli/pseudo_label.py's inference over {len(preds)} "
          f"images in "
          f"{pseudo_s:.3f} s: {passed} above THRES {thres} with a non-zero "
          f"class; equal to a direct eval forward: {preds == direct}",
          flush=True)
    if preds != direct:
        fail("path E4: pseudo_label differs from argmax * [max > THRES]")

    cfg_fm = path_c.train_config(path_c.REAL_3_1,
                                 MODEL={"PRE_TRAIN_PATH": latest})
    data_fm = path_d.synthetic_data(cfg_fm, (32, 224, 32), 0)
    with contextlib.redirect_stdout(io.StringIO()):
        fm = learn.prepare_trainer(cfg_fm, device="cuda", data=data_fm)
    donor = ckpt_io.restore_checkpoint(latest, "cpu")[0]["model"]
    got_sd = fm.state.model.state_dict()
    ema_sd = fm.state.ema.state_dict()
    keys = [k for k in donor if k.startswith("backbone.")]
    moved = [k for k in keys if not (
        torch.equal(got_sd[k].cpu(), donor[k])
        and torch.equal(ema_sd[k].cpu(), donor[k]))]
    print(f"path E4: {Path(latest).name} as real_3_1's PRE_TRAIN_PATH "
          f"({type(fm).__name__}): backbone tensors {len(keys)}, not "
          f"bit-identical in the model or the EMA {len(moved)} {moved[:4]}",
          flush=True)
    if moved or not keys:
        fail("path E4: the backbone did not arrive bit-identical")
    return epoch


def triplet_trainer(seed: int, data2, accum: int):
    """Path E2's trainer at kaggle_supervised_ezbm's width, and the list
    it appends each triplet batch's (anchor targets, rows its positives
    and negatives were read from) to."""
    import torch

    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.models import build_model

    cfg = path_c.train_config(path_e.EZBM, TRAIN={
        "SAVE_CP": "", "LOG_DIR": "", "GRAD_ACCUM": accum})
    torch.manual_seed(seed)
    trainer = learn.make_trainer(cfg, build_model(cfg), device="cuda")
    learn.configure(trainer, cfg, path_e.supervised_data(cfg, data2))
    loader, built, sampled = trainer.train_dl, [], []
    sample, build = loader.sample, trainer._build_triplet_batch
    loader.sample = lambda idx: sampled.append(np.asarray(idx)) or sample(idx)

    def recorded(batch_u8, targets):
        rows = build(batch_u8, targets)
        built.append((np.asarray(targets), sampled[-1]))
        return rows

    trainer._build_triplet_batch = recorded
    return trainer, built


def supervised_triplet(seed: int, data2):
    """Path E2: the triplet branch at kaggle_supervised_ezbm's width, timed;
    then GRAD_ACCUM=2."""
    import torch

    trainer, built = triplet_trainer(seed, data2, 1)
    b = int(trainer.config.DATA.BATCH_SIZE)
    bn = trainer.state.model.fc.bn
    stats0 = [bn.running_mean.clone(), bn.running_var.clone()]
    trainer.n_iter_per_epoch = TRIPLET_WARMUP_STEPS
    t0 = time.perf_counter()
    trainer.train_one(1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    marks = []
    step = trainer._train_step

    def marked(*a, **k):
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append(mark)
        return step(*a, **k)

    trainer._train_step = marked
    trainer.n_iter_per_epoch = TRIPLET_TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meter = trainer.train_one(2)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = np.array([a.elapsed_time(z)
                        for a, z in zip(marks, marks[1:] + [end])])
    tg = trainer.train_dl.manifest.targets
    pos_ok = all((tg[idx[:b]] == t).all() for t, idx in built)
    neg_ok = all((tg[idx[b:]] != t).all() for t, idx in built)
    moved = not (torch.equal(bn.running_mean, stats0[0])
                 or torch.equal(bn.running_var, stats0[1]))
    images = 3 * b
    out = {"step_ms_median": float(np.median(step_ms)),
           "step_ms_min": float(step_ms.min()),
           "step_ms_max": float(step_ms.max()),
           "images_per_s": images * len(step_ms) / wall_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "d_ap_d_an": trainer._last_triplet_dist}
    print(f"path E2: triplet branch, {len(step_ms)} steps of {images} "
          f"images ({b} anchors, positives, negatives; {trainer.img_size} "
          f"px, {trainer.dtype}) after {TRIPLET_WARMUP_STEPS} warm-up steps "
          f"({warm_s:.2f} s): step ms (CUDA events) median "
          f"{out['step_ms_median']:.3f}, min {out['step_ms_min']:.3f}, max "
          f"{out['step_ms_max']:.3f}; {out['images_per_s']:.1f} images/s; "
          f"mean loss {meter.avg:.4f}; last step's mean d_ap, d_an "
          f"{trainer._last_triplet_dist}; positives of the anchor's class "
          f"{pos_ok}, negatives of another {neg_ok} ({len(built)} batches); "
          f"MLP head BN statistics moved {moved}; peak memory "
          f"{out['peak_bytes']} B", flush=True)
    if not (pos_ok and neg_ok and moved and np.isfinite(meter.avg)):
        fail("path E2: the triplet batch or the head's BN is wrong")

    trainer, built = triplet_trainer(seed, data2, 2)
    trainer.n_iter_per_epoch = 2
    meter = trainer.train_one(1)
    torch.cuda.synchronize()
    rows = trainer._micro_indices(3 * b)
    t, idx = built[-1]
    cls = np.concatenate([t, tg[idx]])
    matched = all((c[0] == c[1]).all() and (c[0] != c[2]).all()
                  for c in (cls[r.numpy()].reshape(3, -1) for r in rows))
    blocks = all(np.array_equal(r.numpy().reshape(3, -1),
                                np.arange(3 * b).reshape(3, 2, -1)[:, i])
                 for i, r in enumerate(rows))
    print(f"path E2: GRAD_ACCUM=2, 2 steps of {images} images: microbatch "
          f"rows [A_i; P_i; N_i] {blocks}, classes matched {matched}, "
          f"updates {trainer.state.step}, mean loss {meter.avg:.4f}",
          flush=True)
    if not (blocks and matched and trainer.state.step == 2
            and np.isfinite(meter.avg)):
        fail("path E2: GRAD_ACCUM=2 does not split the triplet batch into "
             "matched microbatches with one update each")
    return out


def cross_device_step(label: str, cfg, batch, seed: int, step, step64):
    """Path E3's method for one step: the labeled view of ``batch`` on the
    card and on the CPU from the same draws, ``step(device, view)`` (its
    ``[stats]`` and updates first) run by each device on each view, and
    ``step64(view)`` the CPU's float64 updates on the card's view. Fails
    when the views, the stats or the updates differ beyond E3's bounds;
    returns ``(readings, the steps by (device, view), the views)``."""
    views = {dev: path_e.step_view(cfg, batch, seed, dev)
             for dev in ("cuda", "cpu")}
    view_err = float((views["cuda"].cpu() - views["cpu"]).abs().max())
    steps = {(dev, v): step(dev, views[v])
             for dev in ("cpu", "cuda") for v in ("cuda", "cpu")}
    upd64 = step64(views["cuda"])
    ref, ref_upd = steps["cpu", "cuda"][:2]
    got, upd = steps["cuda", "cuda"][:2]
    cpu_l2 = path_c.update_errors(ref_upd, upd64)[0]
    # how far each device's float32 step moves when its input changes in
    # the last bit (the other device's view): a ReLU near-tie that one
    # summation order crosses moves one tensor's update by percents
    sens = {dev: path_c.update_errors(steps[dev, "cpu"][1],
                                      steps[dev, "cuda"][1])[0]
            for dev in ("cpu", "cuda")}
    rel = max(abs(a - b) / abs(b) for v in ("cuda", "cpu")
              for a, b in zip(steps["cuda", v][0], steps["cpu", v][0]))
    l2s = {v: path_c.update_errors(steps["cuda", v][1], steps["cpu", v][1])
           for v in views}
    l2, worst = l2s["cuda"]
    l2_64 = path_c.update_errors(upd, upd64)[0]
    # path C's bound on the CPU's view; on the card's view also each
    # device's own move between the two views (the card's ReLU near-tie,
    # PERF.md)
    bounds = {"cpu": 3 * cpu_l2 + 1e-3,
              "cuda": 3 * max(cpu_l2, *sens.values()) + 1e-3}
    print(f"{label}: the labeled view on the card vs the CPU's on the same "
          f"draws: max_abs_err {view_err:.3e} (bound {E3_VIEW_TOL}); the "
          f"float32 step, card vs CPU ({len(batch[0])} images, "
          f"{int(cfg.DATA.IMG_SIZE)} px): stats {got} vs {ref}, worst "
          f"relative error on either view {rel:.3e} (bound "
          f"{TRAIN_TOL_F32_LOSS}); SGD updates relative L2 on the CPU's view "
          f"{l2s['cpu'][0]:.3e} (bound {bounds['cpu']:.3e}: the CPU's "
          f"float32 step is {cpu_l2:.3e} from float64), on the card's "
          f"{l2:.3e} (worst tensor {worst:.3e}; bound {bounds['cuda']:.3e}: "
          f"a view's last bits move the CPU's step by {sens['cpu']:.3e}, the "
          f"card's by {sens['cuda']:.3e}); the card against float64 "
          f"{l2_64:.3e}", flush=True)
    if view_err > E3_VIEW_TOL:
        fail(f"{label}: the step's view differs on the card")
    if rel > TRAIN_TOL_F32_LOSS or any(l2s[v][0] > bounds[v] for v in views):
        fail(f"{label}: the step on the card differs from the CPU's")
    return ({"view_max_abs_err": view_err, "loss_rel_err": rel,
             "update_l2_err": l2, "update_l2_err_cpu_view": l2s["cpu"][0],
             "update_l2_err_vs_f64": l2_64, "cpu_f32_vs_f64_l2": cpu_l2,
             "view_sensitivity_l2": sens}, steps, views)


def supervised_step_matches_cpu(seed: int):
    """Path E3 for one seed: one SGD step, card against CPU, plain and
    triplet."""
    out = {}
    for base, triplet in ((path_e.PATHO, False), (path_e.EZBM, True)):
        cfg = path_e.step_config(base, triplet)
        model = path_c.seeded_model(cfg, seed, path_c.HEAD_STD,
                                    PART1_RESIDUAL_GAMMA)
        x, t = path_e.step_batch(cfg, seed)
        name = "triplet" if triplet else "plain"
        out[name] = cross_device_step(
            f"path E3, seed {seed}, {name}", cfg, (x, t), seed,
            lambda dev, view: path_e.step_once(cfg, model, view, t, dev, seed),
            lambda view: path_e.step_float64(cfg, model, view, t, seed))[0]
    return out


def phase_supervised(seed: int, out_dir: Path, data2):
    """Path E: the supervised trainer, E1-E4."""
    import shutil

    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    shutil.rmtree(out_dir, ignore_errors=True)
    rk.randaugment_mc.launches = 0
    trainer, data, evals, marks, fit_s = supervised_fit(seed, out_dir, data2)
    peak = torch.cuda.max_memory_allocated()
    log = _log_records(out_dir / "log", "suplearning")
    train = [r for r in log if "loss/train" in r]
    steps = trainer.n_iter_per_epoch
    step_ms = [a.elapsed_time(z) for (ea, a), (ez, z) in zip(marks, marks[1:])
               if ea == ez and ea > 1]
    med = float(np.median(step_ms))
    f1 = [float(m["macro/f1"]) for _, (_, m) in evals]
    saves = sorted(p.name for p in (out_dir / "ckpt").iterdir())
    want = [f"epoch_{e}" for e in path_e.gate_saves(
        [(e, l.avg, float(m["macro/f1"])) for e, (l, m) in evals])]
    images = trainer._images_per_step()
    flops = train_flops_per_image(trainer.state.model,
                                  int(trainer.config.DATA.IMG_SIZE)) * images
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    print(f"path E1: run_config, {len(train)} epochs of {steps} steps of "
          f"{images} images ({trainer.img_size} px, {trainer.dtype}) in "
          f"{fit_s:.2f} s; per epoch: wall "
          f"s {[round(r['time/epoch_s'], 3) for r in train]}, step ms (wall / "
          f"steps) {[round(r['time/epoch_s'] * 1e3 / steps, 3) for r in train]}"
          f", images/s {[round(r['throughput/images_per_sec'], 1) for r in train]}"
          f", train loss {[round(r['loss/train'], 4) for r in train]}, valid "
          f"loss {[round(l.avg, 4) for _, (l, _) in evals]}, teacher macro-F1 "
          f"{f1}; step ms (CUDA events between steps, epochs 2-3) median "
          f"{med:.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}; model "
          f"FLOPs per step {flops} ({flops / images:.4e} per image), "
          f"{share:.4f} of the dense bf16 peak; checkpoints {saves} (the gate "
          f"selects {want}); peak memory {peak} B", flush=True)
    if not train[-1]["loss/train"] < train[0]["loss/train"]:
        fail("path E1: the train loss did not fall from epoch 1 to the last")
    if len(f1) != len(train) or f1[-1] < 0.9:
        fail(f"path E1: macro-F1 {f1} (0.9 needed after the last epoch)")
    if saves != want:
        fail(f"path E1: checkpoints {saves}, the gate selects {want}")

    out = {"e2": supervised_triplet(seed, data2),
           "e3": {s: supervised_step_matches_cpu(s)
                  for s in range(seed, seed + PART1_SEEDS)}}
    out["e4_checkpoint_epoch"] = supervised_chain(trainer, data, evals)

    eval_ms = float(np.median([_eval_timed(trainer)[2] for _ in range(3)]))
    u8, t = next(iter(data[0]))
    w = trainer._epoch_weights(1)
    enqueue_ms = host_ms(lambda: trainer._train_step(u8, t, w), iters=5)
    launches = rk.randaugment_mc.launches
    print(f"path E1: evaluate_one on {len(data[1].manifest)} images "
          f"{eval_ms:.3f} ms (median of three, CUDA events); one step's host "
          f"enqueue {enqueue_ms:.3f} ms against its {med:.3f} ms on the card; "
          f"randaugment_mc launches on path E {launches} (no kernel on this "
          f"path)", flush=True)
    if launches:
        fail("path E launched the RandAugment kernel")
    # E1's checkpoints stay: path H3 grafts the latest; main removes them
    shutil.rmtree(out_dir / "log", ignore_errors=True)
    out["e1_checkpoint"] = str(out_dir / "ckpt" /
                               f"epoch_{out['e4_checkpoint_epoch']}")
    out.update({"e1": {"step_ms_median": med, "step_ms_min": min(step_ms),
                       "step_ms_max": max(step_ms),
                       "images_per_s": [r["throughput/images_per_sec"]
                                        for r in train],
                       "flop_share": share, "flops_per_step": flops,
                       "enqueue_ms": enqueue_ms, "eval_ms": eval_ms,
                       "peak_bytes": peak, "macro_f1": f1},
                "launches": launches})
    return out


def phase_serve_int8(seed: int, out_dir: Path):
    """Path A2: path A's model exported with weight-only int8 kernels."""
    import os

    from endoscopy_tpu_torch.cli.infer import predict
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.serve.export import export_model, load_exported
    from endoscopy_tpu_torch.serve.quantize import (quantize_state_dict,
                                                    quantized_fraction)

    config, model = seeded_resnet50(seed)
    full = out_dir / "resnet50_seeded.pt"  # path A's artifact
    path = out_dir / "resnet50_seeded_int8.pt"
    size, _ = export_model(config, model.state_dict(), str(path),
                           quantize="int8")
    frac = quantized_fraction(quantize_state_dict(model), model)
    imgs = np.random.default_rng(seed).integers(
        0, 256, (N_REQUESTS, size, size, 3)).astype(np.uint8)
    rk.randaugment_mc.launches = 0
    f_full = load_exported(str(full), device="cuda")
    f_q = load_exported(str(path), device="cuda")
    p_full, p_q = f_full(imgs), f_q(imgs)
    err = float(np.abs(p_q - p_full).max())
    flips = int((p_q.argmax(1) != p_full.argmax(1)).sum())
    cpu = load_exported(str(path), device="cpu")(imgs[:2])
    err32 = float(np.abs(p_q[:2] - cpu).max())
    sizes = (os.path.getsize(path), os.path.getsize(full))
    print(f"path A2: int8 artifact {sizes[0]} B against {sizes[1]} B "
          f"unquantized ({sizes[0] / sizes[1]:.4f}; {frac:.4f} of the "
          f"parameter scalars int8); {N_REQUESTS} images on the card: int8 "
          f"vs unquantized max_abs_err={err} (atol {INT8_ATOL}), argmax "
          f"differs on {flips} rows; vs the int8 artifact in float32 on the "
          f"CPU max_abs_err={err32} (atol {F32_ATOL})", flush=True)
    if not np.isfinite(p_q).all() or err > INT8_ATOL or flips:
        fail("path A2: the int8 artifact's probabilities differ from the "
             "unquantized artifact's")
    if err32 > F32_ATOL:
        fail(f"path A2: bf16 int8 probabilities differ from float32 ({err32})")

    batch = imgs[:32]
    ms = {}
    for name, fn in (("int8", f_q), ("unquantized", f_full)):
        fn(batch)
        t0 = time.perf_counter()
        for _ in range(10):
            fn(batch)
        ms[name] = (time.perf_counter() - t0) * 100
    print(f"path A2: a bucket-32 call (upload, view, forward, softmax, "
          f"download), host clock: int8 {ms['int8']:.2f} ms, unquantized "
          f"{ms['unquantized']:.2f} ms", flush=True)

    # cli/infer.py's prediction over in-memory canonical images, batches
    # of 32, against direct calls of the artifact on the same batches
    direct = np.concatenate([f_q(imgs[:32]), f_q(imgs[32:])])
    thres = float(np.median(direct.max(1)))
    got = predict(f_q, lambda lo, hi: imgs[lo:hi], len(imgs), 32)
    got_t = predict(f_q, lambda lo, hi: imgs[lo:hi], len(imgs), 32, thres)
    same = (np.array_equal(got["pred"], direct.argmax(1))
            and np.array_equal(got["max_prob"], direct.max(1))
            and np.array_equal(got_t["pred"], direct.argmax(1)
                               * (direct.max(1) > thres)))
    print(f"path A2: cli/infer.py's predict over {len(imgs)} images (batch "
          f"32), with and without --thres {thres:.4f}: equal to direct "
          f"calls {same}; randaugment_mc launches {rk.randaugment_mc.launches}"
          f" (none expected)", flush=True)
    if not same or rk.randaugment_mc.launches:
        fail("path A2: cli/infer.py's predictions differ from the artifact's")
    return {"bytes_int8": sizes[0], "bytes_unquantized": sizes[1],
            "quantized_fraction": frac, "max_abs_err": err,
            "max_abs_err_f32_cpu": err32, "bucket32_ms": ms}


def _stats_errors(got, ref):
    """(worst relative error of a step's statistics, e.g. CoMatch's loss,
    lx, lu, lc, where the reference is not 0, relative L2 error of the
    updates, worst tensor)."""
    (stats, upd), (ref_stats, ref_upd) = got, ref
    rel = max(abs(a - b) / abs(b) for a, b in zip(stats, ref_stats) if b)
    return (rel, *path_c.update_errors(upd, ref_upd))


def _strong1_as_strong0(x, w, s0, s1):
    return x, w, s0, s0  # as if the colour-jitter view were the RandAugment one


def comatch_step_matches_cpu(seed: int):
    """Path F1 for one seed: one CoMatch SGD step of ResNet-50 under
    ``ModelwEmb`` at 112 px, B=4, MU=1, from one seeded state with the
    same draws and dropout keep-mask, on the card against the CPU's
    float32 step, both devices on both devices' views (path E3's method)."""
    config = path_f.step_config()
    model = path_f.step_model(config, seed, PART1_RESIDUAL_GAMMA)
    batch = path_c.canonical_batches(config, seed, 1)[0]
    t = batch[1]
    keep = path_f.keep_mask(config, model, seed)
    views = {dev: path_f.step_views(config, model, batch, dev, seed)
             for dev in ("cuda", "cpu")}
    view_errs = [float((a.cpu() - b).abs().max())
                 for a, b in zip(views["cuda"], views["cpu"])]
    config.TRAIN.DTYPE = "bfloat16"
    views16 = path_f.step_views(config, model, batch, "cuda", seed)

    # THRES in the widest gap between two of the four weak max-
    # probabilities (after DA and smoothing) that leaves the same rows
    # above it in the CPU's float32 forward and the card's bf16 forward
    p16, q16 = path_f.pseudo_scores(config, model, views16, t, "cuda", seed,
                                    keep)
    config.TRAIN.DTYPE = "float32"
    p32, q32 = path_f.pseudo_scores(config, model, views["cpu"], t, "cpu",
                                    seed, keep)
    order = p32.sort(descending=True).values
    thres, margin = None, 0.0
    for k in (1, 2, 3):
        th = float(order[k - 1] + order[k]) / 2
        m = min(float((p32 - th).abs().min()), float((p16 - th).abs().min()))
        if int((p16 >= th).sum()) == k and m > margin:
            thres, margin = th, m
    # no off-diagonal Q entry within the float32/bf16 disagreement of 0.8
    q_gap = float((q32 - q16).abs().max())
    q_margin = min(float((q32 - 0.8).abs().min()),
                   float((q16 - 0.8).abs().min()))
    print(f"path F1, seed {seed}: the views (labeled, weak, strong-0, "
          f"strong-1) on the card vs the CPU's on the same draws: max_abs_err "
          f"{[f'{e:.3e}' for e in view_errs]} (bound {E3_VIEW_TOL}); weak "
          f"max-probabilities, float32 on the CPU {p32.tolist()}, bf16 on the "
          f"card {p16.tolist()}; THRES {thres}, margin {margin:.3e}; "
          f"off-diagonal Q: max {float(q32.max()):.4f}, nearest to 0.8 by "
          f"{q_margin:.3e} against a float32/bf16 disagreement of "
          f"{q_gap:.3e}", flush=True)
    if max(view_errs) > E3_VIEW_TOL:
        fail("path F1: a view differs on the card")
    if thres is None:
        fail("path F1: no THRES splits the weak rows alike in float32 and "
             "bf16")
    if q_margin <= q_gap:
        fail("path F1: a Q entry lies within the precision gap of 0.8")
    config.TRAIN.THRES = thres

    def step(dev, v, alter=None):
        return path_f.step_once(config, model, v, t, dev, seed, keep, alter)

    # each device's float32 step on each device's view
    steps = {(dev, v): step(dev, views[v]) for dev in ("cpu", "cuda")
             for v in ("cuda", "cpu")}
    upd64 = path_f.step_float64(config, model, views["cuda"], t, seed, keep)
    ref = steps["cpu", "cuda"]
    cpu_l2, cpu_worst = path_c.update_errors(ref[1], upd64)
    sens = {dev: path_c.update_errors(steps[dev, "cpu"][1],
                                      steps[dev, "cuda"][1])[0]
            for dev in ("cpu", "cuda")}
    rel = max(_stats_errors(steps["cuda", v], steps["cpu", v])[0]
              for v in ("cuda", "cpu"))
    l2s = {v: path_c.update_errors(steps["cuda", v][1], steps["cpu", v][1])
           for v in ("cuda", "cpu")}
    l2_64 = path_c.update_errors(steps["cuda", "cuda"][1], upd64)[0]
    bounds = {"cpu": 3 * cpu_l2 + 1e-3,
              "cuda": 3 * max(cpu_l2, *sens.values()) + 1e-3}
    print(f"path F1, seed {seed}: float32, card vs CPU: [loss, lx, lu, lc] "
          f"{steps['cuda', 'cuda'][0]} vs {ref[0]}, worst relative error on "
          f"either view {rel:.3e} (bound {TRAIN_TOL_F32_LOSS}); SGD updates "
          f"relative L2 on the CPU's view {l2s['cpu'][0]:.3e} (bound "
          f"{bounds['cpu']:.3e}: the CPU's float32 step is {cpu_l2:.3e} from "
          f"float64, worst tensor {cpu_worst:.3e}), on the card's "
          f"{l2s['cuda'][0]:.3e} (worst tensor {l2s['cuda'][1]:.3e}; bound "
          f"{bounds['cuda']:.3e}: a view's last bits move the CPU's step by "
          f"{sens['cpu']:.3e}, the card's by {sens['cuda']:.3e}); the card "
          f"against float64 {l2_64:.3e}", flush=True)
    if not ref[0][2] > 0:
        fail("path F1: the unsupervised loss is 0 (no weak row passed THRES)")
    if rel > TRAIN_TOL_F32_LOSS or any(l2s[v][0] > bounds[v] for v in bounds):
        fail("path F1 float32 step on the card differs from the CPU's")
    out = {"view_max_abs_err": max(view_errs), "thres": thres,
           "margin": margin, "q_margin": q_margin, "q_gap": q_gap,
           "float32": {"loss_rel_err": rel, "update_l2_err": l2s["cuda"][0],
                       "update_l2_err_cpu_view": l2s["cpu"][0],
                       "update_l2_err_vs_f64": l2_64,
                       "cpu_f32_vs_f64_l2": cpu_l2,
                       "view_sensitivity_l2": sens}}
    # bf16 on the card's bf16 views against the CPU's float32 step on its
    # own views, and the control that the check must refuse
    config.TRAIN.DTYPE = "bfloat16"
    ref32 = steps["cpu", "cpu"]
    for alter in (None, _strong1_as_strong0):
        got = step("cuda", views16, alter)
        rel16, l2, worst = _stats_errors(got, ref32)
        what = "bf16" if alter is None else "bf16 control (strong-1 as strong-0)"
        print(f"path F1, seed {seed}: {what} on the card vs float32 on the "
              f"CPU: [loss, lx, lu, lc] {got[0]} vs {ref32[0]}; worst "
              f"relative loss error {rel16:.3e} (bound {TRAIN_TOL_BF16_LOSS}); "
              f"SGD updates relative L2 error {l2:.3e} (bound "
              f"{TRAIN_TOL_BF16_UPDATE}), worst tensor {worst:.3e}",
              flush=True)
        sound = rel16 <= TRAIN_TOL_BF16_LOSS and l2 <= TRAIN_TOL_BF16_UPDATE
        if alter is None and not sound:
            fail("path F1 bf16 step on the card differs from the CPU's")
        if alter is not None and sound:
            fail("path F1 bf16 check passes a step whose strong-1 view is "
                 "strong-0")
        out["bfloat16" if alter is None else "bfloat16_control"] = {
            "loss_rel_err": rel16, "update_l2_err": l2}
    config.TRAIN.DTYPE = "float32"
    return out


def comatch_full(seed: int):
    """Path F2: ``train_one`` at real_1's full width, 512 images a step."""
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import views
    from endoscopy_tpu_torch.aug.randaugment import randaugment_mc_plain
    from endoscopy_tpu_torch.aug.views import comatch_views, labeled_train_view
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.comatch import CoMatch

    config = path_c.train_config(path_f.REAL_1)
    img = int(config.DATA.IMG_SIZE)
    b, bu = int(config.DATA.BATCH_SIZE), int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    images = path_f.images_per_step(config)
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD)
    flops = train_flops_per_image(model, img) * images
    trainer = CoMatch(model, config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    step_ms, med, wall_s, warm_s, peak, launches, loss = timed_train_one(
        trainer, config, seed, "F2")
    steps = TRAIN_TIMED_STEPS
    cs = trainer.comatch_state
    da_count = int(cs.da_count)
    queue_zero = not bool(cs.queue_feats.any() or cs.queue_probs.any())
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    print(f"path F2: {steps} steps of {images} images (B={b}, B*MU={bu}, "
          f"{img} px, bf16: labeled, weak, strong-0, strong-1) after "
          f"{TRAIN_WARMUP_STEPS} warm-up steps ({warm_s:.2f} s); step ms (CUDA "
          f"events between steps) median {med:.3f}, min {step_ms.min():.3f}, "
          f"max {step_ms.max():.3f}, all {np.round(step_ms, 3).tolist()}; "
          f"wall {wall_s:.3f} s, {images * steps / wall_s:.1f} images/s; mean "
          f"loss {loss:.4f}; randaugment_mc launches {launches}; peak "
          f"memory {peak} B; model FLOPs per step {flops}, "
          f"{flops / (med * 1e-3) / 1e12:.2f} TFLOP/s, {share:.4f} of the "
          f"dense bf16 peak; da_count {da_count}, queue still zero "
          f"{queue_zero} (queue_size {trainer.queue_size}, {b + bu} rows a "
          f"step)", flush=True)
    if da_count != TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS or not queue_zero:
        fail(f"path F2: da_count {da_count}, the queue zero {queue_zero}")

    # the kernel's own input in one more step (plain mode), against the
    # plain version
    seen = []
    kernel = views.randaugment_mc

    def recording(x, pi, pf, *a, **k):
        seen.append((x.clone(), pi.clone(), pf.clone()))
        return kernel(x, pi, pf, *a, **k)

    x_u8, t, u_u8 = path_c.canonical_batches(config, seed, 1)[0]
    x_dev, u_dev = torch.from_numpy(x_u8).cuda(), torch.from_numpy(u_u8).cuda()
    t_dev = torch.from_numpy(t).cuda()
    w = trainer.class_weights
    with mock.patch.object(views, "randaugment_mc", recording):
        trainer._train_step(x_dev, t_dev, u_dev, w, True)
    xk, pi, pf = seen[0]
    got = rk.randaugment_mc(xk, pi, pf)
    ref = randaugment_mc_plain(xk, pi, pf)
    err = float((got.float() - ref.float()).abs().max())
    kern_ms = cuda_ms(lambda: rk.randaugment_mc(xk, pi, pf), iters=50,
                      warmup=3)
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(xk, pi, pf), iters=2,
                       warmup=1)
    bytes_moved = 2 * xk.numel() * xk.element_size() + pi.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"path F2: randaugment_mc in plain mode on the step's strong-0 "
          f"input {tuple(xk.shape)} {xk.dtype}: kernel vs plain version "
          f"max_abs_err={err} (tol 0.0); kernel {kern_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bytes_moved} B at "
          f"{HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    if err != 0.0:
        fail(f"path F2: the kernel differs from the plain version ({err})")

    # the step's parts at its shapes: CUDA events and the host's enqueue
    g = trainer.generator

    def lab_view():
        labeled_train_view(x_dev, img, torch.bfloat16, g, device="cuda")

    def cm_views():
        comatch_views(u_dev, img, torch.bfloat16, g, device="cuda")

    v = trainer._views(x_dev, u_dev)

    def fwd_bwd():
        trainer._forward_backward(*v, t_dev, w, True)

    with torch.no_grad():
        logits, low = trainer._forward(*v)

    def losses():
        with torch.no_grad():
            trainer._losses(logits, low, b, t_dev, w, True)

    split = {}
    for name, fn, iters in (("labeled_view", lab_view, 10),
                            ("comatch_views", cm_views, 10),
                            ("kernel", lambda: rk.randaugment_mc(xk, pi, pf), 20),
                            ("fwd_bwd", fwd_bwd, 5),
                            ("no_grad_block_and_graph_loss", losses, 10),
                            ("opt_ema", trainer._apply_grads, 5)):
        split[name] = {"ms": cuda_ms(fn, iters=iters),
                       "host_ms": host_ms(fn)}
    print("path F2 split (ms, CUDA events / host enqueue): " + "; ".join(
        f"{k} {s['ms']:.4f} / {s['host_ms']:.4f}" for k, s in split.items())
        + f"; sum of labeled view, comatch_views, forward+backward and "
        f"optimizer+EMA {sum(split[k]['ms'] for k in ('labeled_view', 'comatch_views', 'fwd_bwd', 'opt_ema')):.3f} "
        f"against the step's {med:.3f}", flush=True)
    return {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
            "step_ms_max": float(step_ms.max()),
            "images_per_s": images * steps / wall_s, "peak_bytes": peak,
            "flops_per_step": flops, "flop_share": share,
            "launches_per_step": launches / steps, "kernel_ms": kern_ms,
            "kernel_max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "da_count": da_count, "split": split}


def comatch_learn(seed: int, out_dir: Path):
    """Path F3: ``run_config`` on real_1's fields and a few steps of
    real_1_1's through ``cli/learn.py``, on path D's kind of images."""
    import shutil

    import torch

    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    shutil.rmtree(out_dir, ignore_errors=True)
    log_dir = out_dir / "log"
    cfg1, cfg2 = path_f.learn_configs(str(out_dir / "ckpt"), str(log_dir))
    t0 = time.perf_counter()
    data = path_d.synthetic_data(cfg1, path_f.F3_SIZES, seed + 2)
    gen_s = time.perf_counter() - t0
    epochs, steps = int(cfg1.TRAIN.EPOCHS), int(cfg1.TRAIN.EVAL_STEP)
    rk.randaugment_mc.launches = 0
    torch.manual_seed(seed)  # the fresh weights, seeded
    t0 = time.perf_counter()
    trainer, _ = learn.run_config(cfg1, device="cuda", data=data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = rk.randaugment_mc.launches
    log = _log_records(log_dir, "comatch")
    train = [r for r in log if "loss/train" in r]
    valid = [r for r in log if "loss/valid" in r]
    saved = sorted(p.name for p in (out_dir / "ckpt" / "real_1").iterdir())
    print(f"path F3: real_1 through run_config, data {path_f.F3_SIZES} at "
          f"{data[1].size} px made in {gen_s:.2f} s; {epochs} epochs of "
          f"{steps} steps of {trainer._images_per_step()} images in "
          f"{fit_s:.2f} s; train loss "
          f"{[round(r['loss/train'], 4) for r in train]}, step ms (wall / "
          f"steps) {[round(r['time/epoch_s'] * 1e3 / steps, 3) for r in train]}"
          f", valid loss {[round(r['loss/valid'], 4) for r in valid]}, "
          f"macro-F1 {[r['metric/macro_f1'] for r in valid]}; randaugment_mc "
          f"launches {launches}; checkpoints {saved}; da_count "
          f"{int(trainer.comatch_state.da_count)}", flush=True)
    if launches != epochs * steps:
        fail(f"path F3: {launches} kernel launches in {epochs * steps} steps")
    losses = [r["loss/train"] for r in train]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"path F3: train loss {losses} is not finite and falling")
    if len(valid) != epochs or saved != [f"epoch_{e}" for e in
                                         range(1, epochs + 1)]:
        fail(f"path F3: evaluations {len(valid)}, checkpoints {saved}")

    # real_1_1: SGD, MU=7, 704 images a step, on the same images
    data[0][1].batch_size = int(cfg2.DATA.BATCH_SIZE) * int(cfg2.DATA.MU)
    steps2 = int(cfg2.TRAIN.EVAL_STEP) * int(cfg2.TRAIN.EPOCHS)
    rk.randaugment_mc.launches = 0
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    trainer2, _ = learn.run_config(cfg2, device="cuda", data=data)
    torch.cuda.synchronize()
    sgd_s = time.perf_counter() - t0
    launches2 = rk.randaugment_mc.launches
    train2 = [r for r in _log_records(log_dir, "comatch")
              if "loss/train" in r][len(train):]
    print(f"path F3: real_1_1 ({cfg2.TRAIN.OPT_NAME}, MU={cfg2.DATA.MU}, "
          f"{trainer2._images_per_step()} images a step) {steps2} steps in "
          f"{sgd_s:.2f} s: train loss {[r['loss/train'] for r in train2]}, "
          f"step count {trainer2.state.step}, randaugment_mc launches "
          f"{launches2}", flush=True)
    if (trainer2.state.step != steps2 or launches2 != steps2
            or trainer2._images_per_step() != 704
            or not np.isfinite([r["loss/train"] for r in train2]).all()):
        fail("path F3: real_1_1 did not take its steps")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launches, "steps": epochs * steps,
            "launches_per_step": launches / (epochs * steps),
            "train_loss": losses,
            "macro_f1": [r["metric/macro_f1"] for r in valid],
            "real_1_1_launches_per_step": launches2 / steps2}


def phase_comatch(seed: int, out_dir: Path):
    """Path F: the CoMatch trainer, F1-F3."""
    out = {"f1": {s: comatch_step_matches_cpu(s)
                  for s in range(seed, seed + PART1_SEEDS)}}
    out["f2"] = comatch_full(seed)
    out["f3"] = comatch_learn(seed, out_dir)
    return out


def _weak_as_strong(x, w, s):
    return x, w, w  # as if the kernel had left the strong view undone


def semiformer_step_matches_cpu(seed: int):
    """Path G1 for one seed: one warmup step and one FixMatch-phase step
    (SGD) of Conformer-Ti at 112 px, B=4, MU=1, from one seeded state
    (``path_g.seeded_model``'s conditioning) with the same draws, on the
    card against the CPU's float32 step, both devices on both devices'
    views (path E3's method)."""
    config = path_g.step_config()
    model = path_g.seeded_model(config, seed, PART1_RESIDUAL_GAMMA,
                                path_g.HEAD_SCALE)
    batch = path_c.canonical_batches(config, seed, 1)[0]
    t = batch[1]
    views = {dev: path_g.step_views(config, model, batch, dev, seed)
             for dev in ("cuda", "cpu")}
    view_errs = [float((a.cpu() - b).abs().max())
                 for a, b in zip(views["cuda"], views["cpu"])]
    config.TRAIN.DTYPE = "bfloat16"
    views16 = path_g.step_views(config, model, batch, "cuda", seed)
    # THRES in the widest gap between two of the four weak max-
    # probabilities (the conv head's) that leaves the same rows above it
    # in the CPU's float32 forward and the card's bf16 forward
    p16 = path_g.weak_max_probs(config, model, views16, "cuda", seed)
    config.TRAIN.DTYPE = "float32"
    p32 = path_g.weak_max_probs(config, model, views["cpu"], "cpu", seed)
    order = p32.sort(descending=True).values
    thres, margin = None, 0.0
    for k in (1, 2, 3):
        th = float(order[k - 1] + order[k]) / 2
        m = min(float((p32 - th).abs().min()), float((p16 - th).abs().min()))
        if int((p16 >= th).sum()) == k and m > margin:
            thres, margin = th, m
    print(f"path G1, seed {seed}: the views (labeled, weak, strong) on the "
          f"card vs the CPU's on the same draws: max_abs_err "
          f"{[f'{e:.3e}' for e in view_errs]} (bound {E3_VIEW_TOL}); weak "
          f"max-probabilities, float32 on the CPU {p32.tolist()}, bf16 on the "
          f"card {p16.tolist()}; THRES {thres}, margin {margin:.3e}",
          flush=True)
    if max(view_errs) > E3_VIEW_TOL:
        fail("path G1: a view differs on the card")
    if thres is None:
        fail("path G1: no THRES splits the weak rows alike in float32 and "
             "bf16")
    config.TRAIN.THRES = thres

    def step(dev, v, alter=None):
        return path_g.step_once(config, model, v, t, dev, seed, alter)

    out = {"view_max_abs_err": max(view_errs), "thres": thres,
           "margin": margin}
    for phase, n in (("warmup", 1), ("fixmatch", 3)):
        vs = {v: views[v][:n] for v in views}
        steps = {(dev, v): step(dev, vs[v]) for dev in ("cpu", "cuda")
                 for v in ("cuda", "cpu")}
        upd64 = path_g.step_float64(config, model, vs["cuda"], t, seed)
        ref = steps["cpu", "cuda"]
        cpu_l2, cpu_worst = path_c.update_errors(ref[1], upd64)
        sens = {dev: path_c.update_errors(steps[dev, "cpu"][1],
                                          steps[dev, "cuda"][1])[0]
                for dev in ("cpu", "cuda")}
        rel = max(_stats_errors(steps["cuda", v], steps["cpu", v])[0]
                  for v in ("cuda", "cpu"))
        l2s = {v: path_c.update_errors(steps["cuda", v][1],
                                       steps["cpu", v][1])
               for v in ("cuda", "cpu")}
        l2_64 = path_c.update_errors(steps["cuda", "cuda"][1], upd64)[0]
        bounds = {"cpu": 3 * cpu_l2 + 1e-3,
                  "cuda": 3 * max(cpu_l2, *sens.values()) + 1e-3}
        print(f"path G1, seed {seed}, {phase} step: float32, card vs CPU: "
              f"stats {steps['cuda', 'cuda'][0]} vs {ref[0]}, worst "
              f"relative error on either view {rel:.3e} (bound "
              f"{TRAIN_TOL_F32_LOSS}); SGD updates relative L2 on the CPU's "
              f"view {l2s['cpu'][0]:.3e} (bound {bounds['cpu']:.3e}: the "
              f"CPU's float32 step is {cpu_l2:.3e} from float64, worst "
              f"tensor {cpu_worst:.3e}), on the card's {l2s['cuda'][0]:.3e} "
              f"(worst tensor {l2s['cuda'][1]:.3e}; bound "
              f"{bounds['cuda']:.3e}: a view's last bits move the CPU's step "
              f"by {sens['cpu']:.3e}, the card's by {sens['cuda']:.3e}); the "
              f"card against float64 {l2_64:.3e}", flush=True)
        if phase == "fixmatch" and not 0.0 < ref[0][3] < 1.0:
            fail(f"path G1: mask mean {ref[0][3]} is not strictly between "
                 "0 and 1")
        if rel > TRAIN_TOL_F32_LOSS or any(l2s[v][0] > bounds[v]
                                           for v in bounds):
            fail(f"path G1 float32 {phase} step on the card differs from "
                 "the CPU's")
        res = {"float32": {"loss_rel_err": rel,
                           "update_l2_err": l2s["cuda"][0],
                           "update_l2_err_cpu_view": l2s["cpu"][0],
                           "update_l2_err_vs_f64": l2_64,
                           "cpu_f32_vs_f64_l2": cpu_l2,
                           "view_sensitivity_l2": sens}}
        # bf16 on the card's bf16 views against the CPU's float32 step on
        # its own views; in the FixMatch phase also the control that the
        # check must refuse
        config.TRAIN.DTYPE = "bfloat16"
        ref32 = steps["cpu", "cpu"]
        for alter in (None, _weak_as_strong) if n == 3 else (None,):
            got = step("cuda", views16[:n], alter)
            rel16, l2, worst = _stats_errors(got, ref32)
            what = "bf16" if alter is None else "bf16 control (weak as strong)"
            print(f"path G1, seed {seed}, {phase} step: {what} on the card vs "
                  f"float32 on the CPU: stats {got[0]} vs {ref32[0]}; worst "
                  f"relative error {rel16:.3e} (bound {TRAIN_TOL_BF16_LOSS}); "
                  f"SGD updates relative L2 error {l2:.3e} (bound "
                  f"{G1_TOL_BF16_UPDATE}), worst tensor {worst:.3e}",
                  flush=True)
            within = (rel16 <= TRAIN_TOL_BF16_LOSS, l2 <= G1_TOL_BF16_UPDATE)
            if alter is None and not all(within):
                fail(f"path G1 bf16 {phase} step on the card differs from "
                     "the CPU's")
            if alter is not None and any(within):
                fail("path G1 bf16 check: a bound passes a step without the "
                     "strong view")
            res["bfloat16" if alter is None else "bfloat16_control"] = {
                "loss_rel_err": rel16, "update_l2_err": l2}
        config.TRAIN.DTYPE = "float32"
        out[phase] = res
    return out


def semiformer_full(seed: int):
    """Path G2: ``train_one`` in the FixMatch phase at real_2's full
    width, 416 images a step at 224 px, and the warmup step."""
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import views
    from endoscopy_tpu_torch.aug.randaugment import randaugment_mc_plain
    from endoscopy_tpu_torch.aug.views import fixmatch_views, labeled_train_view
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.semiformer import SemiFormer

    config = path_c.train_config(path_g.REAL_2)
    img = int(config.DATA.IMG_SIZE)
    b, bu = int(config.DATA.BATCH_SIZE), int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    images = path_g.images_per_step(config)
    model = path_g.seeded_model(config, seed)
    flops = train_flops_per_image(model, img) * images
    trainer = SemiFormer(model, config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    step_ms, med, wall_s, warm_s, peak, launches, loss = timed_train_one(
        trainer, config, seed, "G2", epoch=trainer.eval_step_sup)
    steps = TRAIN_TIMED_STEPS
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    print(f"path G2: {steps} FixMatch-phase steps of {images} images (B={b}, "
          f"B*MU={bu}, {img} px, bf16, GRAD_ACCUM "
          f"{config.TRAIN.GRAD_ACCUM}) after {TRAIN_WARMUP_STEPS} warm-up "
          f"steps ({warm_s:.2f} s); step ms (CUDA events between steps) "
          f"median {med:.3f}, min {step_ms.min():.3f}, max "
          f"{step_ms.max():.3f}, all {np.round(step_ms, 3).tolist()}; wall "
          f"{wall_s:.3f} s, {images * steps / wall_s:.1f} images/s; mean "
          f"loss {loss:.4f}; randaugment_mc launches {launches}; peak memory "
          f"{peak} B; model FLOPs per step {flops} ({flops / images:.4e} per "
          f"image: convolutions, linears per row, attention's two products; "
          f"forward + both gradients), {flops / (med * 1e-3) / 1e12:.2f} "
          f"TFLOP/s, {share:.4f} of the dense bf16 peak", flush=True)

    # the kernel's own input in one more step (crop-fused, the reflect pad
    # in its load), against the plain version
    seen = []
    kernel = views.randaugment_mc

    def recording(x, pi, pf, *a, **k):
        seen.append((x.clone(), pi.clone(), pf.clone(), k))
        return kernel(x, pi, pf, *a, **k)

    x_u8, t, u_u8 = path_c.canonical_batches(config, seed, 1)[0]
    x_dev, u_dev = torch.from_numpy(x_u8).cuda(), torch.from_numpy(u_u8).cuda()
    t_dev = torch.from_numpy(t).cuda()
    w = trainer.class_weights
    with mock.patch.object(views, "randaugment_mc", recording):
        trainer._train_step(x_dev, t_dev, u_dev, w)
    xk, pi, pf, kw = seen[0]
    got = rk.randaugment_mc(xk, pi, pf, **kw)
    ref = randaugment_mc_plain(xk, pi, pf, **kw)
    err = float((got.float() - ref.float()).abs().max())
    kern_ms = cuda_ms(lambda: rk.randaugment_mc(xk, pi, pf, **kw), iters=50,
                      warmup=3)
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(xk, pi, pf, **kw),
                       iters=2, warmup=1)
    bytes_moved = 2 * xk.numel() * xk.element_size() + pi.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"path G2: randaugment_mc crop-fused (crop {kw.get('crop_size')}, "
          f"pad {kw.get('pad')}) on the step's strong-view input "
          f"{tuple(xk.shape)} {xk.dtype}: kernel vs plain version "
          f"max_abs_err={err} (tol 0.0); kernel {kern_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bytes_moved} B at "
          f"{HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    if err != 0.0 or kw.get("pad") != int(img * 0.125):
        fail(f"path G2: the kernel differs from the plain version ({err}) "
             f"or ran without the fused pad ({kw})")

    # the step's parts at its shapes, and the warmup step (B images)
    g = trainer.generator

    def lab_view():
        labeled_train_view(x_dev, img, torch.bfloat16, g, device="cuda")

    def fm_views():
        fixmatch_views(u_dev, img, torch.bfloat16, g, device="cuda")

    v = trainer._views(x_dev, u_dev)

    def fwd_bwd():
        trainer._forward_backward(*v, t_dev, w)

    def warmup():
        trainer._warmup_step(x_dev, t_dev, w)

    split = {}
    for name, fn, iters in (("labeled_view", lab_view, 10),
                            ("fixmatch_views", fm_views, 10),
                            ("kernel", lambda: rk.randaugment_mc(
                                xk, pi, pf, **kw), 20),
                            ("fwd_bwd", fwd_bwd, 3),
                            ("opt_ema", trainer._apply_grads, 5),
                            ("warmup_step", warmup, 5)):
        split[name] = {"ms": cuda_ms(fn, iters=iters),
                       "host_ms": host_ms(fn)}
    parts = ("labeled_view", "fixmatch_views", "fwd_bwd", "opt_ema")
    print("path G2 split (ms, CUDA events / host enqueue): " + "; ".join(
        f"{k} {s['ms']:.4f} / {s['host_ms']:.4f}" for k, s in split.items())
        + f"; sum of {', '.join(parts)} "
        f"{sum(split[k]['ms'] for k in parts):.3f} against the step's "
        f"{med:.3f}", flush=True)
    return {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
            "step_ms_max": float(step_ms.max()),
            "images_per_s": images * steps / wall_s, "peak_bytes": peak,
            "grad_accum": int(config.TRAIN.GRAD_ACCUM),
            "flops_per_step": flops, "flop_share": share,
            "launches_per_step": launches / steps, "kernel_ms": kern_ms,
            "kernel_max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "split": split}


def semiformer_learn(seed: int, out_dir: Path, data2):
    """Path G3: ``kaggle_supervised_paper``'s Conformer for one epoch
    through ``run_config``, its checkpoint grafted as real_2's
    ``PRE_TRAIN_PATH``, real_2 across ``EVAL_STEP_SUP``, then 3 steps of
    real_2_1, on path D's kind of images."""
    import shutil

    import torch

    from endoscopy_tpu_torch.aug.views import eval_view
    from endoscopy_tpu_torch.ckpt import io as ckpt_io
    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.models import build_model
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    shutil.rmtree(out_dir, ignore_errors=True)
    log_dir = out_dir / "log"
    cfg_sup, cfg2, cfg21 = path_g.learn_configs(str(out_dir / "ckpt"),
                                                str(log_dir))
    # the supervised Conformer (23 classes) on path D's stage-2 images
    rk.randaugment_mc.launches = 0
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    sup, _ = learn.run_config(cfg_sup, device="cuda",
                              data=path_e.supervised_data(cfg_sup, data2))
    torch.cuda.synchronize()
    sup_s = time.perf_counter() - t0
    sup_log = [r for r in _log_records(log_dir, "suplearning")
               if "loss/train" in r]
    donor_dir = out_dir / "ckpt" / "sup_paper" / "epoch_1"
    print(f"path G3: kaggle_supervised_paper (Conformer-Ti, 23 classes, "
          f"{cfg_sup.DATA.IMG_SIZE} px) {sup.n_iter_per_epoch} steps of "
          f"{sup._images_per_step()} images and an evaluation in "
          f"{sup_s:.2f} s: train loss {sup_log[0]['loss/train']:.4f}, step "
          f"ms (wall / steps) "
          f"{sup_log[0]['time/epoch_s'] * 1e3 / sup.n_iter_per_epoch:.3f}; "
          f"randaugment_mc launches {rk.randaugment_mc.launches}; "
          f"checkpoint {donor_dir.is_dir()}", flush=True)
    if not donor_dir.is_dir() or rk.randaugment_mc.launches:
        fail("path G3: the supervised Conformer left no checkpoint or "
             "launched the kernel")

    # real_2 from the supervised checkpoint: the trunk grafted, the heads
    # of another class count left fresh
    cfg2.MODEL.PRE_TRAIN_PATH = str(donor_dir)
    torch.manual_seed(seed + 1)
    model = build_model(cfg2)
    heads = ("conv_cls_head.", "trans_cls_head.")
    fresh = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith(heads)}
    donor = ckpt_io.restore_checkpoint(str(donor_dir), "cpu")[0]["model"]
    trainer = learn.prepare_trainer(cfg2, model=model, device="cuda",
                                    data=data2)
    now = {k: v.cpu() for k, v in trainer.state.model.state_dict().items()}
    not_grafted = [k for k in now if not k.startswith(heads)
                   and not torch.equal(now[k], donor[k])]
    not_fresh = [k for k in fresh if not torch.equal(now[k], fresh[k])]
    print(f"path G3: real_2's PRE_TRAIN_PATH graft: {len(now) - len(fresh)} "
          f"trunk tensors, {len(not_grafted)} not equal to the donor's; "
          f"{len(fresh)} head tensors ({[tuple(fresh[k].shape) for k in fresh]}"
          f" against the donor's {[tuple(donor[k].shape) for k in fresh]}), "
          f"{len(not_fresh)} not fresh", flush=True)
    if not_grafted or not_fresh:
        fail(f"path G3: graft {not_grafted[:4]}, heads {not_fresh[:4]}")

    per_epoch = []
    train_one = trainer.train_one

    def counted(epoch):
        launches, step = rk.randaugment_mc.launches, trainer.state.step
        meter = train_one(epoch)
        per_epoch.append((rk.randaugment_mc.launches - launches,
                          trainer.state.step - step))
        return meter

    trainer.train_one = counted
    rk.randaugment_mc.launches = 0
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    log = _log_records(log_dir, "semiformer")
    train = [r for r in log if "loss/train" in r]
    valid = [r for r in log if "loss/valid" in r]
    saved = sorted(p.name for p in (out_dir / "ckpt" / "real_2").iterdir())
    # the evaluation's probabilities against softmax(conv + trans) of a
    # direct forward of the EMA teacher
    u8, t, m = next(iter(trainer.valid_dl))
    ema = trainer._eval_model()
    probs = trainer._eval_step(ema, u8, t, m)[2]
    bf16 = trainer.dtype == torch.bfloat16
    with torch.no_grad(), torch.autocast(trainer.device.type, torch.bfloat16,
                                         enabled=bf16):
        conv, trans = ema(eval_view(u8, int(cfg2.DATA.IMG_SIZE),
                                    trainer.dtype, device="cuda"
                                    ).permute(0, 3, 1, 2))
    direct = torch.softmax(conv.float() + trans.float(), -1)
    eval_err = float((probs - direct).abs().max())
    conv_only = float((probs - torch.softmax(conv.float(), -1)).abs().max())
    warm = int(cfg2.TRAIN.EVAL_STEP_SUP) - 1
    print(f"path G3: real_2 through fit, {fit_s:.2f} s: (launches, steps) "
          f"per epoch {per_epoch} (the first {warm} the warmup); train loss "
          f"{[round(r['loss/train'], 4) for r in train]}, epoch s "
          f"{[round(r['time/epoch_s'], 3) for r in train]}, valid loss "
          f"{[round(r['loss/valid'], 4) for r in valid]}, macro-F1 "
          f"{[r['metric/macro_f1'] for r in valid]}; checkpoints {saved}; "
          f"evaluation vs softmax(conv + trans) of a direct EMA forward "
          f"max_abs_err {eval_err:.3e} (against softmax(conv) alone "
          f"{conv_only:.3e})", flush=True)
    steps = int(cfg2.TRAIN.EVAL_STEP)
    n_warm = len(data2[0][0].manifest) // int(cfg2.DATA.BATCH_SIZE)
    want = [(0, n_warm)] * warm + [(steps, steps)] * (
        int(cfg2.TRAIN.EPOCHS) - warm)
    if per_epoch != want:
        fail(f"path G3: (launches, steps) per epoch {per_epoch}, expected "
             f"{want}")
    losses = [r["loss/train"] for r in train]
    if not np.isfinite(losses).all():
        fail(f"path G3: train loss {losses}")
    if saved != [f"epoch_{e}" for e in range(1, int(cfg2.TRAIN.EPOCHS) + 1)]:
        fail(f"path G3: checkpoints {saved}")
    if eval_err > 1e-6 or conv_only <= 1e-3:
        fail("path G3: the evaluation is not softmax(conv + trans)")

    # real_2_1: 112 px, 312 images a step, in the FixMatch phase
    data21 = path_d.synthetic_data(cfg21, path_g.REAL_2_1_SIZES, seed + 3)
    steps21 = int(cfg21.TRAIN.EVAL_STEP) * int(cfg21.TRAIN.EPOCHS)
    rk.randaugment_mc.launches = 0
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    trainer21, _ = learn.run_config(cfg21, device="cuda", data=data21)
    torch.cuda.synchronize()
    s21 = time.perf_counter() - t0
    launches21 = rk.randaugment_mc.launches
    train21 = [r for r in _log_records(log_dir, "semiformer")
               if "loss/train" in r][len(train):]
    print(f"path G3: real_2_1 ({cfg21.DATA.IMG_SIZE} px, B="
          f"{cfg21.DATA.BATCH_SIZE}, MU={cfg21.DATA.MU}, "
          f"{trainer21._images_per_step()} images a step) {steps21} steps in "
          f"{s21:.2f} s with an evaluation: train loss "
          f"{[r['loss/train'] for r in train21]}, step count "
          f"{trainer21.state.step}, randaugment_mc launches {launches21}",
          flush=True)
    if (trainer21.state.step != steps21 or launches21 != steps21
            or trainer21._images_per_step() != 312
            or not np.isfinite([r["loss/train"] for r in train21]).all()):
        fail("path G3: real_2_1 did not take its steps")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"supervised_step_ms": sup_log[0]["time/epoch_s"] * 1e3
            / sup.n_iter_per_epoch,
            "launches_steps_per_epoch": per_epoch, "train_loss": losses,
            "macro_f1": [r["metric/macro_f1"] for r in valid],
            "eval_max_abs_err": eval_err,
            "real_2_1_launches_per_step": launches21 / steps21}


def phase_semiformer(seed: int, out_dir: Path, data2):
    """Path G: the SemiFormer trainer, G1-G3."""
    out = {"g1": {s: semiformer_step_matches_cpu(s)
                  for s in range(seed, seed + PART1_SEEDS)}}
    out["g2"] = semiformer_full(seed)
    out["g3"] = semiformer_learn(seed, out_dir, data2)
    return out

# -- paths H, I, J --------------------------------------------------------------


def _marked_steps(trainer, attr: str, run, steps: int):
    """``run()`` with ``trainer.<attr>`` (a step) marked by CUDA events and
    the peak memory reset: ``(step ms array, wall s, peak bytes, run's
    result)``; a warm-up of the same call first."""
    import torch

    marks = []
    step = getattr(trainer, attr)

    def marked(*a, **k):
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append(mark)
        return step(*a, **k)

    setattr(trainer, attr, marked)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    setattr(trainer, attr, step)
    if len(marks) != steps:
        fail(f"{attr} ran {len(marks)} times, {steps} expected")
    step_ms = np.array([a.elapsed_time(z)
                        for a, z in zip(marks, marks[1:] + [end])])
    return step_ms, wall_s, torch.cuda.max_memory_allocated(), out


def ezbm_step_matches_cpu(seed: int):
    """Path H1 for one seed: EZBM's stage-1 step by E3's method (the
    memorized features too), then a stage-2 step on the CPU's memorized
    features with the same draws and dropout mask: SGD card vs CPU, and
    Adam on the card with every tensor outside ``fc`` unmoved."""
    cfg = path_e.step_config(path_e.EZBM, True)
    model = path_c.seeded_model(cfg, seed, path_c.HEAD_STD,
                                PART1_RESIDUAL_GAMMA)
    x, t = path_e.step_batch(cfg, seed)
    out, steps, _ = cross_device_step(
        f"path H1, seed {seed}, stage 1", cfg, (x, t), seed,
        lambda dev, view: path_h.stage1_once(cfg, model, view, t, dev, seed),
        lambda view: path_h.stage1_float64(cfg, model, view, t, seed))
    fts_err = max(float((steps["cuda", v][2] - steps["cpu", v][2]).abs().max()
                        / steps["cpu", v][2].abs().max()) for v in ("cuda", "cpu"))
    feats = steps["cpu", "cuda"][2]
    draws = path_h.stage2_draws(cfg, t, seed)
    s2 = {dev: path_h.stage2_once(cfg, model, feats, draws, dev, seed)
          for dev in ("cpu", "cuda")}
    loss_rel = abs(s2["cuda"][0] - s2["cpu"][0]) / abs(s2["cpu"][0])
    fc = [k for k in s2["cpu"][1] if k.startswith("fc.")]
    fc_l2 = path_c.update_errors({k: s2["cuda"][1][k] for k in fc},
                                 {k: s2["cpu"][1][k] for k in fc})[0]
    bn_err = max(float((g - w).abs().max() / w.abs().max())
                 for g, w in zip(s2["cuda"][2], s2["cpu"][2]))
    _, adam, _ = path_h.stage2_once(cfg, model, feats, draws, "cuda", seed,
                                    "Adam")
    moved = [k for k, d in adam.items() if not k.startswith("fc.") and d.any()]
    still = [k for k in fc if not adam[k].any()]
    lam = draws[3]
    print(f"path H1, seed {seed}: memorized anchor features, card vs CPU, "
          f"{fts_err:.3e} of their largest (bound {TRAIN_TOL_F32_LOSS}); "
          f"stage 2 ({len(draws[1])} pairs of {len(feats)} memorized rows, "
          f"lam {float(lam.min()):.3f}..{float(lam.max()):.3f}, one dropout "
          f"mask): loss {s2['cuda'][0]} vs {s2['cpu'][0]}, relative error "
          f"{loss_rel:.3e} (bound {TRAIN_TOL_F32_LOSS}); fc's SGD update "
          f"relative L2 {fc_l2:.3e} (bound {H1_STAGE2_TOL}); the head's BN "
          f"statistics after both passes {bn_err:.3e} of their largest "
          f"(bound {TRAIN_TOL_F32_LOSS}); Adam on the card: tensors outside "
          f"fc moved {len(moved)} {moved[:3]}, fc tensors unmoved {still}",
          flush=True)
    if (fts_err > TRAIN_TOL_F32_LOSS or loss_rel > TRAIN_TOL_F32_LOSS
            or fc_l2 > H1_STAGE2_TOL or bn_err > TRAIN_TOL_F32_LOSS):
        fail("path H1: the EZBM step on the card differs from the CPU's")
    if moved or still:
        fail("path H1: stage 2 under Adam moved a tensor outside fc, or not "
             "fc")
    out.update({"fts_rel_err": fts_err, "stage2_loss_rel_err": loss_rel,
                "stage2_fc_update_l2_err": fc_l2, "stage2_bn_rel_err": bn_err})
    return out


def ezbm_full(seed: int, data2):
    """Path H2: EZBM's stage-1 step at kaggle_supervised_ezbm's full width
    (96 images at 224 px), then its stage 2 on the memory (192 features a
    step): the sampler's host time, the step's card time and enqueue."""
    import torch

    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.models import build_model

    cfg = path_c.train_config(path_e.EZBM, TRAIN={"SAVE_CP": "",
                                                  "LOG_DIR": ""})
    torch.manual_seed(seed)
    trainer = learn.make_trainer(cfg, build_model(cfg), device="cuda",
                                 trainer_override="ezbm")
    learn.configure(trainer, cfg, path_e.supervised_data(cfg, data2))
    b = int(cfg.DATA.BATCH_SIZE)
    images = 3 * b
    trainer.n_iter_per_epoch = TRIPLET_WARMUP_STEPS
    t0 = time.perf_counter()
    trainer.train_one_stage_1(1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    trainer.n_iter_per_epoch = TRIPLET_TIMED_STEPS
    step_ms, wall_s, peak, meter = _marked_steps(
        trainer, "_stage1_step", lambda: trainer.train_one_stage_1(2),
        TRIPLET_TIMED_STEPS)
    med = float(np.median(step_ms))
    flops = train_flops_per_image(trainer.state.model,
                                  trainer.img_size) * images
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    mem = trainer.mem_features
    width = trainer.state.model.backbone.num_features
    mem_ok = (len(mem) == TRIPLET_TIMED_STEPS
              and all(f.device.type == trainer.device.type
                      and f.shape == (b, width) for f in mem))

    trainer._new_stage2_optimizer()
    targets = np.concatenate(trainer.mem_targets)
    bs2 = b * int(cfg.DATA.MU)
    per_epoch = max(len(targets) // bs2, 1)
    rng = np.random.default_rng(seed)

    def draw():
        idx, dual = trainer._sample_stage2_batch(targets, bs2, rng)
        return idx, dual, trainer._stage2_lam(targets[idx], targets[dual])

    t0 = time.perf_counter()
    for _ in range(5):
        draw()
    sampler_ms = (time.perf_counter() - t0) * 200
    idx, dual, lam = draw()
    feats = torch.cat(mem)

    def dev(a, dtype=torch.long):
        return torch.as_tensor(a).to(trainer.device, dtype)

    args = (feats[dev(idx)], dev(targets[idx]), feats[dev(dual)],
            dev(targets[dual]), dev(lam, torch.float32))
    core_ms = cuda_ms(lambda: trainer._stage2_core(*args), iters=10)
    core_host_ms = host_ms(lambda: trainer._stage2_core(*args), iters=5)
    t0 = time.perf_counter()
    epochs = 3
    losses = [trainer.train_one_stage_2(e).avg for e in range(epochs)]
    torch.cuda.synchronize()
    s2_ms = (time.perf_counter() - t0) * 1e3 / (epochs * per_epoch)
    out = {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
           "step_ms_max": float(step_ms.max()),
           "images_per_s": images * len(step_ms) / wall_s,
           "flops_per_step": flops, "flop_share": share, "peak_bytes": peak,
           "stage2_step_ms": s2_ms, "stage2_sampler_ms": sampler_ms,
           "stage2_host_share": sampler_ms / s2_ms,
           "stage2_core_ms": core_ms, "stage2_core_host_ms": core_host_ms,
           "stage2_steps_per_epoch": per_epoch}
    print(f"path H2: stage 1, {len(step_ms)} steps of {images} images ({b} "
          f"anchors, positives, negatives; {trainer.img_size} px, "
          f"{trainer.dtype}) after {TRIPLET_WARMUP_STEPS} warm-up steps "
          f"({warm_s:.2f} s): step ms (CUDA events) median {med:.3f}, min "
          f"{step_ms.min():.3f}, max {step_ms.max():.3f}; "
          f"{out['images_per_s']:.1f} images/s; mean loss {meter.avg:.4f}; "
          f"model FLOPs per step {flops} ({flops / images:.4e} per image), "
          f"{share:.4f} of the dense bf16 peak; peak memory {peak} B; the "
          f"memory {len(mem)} x {tuple(mem[0].shape)} on the card {mem_ok}. "
          f"Stage 2 ({bs2} features a step, {per_epoch} step(s) an epoch of "
          f"{len(targets)} memorized rows): train_one_stage_2 {s2_ms:.3f} ms "
          f"a step (host clock, synchronized; losses {np.round(losses, 4).tolist()}"
          f"), of which the numpy sampler {sampler_ms:.3f} ms "
          f"({sampler_ms / s2_ms:.3f} of it); the step's device work "
          f"{core_ms:.4f} ms (CUDA events), its host enqueue "
          f"{core_host_ms:.4f} ms", flush=True)
    if not (mem_ok and np.isfinite(meter.avg) and np.isfinite(losses).all()):
        fail("path H2: the memory or a loss is wrong")
    return out


def ezbm_capsule(seed: int, out_dir: Path, donor: str):
    """Path H3: ``prepare_trainer`` and ``fit`` (``run_config``'s two
    calls) on kvasir_capsule_transfer's fields with E1's checkpoint as
    ``PRE_TRAIN_PATH``: the graft, both stages, the stage-2 optimizer, the
    checkpoints."""
    import contextlib
    import io
    import shutil

    import torch

    from endoscopy_tpu_torch.ckpt import io as ckpt_io
    from endoscopy_tpu_torch.cli import learn
    from endoscopy_tpu_torch.models import build_model

    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = path_c.train_config(path_h.CAPSULE, MODEL={"PRE_TRAIN_PATH": donor},
                              TRAIN={**path_h.CAPSULE_CUTS,
                                     "SAVE_CP": str(out_dir / "ckpt"),
                                     "LOG_DIR": ""})
    t0 = time.perf_counter()
    data = path_h.capsule_data(cfg, path_h.CAPSULE_SIZES, seed)
    data_s = time.perf_counter() - t0
    torch.manual_seed(seed)
    model = build_model(cfg)
    fresh = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith(("fc.", "head_emb."))}
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = learn.prepare_trainer(cfg, model=model, device="cuda",
                                        data=data, trainer_override="ezbm")
    donor_sd = ckpt_io.restore_checkpoint(donor, "cpu")[0]["model"]
    got, ema = trainer.state.model.state_dict(), trainer.state.ema.state_dict()
    trunk = [k for k in donor_sd if k.startswith("backbone.")]
    off = [k for k in trunk if not (torch.equal(got[k].cpu(), donor_sd[k])
                                    and torch.equal(ema[k].cpu(), donor_sd[k]))]
    stale = [k for k, v in fresh.items() if not torch.equal(got[k].cpu(), v)]

    events, stage = [], [1]
    s1, s2, ev = (trainer.train_one_stage_1, trainer.train_one_stage_2,
                  trainer.evaluate_one)
    new_opt, save = trainer._new_stage2_optimizer, trainer.save_checkpoint

    def one(s, fn):
        def run(epoch):
            stage[0] = s
            meter = fn(epoch)
            events.append(("train", s, epoch, meter.avg, trainer.state.step))
            return meter
        return run

    def evaluate(*a, **k):
        loss, metric = ev(*a, **k)
        events.append(("eval", stage[0], trainer.epoch, loss.avg,
                       float(metric["macro/f1"])))
        return loss, metric

    def switched():
        new_opt()
        events.append(("opt2", trainer._opt2 is not trainer.state.optimizer,
                       trainer._opt2_count, len(trainer._opt2.state)))

    def saved(folder):
        events.append(("save", stage[0], trainer.epoch))
        return save(folder)

    trainer.train_one_stage_1, trainer.train_one_stage_2 = one(1, s1), one(2, s2)
    trainer.evaluate_one, trainer._new_stage2_optimizer = evaluate, switched
    trainer.save_checkpoint = saved
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    best, want = None, []  # the loss ∧ F1 gate, saving in stage 2 only
    for e in events:
        if e[0] == "eval" and (best is None or (best[0] > e[3]
                                                and best[1] < e[4])):
            best = e[3:]
            if e[1] == 2:
                want.append(("save", 2, e[2]))
    saves = [e for e in events if e[0] == "save"]
    files = sorted(p.name for p in (out_dir / "ckpt").iterdir()) if (
        out_dir / "ckpt").exists() else []
    trains = [e for e in events if e[0] == "train"]
    opt2 = [e for e in events if e[0] == "opt2"]
    epochs = int(cfg.TRAIN.EPOCHS)
    s1_steps = trainer.n_iter_per_epoch * epochs
    print(f"path H3: {len(data[0].manifest)} train / {len(data[1].manifest)} "
          f"valid 11-class images made in {data_s:.2f} s; {Path(donor).name} "
          f"of E1 as PRE_TRAIN_PATH: trunk tensors {len(trunk)}, not "
          f"bit-identical in the model or the EMA {len(off)}, fc/head_emb "
          f"tensors not fresh {stale}; fit {fit_s:.2f} s: per epoch (stage, "
          f"epoch, train loss, step count) {[e[1:] for e in trains]}; "
          f"evaluations (stage, epoch, valid loss, macro-F1) "
          f"{[e[1:] for e in events if e[0] == 'eval']}; the stage-2 "
          f"optimizer (new, count, state entries) {[e[1:] for e in opt2]}; "
          f"saves {saves} (the gate selects {want}), files {files}",
          flush=True)
    if off or not trunk or stale:
        fail("path H3: the graft did not keep the trunk and fresh heads")
    if ([e[1:3] for e in trains] != [(s, e) for s in (1, 2)
                                     for e in range(1, epochs + 1)]
            or opt2 != [("opt2", True, 0, 0)]
            or trainer.state.step != s1_steps + trainer._opt2_count
            or not all(np.isfinite(e[3]) for e in trains)):
        fail("path H3: the stages, the stage-2 optimizer or a loss is wrong")
    if saves != want or files != [f"epoch_{e[2]}" for e in want]:
        fail("path H3: checkpoints other than stage 2's gate selects")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"trunk_tensors": len(trunk), "fit_s": fit_s,
            "train": [e[1:] for e in trains], "saves": [e[2] for e in saves],
            "stage2_steps": trainer._opt2_count}


def phase_ezbm(seed: int, out_dir: Path, data2, donor: str):
    """Path H: the EZBM trainer, H1-H3; no kernel runs on it."""
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    rk.randaugment_mc.launches = 0
    out = {"h1": {s: ezbm_step_matches_cpu(s)
                  for s in range(seed, seed + PART1_SEEDS)},
           "h2": ezbm_full(seed, data2),
           "h3": ezbm_capsule(seed, out_dir, donor)}
    out["launches"] = rk.randaugment_mc.launches
    print(f"path H: randaugment_mc launches {out['launches']} (no kernel on "
          "this path)", flush=True)
    if out["launches"]:
        fail("path H launched the RandAugment kernel")
    return out


def effnet_step_matches_cpu(seed: int):
    """Path I1 for one seed: kaggle_supervised_abnorm's EfficientNet-B1 step
    by E3's method; then bf16 on the card against the CPU's float32 step on
    the card's view, and a bf16 control on the un-augmented eval view that
    the update bound must refuse."""
    import torch

    from endoscopy_tpu_torch.aug.views import eval_view

    cfg = path_e.step_config(path_i.ABNORM, False)
    model = path_c.seeded_model(cfg, seed, path_c.HEAD_STD)
    x, t = path_e.step_batch(cfg, seed)
    out, steps, views = cross_device_step(
        f"path I1, seed {seed}", cfg, (x, t), seed,
        lambda dev, view: path_e.step_once(cfg, model, view, t, dev, seed),
        lambda view: path_e.step_float64(cfg, model, view, t, seed))
    ref = steps["cpu", "cuda"]
    cfg.TRAIN.DTYPE = "bfloat16"
    # the views rounded to bf16, as the trainer's bf16 views are (autocast
    # casts the float32 copy the same way)
    for name, view in (("bfloat16", views["cuda"].bfloat16().float()),
                       ("control", eval_view(x, int(cfg.DATA.IMG_SIZE),
                                             torch.bfloat16,
                                             device="cuda").float())):
        got = path_e.step_once(cfg, model, view, t, "cuda", seed)
        rel = abs(got[0][0] - ref[0][0]) / abs(ref[0][0])
        l2 = path_c.update_errors(got[1], ref[1])[0]
        print(f"path I1, seed {seed}: {name} on the card vs float32 on the "
              f"CPU{' (the un-augmented eval view)' if name == 'control' else ''}"
              f": loss {got[0][0]} vs {ref[0][0]}, relative error {rel:.3e} "
              f"(bound {TRAIN_TOL_BF16_LOSS}); updates relative L2 {l2:.3e} "
              f"(bound {I1_TOL_BF16_UPDATE})", flush=True)
        out[name] = {"loss_rel_err": rel, "update_l2_err": l2}
    if (out["bfloat16"]["loss_rel_err"] > TRAIN_TOL_BF16_LOSS
            or out["bfloat16"]["update_l2_err"] > I1_TOL_BF16_UPDATE):
        fail("path I1: the bf16 step on the card differs from the CPU's")
    if out["control"]["update_l2_err"] <= I1_TOL_BF16_UPDATE:
        fail("path I1: the bf16 bound passes a step on the un-augmented view")
    return out


def supervised_timed(cfg, seed: int, steps: int, label: str,
                     warmup: int = TRIPLET_WARMUP_STEPS, model=None):
    """The supervised trainer on ``cfg``'s model (or ``model``) from flax's
    initializer under ``torch.manual_seed(seed)``, on ``path_e``'s seeded
    canonical rows: ``warmup`` warm-up steps, then ``steps`` marked ones.
    Returns the readings."""
    import torch

    from endoscopy_tpu_torch.models import build_model
    from endoscopy_tpu_torch.train.supervised import SupLearning

    torch.manual_seed(seed)
    if model is None:
        model = build_model(cfg)
    trainer = SupLearning(model, cfg.TRAIN.OPT_NAME, device="cuda")
    trainer.get_dataloader(path_e._Rows(cfg, seed), None)
    k = int(cfg.MODEL.NUM_CLASSES)
    trainer.get_config(cfg, cls_num_list=[1] * k,
                       labeled_targets=path_c.labeled_targets(cfg, seed))
    images = trainer._images_per_step()
    trainer.n_iter_per_epoch = warmup
    t0 = time.perf_counter()
    trainer.train_one(1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    trainer.n_iter_per_epoch = steps
    step_ms, wall_s, peak, meter = _marked_steps(
        trainer, "_train_step", lambda: trainer.train_one(2), steps)
    med = float(np.median(step_ms))
    flops = train_flops_per_image(trainer.state.model,
                                  trainer.img_size) * images
    share = flops / (med * 1e-3) / H100_BF16_FLOPS
    print(f"{label}: {steps} steps of {images} images ({cfg.MODEL.NAME}, "
          f"{trainer.img_size} px, {trainer.dtype}, {type(trainer.state.model).__name__}"
          f") after {warmup} warm-up steps ({warm_s:.2f} s): "
          f"step ms (CUDA events) median {med:.3f}, min {step_ms.min():.3f}, "
          f"max {step_ms.max():.3f}; {images * steps / wall_s:.1f} images/s; "
          f"mean loss {meter.avg:.4f}; model FLOPs per step {flops} "
          f"({flops / images:.4e} per image), {share:.4f} of the dense bf16 "
          f"peak; peak memory {peak} B", flush=True)
    if not np.isfinite(meter.avg):
        fail(f"{label}: mean loss {meter.avg}")
    return {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
            "step_ms_max": float(step_ms.max()),
            "images_per_s": images * steps / wall_s, "flops_per_step": flops,
            "flop_share": share, "peak_bytes": peak, "loss": meter.avg}


def phase_effnet(seed: int):
    """Path I: EfficientNet-B1, I1-I2; no kernel runs on it."""
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    rk.randaugment_mc.launches = 0
    out = {"i1": {s: effnet_step_matches_cpu(s)
                  for s in range(seed, seed + PART1_SEEDS)}}
    abnorm = path_c.train_config(path_i.ABNORM, TRAIN={"SAVE_CP": "",
                                                       "LOG_DIR": ""})
    out["i2"] = supervised_timed(abnorm, seed, TRIPLET_TIMED_STEPS,
                                 "path I2, kaggle_supervised_abnorm")
    sup = path_c.train_config(path_i.SUPERVISED, TRAIN={"SAVE_CP": "",
                                                        "LOG_DIR": ""})
    out["i2_supervised"] = supervised_timed(sup, seed, 3,
                                            "path I2, kaggle_supervised")
    out["launches"] = rk.randaugment_mc.launches
    print(f"path I: randaugment_mc launches {out['launches']} (no kernel on "
          "this path)", flush=True)
    if out["launches"]:
        fail("path I launched the RandAugment kernel")
    return out


def _calm_sasa(model) -> None:
    """Path J1's conditioning: every SASA layer's q kernel x J1_Q_SCALE."""
    import torch

    from endoscopy_tpu_torch.models.attention import SASALayer

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SASALayer):
                m.q_conv.weight.mul_(J1_Q_SCALE)


def fixmatch_full(base: dict, path: str, seed: int):
    """``train_one`` at ``base``'s full width (paths J2, K2), 3 warm-up and
    12 timed steps, and the kernel on the step's own input: one launch a
    step, crop-fused with ``pad`` = side / 8 on ``(B·MU, side, side, 3)``,
    0.0 from its plain version."""
    from unittest import mock

    import torch

    from endoscopy_tpu_torch.aug import views
    from endoscopy_tpu_torch.aug.randaugment import randaugment_mc_plain
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk
    from endoscopy_tpu_torch.train.fixmatch import FixMatch

    config = path_c.train_config(base)
    img = int(config.DATA.IMG_SIZE)
    b, bu = int(config.DATA.BATCH_SIZE), int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    images = b + 2 * bu
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD)
    flops = train_flops_per_image(model, img) * images
    trainer = FixMatch(model, config.TRAIN.OPT_NAME, device="cuda")
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(config, seed))
    step_ms, med, wall_s, warm_s, peak, launches, loss = timed_train_one(
        trainer, config, seed, path)
    steps = TRAIN_TIMED_STEPS
    share = flops / (med * 1e-3) / H100_BF16_FLOPS

    seen = []
    kernel = views.randaugment_mc

    def recording(x, pi, pf, *a, **k):
        seen.append((x.clone(), pi.clone(), pf.clone(), k))
        return kernel(x, pi, pf, *a, **k)

    x_u8, t, u_u8 = path_c.canonical_batches(config, seed, 1)[0]
    with mock.patch.object(views, "randaugment_mc", recording):
        trainer._train_step(torch.from_numpy(x_u8).cuda(),
                            torch.from_numpy(t).cuda(),
                            torch.from_numpy(u_u8).cuda(),
                            trainer.class_weights)
    xk, pi, pf, kw = seen[0]
    err = float((rk.randaugment_mc(xk, pi, pf, **kw).float()
                 - randaugment_mc_plain(xk, pi, pf, **kw).float()).abs().max())
    kern_ms = cuda_ms(lambda: rk.randaugment_mc(xk, pi, pf, **kw), iters=50,
                      warmup=3)
    plain_ms = cuda_ms(lambda: randaugment_mc_plain(xk, pi, pf, **kw),
                       iters=2, warmup=1)
    bytes_moved = 2 * xk.numel() * xk.element_size() + pi.numel() * 4 + pf.numel() * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"path {path}: {steps} steps of {images} images ({config.MODEL.NAME}, B={b}, "
          f"B*MU={bu}, {img} px, bf16, {config.TRAIN.OPT_NAME}) after "
          f"{TRAIN_WARMUP_STEPS} warm-up steps ({warm_s:.2f} s); step ms (CUDA "
          f"events between steps) median {med:.3f}, min {step_ms.min():.3f}, max "
          f"{step_ms.max():.3f}, all {np.round(step_ms, 3).tolist()}; wall "
          f"{wall_s:.3f} s, {images * steps / wall_s:.1f} images/s; mean "
          f"loss {loss:.4f}; randaugment_mc launches {launches}; peak memory "
          f"{peak} B; model FLOPs per step {flops} ({flops / images:.4e} per "
          f"image: convolutions, the head, the attention products; forward + "
          f"both gradients), {share:.4f} of the dense bf16 peak", flush=True)
    print(f"path {path}: randaugment_mc crop-fused (crop {kw.get('crop_size')}, "
          f"pad {kw.get('pad')}) on the step's strong-view input "
          f"{tuple(xk.shape)} {xk.dtype}: kernel vs plain version "
          f"max_abs_err={err} (tol 0.0); kernel {kern_ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bytes_moved} B at "
          f"{HBM_BYTES_PER_S:.3g} B/s)", flush=True)
    if err != 0.0 or kw.get("pad") != int(img * 0.125) or tuple(
            xk.shape) != (bu, img, img, 3):
        fail(f"path {path}: the kernel differs from the plain version ({err}) "
             f"or ran at another shape or without the fused pad ({kw})")
    return {"step_ms_median": med, "step_ms_min": float(step_ms.min()),
            "step_ms_max": float(step_ms.max()),
            "images_per_s": images * steps / wall_s, "peak_bytes": peak,
            "flops_per_step": flops, "flop_share": share,
            "launches_per_step": launches / steps, "kernel_ms": kern_ms,
            "kernel_max_abs_err": err, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bytes": bytes_moved,
            "shape": list(xk.shape), "pad": kw.get("pad")}


def phase_real5(seed: int):
    """Path J: FixMatch on the SASA ResNet-50, J1-J2."""
    out = {"j1": {s: train_step_matches_cpu(
        s, path_j.REAL_5, "path J1", _calm_sasa)
        for s in range(seed, seed + PART1_SEEDS)}}
    out["j2"] = fixmatch_full(path_j.REAL_5, "J2", seed)
    return out


def _calm_densenet(model) -> None:
    """Path K1's conditioning: in every BN that reads a dense block's
    concatenation, the channels the block grew at ``path_k.GROWN_SCALE``."""
    import torch

    from endoscopy_tpu_torch.models.densenet import DenseLayer

    bb = model.backbone
    grown_from = None
    with torch.no_grad():
        for name in bb.names + ["norm_final"]:
            m = getattr(bb, name)
            norm = (m.norm1 if isinstance(m, DenseLayer)
                    else getattr(m, "norm", m))
            if name.endswith("_layer1"):  # the block's input channels
                grown_from = norm.num_features
            norm.weight[grown_from:] = path_k.GROWN_SCALE


def phase_densenet(seed: int):
    """Path K: FixMatch on DenseNet-161 at real_3_1's fields, K1-K2."""
    out = {"k1": {s: train_step_matches_cpu(
        s, path_k.REAL_3_1_DENSENET, "path K1", _calm_densenet)
        for s in range(seed, seed + PART1_SEEDS)}}
    out["k2"] = fixmatch_full(path_k.REAL_3_1_DENSENET, "K2", seed)
    return out


def swin_step_matches_cpu(seed: int):
    """Path L1 for one seed: Swin-T's supervised SGD step at 224 px, B=2,
    by path E3's method."""
    cfg = path_e.step_config(path_l.PATHO_SWIN, False, batch=2,
                             img=path_l.PATHO_SWIN["DATA"]["IMG_SIZE"])
    model = path_c.seeded_model(cfg, seed, path_c.HEAD_STD)
    x, t = path_e.step_batch(cfg, seed)
    return cross_device_step(
        f"path L1, seed {seed}", cfg, (x, t), seed,
        lambda dev, view: path_e.step_once(cfg, model, view, t, dev, seed),
        lambda view: path_e.step_float64(cfg, model, view, t, seed))[0]


def phase_swin(seed: int):
    """Path L: Swin-T in the supervised trainer, L1-L2; no kernel runs on
    it."""
    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    rk.randaugment_mc.launches = 0
    out = {"l1": {s: swin_step_matches_cpu(s)
                  for s in range(seed, seed + PART1_SEEDS)}}
    cfg = path_c.train_config(path_l.PATHO_SWIN, TRAIN={"SAVE_CP": "",
                                                        "LOG_DIR": ""})
    out["l2"] = supervised_timed(cfg, seed, TRIPLET_TIMED_STEPS,
                                 "path L2, kaggle_supervised_patho on Swin-T")
    out["launches"] = rk.randaugment_mc.launches
    print(f"path L: randaugment_mc launches {out['launches']} (no kernel on "
          "this path)", flush=True)
    if out["launches"]:
        fail("path L launched the RandAugment kernel")
    return out


def zoo_model(name: str, seed: int, out_dir: Path):
    """Path M for one registry name at kaggle_supervised_patho's width:
    built on the card, a float32 eval forward against the CPU's, a bf16
    supervised step, the artifact's round trip."""
    import copy
    import os

    import torch

    from endoscopy_tpu_torch.aug.views import eval_view
    from endoscopy_tpu_torch.models import build_model
    from endoscopy_tpu_torch.serve.export import (export_model, load_exported,
                                                  make_infer_fn)

    cfg = path_c.train_config(path_l.PATHO_SWIN, MODEL={"NAME": name},
                              TRAIN={"SAVE_CP": "", "LOG_DIR": ""})
    img = int(cfg.DATA.IMG_SIZE)
    torch.manual_seed(seed)
    model = build_model(cfg)
    imgs = np.random.default_rng(seed).integers(
        0, 256, (M_IMAGES, int(img * 1.2), int(img * 1.2), 3), dtype=np.uint8)
    x = eval_view(imgs, img, torch.float32, device="cpu").permute(0, 3, 1, 2)
    with torch.no_grad():
        want = copy.deepcopy(model).eval()(x)
        got = copy.deepcopy(model).cuda().eval()(x.cuda()).cpu()
    eval_err = float((got - want).abs().max() / want.abs().max())
    step = supervised_timed(cfg, seed, M_TIMED_STEPS, f"path M, {name}",
                            warmup=M_WARMUP_STEPS, model=model)
    path = str(out_dir / f"{name}.pt")
    export_model(cfg, model.state_dict(), path)
    size = os.path.getsize(path)
    served = load_exported(path, device="cuda")(imgs)
    direct = make_infer_fn(model, img, "bfloat16", device="cuda")(imgs)
    os.remove(path)
    art_err = float(np.abs(served - direct).max())
    print(f"path M, {name}: float32 eval forward on the card vs the CPU, "
          f"{M_IMAGES} images at {img} px: {eval_err:.3e} of the largest "
          f"logit (bound {M_EVAL_TOL}); the bf16 step {step['step_ms_median']:.3f} "
          f"ms, peak memory {step['peak_bytes']} B, loss {step['loss']:.4f}; "
          f"its {size} B artifact through load_exported vs a direct eval "
          f"forward: max_abs_err={art_err} (equal expected)", flush=True)
    if not eval_err <= M_EVAL_TOL:
        fail(f"path M, {name}: the float32 forward differs on the card")
    if art_err != 0.0 or not np.isfinite(served).all():
        fail(f"path M, {name}: the artifact serves other probabilities")
    return {"eval_rel_err": eval_err, "artifact_max_abs_err": art_err,
            "artifact_bytes": size, **step}


def phase_zoo(seed: int, out_dir: Path):
    """Path M: every other new registry name; no kernel runs on it."""
    import torch

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    out_dir.mkdir(parents=True, exist_ok=True)
    rk.randaugment_mc.launches = 0
    out = {}
    for name in path_l.M_NAMES:
        out[name] = zoo_model(name, seed, out_dir)
        torch.cuda.empty_cache()
    out["launches"] = rk.randaugment_mc.launches
    print(f"path M: randaugment_mc launches {out['launches']} (no kernel on "
          "this path)", flush=True)
    if out["launches"]:
        fail("path M launched the RandAugment kernel")
    return out


def phase_serve_sized(seed: int, out_dir: Path):
    """Path A3: real_5's SASA ResNet-50 artifact at 112 px, and a
    Conformer-Ti artifact (kaggle_supervised_paper's fields) serving its
    conv head, both on the card."""
    import torch

    from endoscopy_tpu_torch.aug.views import eval_view
    from endoscopy_tpu_torch.device import resolve_dtype
    from endoscopy_tpu_torch.models import build_model
    from endoscopy_tpu_torch.serve.export import (export_model, load_exported,
                                                  make_infer_fn)

    out = {}
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = path_c.train_config(path_j.REAL_5)
    img = int(cfg.DATA.IMG_SIZE)
    model = path_c.seeded_model(cfg, seed, path_c.HEAD_STD)
    path = str(out_dir / "real5_sasa.pt")
    size, n_classes = export_model(cfg, model.state_dict(), path)
    imgs = np.random.default_rng(seed).integers(
        0, 256, (N_REQUESTS, size, size, 3), dtype=np.uint8)
    served = load_exported(path, device="cuda")(imgs)
    direct = make_infer_fn(model, img, "bfloat16", device="cuda")(imgs)
    err = float(np.abs(served - direct).max())
    print(f"path A3: real_5's SASA ResNet-50 exported at {img} px "
          f"(canonical {size}) and loaded on the card: {N_REQUESTS} images, "
          f"served vs a direct bf16 eval forward max_abs_err={err} (atol "
          f"{SERVE_ATOL})", flush=True)
    if served.shape != (N_REQUESTS, n_classes) or not err <= SERVE_ATOL:
        fail("path A3: the SASA artifact serves other probabilities")
    out["real_5_max_abs_err"] = err

    cfg = path_c.train_config(path_g.SUP_PAPER)
    img = int(cfg.DATA.IMG_SIZE)
    torch.manual_seed(seed)
    model = build_model(cfg)
    path = str(out_dir / "conformer_ti.pt")
    size, n_classes = export_model(cfg, model.state_dict(), path)
    imgs = np.random.default_rng(seed + 1).integers(
        0, 256, (32, size, size, 3), dtype=np.uint8)
    served = load_exported(path, device="cuda")(imgs)
    model = model.cuda().eval().to(memory_format=torch.channels_last)
    dev = next(model.parameters()).device
    cdtype = resolve_dtype(dev, "bfloat16")  # float32 on a CPU rehearsal
    with torch.inference_mode(), torch.autocast(
            dev.type, torch.bfloat16, enabled=cdtype == torch.bfloat16):
        x = eval_view(imgs, img, cdtype, device=dev)
        conv, _ = model(x.permute(0, 3, 1, 2))
    direct = torch.softmax(conv.float(), -1).cpu().numpy()
    err = float(np.abs(served - direct).max())
    flips = int((served.argmax(1) != direct.argmax(1)).sum())
    print(f"path A3: Conformer-Ti (kaggle_supervised_paper, {n_classes} "
          f"classes, {img} px) served: 32 images, vs softmax(conv head) of a "
          f"direct bf16 eval forward max_abs_err={err} (atol {SERVE_ATOL}), "
          f"argmax differs on {flips} rows", flush=True)
    if not err <= SERVE_ATOL or flips or served.shape != (32, n_classes):
        fail("path A3: the Conformer artifact does not serve its conv head")
    out["conformer_max_abs_err"] = err
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import shutil

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs an NVIDIA card")

    from endoscopy_tpu_torch.ops import randaugment_kernel as rk

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; {torch.cuda.device_count()} card(s)",
          flush=True)
    # float32 references compute in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    ext = rk.build(verbose=True)
    print(f"built the RandAugment kernel in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for side in (IMG, IMG_C):  # paths A-B, path C
        cluster, smem, active, regs, local = ext.randaugment_mc_info(side,
                                                                     True)
        print(f"randaugment_mc at {side} px: a cluster of {cluster} blocks "
              f"per image, {smem} B dynamic shared memory per block, {regs} "
              f"registers and {local} local bytes per thread, "
              f"cudaOccupancyMaxActiveClusters {active}", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    max_err = phase_compare(gen, IMG)
    max_err_c = phase_compare(gen, IMG_C)
    scratch = Path(__file__).resolve().parent / "build" / "chip_smoke"
    rows = {}

    def run(path, phase, *a):
        t = time.perf_counter()
        rows[path] = phase(*a)
        print(f"path {path} took {time.perf_counter() - t:.1f} s", flush=True)
        print(f"path {path}: " + json.dumps(rows[path]), flush=True)
        return rows[path]

    row = run("B", phase_views, gen, args.seed)
    run("A", lambda: {"a": phase_serve(args.seed, scratch),
                      "a2": phase_serve_int8(args.seed, scratch)})
    run("A3", phase_serve_sized, args.seed, scratch / "path_a3")
    run("C", lambda: {"correctness": phase_train_correctness(args.seed),
                      "full": phase_train_full(args.seed),
                      "accum": phase_train_accum(args.seed),
                      "freeze": phase_train_freeze(args.seed)})
    t0 = time.perf_counter()  # D's images feed E, G and H
    data2, rows["D"] = phase_learn(args.seed, scratch / "path_d")
    print(f"path D took {time.perf_counter() - t0:.1f} s", flush=True)
    print("path D: " + json.dumps(rows["D"]), flush=True)
    run("E", phase_supervised, args.seed, scratch / "path_e", data2)
    run("F", phase_comatch, args.seed, scratch / "path_f")
    run("G", phase_semiformer, args.seed, scratch / "path_g", data2)
    run("H", phase_ezbm, args.seed, scratch / "path_h", data2,
        rows["E"]["e1_checkpoint"])
    shutil.rmtree(scratch / "path_e", ignore_errors=True)
    run("I", phase_effnet, args.seed)
    run("J", phase_real5, args.seed)
    run("K", phase_densenet, args.seed)
    run("L", phase_swin, args.seed)
    run("M", phase_zoo, args.seed, scratch / "path_m")

    train, learn_row, sup_row = rows["C"]["full"], rows["D"], rows["E"]
    f2, f3 = rows["F"]["f2"], rows["F"]["f3"]
    g2, g3 = rows["G"]["g2"], rows["G"]["g3"]
    j2, k2 = rows["J"]["j2"], rows["K"]["k2"]

    def fused(r, side):
        return {"launches_per_step": r["launches_per_step"],
                "max_abs_err": r["kernel_max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": "bytes", "shape": r["shape"], "mode": "crop+pad",
                "pad": int(side * 0.125)}

    kernels = [{
        "name": "randaugment_mc", "route": "cuda",
        "source": "endoscopy_tpu_torch/ops/csrc/randaugment.cu",
        "replaces": "endoscopy_tpu/ops/randaugment_kernel.py:373",
        "launches": row["launches"], "max_abs_err": max_err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "path_c": {"launches_per_step": train["launches_per_step"],
                   "max_abs_err": max(max_err_c,
                                      train["kernel_max_abs_err"]),
                   "ms": train["kernel_ms"], "plain_ms": train["plain_ms"],
                   "bound_ms": train["bound_ms"], "bound_by": "bytes",
                   "side": IMG_C},
        "path_d": {"launches": learn_row["launches"],
                   "steps": learn_row["steps"],
                   "launches_per_step": learn_row["launches_per_step"],
                   "side": IMG_C,
                   "stage2_side": learn_row["stage2_side"],
                   "stage2_launches_per_step":
                       learn_row["stage2_launches_per_step"]},
        "path_e": {"launches": sup_row["launches"]},
        "path_f": {"launches_per_step": f2["launches_per_step"],
                   "max_abs_err": f2["kernel_max_abs_err"],
                   "ms": f2["kernel_ms"], "plain_ms": f2["plain_ms"],
                   "bound_ms": f2["bound_ms"], "bound_by": "bytes",
                   "side": int(path_f.REAL_1["DATA"]["IMG_SIZE"]),
                   "mode": "plain",
                   "f3_launches": f3["launches"], "f3_steps": f3["steps"],
                   "f3_real_1_1_launches_per_step":
                       f3["real_1_1_launches_per_step"]},
        "path_g": {"launches_per_step": g2["launches_per_step"],
                   "max_abs_err": g2["kernel_max_abs_err"],
                   "ms": g2["kernel_ms"], "plain_ms": g2["plain_ms"],
                   "bound_ms": g2["bound_ms"], "bound_by": "bytes",
                   "side": int(path_g.REAL_2["DATA"]["IMG_SIZE"]),
                   "mode": "crop+pad",
                   "g3_launches_steps_per_epoch":
                       g3["launches_steps_per_epoch"],
                   "g3_real_2_1_launches_per_step":
                       g3["real_2_1_launches_per_step"]},
        "path_h": {"launches": rows["H"]["launches"]},
        "path_i": {"launches": rows["I"]["launches"]},
        "path_j": fused(j2, path_j.REAL_5["DATA"]["IMG_SIZE"]),
        "path_k": fused(k2, path_k.REAL_3_1_DENSENET["DATA"]["IMG_SIZE"]),
        "path_l": {"launches": rows["L"]["launches"]},
        "path_m": {"launches": rows["M"]["launches"]},
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
