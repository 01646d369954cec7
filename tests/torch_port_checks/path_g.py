"""Path G's configs and helpers: the SemiFormer trainer's fields of
``configs/kaggle_semisupervised_real_2.yaml`` and ``..._real_2_1.yaml``,
the supervised Conformer's of ``configs/kaggle_supervised_paper.yaml``,
and one SemiFormer step (warmup or FixMatch phase) on a chosen device.

``chip_smoke.py`` uses them on the card; ``semiformer.py`` holds the
configs against the YAML files. No JAX, pandas, cv2, PIL or PyYAML: the
card's machine has none.
"""

from __future__ import annotations

import copy

import torch

from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.train.semiformer import SemiFormer
from torch_port_checks import path_c

# The training fields of the three files. Left out: data paths, the
# pretrained checkpoint (G1 and G2 start from seeded weights; G3 grafts
# its own supervised checkpoint) and the checkpoint directory.
REAL_2 = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 6,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "conformer", "MARGIN": "None",
              "TYPE_SEMI": "SemiFormer"},
    "TRAIN": {"IS_SSL": True, "EPOCHS": 150, "OPT_NAME": "Adam",
              "SCH_NAME": "step", "USE_EMA": True, "EVAL_STEP": 512,
              "EVAL_STEP_SUP": 15, "CLS_WEIGHT": True, "THRES": 0.7,
              "LAMBDA_U": 2},
}
REAL_2_1 = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 24, "MOCKUP_SSL": False, "MU": 6,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "conformer", "MARGIN": "None",
              "TYPE_SEMI": "SemiFormer", "IS_TRIPLET": False, "LOW_DIM": 128},
    "TRAIN": {"IS_FREEZE": False, "IS_SSL": True, "EPOCHS": 100,
              "BASE_LR": 0.001, "WARMUP_LR": 0.0005, "WEIGHT_DECAY": 1e-5,
              "WARMUP_EPOCHS": 5, "DECAY_EPOCHS": 10, "OPT_NAME": "Adam",
              "FREQ_EVAL": 5, "SCH_NAME": "step", "LR_DECAY": 0.8,
              "USE_EMA": True, "EMA_DECAY": 0.999, "EVAL_STEP": 512,
              "EVAL_STEP_SUP": 15, "CLS_WEIGHT": True, "THRES": 0.95,
              "T": 1.0, "LAMBDA_U": 1, "LAMBDA_C": 4},
}
SUP_PAPER = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 23, "NAME": "conformer", "MARGIN": "None"},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 100, "OPT_NAME": "Adam",
              "SCH_NAME": "step", "DECAY_EPOCHS": 5, "EVAL_STEP": 512,
              "CLS_WEIGHT": True, "USE_EMA": True},
}

# G3's cuts (PERF.md §4): the supervised Conformer one epoch with its
# evaluation and checkpoint; real_2 3 epochs (epoch 1 the warmup, 2-3 the
# FixMatch phase) of 8 steps, an evaluation and a checkpoint each, EMA
# decay 0.9 (path D's cut); real_2_1 one FixMatch-phase epoch of 3 steps
SUP_CUTS = {"EPOCHS": 1, "FREQ_EVAL": 1}
REAL_2_CUTS = {"EPOCHS": 3, "EVAL_STEP_SUP": 2, "EVAL_STEP": 8,
               "FREQ_EVAL": 1, "EMA_DECAY": 0.9}
REAL_2_1_CUTS = {"EPOCHS": 1, "EVAL_STEP_SUP": 1, "EVAL_STEP": 3,
                 "FREQ_EVAL": 1}
REAL_2_1_SIZES = (96, 432, 96)  # labeled, unlabeled, valid images


def images_per_step(config) -> int:
    """B (1 + 2 MU): the labeled batch and two views of the unlabeled."""
    return int(config.DATA.BATCH_SIZE) * (1 + 2 * int(config.DATA.MU))


def learn_configs(save_dir: str, log_dir: str):
    """(supervised paper, real_2, real_2_1) configs with G3's cuts,
    checkpoints under ``save_dir/<name>``, the metric log under
    ``log_dir``; real_2's ``PRE_TRAIN_PATH`` is set by the caller."""
    return tuple(
        path_c.train_config(base, TRAIN={**cuts, "SAVE_CP": f"{save_dir}/{name}",
                                         "LOG_DIR": log_dir})
        for name, base, cuts in (("sup_paper", SUP_PAPER, SUP_CUTS),
                                 ("real_2", REAL_2, REAL_2_CUTS),
                                 ("real_2_1", REAL_2_1, REAL_2_1_CUTS)))


def step_config(base: dict = REAL_2, **train):
    """G1's one-step config: ``base``'s fields at 112 px, B=4, MU=1 (12
    images in the FixMatch phase), float32 unless ``train`` says
    otherwise."""
    return path_c.train_config(
        base, DATA={"IMG_SIZE": 112, "BATCH_SIZE": 4, "MU": 1},
        TRAIN={"DTYPE": "float32", **train})


# G1's conditioning (PERF.md §6, PR 8). At the initializer the random
# Conformer is chaotic: the CPU's float32 FixMatch-phase step at 112 px is
# 1.9e-2 from its float64 step, and views rounded to bf16 move it 0.89.
# Each conv block's last BN scale at 0.1 (path C's) brings that to 3.9e-4
# and 3.3e-2. The heads' kernels ×4 spread the weak max-probabilities
# (0.20-0.25 of 6 classes at ×1): a strong view replaced by the weak one
# then moves the losses by 18% instead of 4.8%, far outside bf16's 0.02.
HEAD_SCALE = 4.0


def seeded_model(config, seed: int, residual_gamma=None,
                 head_scale: float = 1.0):
    """The config's Conformer with fresh weights drawn under
    ``torch.manual_seed(seed)`` (flax's initializer); ``residual_gamma``
    sets the scale of every conv block's last BN, as path C's
    ``seeded_model`` does for the ResNet, and ``head_scale`` multiplies
    both heads' kernels."""
    torch.manual_seed(seed)
    model = build_model(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if residual_gamma is not None and name.endswith(".bn3.weight"):
                p.fill_(residual_gamma)
            elif name in ("conv_cls_head.weight", "trans_cls_head.weight"):
                p.mul_(head_scale)
    return model


def _trainer(config, model, device: str, seed: int) -> SemiFormer:
    trainer = SemiFormer(copy.deepcopy(model), "SGD", device=device)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(
        config, seed))
    trainer.generator = torch.Generator().manual_seed(seed)
    return trainer


def step_views(config, model, batch, device: str, seed: int):
    """The FixMatch phase's views ``(x_lb, u_weak, u_strong)`` on
    ``device`` in the config's dtype, drawn from a CPU generator seeded
    with ``seed``, so every device gets the same draws (the labeled view
    alone is the warmup's: it is drawn first)."""
    x, _, u = batch
    return _trainer(config, model, device, seed)._views(x, u)


def step_once(config, model, views, targets, device: str, seed: int,
              alter=None):
    """One SGD step of a copy of ``model`` on ``device``: the warmup step
    on ``views[0]`` when ``views`` holds the labeled view alone, else the
    FixMatch-phase step (``_train_core``); ``alter`` maps the views to the
    ones the step takes. Returns the step's ``[loss]`` or ``[loss, lx,
    lu_conv + lu_trans, mask_mean]`` and each parameter's update, on the
    CPU in float32."""
    trainer = _trainer(config, model, device, seed)
    params = dict(trainer.state.model.named_parameters())
    before = {k: p.detach().float().cpu().clone() for k, p in params.items()}
    views = tuple(v.to(trainer.device) for v in views)
    if alter is not None:
        views = alter(*views)
    t = torch.as_tensor(targets).to(trainer.device, torch.long)
    if len(views) == 1:
        stats = [float(trainer._warmup_core(*views, t, trainer.class_weights))]
    else:
        loss, aux = trainer._train_core(*views, t, trainer.class_weights)
        stats = [float(loss)] + [float(a) for a in aux]
    return stats, {k: p.detach().float().cpu() - before[k]
                   for k, p in params.items()}


def step_float64(config, model, views, targets, seed: int):
    """The same SGD step on the CPU with the model in float64 on the given
    views (the Conformer runs its float32 parts in float64 then), the
    losses taken in float32 as the trainer takes them."""
    trainer = _trainer(config, model, "cpu", seed)
    net = trainer.state.model.double()
    trainer.state.ema = None
    params = dict(net.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    views = tuple(v.cpu().double() for v in views)
    t = torch.as_tensor(targets).long()
    if len(views) == 1:
        trainer._warmup_core(*views, t, trainer.class_weights)
    else:
        trainer._train_core(*views, t, trainer.class_weights)
    return {k: p.detach() - before[k] for k, p in params.items()}


def weak_max_probs(config, model, views, device: str, seed: int):
    """The conv head's max softmax probability of each weak row, which the
    THRES mask reads, from the train-mode forward of the step
    ``step_once`` takes on ``views`` (no update), on the CPU."""
    trainer = _trainer(config, model, device, seed)
    views = tuple(v.to(trainer.device) for v in views)
    trainer.state.model.train()
    with torch.no_grad():
        conv, _ = trainer._heads(torch.cat(views))
    b, n = views[0].shape[0], views[1].shape[0]
    return torch.softmax(conv[b:b + n], -1).amax(-1).cpu()
