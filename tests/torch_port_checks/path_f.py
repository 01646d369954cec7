"""Path F's configs and helpers: the CoMatch trainer's fields of
``configs/kaggle_semisupervised_real_1.yaml`` and ``..._real_1_1.yaml``,
and one CoMatch step on a chosen device.

``chip_smoke.py`` uses them on the card; ``comatch.py`` holds the configs
against the YAML files. No JAX, pandas, cv2, PIL or PyYAML: the card's
machine has none.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from endoscopy_tpu_torch.train.comatch import CoMatch
from torch_port_checks import path_c

# The training fields of kaggle_semisupervised_real_1.yaml (path F's full
# width: Adam, MU=5) and kaggle_semisupervised_real_1_1.yaml (SGD, MU=7).
# Left out: data paths, the pretrained checkpoint (path F starts from
# seeded or fresh weights) and the checkpoint directory.
REAL_1 = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 5,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50", "MARGIN": "None",
              "TYPE_SEMI": "CoMatch", "IS_TRIPLET": False, "LOW_DIM": 64},
    "TRAIN": {"IS_FREEZE": False, "IS_SSL": True, "EPOCHS": 50,
              "BASE_LR": 0.001, "WARMUP_LR": 0.0005, "WARMUP_EPOCHS": 5,
              "DECAY_EPOCHS": 10, "OPT_NAME": "Adam", "FREQ_EVAL": 5,
              "SCH_NAME": "cosine", "LR_DECAY": 0.9, "USE_EMA": True,
              "EMA_DECAY": 0.999, "EVAL_STEP": 512, "CLS_WEIGHT": True,
              "THRES": 0.9, "T": 1.0, "LAMBDA_U": 2, "LAMBDA_C": 2},
}
REAL_1_1 = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 7,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50", "MARGIN": "None",
              "TYPE_SEMI": "CoMatch", "LOW_DIM": 64},
    "TRAIN": {"IS_SSL": True, "EPOCHS": 100, "OPT_NAME": "SGD",
              "SCH_NAME": "cosine", "USE_EMA": True, "EVAL_STEP": 512,
              "CLS_WEIGHT": True, "THRES": 0.9, "LAMBDA_U": 2,
              "LAMBDA_C": 2},
}


def images_per_step(config) -> int:
    """B (1 + 3 MU): the labeled batch and three views of the unlabeled."""
    return int(config.DATA.BATCH_SIZE) * (1 + 3 * int(config.DATA.MU))


# F3's cuts (PERF.md §4): 3 epochs of 8 steps, an evaluation and a
# checkpoint after each, EMA decay 0.9 (path D's cut); real_1_1 one epoch
# of 3 steps
F3_CUTS = {"EPOCHS": 3, "EVAL_STEP": 8, "FREQ_EVAL": 1, "EMA_DECAY": 0.9}
F3_SIZES = (512, 1280, 512)  # labeled, unlabeled, valid images
F3_SGD_CUTS = {"EPOCHS": 1, "EVAL_STEP": 3, "FREQ_EVAL": 1}


def learn_configs(save_dir: str, log_dir: str):
    """(real_1, real_1_1) configs with F3's cuts, checkpoints under
    ``save_dir/real_1`` and ``save_dir/real_1_1``, the metric log under
    ``log_dir``."""
    return (path_c.train_config(REAL_1, TRAIN={
                **F3_CUTS, "SAVE_CP": f"{save_dir}/real_1",
                "LOG_DIR": log_dir}),
            path_c.train_config(REAL_1_1, TRAIN={
                **F3_SGD_CUTS, "SAVE_CP": f"{save_dir}/real_1_1",
                "LOG_DIR": log_dir}))


def step_config(base: dict = REAL_1, **train):
    """F1's one-step config: ``base``'s fields at B=4, MU=1 (16 images),
    float32 unless ``train`` says otherwise."""
    return path_c.train_config(base, DATA={"BATCH_SIZE": 4, "MU": 1},
                               TRAIN={"DTYPE": "float32", **train})


# F1's MLP head: the first dense layer's bias. With zero biases, about 40%
# of the head's 512 units see two or fewer positive rows among the step's
# 16 (ReLU), and the 1-D BN after them divides those few values by their
# tiny spread: bf16 then moves the step's update by 0.6-1.0 relative L2 on
# the CPU's own bf16 arithmetic, as on the card. At 3 every unit is
# active for every row (pre-activations 3 ± 0.25) and bf16 reads 0.18-0.19
# (CPU), path C's regime.
FC1_BIAS = 3.0


def step_model(config, seed: int, residual_gamma: float):
    """``path_c.seeded_model`` (He-normal convolutions, heads of std
    ``path_c.HEAD_STD``, each block's last BN scale ``residual_gamma``)
    with the MLP head's first bias at ``FC1_BIAS``."""
    model = path_c.seeded_model(config, seed, path_c.HEAD_STD,
                                residual_gamma)
    with torch.no_grad():
        model.fc.fc1.bias.fill_(FC1_BIAS)
    return model


def keep_mask(config, model, seed: int) -> torch.Tensor:
    """A seeded keep-mask of the MLP head's dropout for one step's rows,
    so that every device drops the same units."""
    rows = images_per_step(config)
    g = torch.Generator().manual_seed(seed + 7)
    return torch.rand((rows, model.fc.fc1.out_features), generator=g) < 0.8


def _trainer(config, model, device: str, seed: int, keep=None) -> CoMatch:
    trainer = CoMatch(copy.deepcopy(model), "SGD", device=device)
    trainer.get_config(config, labeled_targets=path_c.labeled_targets(
        config, seed))
    trainer.generator = torch.Generator().manual_seed(seed)
    trainer.state.model.fc.keep_mask = keep
    return trainer


def step_views(config, model, batch, device: str, seed: int):
    """The step's views ``(x, u_w, u_s0, u_s1)`` on ``device`` in the
    config's dtype, drawn from a CPU generator seeded with ``seed``, so
    every device gets the same draws."""
    x, _, u = batch
    return _trainer(config, model, device, seed)._views(x, u)


def step_once(config, model, views, targets, device: str, seed: int, keep,
              alter=None):
    """One SGD step (smoothing open, as in ``fit``) of a copy of
    ``model`` on ``device`` through ``_train_core`` on ``views``, its
    dropout kept by ``keep``; ``alter`` maps the views to the ones the
    step takes. Returns ``[loss, lx, lu, lc]`` and each parameter's
    update, on the CPU in float32."""
    trainer = _trainer(config, model, device, seed, keep)
    params = dict(trainer.state.model.named_parameters())
    before = {k: p.detach().float().cpu().clone() for k, p in params.items()}
    views = tuple(v.to(trainer.device) for v in views)
    if alter is not None:
        views = alter(*views)
    t = torch.as_tensor(targets).to(trainer.device, torch.long)
    loss, aux = trainer._train_core(*views, t, trainer.class_weights, True)
    stats = [float(loss)] + [float(a) for a in aux]
    return stats, {k: p.detach().float().cpu() - before[k]
                   for k, p in params.items()}


def step_float64(config, model, views, targets, seed: int, keep):
    """The same SGD step on the CPU with the model in float64 on the given
    float32 views: the backbone and heads in float64 (the backbone hands
    its pooled features over in float32), the losses in float32, as
    ``path_c.step_float64``."""
    trainer = _trainer(config, model, "cpu", seed, keep)
    net = trainer.state.model.double()
    net.features = lambda x: net.backbone(x).double()
    trainer.state.ema = None
    params = dict(net.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    trainer._train_core(*(v.cpu().double() for v in views),
                        torch.as_tensor(targets).long(),
                        trainer.class_weights, True)
    return {k: p.detach() - before[k] for k, p in params.items()}


def pseudo_scores(config, model, views, targets, device: str, seed: int,
                  keep):
    """The weak max-probabilities that the THRES mask reads and the
    off-diagonal entries of ``Q = probs · probsᵀ`` that the 0.8 mask
    reads, in the step ``step_once`` takes with these arguments (the same
    train-mode forward, no update), on the CPU."""
    trainer = _trainer(config, model, device, seed, keep)
    views = tuple(v.to(trainer.device) for v in views)
    b, n = len(targets), len(views[1])
    with torch.no_grad():
        logits, low = trainer._forward(*views)
        probs, _ = trainer._pseudo_and_state(
            logits[b:b + n], low[b:b + n], low[:b],
            torch.as_tensor(targets).to(trainer.device, torch.long), True)
    q = probs @ probs.T
    off = q[~torch.eye(n, dtype=torch.bool, device=q.device)]
    return probs.amax(1).cpu(), off.cpu()
