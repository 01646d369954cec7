"""Path C's configs and one-step helpers: the FixMatch trainer's fields of
``configs/kaggle_semisupervised_real_3_1.yaml`` and ``..._real_3.yaml``,
seeded models and batches, and one SGD step on a chosen device.

``chip_smoke.py`` and ``tests/test_torch_port_kernel_cuda.py`` use them on
the card; ``train.py`` holds the configs against the YAML files. No JAX:
the card's machine has none (nor PyYAML, so the fields are written out).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data.pipeline import canonical_size
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.train.fixmatch import FixMatch

# The training fields of kaggle_semisupervised_real_3_1.yaml (path C's full
# width) and kaggle_semisupervised_real_3.yaml (its freeze run). Left out:
# data paths, the pretrained checkpoint (path C starts from seeded random
# weights) and the checkpoint directory.
REAL_3_1 = {
    "DATA": {"IMG_SIZE": 112, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 7,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50", "MARGIN": "None",
              "TYPE_SEMI": "FixMatch", "IS_TRIPLET": False, "LOW_DIM": 128},
    "TRAIN": {"IS_FREEZE": False, "IS_SSL": True, "EPOCHS": 100,
              "BASE_LR": 0.001, "WARMUP_LR": 0.0005, "WARMUP_EPOCHS": 5,
              "DECAY_EPOCHS": 10, "OPT_NAME": "Adam", "FREQ_EVAL": 5,
              "SCH_NAME": "step", "LR_DECAY": 0.8, "USE_EMA": True,
              "EMA_DECAY": 0.999, "EVAL_STEP": 512, "CLS_WEIGHT": True,
              "THRES": 0.7, "T": 1.0, "LAMBDA_U": 2, "LAMBDA_C": 4},
}
REAL_3 = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 7,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50", "MARGIN": "None",
              "TYPE_SEMI": "FixMatch"},
    "TRAIN": {"IS_FREEZE": True, "IS_SSL": True, "EPOCHS": 10,
              "OPT_NAME": "Adam", "SCH_NAME": "step", "USE_EMA": True,
              "EVAL_STEP": 512, "CLS_WEIGHT": True, "THRES": 0.7,
              "LAMBDA_U": 2},
}
HEAD_STD = 0.03  # path C's head: logits of O(1), weak max-probs spread


def train_config(base: dict, **sections):
    """``default_config`` with a config's fields, then ``sections`` (name
    → {key: value}) over them."""
    merged = {name: dict(fields) for name, fields in base.items()}
    for name, fields in sections.items():
        merged.setdefault(name, {}).update(fields)
    return default_config(merged)


def seeded_model(config, seed: int, head_std: float = 1e-3,
                 residual_gamma=None):
    """The config's model with random weights from ``seed``: He-normal
    convolutions (fan out) and every dense layer (the head; a
    transformer's too) of std ``head_std`` with zero biases (small, so the
    softmax is not saturated). ``residual_gamma`` sets the scale of every
    block's last BN, as a zero-init residual does with 0: a small value
    keeps the random network out of its chaotic regime, where float32
    rounding alone moves a step's update by percents."""
    model = build_model(config)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=g)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, head_std, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif residual_gamma is not None and name.endswith(".bn3"):
                m.weight.fill_(residual_gamma)
    return model


def labeled_targets(config, seed: int) -> np.ndarray:
    """A seeded label list for the balanced class weights: every class, in
    uneven counts."""
    n = int(config.MODEL.NUM_CLASSES)
    rng = np.random.default_rng(seed + 1)
    return np.concatenate([np.arange(n), rng.integers(0, n, 200)])


def canonical_batches(config, seed: int, n: int):
    """``n`` seeded (labeled uint8, targets, unlabeled uint8) batches at the
    config's canonical size (int(IMG_SIZE * 1.2))."""
    rng = np.random.default_rng(seed)
    b, mu, s = (int(config.DATA.BATCH_SIZE), int(config.DATA.MU),
                canonical_size(config))
    return [(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
             rng.integers(0, int(config.MODEL.NUM_CLASSES), b),
             rng.integers(0, 256, (b * mu, s, s, 3), dtype=np.uint8))
            for _ in range(n)]


def _trainer(config, model, device: str, seed: int) -> FixMatch:
    trainer = FixMatch(copy.deepcopy(model), "SGD", device=device)
    trainer.get_config(config, labeled_targets=labeled_targets(config, seed))
    trainer.generator = torch.Generator().manual_seed(seed)
    return trainer


def step_once(config, model, batch, device: str, seed: int, alter=None):
    """One SGD step of a copy of ``model`` on ``device`` through
    ``_train_step``, its views drawn from a CPU generator seeded with
    ``seed``, so every device gets the same draws; ``alter`` maps the views
    ``(x_lb, u_weak, u_strong)`` to the ones the step takes. Returns
    ``[loss, lx, lu, mask_mean]`` and each parameter's update, on the CPU
    in float32."""
    trainer = _trainer(config, model, device, seed)
    params = dict(trainer.state.model.named_parameters())
    before = {k: p.detach().float().cpu().clone() for k, p in params.items()}
    if alter is not None:
        views = trainer._views
        trainer._views = lambda *a: alter(*views(*a))
    x, t, u = batch
    loss, aux = trainer._train_step(x, t, u, trainer.class_weights)
    stats = [float(loss)] + [float(a) for a in aux]
    return stats, {k: p.detach().float().cpu() - before[k]
                   for k, p in params.items()}


def step_float64(config, model, batch, seed: int):
    """The same SGD step on the CPU in float64, the precision reference:
    the float32 run's views (the kernel's plain version takes float32 or
    bf16), then the model and the update in float64. The backbone hands
    its pooled features over in float32 and the trainer takes the losses
    in float32: relative errors near 1e-7, far below a float32 step's
    own."""
    trainer = _trainer(config, model, "cpu", seed)
    views = trainer._views(batch[0], batch[2])
    net = trainer.state.model.double()
    net.forward = lambda x: net.head(net.backbone(x).double())
    trainer.state.ema = None
    params = dict(net.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    trainer._train_core(*(v.double() for v in views),
                        torch.as_tensor(batch[1]).long(),
                        trainer.class_weights)
    return {k: p.detach() - before[k] for k, p in params.items()}


def update_errors(upd, ref):
    """(relative L2 error over every update, the worst tensor's largest
    error over its largest update)."""
    num = sum(float((upd[k].double() - ref[k].double()).pow(2).sum())
              for k in ref)
    den = sum(float(ref[k].double().pow(2).sum()) for k in ref)
    worst = max(float((upd[k].double() - ref[k].double()).abs().max()
                      / ref[k].abs().max())
                for k in ref if ref[k].abs().max() > 0)
    return (num / den) ** 0.5, worst
