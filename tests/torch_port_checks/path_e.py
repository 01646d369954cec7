"""Path E's configs, data and one-step helpers: the supervised trainer.

The fields of ``configs/kaggle_supervised_patho.yaml`` (the plain branch)
and ``configs/kaggle_supervised_ezbm.yaml`` (the triplet branch) written
out, since the card's machine has no PyYAML; ``supervised.py`` holds them
against the files on the CPU. ``chip_smoke.py`` and
``tests/test_torch_port_kernel_cuda.py`` use the helpers on the card. No
JAX, pandas, cv2, PIL or PyYAML.

- Data: path D's seeded 268 px images of known class (its stage 2's
  labeled and unlabeled arrays make E's train set, its valid array E's
  valid set), in the port's ``CanonicalLoader``/``EvalLoader`` with only
  ``decode`` swapped (``path_d.array_loader``).
- Cuts of the plain run (PERF.md §4): no ``PRE_TRAIN_PATH`` (the
  repository has no weights), ``EPOCHS`` 3 with ``FREQ_EVAL`` 1, and
  ``EMA_DECAY`` 0.9 (path D's cut: at 0.999 the teacher would not move in
  about 96 steps).
"""

from __future__ import annotations

import copy
import types

import numpy as np
import torch

from endoscopy_tpu_torch.aug.views import labeled_train_view
from endoscopy_tpu_torch.data.manifest import Manifest, get_cls_num_list
from endoscopy_tpu_torch.data.pipeline import CanonicalLoader, EvalLoader
from endoscopy_tpu_torch.train.supervised import SupLearning
from torch_port_checks import path_c, path_d

# The training fields of kaggle_supervised_patho.yaml and
# kaggle_supervised_ezbm.yaml. Left out: data paths, the pretrained
# checkpoint (path E starts from fresh weights) and the checkpoint
# directory.
PATHO = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50", "MARGIN": "None"},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 100, "OPT_NAME": "Adam",
              "SCH_NAME": "cosine", "FREQ_EVAL": 2, "CLS_WEIGHT": True,
              "USE_EMA": True},
}
EZBM = {
    "DATA": {"IMG_SIZE": 224, "BATCH_SIZE": 32, "MOCKUP_SSL": False, "MU": 6,
             "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 6, "NAME": "resnet50", "MARGIN": "None",
              "TYPE_SEMI": "FixMatch", "IS_TRIPLET": True},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 20, "BASE_LR": 0.001,
              "WARMUP_LR": 0.0005, "WARMUP_EPOCHS": 5, "DECAY_EPOCHS": 5,
              "OPT_NAME": "Adam", "FREQ_EVAL": 2, "SCH_NAME": "step",
              "LR_DECAY": 0.8, "USE_EMA": True, "EMA_DECAY": 0.999,
              "EVAL_STEP": 256, "CLS_WEIGHT": True, "THRES": 0.9,
              "LAMBDA_U": 1.0, "LAMBDA_C": 4.0, "EXPANSION": "balance"},
}
PATHO_CUTS = {"EPOCHS": 3, "FREQ_EVAL": 1, "EMA_DECAY": 0.9}


def patho_config(save_dir: str, log_dir: str):
    """E1's config: ``PATHO`` with its cuts, checkpoints under
    ``save_dir`` and the metric log under ``log_dir``."""
    return path_c.train_config(PATHO, TRAIN={**PATHO_CUTS,
                                             "SAVE_CP": save_dir,
                                             "LOG_DIR": log_dir})


def supervised_data(config, stage2_data):
    """What ``cli/learn.py::build_data`` returns for a supervised config,
    from path D's stage 2 data (``path_d.synthetic_data``): its labeled and
    unlabeled images with their classes as the train set, its valid
    images as the valid set."""
    (lab, unl), valid, _, _ = stage2_data
    images = np.concatenate([lab.images, unl.images])
    targets = np.concatenate([lab.manifest.targets, unl.classes])
    size = lab.size
    bs = int(config.DATA.BATCH_SIZE)
    train = path_d.array_loader(CanonicalLoader, images)(
        Manifest(np.arange(len(images)), targets), bs, size, seed=0)
    valid = path_d.array_loader(EvalLoader, valid.images)(
        valid.manifest, bs, size)
    n_cls = int(config.MODEL.NUM_CLASSES)
    return train, valid, get_cls_num_list(targets, n_cls), targets


def gate_saves(evaluations) -> list:
    """The epochs ``SupLearning.fit`` saves for ``evaluations`` (epoch,
    valid loss, macro-F1): the first, then each where both improved."""
    saves, best = [], None
    for epoch, loss, f1 in evaluations:
        if best is None or (best[0] > loss and best[1] < f1):
            best = (loss, f1)
            saves.append(epoch)
    return saves


class _Rows:
    """A train loader of ``n`` seeded canonical images, classes in turn,
    with the ``manifest``, ``rng`` and ``sample`` the triplet branch
    reads."""

    def __init__(self, config, seed: int, n: int = 64):
        rng = np.random.default_rng(seed)
        s = int(config.DATA.IMG_SIZE * 1.2)
        k = int(config.MODEL.NUM_CLASSES)
        t = np.arange(n) % k
        self.images = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
        self.manifest = Manifest(np.arange(n), t)
        self.rng = np.random.default_rng(seed + 1)
        self.bs = int(config.DATA.BATCH_SIZE)

    def sample(self, idx):
        return self.images[idx]

    def __iter__(self):
        while True:
            idx = self.rng.choice(len(self.images), self.bs, replace=False)
            yield self.images[idx], self.manifest.targets[idx]


def step_config(base: dict, triplet: bool, img: int = 112, **model):
    """E3's config: ``base``'s fields at B=4, ``img`` px, float32, with
    ``model``'s fields over them."""
    return path_c.train_config(
        base, DATA={"IMG_SIZE": img, "BATCH_SIZE": 4},
        MODEL={"IS_TRIPLET": triplet, **model},
        TRAIN={"DTYPE": "float32", "GRAD_ACCUM": 1})


def _trainer(config, model, device: str, seed: int) -> SupLearning:
    trainer = SupLearning(copy.deepcopy(model), "SGD", device=device)
    trainer.get_dataloader(_Rows(config, seed), None)
    trainer.get_config(config, cls_num_list=[1] * 6,
                       labeled_targets=path_c.labeled_targets(config, seed))
    trainer.generator = torch.Generator().manual_seed(seed)
    if trainer.is_triplet:  # the MLP head draws its dropout from it
        trainer.state.model.fc.generator = trainer.generator
    return trainer


def step_batch(config, seed: int):
    """One seeded (uint8 batch, targets) for a step: ``[A; P; N]`` through
    ``_build_triplet_batch`` for the triplet branch, ``targets`` the
    anchors'."""
    rows = _Rows(config, seed)
    x, t = next(iter(rows))
    if bool(config.MODEL.IS_TRIPLET):
        x = SupLearning._build_triplet_batch(
            types.SimpleNamespace(train_dl=rows), x, t)
    return x, t


def step_view(config, batch, seed: int, device: str) -> torch.Tensor:
    """The labeled train view of ``batch``'s images on ``device`` in
    float32, drawn from a CPU generator seeded with ``seed``. A step
    compared across devices takes one view: the view's own float32
    roundings differ in the last bit between devices (its jitter's means,
    its normalize), and a step at B=4 can turn that into percents of a
    tensor's update (a ReLU input within rounding of 0)."""
    return labeled_train_view(batch[0], int(config.DATA.IMG_SIZE),
                              torch.float32, torch.Generator().manual_seed(
                                  seed), device=device)


def step_once(config, model, view, targets, device: str, seed: int):
    """One SGD step of a copy of ``model`` on ``device`` through
    ``_train_core`` on ``view``; the MLP head's dropout draws from a CPU
    generator seeded with ``seed``, so every device gets the same mask.
    Returns the step's ``[loss(, d_ap, d_an)]`` and each parameter's
    update, on the CPU in float32."""
    trainer = _trainer(config, model, device, seed)
    params = dict(trainer.state.model.named_parameters())
    before = {k: p.detach().float().cpu().clone() for k, p in params.items()}
    loss, aux = trainer._train_core(
        view.to(trainer.device), torch.as_tensor(targets).to(
            trainer.device, torch.long), trainer.class_weights)
    stats = [float(loss)] + [float(a) for a in aux]
    return stats, {k: p.detach().float().cpu() - before[k]
                   for k, p in params.items()}


def step_float64(config, model, view, targets, seed: int):
    """The same SGD step on the CPU in float64 from the same view and
    draws: the backbone hands its pooled features over in float32, the
    heads and the update run in float64 (``path_c.step_float64``'s
    method)."""
    trainer = _trainer(config, model, "cpu", seed)
    net = trainer.state.model.double()
    if trainer.is_triplet:
        net.features = lambda x: net.backbone(x).double()
    else:
        net.forward = lambda x: net.head(net.backbone(x).double())
    trainer.state.ema = None
    params = dict(net.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    trainer._train_core(view.cpu().double(), torch.as_tensor(targets).long(),
                        trainer.class_weights)
    return {k: p.detach() - before[k] for k, p in params.items()}
