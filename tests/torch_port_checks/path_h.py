"""Path H's configs, data and one-step helpers: the EZBM trainer.

The fields of ``configs/kaggle_supervised_ezbm.yaml`` (``path_e.EZBM``)
and ``configs/kvasir_capsule_transfer.yaml`` written out, since the card's
machine has no PyYAML; ``ezbm.py`` holds them against the files on the
CPU. ``chip_smoke.py`` uses the helpers on the card. No JAX, pandas, cv2,
PIL or PyYAML.

- H3's data: seeded 11-class images at the capsule preset's canonical
  side (``path_d.synthetic_data``), its labeled and unlabeled arrays the
  train set, its valid array the valid set (``path_e.supervised_data``).
- H3's cuts (PERF.md §4): ``EPOCHS`` 2 with ``FREQ_EVAL`` 1 (both stages
  run two epochs), ``EMA_DECAY`` 0.9 (path D's cut), the pretrained
  checkpoint path E1's (the repository has no weights).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from endoscopy_tpu_torch.train.ezbm import EZBM
from torch_port_checks import path_c, path_d, path_e

CAPSULE = {
    "DATA": {"INPUT_NAME": "path", "IMG_SIZE": 224, "BATCH_SIZE": 32,
             "MOCKUP_SSL": False, "MU": 6, "IS_CROP": True},
    "MODEL": {"NUM_CLASSES": 11, "NAME": "resnet50", "MARGIN": "None",
              "IS_TRIPLET": True},
    "TRAIN": {"IS_SSL": False, "EPOCHS": 20, "OPT_NAME": "Adam",
              "SCH_NAME": "step", "FREQ_EVAL": 2, "CLS_WEIGHT": True,
              "USE_EMA": True, "LAMBDA_C": 4.0, "EXPANSION": "balance"},
}
PRESETS = {"kaggle_supervised_ezbm": path_e.EZBM,
           "kvasir_capsule_transfer": CAPSULE}
CAPSULE_CUTS = {"EPOCHS": 2, "FREQ_EVAL": 1, "EMA_DECAY": 0.9}
CAPSULE_SIZES = (176, 176, 176)  # labeled, unlabeled, valid images


def capsule_data(config, sizes, seed: int):
    """What ``cli/learn.py::build_data`` returns for a supervised config,
    from seeded images of the config's classes (``path_d``)."""
    return path_e.supervised_data(config, path_d.synthetic_data(
        config, sizes, seed))


def trainer(config, model, device: str, seed: int, opt: str) -> EZBM:
    """An EZBM trainer over a copy of ``model`` on ``device``, its views
    and dropout drawn from a CPU generator seeded with ``seed``."""
    t = EZBM(copy.deepcopy(model), opt, device=device)
    t.get_dataloader(path_e._Rows(config, seed), None)
    t.get_config(config, cls_num_list=[2] * int(config.MODEL.NUM_CLASSES),
                 labeled_targets=path_c.labeled_targets(config, seed))
    t.generator = torch.Generator().manual_seed(seed)
    t.state.model.fc.generator = t.generator
    return t


def _updates(t, before):
    return {k: p.detach().float().cpu() - before[k]
            for k, p in t.state.model.named_parameters()}


def stage1_once(config, model, view, targets, device: str, seed: int):
    """One stage-1 SGD step through ``_stage1_core`` on ``view``. Returns
    ``([loss], updates, the memorized anchor features)`` on the CPU."""
    t = trainer(config, model, device, seed, "SGD")
    before = {k: p.detach().float().cpu().clone()
              for k, p in t.state.model.named_parameters()}
    loss, fts = t._stage1_core(view.to(t.device), torch.as_tensor(
        targets).to(t.device, torch.long), t.class_weights)
    return [float(loss)], _updates(t, before), fts.cpu()


def stage1_float64(config, model, view, targets, seed: int):
    """The same stage-1 step on the CPU in float64 (the backbone's pooled
    features handed over in float32, ``path_e.step_float64``'s method)."""
    t = trainer(config, model, "cpu", seed, "SGD")
    net = t.state.model.double()
    net.features = lambda x: net.backbone(x).double()
    t.state.ema = None
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    t._stage1_core(view.cpu().double(), torch.as_tensor(targets).long(),
                   t.class_weights)
    return {k: p.detach() - before[k] for k, p in net.named_parameters()}


def stage2_draws(config, targets: np.ndarray, seed: int):
    """Seeded stage-2 inputs for ``B · MU`` pairs of a memory whose rows
    have ``targets``, drawn by the trainer's sampler in ``reverse`` mode
    over uneven class counts (so ``lam`` is not 0.5): (memory targets,
    primary rows, dual rows, lam)."""
    t = EZBM(device="cpu")
    t.cls_num_list = list(range(1, int(config.MODEL.NUM_CLASSES) + 1))
    t.expansion = "reverse"
    targets = np.asarray(targets)
    bs2 = int(config.DATA.BATCH_SIZE) * int(config.DATA.MU)
    idx, dual = t._sample_stage2_batch(targets, bs2,
                                       np.random.default_rng(seed))
    return targets, idx, dual, t._stage2_lam(targets[idx], targets[dual])


def stage2_once(config, model, feats, draws, device: str, seed: int,
                opt: str = "SGD"):
    """One stage-2 step through ``_stage2_core`` on ``feats`` (the memory)
    and ``draws`` (:func:`stage2_draws`), the dropout mask drawn from a
    CPU generator seeded with ``seed``. Returns ``(loss, updates, the
    head's BN statistics after both passes)`` on the CPU."""
    t = trainer(config, model, device, seed, opt)
    t._new_stage2_optimizer()
    targets, idx, dual, lam = draws
    before = {k: p.detach().float().cpu().clone()
              for k, p in t.state.model.named_parameters()}
    f = feats.to(t.device)

    def dev(a, dtype=torch.long):
        return torch.as_tensor(a).to(t.device, dtype)

    loss = t._stage2_core(f[dev(idx)], dev(targets[idx]), f[dev(dual)],
                          dev(targets[dual]), dev(lam, torch.float32))
    bn = t.state.model.fc.bn
    return (float(loss), _updates(t, before),
            [bn.running_mean.cpu(), bn.running_var.cpu()])
