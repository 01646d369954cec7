"""Training entry point (port of ``endoscopy_tpu/cli/learn.py``).

Usage::

    python -m endoscopy_tpu_torch.cli.learn --config-1 configs/foo.yaml \
        [--config-2 configs/bar.yaml] [--device cuda|cpu]

``--config`` is another name for ``--config-1``.

Two configs run progressive resizing: the model is built once from the
first config, and the second stage trains the first stage's final weights
at its own image size. ``TRAIN.IS_SSL`` with ``MODEL.TYPE_SEMI: FixMatch``,
``CoMatch`` or ``SemiFormer`` trains that trainer (all fed by the same
labeled and unlabeled loaders; SemiFormer's warmup epochs, before
``TRAIN.EVAL_STEP_SUP``, use the labeled one alone, and a resume past them
starts in the FixMatch phase), ``TRAIN.IS_SSL: False`` the supervised
trainer (its plain and triplet branches), and ``--trainer ezbm`` the
two-stage EZBM trainer (``train/ezbm.py``, given ``cls_num_list``, as
the supervised trainer is); ``MODEL.PRE_TRAIN_PATH`` grafts
a donor's trunk and ``MODEL.PRE_TRAIN_RESUME`` resumes a checkpoint (a
directory of the port, or a JAX train state dumped to ``.npz``). SIGTERM
checkpoints at the next epoch boundary and exits 143.

pandas (the CSVs) and cv2 (the JPEGs) are imported only by
:func:`build_data`, so a caller that brings its own loaders needs neither.
Not ported yet (ROADMAP.md): ``DATA.LOADER: native`` and ``--preview``.
"""

from __future__ import annotations

import argparse

from endoscopy_tpu_torch.config.loader import get_config, is_none
from endoscopy_tpu_torch.data.manifest import (build_ssl_manifests,
                                               build_supervised_manifests,
                                               shard_for_host)
from endoscopy_tpu_torch.data.pipeline import (CanonicalLoader, EvalLoader,
                                               canonical_size)
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.train import preempt


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to endoscopy_tpu_torch yet; see the port "
        "queue in ROADMAP.md")


def build_data(config):
    """``(train loader(s), valid loader, cls_num_list, labeled targets)``
    from the config's CSVs: ``(labeled, unlabeled)`` loaders for an SSL
    config, one loader over the full supervised split otherwise."""
    import pandas as pd

    if config.DATA.get("LOADER") == "native":
        raise _not_ported("DATA.LOADER: native (the C++ loader)")
    df_anno = pd.read_csv(config.DATA.ANNO)
    size = canonical_size(config)
    bs = int(config.DATA.BATCH_SIZE)
    workers = int(config.DATA.NUM_WORKERS)
    if not config.TRAIN.IS_SSL:
        train, valid, cls_num_list = build_supervised_manifests(
            config, df_anno, is_full_sup=True)
        train_dl = CanonicalLoader(shard_for_host(train), bs, size, seed=0,
                                   num_workers=workers)
        valid_dl = EvalLoader(valid, bs, size, num_workers=workers)
        return train_dl, valid_dl, cls_num_list, train.targets
    df_unanno = (None if config.DATA.MOCKUP_SSL
                 else pd.read_csv(config.DATA.UNANNO))
    labeled, unlabeled, valid, cls_num_list = build_ssl_manifests(
        config, df_anno, df_unanno)
    lab_dl = CanonicalLoader(shard_for_host(labeled), bs, size, seed=0,
                             num_workers=workers)
    unl_dl = CanonicalLoader(shard_for_host(unlabeled),
                             bs * int(config.DATA.MU), size, seed=1,
                             num_workers=workers)
    valid_dl = EvalLoader(valid, bs, size, num_workers=workers)
    return (lab_dl, unl_dl), valid_dl, cls_num_list, labeled.targets


def make_trainer(config, model, device=None, trainer_override=None):
    """The trainer ``TRAIN.IS_SSL`` and ``MODEL.TYPE_SEMI`` select, or
    EZBM for ``trainer_override='ezbm'``."""
    if trainer_override == "ezbm":
        from endoscopy_tpu_torch.train.ezbm import EZBM
        return EZBM(model=model, opt_func=config.TRAIN.OPT_NAME,
                    device=device)
    if not config.TRAIN.IS_SSL:
        from endoscopy_tpu_torch.train.supervised import SupLearning
        return SupLearning(model=model, opt_func=config.TRAIN.OPT_NAME,
                           device=device)
    type_semi = config.MODEL.TYPE_SEMI
    if type_semi == "FixMatch":
        from endoscopy_tpu_torch.train.fixmatch import FixMatch
        return FixMatch(model=model, opt_func=config.TRAIN.OPT_NAME,
                        device=device)
    if type_semi == "CoMatch":
        from endoscopy_tpu_torch.train.comatch import CoMatch
        return CoMatch(model=model, opt_func=config.TRAIN.OPT_NAME,
                       device=device)
    if type_semi == "SemiFormer":
        from endoscopy_tpu_torch.train.semiformer import SemiFormer
        return SemiFormer(model=model, opt_func=config.TRAIN.OPT_NAME,
                          device=device)
    raise ValueError(f"unknown TYPE_SEMI {type_semi}")


def configure(trainer, config, data) -> None:
    """``get_dataloader`` and ``get_config`` with ``data`` (what
    :func:`build_data` returns), as each trainer takes them."""
    train_dl, valid_dl, cls_num_list, labeled_targets = data
    trainer.get_dataloader(train_dl, valid_dl)
    if config.TRAIN.IS_SSL and trainer.trainer_name != "EZBM":
        trainer.get_config(config, labeled_targets=labeled_targets)
    else:
        trainer.get_config(config, cls_num_list=cls_num_list,
                           labeled_targets=labeled_targets)


def prepare_trainer(config, model=None, carry_state=None, device=None,
                    data=None, trainer_override=None):
    """One stage up to ``fit``: the data, the trainer, its config, the
    weights (``carry_state``, the previous stage's model state, or else
    ``MODEL.PRE_TRAIN_PATH``) and the resume. ``data`` is what
    :func:`build_data` returns; by default it is built from the CSVs.
    ``trainer_override`` is ``--trainer``."""
    if data is None:
        data = build_data(config)
    if model is None:
        model = build_model(config)
    trainer = make_trainer(config, model, device=device,
                           trainer_override=trainer_override)
    configure(trainer, config, data)
    from endoscopy_tpu_torch.ckpt.transfer import (apply_pretrain,
                                                   carry_stage_weights)
    if carry_state is not None:
        carry_stage_weights(trainer, carry_state)
    else:
        apply_pretrain(trainer, config)
    if not is_none(config.MODEL.PRE_TRAIN_RESUME):
        trainer.load_checkpoint(config.MODEL.PRE_TRAIN_RESUME, is_train=True)
    return trainer


def run_config(config, model=None, carry_state=None, device=None, data=None,
               trainer_override=None):
    """One training stage: :func:`prepare_trainer`, then ``fit``. Returns
    ``(trainer, model)``."""
    trainer = prepare_trainer(config, model, carry_state, device, data,
                              trainer_override)
    trainer.fit()
    return trainer, trainer.state.model


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="endoscopy_tpu_torch training")
    parser.add_argument("--config-1", "--config", dest="config_1",
                        required=True)
    parser.add_argument("--config-2", default=None,
                        help="second stage for progressive resizing")
    parser.add_argument("--trainer", default=None, choices=[None, "ezbm"],
                        help="override trainer dispatch (EZBM's two "
                        "stages)")
    parser.add_argument("--preview", default=None, metavar="PATH.png",
                        help="augmentation-view grid (not ported yet)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.preview is not None:
        raise _not_ported("--preview (eval/visualize.py)")

    # SIGTERM → checkpoint at the next epoch boundary → exit 143
    preempt.install()

    configs = [get_config(args.config_1)]
    if args.config_2:
        configs.append(get_config(args.config_2))

    model = None
    carry_state = None
    for idx, config in enumerate(configs):
        print(f"=== stage {idx} | IMG_SIZE={config.DATA.IMG_SIZE} ===")
        trainer, model = run_config(config, model=model,
                                    carry_state=carry_state,
                                    device=args.device,
                                    trainer_override=args.trainer)
        carry_state = model.state_dict()
        if preempt.requested():
            print("[preempt] exiting 143 (checkpoint saved; resume with "
                  "MODEL.PRE_TRAIN_RESUME)", flush=True)
            raise SystemExit(143)


if __name__ == "__main__":
    main()
