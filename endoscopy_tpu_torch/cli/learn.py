"""Training entry point (port of ``endoscopy_tpu/cli/learn.py``).

Usage::

    python -m endoscopy_tpu_torch.cli.learn --config-1 configs/foo.yaml \
        [--config-2 configs/bar.yaml] [--device cuda|cpu]
    torchrun --standalone --nproc_per_node=<cards> \
        -m endoscopy_tpu_torch.cli.learn --config-1 configs/foo.yaml

``--config`` is another name for ``--config-1``. Under ``torchrun`` each
process joins the group (``parallel/mesh.py::init_from_env``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and trains on its rows of
the global batch (``train/common.py``).

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

:func:`build_data` reads the CSVs with ``data/csv_table.py`` (no pandas).
``DATA.LOADER: native`` decodes the JPEGs with the native loader
(``data/native_loader.py``), the validation set too, so that route needs
no cv2: on the card nvJPEG and the resize kernel (``data/jpeg_card.py``)
on ``cuda:LOCAL_RANK`` under ``torchrun``, the batches staying there; on
the CPU libjpeg. Any other value decodes with cv2 on the host, imported
only then. A caller that brings its own loaders needs neither.
``--preview PATH.png`` saves the trainer's views of one batch before each
stage trains (``eval/visualize.py::preview_views``; ``_stage<i>`` is added
to the name with two configs).
"""

from __future__ import annotations

import argparse
import functools
import os

from endoscopy_tpu_torch.config.loader import get_config, is_none
from endoscopy_tpu_torch.data.csv_table import read_csv
from endoscopy_tpu_torch.data.manifest import (build_ssl_manifests,
                                               build_supervised_manifests,
                                               shard_for_host)
from endoscopy_tpu_torch.data.pipeline import (CanonicalLoader, EvalLoader,
                                               canonical_size)
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.parallel import (group_rank, group_size, in_group,
                                          init_from_env, leave_group)
from endoscopy_tpu_torch.train import preempt


def rank_batch_size(config) -> int:
    """This rank's share of the global ``DATA.BATCH_SIZE``; raises when the
    ranks do not divide it."""
    bs = int(config.DATA.BATCH_SIZE)
    world = group_size()
    if bs % world:
        raise ValueError(f"DATA.BATCH_SIZE {bs} is not divisible by the "
                         f"{world} processes of the group")
    return bs // world


def _train_loader(manifest, bs: int, size: int, seed: int, workers: int,
                  native: bool, device):
    if native:
        from endoscopy_tpu_torch.data.native_loader import \
            NativeCanonicalLoader
        return NativeCanonicalLoader(manifest, bs, size, seed=seed,
                                     num_threads=workers, device=device)
    return CanonicalLoader(manifest, bs, size, seed=seed, num_workers=workers)


def build_data(config, device=None):
    """``(train loader(s), valid loader, cls_num_list, labeled targets)``
    from the config's CSVs: ``(labeled, unlabeled)`` loaders for an SSL
    config, one loader over the full supervised split otherwise. In a
    process group the train loaders read this rank's rows of the
    manifests (``shard_for_host``) in this rank's share of the batch; the
    class counts and targets are the whole manifest's, and every rank's
    valid loader reads the whole validation set. ``DATA.LOADER: native``
    decodes every loader's files with the native loader on ``device``
    (``cuda`` by default: nvJPEG, the batches on the card; ``cpu``: the
    libjpeg core), seeds 0 and 1 for the train loaders, ``NUM_WORKERS``
    threads each."""
    native = config.DATA.get("LOADER") == "native"
    decoder = None
    if native:
        from endoscopy_tpu_torch.data.native_loader import decode_files
        decoder = functools.partial(decode_files, device=device)
    df_anno = read_csv(config.DATA.ANNO)
    size = canonical_size(config)
    bs = rank_batch_size(config)
    workers = int(config.DATA.NUM_WORKERS)
    valid_kw = dict(num_workers=workers, decoder=decoder)
    if not config.TRAIN.IS_SSL:
        train, valid, cls_num_list = build_supervised_manifests(
            config, df_anno, is_full_sup=True)
        train_dl = _train_loader(shard_for_host(train), bs, size, 0, workers,
                                 native, device)
        valid_dl = EvalLoader(valid, bs, size, **valid_kw)
        return train_dl, valid_dl, cls_num_list, train.targets
    df_unanno = (None if config.DATA.MOCKUP_SSL
                 else read_csv(config.DATA.UNANNO))
    labeled, unlabeled, valid, cls_num_list = build_ssl_manifests(
        config, df_anno, df_unanno)
    lab_dl = _train_loader(shard_for_host(labeled), bs, size, 0, workers,
                           native, device)
    unl_dl = _train_loader(shard_for_host(unlabeled),
                           bs * int(config.DATA.MU), size, 1, workers, native,
                           device)
    valid_dl = EvalLoader(valid, bs, size, **valid_kw)
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
                    data=None, trainer_override=None, preview=None):
    """One stage up to ``fit``: the data, the trainer, its config, the
    weights (``carry_state``, the previous stage's model state, or else
    ``MODEL.PRE_TRAIN_PATH``) and the resume. ``data`` is what
    :func:`build_data` returns (in a process group, this rank's loaders);
    by default it is built from the CSVs on ``device``.
    ``trainer_override`` is ``--trainer``; ``preview`` a PNG path for
    :func:`eval.visualize.preview_views` of the train loaders, rendered on
    ``device`` before the trainer is built (written by rank 0 alone)."""
    if data is None:
        data = build_data(config, device)
    if preview:
        from endoscopy_tpu_torch.eval.visualize import preview_views
        save = preview if group_rank() == 0 else None
        preview_views(config, data[0], save_path=save, device=device)
        print(f"augmentation preview saved to {preview}")
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
               trainer_override=None, preview=None):
    """One training stage: :func:`prepare_trainer`, then ``fit``. Returns
    ``(trainer, model)``."""
    trainer = prepare_trainer(config, model, carry_state, device, data,
                              trainer_override, preview)
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
                        help="save a one-batch augmentation-view grid "
                        "before training")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    # SIGTERM → checkpoint at the next epoch boundary → exit 143
    preempt.install()
    group = init_from_env(args.device)  # NCCL on cuda:LOCAL_RANK
    device = group.device if in_group() else args.device

    configs = [get_config(args.config_1)]
    if args.config_2:
        configs.append(get_config(args.config_2))

    model = None
    carry_state = None
    try:
        for idx, config in enumerate(configs):
            print(f"=== stage {idx} | IMG_SIZE={config.DATA.IMG_SIZE} ===")
            preview = args.preview
            if preview and len(configs) > 1:
                stem, ext = os.path.splitext(preview)
                preview = f"{stem}_stage{idx}{ext or '.png'}"
            trainer, model = run_config(config, model=model,
                                        carry_state=carry_state,
                                        device=device,
                                        trainer_override=args.trainer,
                                        preview=preview)
            carry_state = model.state_dict()
            if preempt.requested():
                print("[preempt] exiting 143 (checkpoint saved; resume with "
                      "MODEL.PRE_TRAIN_RESUME)", flush=True)
                raise SystemExit(143)
    finally:
        leave_group()


if __name__ == "__main__":
    main()
