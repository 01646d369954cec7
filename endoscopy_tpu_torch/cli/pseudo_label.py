"""Pseudo-label an unlabeled pool (port of ``endoscopy_tpu/cli/pseudo_label.py``).

Usage::

    python -m endoscopy_tpu_torch.cli.pseudo_label --config <yaml> \
        --checkpoint <dir|.npz> --unlabeled-csv in.csv \
        [--unlabeled-root DIR] --out out.csv [--device cuda|cpu]

The second stage of the real-SSL pipeline: a trained classifier (the
binary abnormal one) runs ``BaseTrainer.inference`` over the pool, giving
``pred = argmax · [max_prob > THRES]`` per image; the written CSV (the
input's columns and ``pred``) is the ``DATA.UNANNO`` of the real-SSL
configs, which train on its ``pred == 1`` rows. ``inference`` does the
work on a configured trainer and a loader; :func:`main` builds them from
the CSVs (pandas and cv2 are imported there only).
"""

from __future__ import annotations

import argparse
from endoscopy_tpu_torch.config.loader import get_config
from endoscopy_tpu_torch.data.manifest import (Manifest,
                                               build_supervised_manifests)
from endoscopy_tpu_torch.data.pipeline import (CanonicalLoader, EvalLoader,
                                               canonical_size)
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.train.supervised import SupLearning


def main(argv=None) -> None:
    import pandas as pd

    parser = argparse.ArgumentParser(description="endoscopy_tpu_torch pseudo-labels")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a checkpoint directory or a JAX state .npz")
    parser.add_argument("--unlabeled-csv", required=True)
    parser.add_argument("--unlabeled-root", default=None,
                        help="defaults to DATA.UNANNO_PATH")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    config = get_config(args.config)
    trainer = SupLearning(model=build_model(config),
                          opt_func=config.TRAIN.OPT_NAME, device=args.device)
    train_m, valid_m, cls_num_list = build_supervised_manifests(
        config, pd.read_csv(config.DATA.ANNO))
    size = canonical_size(config)
    bs = int(config.DATA.BATCH_SIZE)
    trainer.get_dataloader(CanonicalLoader(train_m, bs, size, cache=False),
                           EvalLoader(valid_m, bs, size, cache=False))
    trainer.get_config(config, cls_num_list=cls_num_list,
                       labeled_targets=train_m.targets)
    trainer.load_checkpoint(args.checkpoint, is_train=False)

    df_unl = pd.read_csv(args.unlabeled_csv)
    root = args.unlabeled_root or config.DATA.UNANNO_PATH
    unl_m = Manifest.from_df(df_unl, root, config.DATA.INPUT_NAME,
                             target_name=None)
    df_unl = df_unl.copy()
    df_unl["pred"] = list(trainer.inference(
        EvalLoader(unl_m, bs, size, cache=False)).values())
    df_unl.to_csv(args.out, index=False)
    kept = int((df_unl["pred"] == 1).sum())
    print(f"wrote {args.out}: {kept}/{len(df_unl)} rows pass pred==1")


if __name__ == "__main__":
    main()
