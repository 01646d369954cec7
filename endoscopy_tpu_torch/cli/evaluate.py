"""Evaluation entry point (port of ``endoscopy_tpu/cli/evaluate.py``).

Usage::

    python -m endoscopy_tpu_torch.cli.evaluate --config <yaml> \
        --checkpoint <dir|.npz> [--report] [--misclassified out.csv] \
        [--device cuda|cpu]

Loads a checkpoint into the config's trainer and runs the validation set:
the metric dict, macro-F1, the sensitivity/specificity table and, with
``--report``, the confusion matrix; ``--misclassified`` writes the
misclassified rows (``path,target,pred``) and ``--confusion`` the
confusion-matrix heatmap PNG (``eval/visualize.py::show_cfs_matrix``; no
PNG without matplotlib). :func:`evaluate` does the work on a configured
trainer; :func:`main` builds it from the config's CSVs on ``--device``.
"""

from __future__ import annotations

import argparse
import csv

from endoscopy_tpu_torch.cli.learn import (build_data, configure,
                                           make_trainer)
from endoscopy_tpu_torch.config.loader import get_config
from endoscopy_tpu_torch.models import build_model


def evaluate(trainer, report: bool = False, misclassified=None,
             confusion=None):
    """The trainer's evaluation of its valid loader, printed; with
    ``misclassified`` a path, the misclassified rows written there as CSV;
    with ``confusion`` a path, the confusion-matrix heatmap there. Returns
    ``(loss meter, metric dict)``."""
    valid_loss, metric = trainer.evaluate_one(show_metric=True,
                                              show_report=report)
    print(f"Valid Loss: {valid_loss.avg:.4f}")
    print(f"macro-F1: {metric['macro/f1']:.4f}")
    print(metric["sen/spec"])
    if not (misclassified or confusion):
        return valid_loss, metric
    _, probs, targets, keep = trainer._eval_pass(trainer.valid_dl)
    preds, targets = probs[keep].argmax(axis=1), targets[keep]
    if confusion:
        from endoscopy_tpu_torch.eval.visualize import show_cfs_matrix
        show_cfs_matrix(targets, preds, int(trainer.config.MODEL.NUM_CLASSES),
                        save_path=confusion)
        print("wrote", confusion)
    if misclassified:
        wrong = preds != targets
        paths = trainer.valid_dl.manifest.paths[:len(wrong)]
        with open(misclassified, "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(["path", "target", "pred"])
            out.writerows(zip(paths[wrong], targets[wrong].tolist(),
                              preds[wrong].tolist()))
        print(f"wrote {misclassified}: {int(wrong.sum())} misclassified")
    return valid_loss, metric


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="endoscopy_tpu_torch evaluation")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a checkpoint directory or a JAX state .npz")
    parser.add_argument("--report", action="store_true")
    parser.add_argument("--confusion", default=None,
                        help="write the confusion-matrix heatmap PNG here")
    parser.add_argument("--misclassified", default=None,
                        help="write the misclassified validation rows here")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = get_config(args.config)
    trainer = make_trainer(config, build_model(config), device=args.device)
    configure(trainer, config, build_data(config, trainer.device))
    trainer.load_checkpoint(args.checkpoint, is_train=False)
    evaluate(trainer, args.report, args.misclassified, args.confusion)


if __name__ == "__main__":
    main()
