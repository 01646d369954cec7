"""Dataset exploration: manifest statistics + class-distribution chart
(port of ``endoscopy_tpu/cli/eda.py``).

CLI counterpart of the reference's EDA notebooks (EDA_hyper.ipynb,
EDA_capsule.ipynb): per-class counts and train/valid/labeled/unlabeled
breakdowns of an annotation CSV, the class-imbalance ratio that motivates
the re-weighting/LDAM/EZBM machinery, and an optional bar-chart PNG
(the notebooks' value_counts plots).

Usage::

    python -m endoscopy_tpu_torch.cli.eda --csv anno.csv [--target target] \
        [--chart dist.png]

Host pandas (imported by :func:`main`) and matplotlib on the CPU, as in the
JAX package.
"""

from __future__ import annotations

import argparse


def describe(df, target: str = "target") -> dict:
    """Manifest statistics dict (EDA value_counts flows)."""
    out = {"rows": len(df)}
    counts = df[target].value_counts().sort_index()
    out["classes"] = counts.to_dict()
    if len(counts):
        out["imbalance_ratio"] = float(counts.max() / max(counts.min(), 1))
    if "is_valid" in df.columns:
        out["train_rows"] = int((~df["is_valid"].astype(bool)).sum())
        out["valid_rows"] = int(df["is_valid"].astype(bool).sum())
        out["valid_classes"] = (
            df[df["is_valid"].astype(bool)][target]
            .value_counts().sort_index().to_dict())
    if "is_labeled" in df.columns:
        train = (df[~df["is_valid"].astype(bool)]
                 if "is_valid" in df.columns else df)
        out["labeled_rows"] = int(train["is_labeled"].astype(bool).sum())
        out["unlabeled_rows"] = int((~train["is_labeled"].astype(bool)).sum())
    if "pred" in df.columns:
        out["pseudo_positive_rows"] = int((df["pred"] == 1).sum())
    return out


def chart(df, target: str, save_path: str) -> bool:
    """Class-distribution bar chart (sorted desc, the notebooks' layout).

    Returns True when the PNG was written, False when matplotlib is
    unavailable (headless pods).
    """
    from endoscopy_tpu_torch.utils.plotting import _plt

    counts = df[target].value_counts().sort_values(ascending=False)
    plt = _plt()
    if plt is None:  # pragma: no cover - headless pods without mpl
        return False
    fig, ax = plt.subplots(figsize=(max(6, len(counts) * 0.6), 4))
    ax.bar([str(c) for c in counts.index], counts.values)
    ax.set_ylabel("images")
    ax.set_xlabel(target)
    ax.tick_params(axis="x", rotation=60)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", required=True)
    parser.add_argument("--target", default="target")
    parser.add_argument("--chart", default=None,
                        help="write a class-distribution bar chart PNG here")
    args = parser.parse_args(argv)

    import pandas as pd
    df = pd.read_csv(args.csv)
    stats = describe(df, args.target)
    for k, v in stats.items():
        print(f"{k}: {v}")
    if args.chart:
        if chart(df, args.target, args.chart):
            print(f"chart written to {args.chart}")
        else:
            print("chart skipped: matplotlib not available")


if __name__ == "__main__":
    main()
