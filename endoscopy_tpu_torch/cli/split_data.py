"""Dataset split CLI (port of ``endoscopy_tpu/cli/split_data.py``;
reference L1: Split.ipynb).

Reproduces the reference's manifest-building notebook as a command:

- train/valid split with ``is_valid`` flags — the reference uses a plain
  (non-stratified) ``train_test_split(test_size=0.2, random_state=42)``
  (Split.ipynb cell 11); ``--stratify`` opts into per-class splitting.
- optional mock-SSL labeling: ``--labeled-frac`` marks that fraction of the
  TRAIN rows ``is_labeled=True`` (stratified by target) and the rest False,
  producing the ``df_split_mock_*`` CSV contract the SSL trainers consume
  (dataset.py:268-277; 1:9 mock split == --labeled-frac 0.1).

Usage::

    python -m endoscopy_tpu_torch.cli.split_data --csv labels.csv --out fold_0.csv \
        [--valid-frac 0.2] [--seed 42] [--stratify] [--labeled-frac 0.1] \
        [--target-col target]

Host pandas and numpy on the CPU, as in the JAX package (pandas is imported
by :func:`main`; :func:`split_dataframe` takes the caller's frame): the
same CSV, byte for byte, from the same input and seed.
"""

from __future__ import annotations

import argparse

import numpy as np


def split_dataframe(df, valid_frac: float = 0.2, seed: int = 42,
                    stratify: bool = False, labeled_frac: float | None = None,
                    target_col: str = "target"):
    """Return a copy of ``df`` with ``is_valid`` (and optionally
    ``is_labeled``) columns, preserving the reference CSV schema."""
    rng = np.random.default_rng(seed)
    # positional masks throughout: reset to a RangeIndex so groupby labels
    # are valid positions regardless of the caller's index
    df = df.reset_index(drop=True)
    n = len(df)

    if stratify:
        valid_mask = np.zeros(n, dtype=bool)
        for _, idx in df.groupby(target_col).groups.items():
            idx = np.asarray(idx)
            k = int(round(len(idx) * valid_frac))
            valid_mask[rng.permutation(idx)[:k]] = True
    else:
        perm = rng.permutation(n)
        valid_mask = np.zeros(n, dtype=bool)
        valid_mask[perm[: int(round(n * valid_frac))]] = True
    df["is_valid"] = valid_mask

    if labeled_frac is not None:
        labeled = np.zeros(n, dtype=bool)
        train_df = df[~df["is_valid"]]
        # stratified per class so rare pathologies keep labeled examples
        for _, idx in train_df.groupby(target_col).groups.items():
            idx = np.asarray(idx)
            k = max(1, int(round(len(idx) * labeled_frac)))
            labeled[rng.permutation(idx)[:k]] = True
        labeled[valid_mask] = True  # valid rows always keep their labels
        df["is_labeled"] = labeled
    return df


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csv", required=True, help="input CSV (image/path + target)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--valid-frac", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--stratify", action="store_true")
    parser.add_argument("--labeled-frac", type=float, default=None,
                        help="mock-SSL labeled fraction of train rows")
    parser.add_argument("--target-col", default="target")
    args = parser.parse_args(argv)

    import pandas as pd
    df = pd.read_csv(args.csv)
    out = split_dataframe(df, valid_frac=args.valid_frac, seed=args.seed,
                          stratify=args.stratify,
                          labeled_frac=args.labeled_frac,
                          target_col=args.target_col)
    out.to_csv(args.out, index=False, header=True)
    n_valid = int(out["is_valid"].sum())
    msg = f"wrote {args.out}: {len(out) - n_valid} train / {n_valid} valid"
    if "is_labeled" in out:
        n_lab = int((out["is_labeled"] & ~out["is_valid"]).sum())
        msg += f" ({n_lab} labeled train rows)"
    print(msg)


if __name__ == "__main__":
    main()
