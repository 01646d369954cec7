"""CSV manifest layer (copy of ``endoscopy_tpu/data/manifest.py``).

The CSVs carry ``image``/``path`` (``DATA.INPUT_NAME``), ``target``,
``is_valid``, and for SSL splits ``is_labeled`` (mock pools) or ``pred``
(real pools, filtered by ``pred == 1``). A :class:`Manifest` is the resolved
flat view of one split: image paths and integer targets. The split
functions take a pandas DataFrame or the port's ``data/csv_table.py``
table, which ``cli/learn.py::build_data`` reads; they import no pandas.

In a process group :func:`shard_for_host` gives each rank its strided
slice of a manifest, as each host of the JAX package reads its own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Manifest:
    """A resolved data split: image paths and targets (both length N)."""

    paths: np.ndarray  # object array of path strings
    targets: np.ndarray  # int64 labels (zeros for unlabeled pools)

    def __post_init__(self) -> None:
        self.paths = np.asarray(self.paths, dtype=object)
        self.targets = np.asarray(self.targets, dtype=np.int64)
        if len(self.paths) != len(self.targets):
            raise ValueError(
                f"paths ({len(self.paths)}) and targets ({len(self.targets)}) "
                f"length mismatch")

    def __len__(self) -> int:
        return len(self.paths)

    @classmethod
    def from_df(cls, df, root: str, input_name: str = "image",
                target_name: Optional[str] = "target") -> "Manifest":
        """``os.path.join(root, row[input_name])`` per row. Without a
        target column (``target_name=None``, or absent as in real unlabeled
        pools) the targets are zeros."""
        paths = np.array(
            [os.path.join(root, str(p)) for p in df[input_name]], dtype=object)
        if target_name is not None and target_name in df.columns:
            targets = df[target_name].to_numpy(np.int64)
        else:
            targets = np.zeros(len(df), np.int64)
        return cls(paths=paths, targets=targets)

    def take(self, indices: np.ndarray) -> "Manifest":
        indices = np.asarray(indices)
        return Manifest(paths=self.paths[indices], targets=self.targets[indices])


def get_cls_num_list(targets: np.ndarray, num_classes: int) -> List[int]:
    """Per-class sample counts, of length ``max(num_classes, observed
    classes)``."""
    t = np.asarray(targets, np.int64)
    return np.bincount(t, minlength=int(num_classes)).tolist()


def _split_valid(df):
    valid_mask = df["is_valid"].astype(bool)
    return df[~valid_mask], df[valid_mask]


def build_supervised_manifests(config, df_anno, is_full_sup: bool = True
                               ) -> Tuple[Manifest, Manifest, List[int]]:
    """Supervised split: (train, valid, cls_num_list). ``is_full_sup``
    trains on every non-valid row; ``False`` keeps the ``is_labeled`` rows."""
    input_name = str(config.DATA.INPUT_NAME)
    target_name = str(config.DATA.TARGET_NAME)
    df_train, df_valid = _split_valid(df_anno)
    if not is_full_sup and "is_labeled" in df_train.columns:
        df_train = df_train[df_train["is_labeled"].astype(bool)]
    train_m = Manifest.from_df(df_train, config.DATA.PATH, input_name, target_name)
    valid_m = Manifest.from_df(df_valid, config.DATA.PATH, input_name, target_name)
    cls_num_list = get_cls_num_list(train_m.targets,
                                    int(config.MODEL.NUM_CLASSES))
    return train_m, valid_m, cls_num_list


def build_ssl_manifests(config, df_anno, df_unanno=None
                        ) -> Tuple[Manifest, Manifest, Manifest, List[int]]:
    """SSL split: (labeled, unlabeled, valid, cls_num_list).

    Mock pools (``DATA.MOCKUP_SSL``): the anno CSV's ``is_labeled`` column
    splits the training rows; both live under ``DATA.PATH``. Real pools:
    every training row is labeled, and the unlabeled pool is the
    ``DATA.UNANNO`` CSV's ``pred == 1`` rows under ``DATA.UNANNO_PATH``.
    """
    input_name = str(config.DATA.INPUT_NAME)
    target_name = str(config.DATA.TARGET_NAME)
    df_train, df_valid = _split_valid(df_anno)
    valid_m = Manifest.from_df(df_valid, config.DATA.PATH, input_name, target_name)

    if config.DATA.MOCKUP_SSL:
        if "is_labeled" not in df_train.columns:
            raise ValueError(
                "DATA.MOCKUP_SSL=True needs an 'is_labeled' column in the "
                "anno CSV (mock split contract, e.g. df_split_mock_1_9.csv)")
        lab_mask = df_train["is_labeled"].astype(bool)
        labeled_m = Manifest.from_df(df_train[lab_mask], config.DATA.PATH,
                                     input_name, target_name)
        unlabeled_m = Manifest.from_df(df_train[~lab_mask], config.DATA.PATH,
                                       input_name, target_name=None)
    else:
        if df_unanno is None:
            raise ValueError("MOCKUP_SSL=False requires the DATA.UNANNO CSV")
        labeled_m = Manifest.from_df(df_train, config.DATA.PATH,
                                     input_name, target_name)
        df_pool = df_unanno[df_unanno["pred"] == 1]
        unlabeled_m = Manifest.from_df(df_pool, config.DATA.UNANNO_PATH,
                                       input_name, target_name=None)

    cls_num_list = get_cls_num_list(labeled_m.targets,
                                    int(config.MODEL.NUM_CLASSES))
    return labeled_m, unlabeled_m, valid_m, cls_num_list


def shard_for_host(manifest: Manifest) -> Manifest:
    """This rank's slice of ``manifest`` in a process group: rank ``i`` of
    ``P`` keeps rows ``i::P``. The manifest itself in one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return manifest
    world, rank = dist.get_world_size(), dist.get_rank()
    return manifest.take(np.arange(rank, len(manifest), world))
