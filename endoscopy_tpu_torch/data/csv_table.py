"""Reading the manifests' CSVs without pandas.

:func:`read_csv` returns a :class:`Table`, a small column table with the
part of pandas' DataFrame that the split functions of ``data/manifest.py``
use: ``df[col]``, ``df.columns``, ``len(df)``, row selection by a boolean
mask (``df[mask]``), and columns that are numpy arrays with ``astype``,
``~``, ``==`` and ``to_numpy(dtype)``.

A column's type is inferred as ``pd.read_csv`` infers it for these files:
int64 when every value is an integer, bool when every value is ``True`` or
``False``, float64 when every value is a number, and str otherwise. It
departs from pandas on empty fields: pandas reads them as NaN (and an
integer column with one becomes float64), here the column is str.
"""

from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np


class Column(np.ndarray):
    """A numpy array with pandas' ``Series.to_numpy``."""

    def to_numpy(self, dtype=None) -> np.ndarray:
        return np.asarray(self, dtype=dtype)


def _infer(values: List[str]) -> np.ndarray:
    for parse in (_ints, _bools, _floats):
        arr = parse(values)
        if arr is not None:
            return arr
    return np.asarray(values, dtype=object)


def _ints(values):
    try:
        return np.asarray([int(v) for v in values], dtype=np.int64)
    except ValueError:
        return None


def _bools(values):
    if values and set(values) <= {"True", "False"}:
        return np.asarray([v == "True" for v in values], dtype=bool)
    return None


def _floats(values):
    try:
        return np.asarray([float(v) for v in values], dtype=np.float64)
    except ValueError:
        return None


class Table:
    """Named columns of equal length (see the module docstring)."""

    def __init__(self, columns: Dict[str, np.ndarray]) -> None:
        self._cols = {name: np.asarray(col).view(Column)
                      for name, col in columns.items()}
        lengths = {len(c) for c in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        mask = np.asarray(key)
        if mask.dtype != bool or mask.shape != (len(self),):
            raise TypeError("a Table selects rows by a boolean mask of its "
                            f"length {len(self)}, got {mask.dtype} "
                            f"{mask.shape}")
        return Table({name: col[mask] for name, col in self._cols.items()})


def read_csv(path: str) -> Table:
    """The CSV at ``path`` (a header line, then one row a line)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    for i, r in enumerate(rows):
        if len(r) != len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, the "
                             f"header {len(header)}")
    return Table({name: _infer([r[j] for r in rows])
                  for j, name in enumerate(header)})
