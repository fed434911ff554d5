"""CSV tables read with the standard library and numpy, as the readers of
the JAX package read them with pandas (``pd.read_csv`` with a header row):
a column's values as float64 (pandas' missing markers, the empty field
among them, read as NaN) or as integers (``.astype(int)``: whole numbers
or truncated floats), the column sets that pandas sorts
(``df.columns.difference``) and the ``index_col=0`` description files, keyed
as pandas infers the index (integers where every key is one)."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

# the strings pandas reads as missing by default
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
                       "n/a", "nan", "null"})


class Table:
    """A CSV file's header and its columns of strings, in file order."""

    def __init__(self, path: Path):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        self.columns = rows[0]
        self._cols = {name: [r[i] for r in rows[1:]] for i, name in enumerate(self.columns)}

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def strings(self, name: str) -> list[str]:
        return self._cols[name]

    def floats(self, name: str) -> np.ndarray:
        return np.array([np.nan if v in NA_VALUES else float(v) for v in self._cols[name]],
                        dtype=np.float64)

    def ints(self, name: str) -> np.ndarray:
        try:
            return np.array([int(v) for v in self._cols[name]], dtype=np.int64)
        except ValueError:
            return self.floats(name).astype(np.int64)

    def matrix(self, names) -> np.ndarray:
        """The named columns side by side, [rows, len(names)] float64."""
        return np.stack([self.floats(n) for n in names], axis=1)

    def difference(self, drop) -> list[str]:
        """``df.columns.difference(drop)``: the other columns, sorted."""
        return sorted(set(self.columns) - set(drop))

    def without(self, drop) -> list[str]:
        """``df.drop(columns=drop).columns``: the other columns in file order."""
        missing = set(drop) - set(self.columns)
        if missing:
            raise KeyError(f"columns {sorted(missing)} not found")
        return [c for c in self.columns if c not in set(drop)]


def index_dict(path: Path, column: str) -> dict:
    """``pd.read_csv(path, index_col=0)[column].to_dict()``: the first
    column's values as keys (integers where every key is one) to the
    column's values (a missing one NaN)."""
    table = Table(path)
    keys = table.strings(table.columns[0])
    try:
        keys = [int(k) for k in keys]
    except ValueError:
        pass
    return {k: (np.nan if v in NA_VALUES else v) for k, v in zip(keys, table.strings(column))}
