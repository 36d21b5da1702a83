"""Metadata loading, stratified splitting, undersampling, on numpy alone.

Counterpart of ``mamba_clip_tpu/data/metadata.py``, which reads the ISIC
CSVs with pandas. Here :func:`read_csv` reads them with the ``csv`` module
into a ``ColumnTable`` whose columns have the types ``pd.read_csv`` infers
for them, and :func:`write_csv` writes the text ``DataFrame.to_csv(index=
False)`` writes. The splits keep pandas' row order: ``train_test_split``,
``get_metadata`` and ``undersample_data`` give the JAX package's rows, in
its order, for the same CSV and arguments.

Floats are parsed with ``float``, which rounds correctly; pandas' default
parser does not always (its results can be off by some ulps, about 1e-13
relative), so the port's floats are those of ``pd.read_csv(...,
float_precision="round_trip")``.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import get_logger
from .dataset import ColumnTable

logger = get_logger(__name__)

# pandas' default missing-value strings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
# one cell a line; pandas' C parser ignores the spaces around a number
_INTS = re.compile(r"(?:[ \t]*[+-]?\d+[ \t]*(?:\n|\Z))+")
_FLOATS = re.compile(
    r"(?:[ \t]*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)[ \t]*(?:\n|\Z))+",
    re.IGNORECASE)


def _column(cells) -> np.ndarray:
    """One column's cells as ``pd.read_csv`` types them: all integers ->
    int64, integers with a missing cell -> float64, all numbers -> float64,
    all booleans -> bool (object with NaN where one is missing), anything
    else -> object ``str`` with NaN where a cell is missing."""
    missing = [c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return np.full(len(cells), np.nan)
    text = "\n".join(present)
    if _INTS.fullmatch(text) and not any(missing):
        return np.array([int(c) for c in cells], np.int64)
    if _FLOATS.fullmatch(text):
        return np.array([np.nan if m else float(c) for c, m in zip(cells, missing)], np.float64)
    if all(c in _TRUE or c in _FALSE for c in present):
        if not any(missing):
            return np.array([c in _TRUE for c in cells], bool)
        out = [np.nan if m else c in _TRUE for c, m in zip(cells, missing)]
    else:
        out = [np.nan if m else c for c, m in zip(cells, missing)]
    arr = np.empty(len(out), object)
    arr[:] = out
    return arr


def read_csv(path: str) -> ColumnTable:
    """A CSV with a header line -> ``ColumnTable`` (row labels 0..n-1),
    each column typed as ``pd.read_csv`` types it; blank lines are
    skipped. A missing file raises ``FileNotFoundError`` naming it."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    header, body = rows[0], rows[1:]
    width = len(header)
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: expected {width} fields in line {i + 2}, saw {len(r)}")
        if len(r) < width:
            r.extend([""] * (width - len(r)))
    cols = list(zip(*body)) if body else [()] * width
    return ColumnTable({name: _column(list(c)) for name, c in zip(header, cols)})


def _cell(v) -> str:
    """A value as ``to_csv`` writes it: a missing one empty, a number by
    its numpy ``str`` (the shortest string that reads back to it)."""
    if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
        return ""
    return str(v)


def write_csv(table: ColumnTable, path: str) -> None:
    """Write ``table`` with a header line and no row labels: the bytes that
    ``pd.DataFrame(...).to_csv(path, index=False)`` writes for the same
    columns."""
    cols = [table[c] for c in table.columns]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator=os.linesep)
        w.writerow(table.columns)
        for i in range(len(table)):
            w.writerow([_cell(c[i]) for c in cols])


def _isna(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype == object:
        return np.array([v is None or (isinstance(v, float) and v != v) for v in values], bool)
    return np.zeros(len(values), bool)


def _sort_positions(values, ascending: bool = True) -> np.ndarray:
    """The row order of ``DataFrame.sort_values(col, ascending=...)``
    (pandas' ``nargsort``): the non-missing values argsorted with numpy's
    quicksort, which is not stable, reversed before and after for
    descending order, then the missing rows in their order."""
    values = np.asarray(values)
    mask = _isna(values)
    idx = np.arange(len(values))
    non_nans, non_nan_idx = values[~mask], idx[~mask]
    if not ascending:
        non_nans, non_nan_idx = non_nans[::-1], non_nan_idx[::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, np.nonzero(mask)[0]])


def _first_appearance(values: np.ndarray) -> np.ndarray:
    """The distinct values in order of first appearance (``Series.unique``)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _value_counts(values: np.ndarray) -> dict:
    """``dict(Series.value_counts())``: Python keys, numpy counts, most
    frequent first."""
    classes = _first_appearance(values)
    counts = np.array([np.count_nonzero(values == c) for c in classes], np.int64)
    keys = classes.tolist()
    return {keys[i]: counts[i] for i in _sort_positions(counts, ascending=False)}


def train_test_split(
    data: ColumnTable,
    test_size=0.2,
    random_state: Optional[int] = None,
    stratify=None,
) -> Tuple[ColumnTable, ColumnTable]:
    """Per-class shuffled split: the classes in ``np.unique`` order, each
    shuffled by one generator seeded with ``random_state``."""
    rng = np.random.default_rng(random_state)
    if stratify is not None:
        y = np.asarray(stratify)
        train_idx, test_idx = [], []
        for cls in np.unique(y):
            cls_pos = np.where(y == cls)[0]
            rng.shuffle(cls_pos)
            n_test = (
                int(len(cls_pos) * test_size)
                if isinstance(test_size, float)
                else int(test_size)
            )
            test_idx.extend(cls_pos[:n_test])
            train_idx.extend(cls_pos[n_test:])
    else:
        idx = rng.permutation(len(data))
        n_test = (
            int(len(data) * test_size)
            if isinstance(test_size, float)
            else int(test_size)
        )
        test_idx, train_idx = idx[:n_test], idx[n_test:]
    return data.take(train_idx), data.take(test_idx)


def get_metadata(args):
    """(train, val, test) tables: ``test-metadata.csv`` under ``--is-test``,
    else ``train-metadata.csv`` split 80/20, stratified by ``target``, with
    the run's seed."""
    train_metadata = val_metadata = test_metadata = None
    if args.is_test:
        test_metadata = read_csv(os.path.join(args.data_path, "test-metadata.csv"))
    else:
        train_metadata = read_csv(os.path.join(args.data_path, "train-metadata.csv"))
        targets = train_metadata["target"]
        logger.info(f"Stratifying by target: {_value_counts(targets)}")
        train_metadata, val_metadata = train_test_split(
            train_metadata, test_size=0.2, stratify=targets, random_state=args.seed
        )
    return train_metadata, val_metadata, test_metadata


def undersample_data(args, train_metadata: ColumnTable, val_metadata: Optional[ColumnTable]):
    """Cap each class of the train split at ``--undersample`` rows: a random
    draw (default), or by ``--undersample-by`` sorted ascending (``asc``),
    descending (``desc``), its head and tail in the ratio ``"n/m"``, or
    every k-th row (``uniform``). The classes go in order of first
    appearance. ``--add-remaining-samples`` appends the dropped rows to the
    validation split in the order of their original row labels."""
    n_cap = args.undersample
    col = args.undersample_by
    sort_by = args.undersample_sort_by
    rng = np.random.default_rng(args.seed)

    def select(tbl: ColumnTable) -> ColumnTable:
        if n_cap is None or n_cap >= len(tbl):
            return tbl
        if sort_by is not None and col is not None:
            if sort_by == "asc":
                return tbl.take(_sort_positions(tbl[col])).head(n_cap)
            if sort_by == "desc":
                return tbl.take(_sort_positions(tbl[col], ascending=False)).head(n_cap)
            if "/" in str(sort_by):
                lo_p, hi_p = map(int, str(sort_by).split("/"))
                n_lo = int(n_cap * lo_p / (lo_p + hi_p))
                n_hi = n_cap - n_lo
                s = tbl.take(_sort_positions(tbl[col]))
                return ColumnTable.concat([s.head(n_lo), s.tail(n_hi)])
            if sort_by == "uniform":
                s = tbl.take(_sort_positions(tbl[col]))
                step = max(len(s) // n_cap, 1)
                return s[::step]
            raise ValueError(f"Unknown undersample-sort-by: {sort_by}")
        # DataFrame.sample(n, random_state=s)
        draw = np.random.RandomState(int(rng.integers(2**31))).choice(
            len(tbl), n_cap, replace=False)
        return tbl.take(draw)

    targets = train_metadata["target"]
    kept = [select(train_metadata.take(np.nonzero(targets == cls)[0]))
            for cls in _first_appearance(targets)]
    new_train = ColumnTable.concat(kept)
    if args.add_remaining_samples and val_metadata is not None:
        dropped = np.nonzero(~np.isin(train_metadata.index, new_train.index))[0]
        dropped = dropped[np.argsort(train_metadata.index[dropped], kind="stable")]
        val_metadata = ColumnTable.concat([val_metadata, train_metadata.take(dropped)])
    return new_train, val_metadata


def class_counts(targets: np.ndarray) -> np.ndarray:
    return np.unique(np.asarray(targets), return_counts=True)[1]


def balanced_class_weights(targets: np.ndarray) -> np.ndarray:
    """sklearn's 'balanced' weights, ``n / (classes * count)``, for
    ``--class-weighted-loss``."""
    t = np.asarray(targets)
    counts = class_counts(t)
    return len(t) / (len(counts) * counts.astype(np.float64))
