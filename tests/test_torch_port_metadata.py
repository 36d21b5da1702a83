"""The port's metadata layer (``data/metadata.py`` over ``ColumnTable``)
against pandas and the JAX package's ``data/metadata.py``, on the CPU.

- ``read_csv`` against ``pd.read_csv``, column by column: names and order,
  the dtype's kind, the missing cells, strings equal, floats bit for bit
  against ``float_precision="round_trip"`` and within rel 1e-12 of pandas'
  default parser (which is not correctly rounded), on a CSV that
  ``synthetic_metadata`` wrote, a hand-written one of edge cells and a
  label-free test CSV;
- ``train_test_split``, ``get_metadata`` and ``undersample_data`` (every
  ``--undersample-sort-by`` strategy, with and without
  ``--add-remaining-samples``, two seeds): the rows (ids, labels, targets)
  in JAX's order; the error of an unknown strategy;
- ``write_csv``: the bytes of ``DataFrame.to_csv(index=False)``.
"""

import logging
import types

import numpy as np
import pandas as pd
import pytest
import torch

from mamba_clip_tpu.data import dataset as jds
from mamba_clip_tpu.data import metadata as jmeta
from mamba_clip_tpu_torch.data import dataset as tds
from mamba_clip_tpu_torch.data import metadata as tmeta

torch.set_num_threads(1)

EDGE_CSV = (
    'isic_id,target,age_approx,sex,note,flag,flag_gap,count,empty,mixed,size\n'
    'ISIC_1,0,55.0,male,"a, quoted comma",True,True,3,,1,1.5\n'
    'ISIC_2,1,,NA,null,False,,4,,x,\n'
    'ISIC_3,0,40,female,"",TRUE,False,,,N/A,2.25e-3\n'
    '\n'
    'ISIC_4,0,70.0,None,plain text,false,true,-7,,2.5,-0.125\n'
)


def _write_files(d):
    """{name: path}: the synthetic CSV (pandas' own ``to_csv``), the edge
    cells and a label-free test CSV."""
    synth = jds.synthetic_metadata(600, seed=3)
    paths = {"synthetic": d / "train-metadata.csv", "edge": d / "edge.csv",
             "label_free": d / "test-metadata.csv"}
    synth.to_csv(paths["synthetic"], index=False)
    paths["edge"].write_text(EDGE_CSV)
    jds.synthetic_metadata(40, seed=4).drop(columns=["target"]).to_csv(
        paths["label_free"], index=False)
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write_files(tmp_path_factory.mktemp("csv"))


def _is_missing(v):
    return v is None or (isinstance(v, float) and v != v)


@pytest.mark.parametrize("name", ["synthetic", "edge", "label_free"])
def test_read_csv_equals_pandas(files, name):
    got = tmeta.read_csv(files[name])
    exact = pd.read_csv(files[name], float_precision="round_trip")
    default = pd.read_csv(files[name])
    assert got.columns == list(exact.columns)
    assert len(got) == len(exact) and np.array_equal(got.index, np.arange(len(exact)))
    for c in exact.columns:
        want, mine = exact[c].to_numpy(), got[c]
        assert mine.dtype.kind == want.dtype.kind, (c, mine.dtype, want.dtype)
        if want.dtype.kind == "f":
            assert np.array_equal(np.isnan(mine), np.isnan(want)), c
            assert np.array_equal(mine, want, equal_nan=True), c
            dflt = default[c].to_numpy()
            ok = ~np.isnan(dflt)
            rel = np.abs(mine[ok] - dflt[ok]) / np.maximum(np.abs(dflt[ok]), 1e-300)
            n_off = int(np.count_nonzero(mine[ok] != dflt[ok]))
            assert rel.max(initial=0.0) <= 1e-12, (
                f"{c}: {n_off} of {ok.sum()} cells differ from pandas' default parser, "
                f"max rel {rel.max()}")
        elif want.dtype == object:
            assert [_is_missing(v) for v in mine] == [_is_missing(v) for v in want], c
            assert all(_is_missing(a) or (type(a) is type(b) and a == b)
                       for a, b in zip(mine, want)), c
        else:
            assert mine.dtype == want.dtype and np.array_equal(mine, want), c
    if name == "edge":  # what the hand-written cells are there to show
        kinds = {c: got[c].dtype.kind for c in got.columns}
        assert kinds == {"isic_id": "O", "target": "i", "age_approx": "f", "sex": "O",
                         "note": "O", "flag": "b", "flag_gap": "O", "count": "f",
                         "empty": "f", "mixed": "O", "size": "f"}
        assert got["note"][0] == "a, quoted comma" and _is_missing(got["note"][2])
        assert len(got) == 4  # the blank line is skipped
    if name == "label_free":
        assert "target" not in got.columns
        # a written 'nan' (synthetic_metadata's missing sex) reads back missing
        assert any(_is_missing(v) for v in got["sex"])


def test_column_table_rows_as_iloc():
    cols = {"a": np.arange(10) * 2, "b": np.array(list("abcdefghij"), object)}
    df = pd.DataFrame(cols, index=np.arange(100, 110))
    t = tds.ColumnTable(cols, index=np.arange(100, 110))
    for mine, want in ((t.take([3, 1, 7]), df.iloc[[3, 1, 7]]), (t.head(4), df.head(4)),
                       (t.tail(3), df.tail(3)), (t.tail(0), df.tail(0)), (t[::3], df.iloc[::3]),
                       (tds.ColumnTable.concat([t.take([5]), t.head(2)]),
                        pd.concat([df.iloc[[5]], df.head(2)]))):
        assert list(mine.index) == list(want.index)
        assert all(list(mine[c]) == list(want[c]) for c in cols)
    assert t.row(2) == {"a": 4, "b": "c"}
    with pytest.raises(ValueError, match="concat of tables with columns"):
        tds.ColumnTable.concat([t, tds.ColumnTable({"a": np.arange(2)})])


def _args(d, seed, **kw):
    base = dict(is_test=False, data_path=str(d) + "/", seed=seed, undersample=None,
                undersample_by=None, undersample_sort_by=None, add_remaining_samples=False)
    return types.SimpleNamespace(**{**base, **kw})


def _same_rows(mine, want):
    """ids, labels and targets of a port table equal to a pandas frame's,
    in order."""
    assert list(mine["isic_id"]) == list(want["isic_id"])
    assert list(mine.index) == list(want.index)
    if "target" in want.columns:
        assert np.array_equal(mine["target"], want["target"].to_numpy())


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("seed", [0, 7])
def test_get_metadata_and_split_equal_jax(files, seed):
    d = files["synthetic"].rsplit("/", 1)[0]
    logged = {}
    for name, get in (("mamba_clip_tpu", jmeta.get_metadata),
                      ("mamba_clip_tpu_torch", tmeta.get_metadata)):
        grab = _Lines()
        logging.getLogger(name).addHandler(grab)
        try:
            logged[name] = (get(_args(d, seed)), grab.lines)
        finally:
            logging.getLogger(name).removeHandler(grab)
    (want, want_lines), (got, got_lines) = logged.values()
    for mine, ref in zip(got[:2], want[:2]):
        _same_rows(mine, ref)
    assert got[2] is None and want[2] is None
    assert got_lines == want_lines and want_lines[0].startswith("Stratifying by target: {0: ")
    # the split alone, without stratification
    frame, table = pd.read_csv(files["synthetic"]), tmeta.read_csv(files["synthetic"])
    for mine, ref in zip(tmeta.train_test_split(table, test_size=0.3, random_state=seed),
                         jmeta.train_test_split(frame, test_size=0.3, random_state=seed)):
        _same_rows(mine, ref)
    # --is-test reads the label-free CSV
    lf = files["label_free"].rsplit("/", 1)[0]
    _, _, mine = tmeta.get_metadata(_args(lf, seed, is_test=True))
    _, _, ref = jmeta.get_metadata(_args(lf, seed, is_test=True))
    _same_rows(mine, ref)


@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("sort_by", [None, "asc", "desc", "1/3", "uniform"])
def test_undersample_equals_jax(files, sort_by, add, seed):
    d = files["synthetic"].rsplit("/", 1)[0]
    # age_approx: five values and NaN over 480 train rows, so the sorts
    # decide among ties; pandas' sort is numpy's quicksort, not stable
    a = _args(d, seed, undersample=150, undersample_by="age_approx" if sort_by else None,
              undersample_sort_by=sort_by, add_remaining_samples=add)
    jt, jv, _ = jmeta.get_metadata(a)
    tt, tv, _ = tmeta.get_metadata(a)
    want = jmeta.undersample_data(a, jt, jv)
    got = tmeta.undersample_data(a, tt, tv)
    for mine, ref in zip(got, want):
        _same_rows(mine, ref)
    assert len(got[0]) < len(tt)
    assert len(got[1]) == len(tv) + (len(tt) - len(got[0]) if add else 0)


def test_unknown_strategy_raises_as_jax(files):
    d = files["synthetic"].rsplit("/", 1)[0]
    a = _args(d, 0, undersample=10, undersample_by="age_approx", undersample_sort_by="middle")
    jt, jv, _ = jmeta.get_metadata(a)
    tt, tv, _ = tmeta.get_metadata(a)
    with pytest.raises(ValueError) as want:
        jmeta.undersample_data(a, jt, jv)
    with pytest.raises(ValueError) as got:
        tmeta.undersample_data(a, tt, tv)
    assert str(got.value) == str(want.value) == "Unknown undersample-sort-by: middle"


@pytest.mark.parametrize("what", ["synthetic", "label_free", "submission"])
def test_write_csv_is_pandas_to_csv(tmp_path, what):
    if what == "submission":  # float32 probabilities, as evaluate writes them
        p = np.random.default_rng(5).random(300).astype(np.float32)
        p[:3] = (1e-8, 0.5, np.float32(0.016527636))
        ids = [f"ISIC_{i:07d}" for i in range(300)]
        mine = tds.ColumnTable({"isic_id": ids, "target": p})
        want = pd.DataFrame({"isic_id": ids, "target": p})
    else:
        n, seed = (700, 2) if what == "synthetic" else (50, 6)
        mine, want = tds.synthetic_metadata(n, seed), jds.synthetic_metadata(n, seed)
        if what == "label_free":
            mine = tds.ColumnTable({c: mine[c] for c in mine.columns if c != "target"})
            want = want.drop(columns=["target"])
    tmeta.write_csv(mine, str(tmp_path / "port.csv"))
    want.to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
