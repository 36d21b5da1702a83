"""The port's host data path against the JAX package's, on the CPU.

Sampling indices, generated reports, the synthetic metadata, dataset
items, whole epochs of ``BatchLoader`` batches, ``resolve_text_context``
and the class weights must be **equal** (integers and strings exactly,
floats bit for bit: both sides make the same numpy draws in the same
order), though the JAX package keeps its metadata in pandas and the port
in a ``ColumnTable`` of numpy columns. No tolerance is involved.
"""

import numpy as np
import pytest
import torch

from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data import dataset as jds
from mamba_clip_tpu.data import loader as jloader
from mamba_clip_tpu.data import metadata as jmeta
from mamba_clip_tpu.data import report_gen as jrep
from mamba_clip_tpu.data import sampling as jsamp
from mamba_clip_tpu.data import tokenizer as jtok
from mamba_clip_tpu_torch.data import dataset as tds
from mamba_clip_tpu_torch.data import loader as tloader
from mamba_clip_tpu_torch.data import metadata as tmeta
from mamba_clip_tpu_torch.data import report_gen as trep
from mamba_clip_tpu_torch.data import sampling as tsamp
from mamba_clip_tpu_torch.data import tokenizer as ttok

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)


def _targets(n=203, seed=0):
    t = (np.random.default_rng(seed).random(n) < 0.15).astype(np.int64)
    t[:2] = (0, 1)
    return t


@pytest.mark.parametrize("sampling", [None, "instance", "class", "sqrt", "cbrt", "prog"])
@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
def test_epoch_indices_equal_jax(sampling, rank, world):
    t = _targets()
    for epoch in (0, 2):
        a = jsamp.epoch_indices(t, sampling, 7, epoch, n_eps=4, rank=rank, world_size=world)
        b = tsamp.epoch_indices(t, sampling, 7, epoch, n_eps=4, rank=rank, world_size=world)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("base", ["instance", "sqrt", "prog"])
def test_combo_epoch_indices_equal_jax(base):
    t = _targets()
    a = jsamp.combo_epoch_indices(t, 3, 1, base_sampling=base, n_eps=5, rank=1, world_size=2)
    b = tsamp.combo_epoch_indices(t, 3, 1, base_sampling=base, n_eps=5, rank=1, world_size=2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="not a valid sampling mode"):
        tsamp.sampling_probabilities(np.array([3, 1]), "bogus")


def test_synthetic_metadata_equals_jax_column_by_column():
    for n, seed in ((37, 0), (500, 3)):
        df, tab = jds.synthetic_metadata(n, seed), tds.synthetic_metadata(n, seed)
        assert list(df.columns) == tab.columns and len(df) == len(tab) == n
        for c in tab.columns:
            want, got = df[c].to_numpy(), tab[c]
            if want.dtype.kind == "f":
                assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True), c
            else:
                assert [str(v) for v in got] == [str(v) for v in want], c
        # a missing sex or site is the string 'nan' on both sides, not a NaN
        assert "nan" in set(tab["sex"]) and "nan" in set(df["sex"])
    assert int(tds.synthetic_metadata(500, 3)["target"].sum()) == 10


@pytest.mark.parametrize("is_eval,include_target", [(False, True), (False, False), (True, True)])
def test_generated_reports_equal_jax_string_for_string(is_eval, include_target):
    """The JAX row is a pandas Series (``DataFrame.iloc``), the port's a dict
    of numpy scalars: the same generator must give the same string."""
    n = 60
    df = jds.synthetic_metadata(n, 5).set_index("isic_id")
    tab = tds.synthetic_metadata(n, 5)
    for i in range(n):
        kw = dict(is_eval=is_eval, shuffle=not is_eval, dropout=0.0 if is_eval else 0.1,
                  include_target=include_target)
        want = jrep.generate_report(df.iloc[i], rng=np.random.default_rng((1, 2, i)), **kw)
        row = {k: v for k, v in tab.row(i).items() if k != "isic_id"}
        got = trep.generate_report(row, rng=np.random.default_rng((1, 2, i)), **kw)
        assert got == want and len(got) > 40, i
    # hand-made rows: Python None, float NaN and missing keys count as missing
    for row in ({"age_approx": 40.0, "sex": None, "anatom_site_general": "torso",
                 "tbp_lv_H": float("nan"), "clin_size_long_diam_mm": 3.14159},
                {"sex": "female", "tbp_lv_symm_2axis": 0.5, "tbp_lv_symm_2axis_angle": 90.0,
                 "iddx_1": "Benign", "iddx_2": np.nan}):
        assert (trep.generate_report(row, is_eval=True, include_target=True)
                == jrep.generate_report(row, is_eval=True, include_target=True))
        count = ttok.HashTokenizer().count_tokens
        assert (trep.report_token_upper_bound(row, count, True)
                == jrep.report_token_upper_bound(row, count, True))


@pytest.mark.parametrize("is_train", [True, False])
def test_dataset_items_equal_jax(is_train):
    kw = dict(n=48, staging_size=24, is_train=is_train, include_target=is_train, seed=2)
    a = jds.SyntheticIsicDataset(tokenizer=jtok.HashTokenizer(context_length=96), **kw)
    b = tds.SyntheticIsicDataset(tokenizer=ttok.HashTokenizer(context_length=96), **kw)
    assert len(a) == len(b) == 48 and np.array_equal(a.targets, b.targets)
    assert b.targets.dtype == np.int32 and b.ids[3] == "ISIC_0000003"
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in (0, 7, 47):
            x, y = a[i], b[i]
            assert sorted(x) == sorted(y) == ["image", "target", "tokens"]
            for k in x:
                assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k
                assert np.array_equal(x[k], y[k]), (epoch, i, k)
    no_text = tds.SyntheticIsicDataset(n=4, staging_size=8)
    assert sorted(no_text[1]) == ["image", "target"]


LOADER_CASES = {
    "shuffled": dict(batch_size=8, shuffle=True, drop_last=True),
    "class_sampling": dict(batch_size=8, sampling="class", n_epochs=3),
    "balanced_mixup": dict(batch_size=8, balanced_mixup=True, n_epochs=3),
    "eval_tail": dict(batch_size=16, shuffle=False, drop_last=False),
    "two_hosts_eval": dict(batch_size=8, shuffle=False, drop_last=False, rank=1, world_size=2),
    "start_batch": dict(batch_size=8, shuffle=True, drop_last=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_batch_loader_epoch_equals_jax_array_for_array(case):
    kw = dict(LOADER_CASES[case], seed=4, workers=3)
    dkw = dict(n=53, staging_size=16, is_train=kw.get("shuffle", True), include_target=True,
               seed=4)
    a = jloader.BatchLoader(
        jds.SyntheticIsicDataset(tokenizer=jtok.HashTokenizer(context_length=64), **dkw), **kw)
    b = tloader.BatchLoader(
        tds.SyntheticIsicDataset(tokenizer=ttok.HashTokenizer(context_length=64), **dkw), **kw)
    assert (a.num_batches, a.num_samples) == (b.num_batches, b.num_samples) == (len(a), b.num_samples)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        if case == "start_batch":
            full = list(b)
            a.start_batch = b.start_batch = 3
        want, got = list(a), list(b)
        assert len(want) == len(got) == a.num_batches - a.start_batch
        for x, y in zip(want, got):
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (case, epoch, k)
        if case == "start_batch":  # the tail of the uninterrupted epoch, batch for batch
            for x, y in zip(full[3:], got):
                assert all(np.array_equal(x[k], y[k]) for k in x)
            a.start_batch = b.start_batch = 0
    if case == "balanced_mixup":
        assert {"mix_image", "mix_tokens", "mix_target"} <= set(got[0])
        # the mix stream is class-balanced: far more positives than 2% of the split
        mix_pos = np.mean([g["mix_target"].mean() for g in got])
        assert mix_pos > 0.25
    if case == "eval_tail":
        assert [len(g["image"]) for g in got] == [16, 16, 16, 5]


def test_loader_refuses_an_empty_epoch_and_stops_its_producer():
    ds = tds.SyntheticIsicDataset(n=5, staging_size=8)
    with pytest.raises(ValueError, match="dataset yields 0 batches"):
        list(tloader.BatchLoader(ds, batch_size=8))
    big = tloader.BatchLoader(tds.SyntheticIsicDataset(n=64, staging_size=8), batch_size=4,
                              prefetch_batches=1)
    it = iter(big)
    next(it)
    it.close()  # the consumer walks away: the stop-aware producer must not block forever

    class Broken:
        targets = np.zeros(8, np.int32)

        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(tloader.BatchLoader(Broken(), batch_size=4))


def test_resolve_text_context_equals_jax():
    df, tab = jds.synthetic_metadata(300, 0), tds.synthetic_metadata(300, 0)
    for include_target in (True, False):
        jt, tt = jtok.HashTokenizer(), ttok.HashTokenizer()
        want = jtok.resolve_text_context("auto", jt, [(df, include_target)])
        got = ttok.resolve_text_context("auto", tt, [(tab, include_target)])
        assert got == want and got % 16 == 0 and got < 256
        assert (tt.context_length, tt.on_overflow) == (jt.context_length, jt.on_overflow)
        assert (ttok.measure_required_context(tt, [(tab, include_target)], sample_cap=50)
                == jtok.measure_required_context(jt, [(df, include_target)], sample_cap=50))
        # no draw of any row overflows the measured context
        ds = tds.SyntheticIsicDataset(300, tokenizer=tt, is_train=True, staging_size=4,
                                      include_target=include_target, seed=0)
        assert max(int((ds[i]["tokens"] != 0).sum()) for i in range(0, 300, 7)) <= got
    tt = ttok.HashTokenizer()
    assert ttok.resolve_text_context(None, tt) == 256
    assert ttok.resolve_text_context("64", tt) == 64 and tt.on_overflow == "error"
    assert ttok.resolve_text_context("auto", tt, None) == 64
    with pytest.raises(ValueError, match="overflows the trimmed"):
        tt(" ".join(["word"] * 80))
    with pytest.raises(ValueError, match="too small"):
        ttok.resolve_text_context(4, tt)
    with pytest.raises(ValueError, match="exceeds the text tower"):
        ttok.resolve_text_context(512, tt)
    assert ttok.resolve_text_context("auto", tt, [(tab, True)], model_context=64) == 64
    assert tt.on_overflow == "truncate"


def test_class_weights_and_get_data_equal_jax():
    t = _targets()
    assert np.array_equal(tmeta.class_counts(t), jmeta.class_counts(t))
    assert np.array_equal(tmeta.balanced_class_weights(t), jmeta.balanced_class_weights(t))
    args = Args(synthetic_data=True, stage=2, seed=1, batch_size=8, epochs=2, workers=2,
                train_num_samples=40, val_num_samples=19, balanced_mixup=0.4, sampling="sqrt")
    want = jloader.get_data(args, tokenizer=jtok.HashTokenizer(64), staging_size=16)
    got = tloader.get_data(args, tokenizer=ttok.HashTokenizer(64), staging_size=16)
    assert sorted(got) == sorted(want) == ["train", "val"]
    for split in got:
        w, g = want[split], got[split]
        assert (g.num_batches, g.num_samples) == (w.num_batches, w.num_samples)
        assert np.array_equal(g.targets, w.targets)
        assert (g.class_weights is None) == (w.class_weights is None)
        for attr in ("sampling", "shuffle", "drop_last", "balanced_mixup", "n_epochs"):
            assert getattr(g.loader, attr) == getattr(w.loader, attr), (split, attr)
        assert g.loader.dataset.include_target == w.loader.dataset.include_target is False
    assert np.array_equal(got["train"].class_weights, want["train"].class_weights)
    a, b = next(iter(want["val"].loader)), next(iter(got["val"].loader))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # the real branch with no metadata builds no split, as JAX's does
    # (tests/test_torch_port_dataset_io.py holds it over files)
    real = Args(synthetic_data=False, batch_size=8, epochs=1)
    assert tloader.get_data(real) == jloader.get_data(real) == {}


def test_device_prefetch_keeps_order_and_values_on_the_cpu():
    batches = [{"image": np.full((2, 3), i, np.uint8), "target": np.array([i, -i], np.int32)}
               for i in range(5)]
    seen = []

    def source():
        for b in batches:
            seen.append(int(b["target"][0]))
            yield b

    out = tloader.device_prefetch(source(), "cpu", depth=2)
    first = next(out)
    assert seen == [0, 1, 2]  # two batches in flight beyond the one handed out
    rest = list(out)
    for want, got in zip(batches, [first] + rest):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in got.values())
        assert all(np.array_equal(want[k], got[k].numpy()) for k in want)
    assert len(rest) == 4


def test_port_runs_without_pandas_sklearn_pil_h5py_orbax():
    """The card's machine promises numpy, scipy, einops, pytest and
    hypothesis only: with pandas, scikit-learn, PIL, h5py, orbax and JAX made
    unimportable every module of the port imports, a synthetic batch loads
    and ``partial_auc`` computes."""
    import os
    import pathlib
    import subprocess
    import sys

    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BANNED = ('jax', 'jaxlib', 'flax', 'orbax', 'mamba_clip_tpu', 'pandas', 'sklearn',\n"
        "          'PIL', 'h5py')\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in BANNED]:\n"
        "    del sys.modules[k]\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BANNED:\n"
        "            raise ImportError('port imports ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mamba_clip_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from types import SimpleNamespace as NS\n"
        "from mamba_clip_tpu_torch.data.loader import get_data\n"
        "from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer\n"
        "from mamba_clip_tpu_torch.eval import partial_auc\n"
        "a = NS(synthetic_data=True, stage=1, seed=0, batch_size=4, epochs=1, workers=2,\n"
        "       train_num_samples=8, val_num_samples=4, sampling=None, balanced_mixup=0.0)\n"
        "b = next(iter(get_data(a, tokenizer=HashTokenizer(32), staging_size=8)['train'].loader))\n"
        "assert b['image'].shape == (4, 8, 8, 3) and b['tokens'].shape == (4, 32)\n"
        "assert abs(partial_auc([0, 0, 1, 1], [0.1, 0.4, 0.35, 0.8]) - 0.1) < 1e-12\n"
        "assert not [k for k in sys.modules if k.split('.')[0] in BANNED]\n"
        "print('ok')\n"
    )
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
