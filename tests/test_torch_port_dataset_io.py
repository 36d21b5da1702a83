"""The port's ISIC readers (``IsicChallengeDataset``, ``StagingCache``,
``get_data``'s real branch) against the JAX package's, on files written
here, on the CPU.

- Items equal item for item (image bytes, tokens, target) over a JPEG
  directory and an HDF5 file, train and eval, two epochs; once with the
  native decoder and once with ``fastimage`` unavailable in both packages,
  so that PIL decodes (what the card's machine does).
- ``StagingCache``: JAX's file names; a second read is served from the
  memmap with the same bytes; files of another shape are made anew.
- ``small_test``, ``close``, the label-free split (``targets`` None, no
  ``target`` key), and the error that names h5py when it does not import.
- ``get_data`` over files: every batch of an epoch of train (two epochs)
  and val, and of the ``--is-test`` split, array for array JAX's.
"""

import io
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

from mamba_clip_tpu.data import dataset as jds
from mamba_clip_tpu.data import fastimage as jfast
from mamba_clip_tpu.data import loader as jloader
from mamba_clip_tpu.data import metadata as jmeta
from mamba_clip_tpu.data.tokenizer import HashTokenizer as JHash
from mamba_clip_tpu_torch.data import dataset as tds
from mamba_clip_tpu_torch.data import fastimage as tfast
from mamba_clip_tpu_torch.data import loader as tloader
from mamba_clip_tpu_torch.data import metadata as tmeta
from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer as THash

torch.set_num_threads(1)

STAGING = 32


def _jpeg(rng, h, w):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def isic(tmp_path_factory):
    """An ISIC-2024 layout: ``train-metadata.csv`` (40 rows) with its JPEGs
    in ``train-image/image``, the same images in ``train.hdf5``, and a
    label-free ``test-metadata.csv`` (10 rows) with ``test-image.hdf5``."""
    d = tmp_path_factory.mktemp("isic")
    train = jds.synthetic_metadata(40, seed=3)
    train.to_csv(d / "train-metadata.csv", index=False)
    test = jds.synthetic_metadata(10, seed=4).drop(columns=["target"])
    test["isic_id"] = [f"ISIC_9{i:06d}" for i in range(10)]
    test.to_csv(d / "test-metadata.csv", index=False)
    rng = np.random.default_rng(0)
    (d / "train-image" / "image").mkdir(parents=True)
    import h5py

    with h5py.File(d / "train.hdf5", "w") as f:
        for k, isic_id in enumerate(train["isic_id"]):
            blob = _jpeg(rng, 40 + 8 * (k % 5), 56 + 4 * (k % 3))
            (d / "train-image" / "image" / f"{isic_id}.jpg").write_bytes(blob)
            f[isic_id] = np.void(blob)
    with h5py.File(d / "test-image.hdf5", "w") as f:
        for isic_id in test["isic_id"]:
            f[isic_id] = np.void(_jpeg(rng, 48, 48))
    return d


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    if request.param == "pil":
        for mod in (jfast, tfast):
            monkeypatch.setattr(mod, "decode_resize", lambda blob, side: None)
    else:
        assert tfast.available() and jfast.available()
    return request.param


def _pair(isic, layout, csv="train-metadata.csv", **kw):
    path = str(isic / "train-image" / "image") if layout == "jpg" else str(isic / "train.hdf5")
    if csv == "test-metadata.csv" and layout == "hdf5":
        path = str(isic / "test-image.hdf5")
    kw = dict(staging_size=STAGING, seed=3, **kw)
    return (jds.IsicChallengeDataset(path, str(isic / csv), tokenizer=JHash(16, 200), **kw),
            tds.IsicChallengeDataset(path, str(isic / csv), tokenizer=THash(16, 200), **kw))


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
        assert np.array_equal(b[k], a[k]), k


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("layout", ["jpg", "hdf5"])
def test_items_equal_jax(isic, layout, is_train, decoder):
    jd, td = _pair(isic, layout, is_train=is_train, include_target=is_train)
    assert td.ids == jd.ids and len(td) == len(jd) == 40
    assert np.array_equal(td.targets, jd.targets) and td.targets.dtype == np.int32
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(jd)):
            _same_item(jd[i], td[i])
    jd.close()
    td.close()


def test_staging_cache_names_hits_and_reshape(isic, tmp_path, monkeypatch):
    ids = ["ISIC_0000001", "ISIC_0000002", 7]
    assert tds._content_key("a/b.hdf5", ids) == jds._content_key("a/b.hdf5", ids)
    assert tds._content_key("a/b.hdf5", ids) != tds._content_key("a/c.hdf5", ids)
    jd, _ = _pair(isic, "jpg", is_train=True, cache_dir=str(tmp_path / "jax"))
    _, td = _pair(isic, "jpg", is_train=True, cache_dir=str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 2
    first = td[2]["image"]
    assert td.cache.done[2] == 1 and td.cache.done.sum() == 1

    def no_decode(blob, side):
        raise AssertionError("decoded again")

    monkeypatch.setattr(tfast, "decode_resize", no_decode)
    again = td[2]["image"]
    assert np.array_equal(again, first) and np.array_equal(again, jd[2]["image"])
    # a cache of another shape under the same name is made anew
    name = next(n for n in os.listdir(tmp_path / "port") if not n.endswith("_done.npy"))
    name = name[: -len(f"_{STAGING}.npy")]
    same = tds.StagingCache(str(tmp_path / "port"), name, 40, STAGING)
    assert same.done[2] == 1 and np.array_equal(same.get(2), first)
    other = tds.StagingCache(str(tmp_path / "port"), name, 41, STAGING)
    assert other.data.shape == (41, STAGING, STAGING, 3) and other.done.sum() == 0
    assert other.get(2) is None


def test_small_test_close_and_the_label_free_split(isic):
    big = jds.synthetic_metadata(530, seed=1)
    jd = jds.IsicChallengeDataset("nowhere", big, small_test=True)
    td = tds.IsicChallengeDataset("nowhere", tds.synthetic_metadata(530, seed=1),
                                  small_test=True)
    assert len(td) == len(jd) == 512 and td.ids == jd.ids
    # without an isic_id column the row labels are the ids
    no_id = tds.ColumnTable({"target": np.zeros(5, np.int64)}, index=np.arange(3, 8))
    assert tds.IsicChallengeDataset("nowhere", no_id).ids == [3, 4, 5, 6, 7]
    # the label-free test split
    jd, td = _pair(isic, "hdf5", csv="test-metadata.csv")
    assert td.targets is None and jd.targets is None and td.ids == jd.ids
    for i in (0, 9):
        _same_item(jd[i], td[i])
        assert "target" not in td[i]
    # one h5py handle a thread; close releases them all, and reads reopen
    threads = [threading.Thread(target=td.__getitem__, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(td._h5_all) == 4  # three threads and the test's own
    handles = list(td._h5_all)
    td.close()
    assert td._h5_all == [] and not any(h.id.valid for h in handles)
    _same_item(jd[3], td[3])
    td.close()
    jd.close()


def test_hdf5_without_h5py_names_it(isic, monkeypatch):
    _, td = _pair(isic, "hdf5")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py.*JPEG-directory layout.*needs only PIL"):
        td[0]


def _args(isic, **kw):
    base = dict(synthetic_data=False, is_test=False, stage=1, data_path=str(isic) + "/",
                seed=5, batch_size=4, epochs=2, workers=2, sampling=None, balanced_mixup=0.0,
                train_num_samples=None, val_num_samples=None, small_test=False,
                cache_staging=None, undersample=None, undersample_by=None,
                undersample_sort_by=None, add_remaining_samples=False)
    return types.SimpleNamespace(**{**base, **kw})


def _same_batches(jinfo, tinfo, epochs):
    assert tinfo.num_batches == jinfo.num_batches and tinfo.num_samples == jinfo.num_samples
    for name in ("targets", "class_weights"):
        a, b = getattr(jinfo, name), getattr(tinfo, name)
        assert (a is None and b is None) or np.array_equal(a, b), name
    n = 0
    for epoch in epochs:
        jinfo.set_epoch(epoch)
        tinfo.set_epoch(epoch)
        for a, b in zip(jinfo.loader, tinfo.loader, strict=True):
            _same_item(a, b)
            n += 1
    assert n == jinfo.num_batches * len(epochs)


@pytest.mark.parametrize("case", ["train_val", "is_test"])
def test_get_data_batches_equal_jax(isic, tmp_path, case):
    kw = (dict(undersample=20, add_remaining_samples=True, val_num_samples=9,
               cache_staging=str(tmp_path / "cache"))
          if case == "train_val" else dict(is_test=True, stage=2))
    a = _args(isic, **kw)
    jt, jv, jtest = jmeta.get_metadata(a)
    tt, tv, ttest = tmeta.get_metadata(a)
    if case == "train_val":
        jt, jv = jmeta.undersample_data(a, jt, jv)
        tt, tv = tmeta.undersample_data(a, tt, tv)
    want = jloader.get_data(a, jt, jv, jtest, tokenizer=JHash(16, 200), staging_size=STAGING)
    got = tloader.get_data(a, tt, tv, ttest, tokenizer=THash(16, 200), staging_size=STAGING)
    assert sorted(got) == sorted(want) == (["train", "val"] if case == "train_val" else ["test"])
    for split in got:
        _same_batches(want[split], got[split], (0, 1) if split == "train" else (0,))
    if case == "train_val":
        assert len(got["val"].loader.dataset) == 9  # --val-num-samples caps by position
        assert got["train"].loader.dataset.cache is not None
    else:
        assert got["test"].targets is None and got["test"].loader.dataset.is_hdf5
        assert got["test"].num_samples == 10 and got["test"].num_batches == 3


@pytest.mark.parametrize("native", [True, False])
def test_benchmark_data_prints_jax_lines(capsys, monkeypatch, native):
    """The port's ``benchmark_data`` prints the lines of
    ``tools/benchmark_data.py``, the numbers aside; "UNAVAILABLE" where
    ``fastimage`` does not build."""
    import re
    import runpy

    from mamba_clip_tpu_torch import benchmark_data

    if not native:
        for mod in (jfast, tfast):
            monkeypatch.setattr(mod, "available", lambda: False)
    flags = ["--n", "4", "--staging", "32", "--src-size", "64"]
    benchmark_data.main(flags)
    port = capsys.readouterr().out.splitlines()
    tool = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "benchmark_data.py")
    monkeypatch.setattr(sys, "argv", [tool] + flags)
    runpy.run_path(tool, run_name="__main__")
    jax = capsys.readouterr().out.splitlines()
    number = re.compile(r"\d+(\.\d+)?")
    assert [number.sub("#", ln) for ln in port] == [number.sub("#", ln) for ln in jax]
    assert len(port) == 6 and ("UNAVAILABLE" in port[1]) == (not native)
