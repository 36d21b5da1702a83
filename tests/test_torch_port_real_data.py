"""The port's CLI over files in the ISIC-2024 layout, on the CPU, at the
tiny width of ``tests/test_torch_port_cli.py``.

- stage 1 with ``--undersample``, ``--add-remaining-samples`` and
  ``--cache-staging`` over ``train-metadata.csv`` and
  ``train-image/image/<isic_id>.jpg``: its splits are those JAX's
  ``get_metadata`` -> ``undersample_data`` -> ``get_data`` give, and the
  staging cache is filled;
- then stage 2, which finds it, and ``--is-test --stage 2 --resume latest``
  of stage 2's run on a label-free 12-row ``test-metadata.csv`` (ragged
  against batch 8), as ``tests/test_e2e.py`` runs JAX's: every row
  predicted, no loss or pAUC, and ``submission.csv`` byte for byte what
  ``pd.DataFrame({...}).to_csv(index=False)`` writes for the same ids and
  probabilities, the ids in JAX's loader order;
- ``resolve_text_context`` (``--text-context auto``) over the real splits
  equal to JAX's.
"""

import os
import types

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mamba_clip_tpu.data import dataset as jds
from mamba_clip_tpu.data import loader as jloader
from mamba_clip_tpu.data import metadata as jmeta
from mamba_clip_tpu.data import tokenizer as jtok
from mamba_clip_tpu_torch import eval as teval
from mamba_clip_tpu_torch.cli.main import main
from mamba_clip_tpu_torch.data import metadata as tmeta
from mamba_clip_tpu_torch.data import tokenizer as ttok
from test_torch_port_cli import _argv, _log_lines, tiny  # noqa: F401  (a fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def isic(tmp_path_factory):
    """``train-metadata.csv`` of 60 rows (11 positive) and a label-free 12-row
    ``test-metadata.csv``, every image a JPEG in ``train-image/image`` (the
    test split reads that directory too when there is no HDF5 file)."""
    d = tmp_path_factory.mktemp("isic")
    train = jds.synthetic_metadata(60, seed=5)
    train.loc[::6, "target"] = 1  # positives in every split: stage 2 computes pAUC
    train.to_csv(d / "train-metadata.csv", index=False)
    test = jds.synthetic_metadata(12, seed=3).drop(columns=["target"])
    test["isic_id"] = [f"ISIC_8{i:06d}" for i in range(12)]
    test.to_csv(d / "test-metadata.csv", index=False)
    (d / "train-image" / "image").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for isic_id in list(train["isic_id"]) + list(test["isic_id"]):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
            d / "train-image" / "image" / f"{isic_id}.jpg", quality=90)
    return d


def _jax_data(argv_args):
    """JAX's splits for the same flags: get_metadata -> undersample_data ->
    get_data."""
    a = argv_args
    train, val, test = jmeta.get_metadata(a)
    if a.undersample and train is not None:
        train, val = jmeta.undersample_data(a, train, val)
    return jloader.get_data(a, train, val, test, tokenizer=jtok.HashTokenizer(32, 512),
                            staging_size=32)


def test_two_stages_then_is_test_write_the_submission(tiny, isic, tmp_path, monkeypatch):
    from mamba_clip_tpu import config as jcfg

    data = ["--data-path", f"{isic}/"]
    s1 = _argv(tmp_path / "logs", "--stage", "1", "--undersample", "30",
               "--add-remaining-samples", "--cache-staging", str(tmp_path / "cache"), *data,
               synthetic=False)
    with _log_lines() as lines:
        m1 = main(s1)
    cached = sorted(os.listdir(tmp_path / "cache"))
    assert len(cached) == 4 and all(n.startswith(("train_32_", "eval_16_")) for n in cached)
    want = _jax_data(jcfg.parse_args(s1))
    # 39 train rows (30 + the 9 positives) and 11 + 10 val rows, capped at
    # 32 and 16 by --train-num-samples and --val-num-samples
    assert [len(want[k].loader.dataset) for k in ("train", "val")] == [32, 16]
    assert np.isfinite(m1["val_loss"]) and m1["num_samples"] == 16
    assert any(line.startswith("Stratifying by target: {0: ") for line in lines)

    written = {}
    orig = teval.write_csv

    def spy(table, path):
        written["table"] = table
        orig(table, path)

    # stage 2 finds stage 1's run; --is-test resumes stage 2's
    s2 = _argv(tmp_path / "logs", "--stage", "2", "--name", "s2", *data, synthetic=False)
    m2 = main(s2)
    n_val = len(_jax_data(jcfg.parse_args(s2))["val"].loader.dataset)  # not undersampled
    assert np.isfinite(m2["val_loss"]) and m2["num_samples"] == n_val == 11
    assert 0.0 <= m2["partial_auc"] <= 0.2
    monkeypatch.setattr(teval, "write_csv", spy)
    test = s2 + ["--is-test", "--resume", "latest"]
    with _log_lines() as lines:
        m3 = main(test)
    assert any(line.startswith("Resuming from latest checkpoint: ") for line in lines)
    assert m3["num_samples"] == 12 and "val_loss" not in m3 and "partial_auc" not in m3
    sub = tmp_path / "logs" / "s2" / "checkpoints" / "submission.csv"
    table = written["table"]
    ids = _jax_data(jcfg.parse_args(test))["test"].loader.dataset.ids
    assert list(table["isic_id"]) == ids
    probs = table["target"]
    assert probs.dtype == np.float32 and ((probs >= 0) & (probs <= 1)).all()
    want_csv = tmp_path / "pandas.csv"
    pd.DataFrame({"isic_id": ids, "target": probs}).to_csv(want_csv, index=False)
    assert sub.read_bytes() == want_csv.read_bytes()
    assert len(pd.read_csv(sub)) == 12


@pytest.mark.parametrize("stage", [1, 2])
def test_resolve_text_context_over_the_real_splits_equals_jax(isic, stage):
    a = types.SimpleNamespace(is_test=False, data_path=f"{isic}/", seed=2, undersample=20,
                              undersample_by=None, undersample_sort_by=None,
                              add_remaining_samples=True)
    got = {}
    for name, meta, tok in (("jax", jmeta, jtok), ("port", tmeta, ttok)):
        train, val, _ = meta.get_metadata(a)
        train, val = meta.undersample_data(a, train, val)
        _, _, test = meta.get_metadata(types.SimpleNamespace(**{**vars(a), "is_test": True}))
        hashed = tok.HashTokenizer(256)
        splits = [(train, stage == 1), (val, stage == 1), (test, False)]
        ctx = tok.resolve_text_context("auto", hashed, splits, model_context=256)
        got[name] = (ctx, hashed.context_length, hashed.on_overflow,
                     tok.measure_required_context(hashed, splits))
    assert got["port"] == got["jax"]
    assert got["port"][0] < 256
