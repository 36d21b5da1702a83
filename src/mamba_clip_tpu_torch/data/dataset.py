"""ISIC-2024 dataset readers (host side) and the synthetic stand-in, on
numpy alone.

Counterpart of ``mamba_clip_tpu/data/dataset.py``. The JAX package keeps
metadata in a pandas frame; here it is a :class:`ColumnTable`, a dict of
equal-length numpy columns with the frame's row labels beside them, whose
rows read as mappings, which is all that ``report_gen.generate_report``,
the tokenizer's context measurement and ``metadata.py`` need. The random
draws are made in the JAX package's order, so both give the same metadata,
images, reports and tokens for the same seed and files.

Item contract: ``dict(image=uint8 (S, S, 3), tokens=int32 (context,),
target=int32)``; the host stage makes the square staging array only, all
augmentation runs on the device (``ops/preprocess.py``).

- :class:`IsicChallengeDataset` reads ``<isic_id>.jpg`` files from a
  directory or JPEG blobs from an HDF5 file keyed by ``isic_id``, with its
  metadata from a CSV (``metadata.read_csv``) or a ``ColumnTable``. A JPEG
  decodes through the native libjpeg path (``fastimage.py``), else PIL
  (``_decode_to_square``); PIL and h5py are imported inside the functions
  that need them, so the JPEG-directory layout needs PIL only.
- :class:`StagingCache` keeps the decoded squares in a disk memmap, so
  that epochs after the first read them instead of decoding again.
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from .report_gen import generate_report


def _decode_to_square(img, staging: int) -> np.ndarray:
    """PIL image -> RGB uint8 (staging, staging, 3): keep-ratio resize of the
    shorter side then center crop."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = staging / min(w, h)
    nw, nh = max(int(round(w * scale)), staging), max(int(round(h * scale)), staging)
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - staging) // 2
    top = (nh - staging) // 2
    img = img.crop((left, top, left + staging, top + staging))
    return np.asarray(img, dtype=np.uint8)


class ColumnTable:
    """Equal-length named numpy columns and their rows' labels: ``table[name]``
    is a column, ``table.row(i)`` a mapping of row ``i``'s values,
    ``table.index`` the labels (default ``arange(n)``), which ``take``,
    ``head``, ``tail``, ``table[::step]`` and ``concat`` carry along as
    ``DataFrame.iloc`` and ``pd.concat`` do."""

    def __init__(self, columns: Mapping[str, np.ndarray], index=None):
        self._cols: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        self._n = lengths.pop() if lengths else 0
        self.index = np.arange(self._n) if index is None else np.asarray(index)
        if len(self.index) != self._n:
            raise ValueError(f"{len(self.index)} row labels for {self._n} rows")

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, key):
        """A column by name, or the rows of a slice (``table[::step]``)."""
        if isinstance(key, slice):
            return self.take(np.arange(self._n)[key])
        return self._cols[key]

    def row(self, i: int) -> Dict[str, object]:
        return {k: v[i] for k, v in self._cols.items()}

    def take(self, positions) -> "ColumnTable":
        """The rows at ``positions``, in that order, with their labels."""
        pos = np.asarray(positions, dtype=np.intp)
        return ColumnTable({k: v[pos] for k, v in self._cols.items()}, index=self.index[pos])

    def head(self, n: int) -> "ColumnTable":
        return self.take(np.arange(min(n, self._n)))

    def tail(self, n: int) -> "ColumnTable":
        return self.take(np.arange(max(self._n - n, 0), self._n))

    @staticmethod
    def concat(tables: Sequence["ColumnTable"]) -> "ColumnTable":
        """The tables' rows one after another; every table has the same
        columns in the same order."""
        cols = tables[0].columns
        for t in tables[1:]:
            if t.columns != cols:
                raise ValueError(f"concat of tables with columns {cols} and {t.columns}")
        return ColumnTable({c: np.concatenate([t[c] for t in tables]) for c in cols},
                           index=np.concatenate([t.index for t in tables]))


def _content_key(data_path, ids) -> str:
    """Hash of the image source and the whole id sequence a cache holds:
    two datasets of equal length but different ids (two ``--undersample``
    draws, same-size val and test splits) never share a memmap, whose
    done-bitmap would otherwise serve one's images for the other's rows."""
    h = hashlib.sha1()
    h.update(str(data_path).encode())
    for i in ids:
        h.update(b"\0")
        h.update(str(i).encode())
    return h.hexdigest()[:16]


class StagingCache:
    """Disk memmap of decoded uint8 staging squares and a done-bitmap.

    After the first epoch the squares are read from here instead of decoded
    again (about 196 KB an image at 256 px). Safe for the loader's threads:
    each writes its own rows, and a row's done flag is set only after the
    row is written. Files of another shape are made anew."""

    def __init__(self, cache_dir: str, name: str, n: int, staging: int):
        os.makedirs(cache_dir, exist_ok=True)
        data_path = os.path.join(cache_dir, f"{name}_{staging}.npy")
        done_path = os.path.join(cache_dir, f"{name}_{staging}_done.npy")
        shape = (n, staging, staging, 3)
        self.data = self.done = None
        if os.path.exists(data_path) and os.path.exists(done_path):
            self.data = np.lib.format.open_memmap(data_path, mode="r+")
            self.done = np.lib.format.open_memmap(done_path, mode="r+")
        if self.data is None or self.data.shape != shape or self.done.shape != (n,):
            self.data = np.lib.format.open_memmap(data_path, mode="w+", dtype=np.uint8,
                                                  shape=shape)
            self.done = np.lib.format.open_memmap(done_path, mode="w+", dtype=np.uint8,
                                                  shape=(n,))

    def get(self, idx: int):
        if self.done[idx]:
            return np.asarray(self.data[idx])
        return None

    def put(self, idx: int, arr: np.ndarray) -> None:
        self.data[idx] = arr
        self.done[idx] = 1


class IsicChallengeDataset:
    """Map-style dataset over the ISIC-2024 files: ``data_path`` is an HDF5
    file (``.h5``/``.hdf5``) of JPEG blobs keyed by ``isic_id`` or a
    directory of ``<isic_id>.jpg``; ``metadata_or_path`` a CSV path or a
    ``ColumnTable``. Items are ``dict(image, tokens, target)``; a split
    without a ``target`` column (the challenge's test metadata) has
    ``targets`` None and items without ``target``."""

    def __init__(
        self,
        data_path: str,
        metadata_or_path,
        tokenizer=None,
        staging_size: int = 256,
        is_train: bool = False,
        include_target: bool = False,
        small_test: bool = False,
        seed: int = 0,
        cache_dir: Optional[str] = None,
    ):
        self.data_path = data_path
        self.is_hdf5 = str(data_path).endswith((".h5", ".hdf5"))
        if isinstance(metadata_or_path, str):
            from .metadata import read_csv

            meta = read_csv(metadata_or_path)
        else:
            meta = metadata_or_path
        if small_test:
            meta = meta.head(512)
        # the id is the frame's index (its row labels where there is no
        # isic_id column), not one of the row's values
        self.ids = (list(meta["isic_id"]) if "isic_id" in meta.columns
                    else meta.index.tolist())
        self.meta = ColumnTable({c: meta[c] for c in meta.columns if c != "isic_id"})
        self.targets = (self.meta["target"].astype(np.int32)
                        if "target" in self.meta.columns else None)
        self.tokenizer = tokenizer
        self.staging_size = staging_size
        self.is_train = is_train
        self.include_target = include_target
        self.seed = seed
        self.epoch = 0
        # one h5py handle a thread: SWMR guards readers in other processes,
        # but concurrent reads on one handle from the loader's threads are
        # unsafe unless libhdf5 was built thread-safe
        self._h5_local = threading.local()
        self._h5_all: list = []
        self._h5_all_lock = threading.Lock()
        self._token_memo = {} if not is_train else None  # eval text is deterministic
        self.cache = (
            StagingCache(
                cache_dir,
                f"{'train' if is_train else 'eval'}"
                f"_{len(self.ids)}_{_content_key(data_path, self.ids)}",
                len(self.ids),
                staging_size,
            )
            if cache_dir
            else None
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.ids)

    def _h5_file(self):
        f = getattr(self._h5_local, "file", None)
        if f is None:
            try:
                import h5py
            except ImportError as e:
                raise ImportError(
                    f"reading {self.data_path} needs h5py, which does not import ({e}); "
                    "the JPEG-directory layout (<data_path>/train-image/image/<isic_id>.jpg) "
                    "needs only PIL") from e
            f = h5py.File(self.data_path, "r", libver="latest", swmr=True)
            self._h5_local.file = f
            with self._h5_all_lock:
                self._h5_all.append(f)
        return f

    def _load_image(self, isic_id: str, idx: Optional[int] = None) -> np.ndarray:
        if self.cache is not None and idx is not None:
            hit = self.cache.get(idx)
            if hit is not None:
                return hit
        if self.is_hdf5:
            blob = bytes(self._h5_file()[isic_id][()])
        else:
            with open(os.path.join(self.data_path, f"{isic_id}.jpg"), "rb") as f:
                blob = f.read()
        from . import fastimage

        out = fastimage.decode_resize(blob, self.staging_size)
        if out is None:
            from PIL import Image

            out = _decode_to_square(Image.open(io.BytesIO(blob)), self.staging_size)
        if self.cache is not None and idx is not None:
            self.cache.put(idx, out)
        return out

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        out = {"image": self._load_image(self.ids[idx], idx)}
        if self.tokenizer is not None:
            if self._token_memo is not None and idx in self._token_memo:
                out["tokens"] = self._token_memo[idx]
            else:
                text = generate_report(
                    self.meta.row(idx),
                    is_eval=not self.is_train,
                    shuffle=self.is_train,
                    dropout=0.1 if self.is_train else 0.0,
                    include_target=self.include_target,
                    rng=rng,
                )
                out["tokens"] = self.tokenizer(text)[0]
                if self._token_memo is not None:
                    self._token_memo[idx] = out["tokens"]
        if self.targets is not None:
            out["target"] = np.int32(self.targets[idx])
        return out

    def close(self):
        with self._h5_all_lock:
            files, self._h5_all = self._h5_all, []
        for f in files:
            try:
                f.close()
            except Exception:  # a handle already closed or its file gone: nothing to release
                pass
        self._h5_local = threading.local()


def synthetic_metadata(n: int, seed: int = 0) -> ColumnTable:
    """ISIC-shaped synthetic metadata: the columns the report generator
    consumes. A missing ``sex`` or ``anatom_site_general`` is the string
    ``'nan'`` (numpy turns the mixed choice list into strings), which the
    report generator does not count as missing; both packages agree."""
    rng = np.random.default_rng(seed)
    sites = ["head/neck", "upper extremity", "lower extremity", "torso"]
    sexes = ["male", "female"]
    n_pos = max(int(n * 0.02), 1)
    target = np.zeros(n, np.int64)
    target[rng.choice(n, n_pos, replace=False)] = 1
    return ColumnTable(
        {
            "isic_id": np.array([f"ISIC_{i:07d}" for i in range(n)]),
            "target": target,
            "age_approx": rng.choice([25, 40, 55, 70, np.nan], n),
            "sex": rng.choice(sexes + [np.nan], n),
            "anatom_site_general": rng.choice(sites + [np.nan], n),
            "clin_size_long_diam_mm": rng.uniform(1, 20, n),
            "tbp_lv_H": rng.uniform(0, 60, n),
            "tbp_lv_areaMM2": rng.uniform(1, 80, n),
            "tbp_lv_area_perim_ratio": rng.uniform(10, 40, n),
            "tbp_lv_color_std_mean": rng.uniform(0, 2, n),
            "tbp_lv_deltaLBnorm": rng.uniform(0, 15, n),
            "tbp_lv_eccentricity": rng.uniform(0, 1, n),
            "tbp_lv_location_simple": rng.choice(sites, n),
            "tbp_lv_minorAxisMM": rng.uniform(1, 15, n),
            "tbp_lv_nevi_confidence": rng.uniform(0, 100, n),
            "tbp_lv_norm_border": rng.uniform(0, 10, n),
            "tbp_lv_norm_color": rng.uniform(0, 10, n),
            "tbp_lv_perimeterMM": rng.uniform(5, 60, n),
            "tbp_lv_radial_color_std_max": rng.uniform(0, 3, n),
            "tbp_lv_symm_2axis": rng.uniform(0, 1, n),
            "tbp_lv_symm_2axis_angle": rng.integers(0, 180, n).astype(np.float64),
            "iddx_1": rng.choice(["Benign", "Malignant"], n),
        }
    )


class SyntheticIsicDataset:
    """Random images + ISIC-shaped metadata. Images are deterministic per
    index; the report's draws come from a generator seeded by (seed, epoch,
    index), so any worker thread produces the same item."""

    def __init__(
        self,
        n: int = 1024,
        tokenizer=None,
        staging_size: int = 256,
        is_train: bool = False,
        include_target: bool = False,
        seed: int = 0,
    ):
        meta = synthetic_metadata(n, seed)
        self.ids = list(meta["isic_id"])
        # rows without the id, as the JAX package's frame is indexed by it
        self.meta = ColumnTable({k: meta[k] for k in meta.columns if k != "isic_id"})
        self.targets = self.meta["target"].astype(np.int32)
        self.tokenizer = tokenizer
        self.staging_size = staging_size
        self.is_train = is_train
        self.include_target = include_target
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.meta)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        img_rng = np.random.default_rng((self.seed, idx))
        s = self.staging_size
        image = img_rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
        out = {"image": image, "target": np.int32(self.targets[idx])}
        if self.tokenizer is not None:
            text = generate_report(
                self.meta.row(idx),
                is_eval=not self.is_train,
                shuffle=self.is_train,
                dropout=0.1 if self.is_train else 0.0,
                include_target=self.include_target,
                rng=rng,
            )
            out["tokens"] = self.tokenizer(text)[0]
        return out
