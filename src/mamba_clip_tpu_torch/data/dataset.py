"""The synthetic ISIC-2024 stand-in dataset (host side), on numpy alone.

Counterpart of ``synthetic_metadata`` and ``SyntheticIsicDataset`` in
``mamba_clip_tpu/data/dataset.py``. The JAX package keeps metadata in a
pandas frame; here it is a :class:`ColumnTable`, a dict of equal-length
numpy arrays whose rows read as mappings, which is all that
``report_gen.generate_report`` and the tokenizer's context measurement
need. The random draws are made in the JAX package's order, so both give
the same metadata, images, reports and tokens for the same seed.

Item contract: ``dict(image=uint8 (S, S, 3), tokens=int32 (context,),
target=int32)``; the host stage makes the square staging array only, all
augmentation runs on the device (``ops/preprocess.py``).

``_decode_to_square`` (PIL, imported inside) decodes a JPEG for the HTTP
host where the native decoder (``fastimage.py``) is unavailable. The
real-data readers (``IsicChallengeDataset`` over HDF5 or JPEG files,
``StagingCache``) need pandas and h5py and are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    """Equal-length named numpy columns; ``table[name]`` is a column,
    ``table.row(i)`` a mapping of that row's values."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        self._cols: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {sorted(lengths)}")
        self._n = lengths.pop() if lengths else 0

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def row(self, i: int) -> Dict[str, object]:
        return {k: v[i] for k, v in self._cols.items()}


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
