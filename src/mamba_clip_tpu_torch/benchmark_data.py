"""Data-path micro-benchmarks of the host (no device work).

Counterpart of ``tools/benchmark_data.py``, with the same flags and output
lines. It times the stages that feed real-data training: JPEG decode to a
staging square (the native libjpeg module, "UNAVAILABLE" where it does not
build, and PIL), staging-cache reads, report generation, and the assembled
``BatchLoader`` over synthetic items (64 a batch, 4 worker threads). The
source image is a ``--src-size``-square JPEG of uniform noise, quality 92.

    python -m mamba_clip_tpu_torch.benchmark_data [--n 256] [--staging 256] [--src-size 1024]

PIL is imported inside ``main``: the module imports without it.
"""

from __future__ import annotations

import argparse
import io
import tempfile
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--staging", type=int, default=256)
    ap.add_argument("--src-size", type=int, default=1024,
                    help="synthetic source JPEG side (ISIC images are ~1-6k px)")
    a = ap.parse_args(argv)

    from PIL import Image

    from .data import fastimage
    from .data.dataset import StagingCache, SyntheticIsicDataset, _decode_to_square
    from .data.loader import BatchLoader
    from .data.report_gen import generate_report
    from .data.tokenizer import HashTokenizer

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (a.src_size, a.src_size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=92)
    blob = buf.getvalue()
    print(f"source: {a.src_size}px JPEG, {len(blob)/1024:.0f} KiB "
          f"-> staging {a.staging}px")

    n = a.n
    if fastimage.available():
        t0 = time.perf_counter()
        for _ in range(n):
            fastimage.decode_resize(blob, a.staging)
        dt = (time.perf_counter() - t0) / n
        print(f"native decode+stage: {dt*1000:.2f} ms/img -> {1/dt:.0f} img/s")
    else:
        print("native decode: UNAVAILABLE (libjpeg/g++ missing)")

    t0 = time.perf_counter()
    for _ in range(n):
        _decode_to_square(Image.open(io.BytesIO(blob)), a.staging)
    dt = (time.perf_counter() - t0) / n
    print(f"PIL decode+stage:    {dt*1000:.2f} ms/img -> {1/dt:.0f} img/s")

    with tempfile.TemporaryDirectory() as td:
        cache = StagingCache(td, "bench", n, a.staging)
        img = fastimage.decode_resize(blob, a.staging)
        if img is None:
            img = _decode_to_square(Image.open(io.BytesIO(blob)), a.staging)
        for i in range(n):
            cache.put(i, img)
        t0 = time.perf_counter()
        for i in range(n):
            cache.get(i)
        dt = (time.perf_counter() - t0) / n
        print(f"staging-cache read:  {dt*1000:.3f} ms/img -> {1/dt:.0f} img/s")

    tok = HashTokenizer(256, 30522)
    ds = SyntheticIsicDataset(512, tokenizer=tok, staging_size=a.staging, is_train=True)
    row = ds.meta.row(0)
    t0 = time.perf_counter()
    for i in range(500):
        generate_report(row, rng=np.random.default_rng(i))
    print(f"report generation:   {(time.perf_counter()-t0)/500*1000:.3f} ms/item")

    loader = BatchLoader(ds, batch_size=64, seed=0, workers=4)
    t0 = time.perf_counter()
    seen = 0
    for b in loader:
        seen += b["image"].shape[0]
    dt = time.perf_counter() - t0
    print(f"assembled loader:    {seen/dt:.0f} items/s (synthetic images)")


if __name__ == "__main__":
    main()
