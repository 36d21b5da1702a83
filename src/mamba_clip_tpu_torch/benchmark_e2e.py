"""End-to-end real-data training benchmark: host decode to device train.

Counterpart of ``tools/benchmark_e2e.py``, with its flags and its JSON
line. It writes an ISIC-shaped dataset of real JPEGs and its metadata CSV,
drives the port's CLI (``python -m mamba_clip_tpu_torch.cli.main``) for two
epochs of stage 1 with ``--cache-staging``, and reports each epoch's
throughput parsed from the CLI's train log lines (the median of an epoch's
``samples/s`` points, the first two dropped when there are more than four).

Epoch 1 decodes every JPEG and fills the staging cache; epoch 2 reads the
cache (the steady state of a multi-epoch run).

``--layout``: ``hdf5`` (the default, as the JAX tool writes it:
``train-image.hdf5`` of JPEG blobs keyed by ``isic_id``, which needs
h5py) or ``jpeg`` (``train-image/image/<isic_id>.jpg``, which the dataset
of both packages reads too, and which needs only PIL). Without h5py,
``hdf5`` raises an ``ImportError`` that names ``--layout jpeg``; the
layout is never switched silently. The data and the logs go under
``--root`` (default: a fresh temporary directory, removed afterwards).

    python -m mamba_clip_tpu_torch.benchmark_e2e [--n 3072] [--src-px 256] [--batch 64] [--workers 4] [--fresh] [--layout hdf5|jpeg] [--root DIR] [--device auto|cuda|cpu]

Prints one JSON line: ``{"epoch1_img_s": ..., "epoch2_img_s": ..., ...}``.
The CLI runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("hdf5", "jpeg")
_RATE = re.compile(r"Train Epoch: (\d+) \[\s*\d+/\d+.*?samples/s: ([0-9.]+)")


def make_jpeg(size: int, rng) -> bytes:
    """A ``size``-square JPEG (quality 90) of skin-like low-frequency
    content, so that its entropy is realistic."""
    from PIL import Image

    base = rng.normal(180, 30, (size // 8, size // 8, 3))
    img = np.clip(
        np.kron(base, np.ones((8, 8, 1))) + rng.normal(0, 8, (size, size, 3)), 0, 255,
    ).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def build_dataset(root: str, n: int, src_px: int, seed: int = 0, layout: str = "hdf5") -> None:
    """``train-metadata.csv`` (``synthetic_metadata(n, seed)``) and one JPEG
    an id in ``layout`` under ``root``."""
    from .data.dataset import synthetic_metadata
    from .data.metadata import write_csv

    if layout not in LAYOUTS:
        raise ValueError(f"--layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "hdf5":
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"--layout hdf5 writes train-image.hdf5 and needs h5py, which does not "
                f"import ({e}); --layout jpeg writes train-image/image/<isic_id>.jpg, "
                "which needs only PIL") from e
    os.makedirs(root, exist_ok=True)
    meta = synthetic_metadata(n, seed=seed)
    write_csv(meta, os.path.join(root, "train-metadata.csv"))
    rng = np.random.default_rng(seed)
    if layout == "hdf5":
        with h5py.File(os.path.join(root, "train-image.hdf5"), "w") as f:
            for isic_id in meta["isic_id"]:
                f[str(isic_id)] = np.void(make_jpeg(src_px, rng))
        return
    img_dir = os.path.join(root, "train-image", "image")
    os.makedirs(img_dir, exist_ok=True)
    for isic_id in meta["isic_id"]:
        with open(os.path.join(img_dir, f"{isic_id}.jpg"), "wb") as f:
            f.write(make_jpeg(src_px, rng))


def _built(root: str, layout: str) -> bool:
    if layout == "hdf5":
        return os.path.exists(os.path.join(root, "train-image.hdf5"))
    return os.path.isdir(os.path.join(root, "train-image", "image"))


def parse_rates(log: str) -> dict:
    """The CLI's per-step ``samples/s`` points of epochs 0 and 1, from its
    train log lines."""
    rates = {0: [], 1: []}
    for m in _RATE.finditer(log):
        ep, r = int(m.group(1)), float(m.group(2))
        if ep in rates:
            rates[ep].append(r)
    return rates


def steady(v) -> float:
    """The median of an epoch's points, the first two (compile and fill-in)
    dropped when there are more than four."""
    v = v[2:] if len(v) > 4 else v
    return float(np.median(v)) if v else float("nan")


def run(n: int, src_px: int, batch: int, workers: int, fresh: bool, layout: str = "hdf5",
        root=None, device: str = "auto"):
    """Build the dataset (unless it is there), run the CLI for two epochs
    and return the JSON object."""
    from .pipeline import resolve_device

    resolve_device(device)  # no card and no --device cpu: fail before the data is written
    owned = root is None
    base = tempfile.mkdtemp(prefix="e2e_bench_") if owned else root
    try:
        data = os.path.join(base, f"data_{n}_{src_px}_{layout}")
        logs = os.path.join(base, "logs")
        if fresh and os.path.exists(data):
            shutil.rmtree(data)
        if not _built(data, layout):
            build_dataset(data, n, src_px, layout=layout)
        # a fresh staging cache: epoch 1 must pay the decode
        staging = os.path.join(data, "staging")
        shutil.rmtree(staging, ignore_errors=True)
        shutil.rmtree(logs, ignore_errors=True)

        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [
            sys.executable, "-m", "mamba_clip_tpu_torch.cli.main",
            "--data-path", data, "--cache-staging", staging,
            "--batch-size", str(batch), "--epochs", "2", "--warmup", "2",
            "--lr", "1e-4", "--precision", "amp", "--stage", "1",
            "--logs", logs, "--workers", str(workers),
            "--log-every-n-steps", "4", "--grad-clip-norm", "1.0",
            "--device", device,
        ]
        proc = subprocess.run(cmd, env=env, cwd=base, text=True, capture_output=True,
                              timeout=3600)
        out = proc.stdout + proc.stderr
        if proc.returncode != 0:
            sys.stderr.write(out[-4000:])
            raise SystemExit(f"CLI failed rc={proc.returncode}")
        rates = parse_rates(out)
        return {
            "n_images": n, "src_px": src_px, "batch": batch, "workers": workers,
            "epoch1_img_s": round(steady(rates[0]), 1),
            "epoch2_img_s": round(steady(rates[1]), 1),
            "steps_per_epoch": len(rates[0]),
        }
    finally:
        if owned:
            shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=3072)
    p.add_argument("--src-px", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--fresh", action="store_true")
    p.add_argument("--layout", choices=LAYOUTS, default="hdf5")
    p.add_argument("--root", default=None,
                   help="where the data and the logs go (default: a temporary directory)")
    p.add_argument("--device", default="auto", help="auto|cuda|cpu (auto: the card)")
    a = p.parse_args(argv)
    out = run(a.n, a.src_px, a.batch, a.workers, a.fresh, a.layout, a.root, a.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
