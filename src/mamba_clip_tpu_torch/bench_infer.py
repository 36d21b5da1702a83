"""Inference throughput of an exported serving artifact (forward only).

Counterpart of ``tools/bench_infer.py --artifact DIR``: every entry point
of the artifact's manifest is loaded through ``serving.load_serving`` and
timed on a batch of random uint8 staging images or random tokens: warm-up
calls, then back-to-back calls closed by one synchronizing reduction of
the last output. The JAX tool's in-process scenarios are the port's
``profile_classify.py`` and ``profile_embed.py``.

    python -m mamba_clip_tpu_torch.bench_infer --artifact DIR [--device cuda|cpu]

Env knobs, as the JAX tool's: BENCH_INFER_BATCH (64), BENCH_INFER_STEPS
(30), BENCH_INFER_WARMUP (3). Output: one JSON line per entry point, the
JAX tool's keys plus ``device`` (the card's name, or ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .bench_serving import device_name


def _artifact_scenarios(art_dir: str, device, batch: int):
    from .serving import load_serving

    served = load_serving(art_dir, device=device)
    m = served["manifest"]
    np_rng = np.random.default_rng(0)
    staging = int(m["staging_size"])
    raw = torch.from_numpy(
        np_rng.integers(0, 256, (batch, staging, staging, 3), dtype=np.uint8)).to(device)
    tokens = torch.from_numpy(
        np_rng.integers(4, int(m["vocab_size"]), (batch, int(m["context_length"])),
                        dtype=np.int32)).to(device)
    art_quant = m.get("quant") or "bf16"
    for name in sorted(m["entry_points"]):
        fn = served[name]
        x = tokens if name == "text_embed" else raw

        def call(fn=fn, x=x):
            # the reduction of the last output is the barrier read below
            return fn(x).float().sum()

        yield f"artifact_{name}", call, art_quant


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True,
                   help="exported serving dir (mamba_clip_tpu_torch.export_serving)")
    p.add_argument("--device", default="cuda",
                   help="where the entry points run: cuda (the card) or cpu")
    a = p.parse_args(argv)
    batch = int(os.environ.get("BENCH_INFER_BATCH", 64))
    steps = int(os.environ.get("BENCH_INFER_STEPS", 30))
    warmup = int(os.environ.get("BENCH_INFER_WARMUP", 3))

    for name, call, quant_label in _artifact_scenarios(a.artifact, a.device, batch):
        for _ in range(warmup):
            out = call()
        float(out)  # barrier
        t0 = time.perf_counter()
        for _ in range(steps):
            out = call()
        val = float(out)  # barrier: the device's queue drains here
        dt = time.perf_counter() - t0
        if not math.isfinite(val):
            raise RuntimeError(f"non-finite output in {name}")
        print(json.dumps({
            "metric": f"infer_{name}_images_per_sec_per_chip",
            "value": round(batch * steps / dt, 2),
            "unit": "images/sec/chip",
            "batch": batch,
            "quant": quant_label,
            "device": device_name(a.device),
        }), flush=True)


if __name__ == "__main__":
    main()
