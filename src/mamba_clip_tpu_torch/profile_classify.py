"""Where the time of the medmamba ``classify`` entry point goes on the card.

    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.profile_classify \
        [--batch 64] [--iters 10] [--out FILE]

Builds the full-width medmamba serving path (image 224, staging 256, bf16
compute, random weights from seed 0) on the CUDA card and warms it up.
Then it times ``iters`` calls of ``classify`` on device-resident uint8
input, and traces ``iters`` more with ``torch.profiler``. Prints one JSON
object: the card; the host time per call and img/s, untraced; the device
time per call summed over the kernels, traced; the device's idle share,
as one minus that device time over the untraced host time, and as the
gaps of the traced window (the profiler slows the host, so this one
reads high); the kernels launched per call; and the device time per call
of the 25 costliest kernels by exact name. ``--out`` writes the same
object with every kernel name. Fails where there is no card or the trace
holds no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .serving import make_serving_fns


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_classify: no CUDA card")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, fns, meta = make_serving_fns(
        "medmamba", precision="amp", image_size=224, device="cuda",
        generator=torch.Generator().manual_seed(0))
    classify = fns["classify"]
    S = meta["staging_size"]
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (args.batch, S, S, 3), dtype=np.uint8)).cuda()
    for _ in range(3):
        classify(model, x)
    torch.cuda.synchronize()

    def timed_calls() -> float:
        """Host microseconds for ``iters`` calls, ending in a synchronise."""
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = classify(model, x)
        torch.cuda.synchronize()
        if out.shape != (args.batch, meta["num_classes"]) or not torch.isfinite(out).all():
            raise SystemExit("profile_classify: classify gave a bad result")
        return (time.perf_counter() - t0) * 1e6

    wall_us = timed_calls()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall_us = timed_calls()

    by_name = defaultdict(float)
    intervals = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        by_name[evt.name] += (e - s) / args.iters
        intervals.append((s, e))
    if not intervals:
        raise SystemExit("profile_classify: the trace holds no device time "
                         "(device time not measured)")
    busy = _busy_us(intervals)
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    device_ms = sum(by_name.values()) / 1e3
    host_ms = wall_us / args.iters / 1e3
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])
    result = {
        "card": card,
        "batch": args.batch,
        "iters": args.iters,
        # untraced: the profiler slows the host, not the kernels
        "host_ms_per_call": host_ms,
        "img_per_s": args.batch / (host_ms / 1e3),
        "device_ms_per_call": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
        "traced_host_ms_per_call": traced_wall_us / args.iters / 1e3,
        "traced_device_idle_share": 1.0 - busy / span,
        "kernels_per_call": len(intervals) / args.iters,
        "kernel_ms_per_call": {k: v / 1e3 for k, v in kernels},
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    result["kernel_ms_per_call"] = dict(list(result["kernel_ms_per_call"].items())[:25])
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
