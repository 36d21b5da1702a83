"""Trace a train step on the card and attribute its device time by kernel
class.

    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.profile_step \\
        [--model biomedclip|medmamba] [--batch 64] [--precision amp] \\
        [--attn-impl flash|einsum] [--steps 5] [--top 15] [--trace-dir DIR]

Counterpart of ``tools/profile_step.py``. ``--model biomedclip`` (the
default) builds the stage-1 contrastive step of full-width BiomedCLIP with
``attn_impl="flash"`` unless asked, ``--model medmamba`` the stage-2 CE
step of full-width medmamba, both through ``profile_train``'s set-up
functions (image 224, staging 256, random weights from seed 0,
device-resident batches). It takes 3 warm-up steps, traces ``steps`` steps
with ``torch.profiler``, writes the Chrome trace to
``<trace_dir>/trace.json`` (a temporary directory, removed, unless
``--trace-dir`` is given), reads it back with
``utils/profiling.load_device_op_times`` and prints the attribution table
(``format_attribution``) with the ``top`` costliest kernels. Fails where
there is no card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .profile_classify import card_name, trace_summary
from .profile_train import KERNEL_WRAPPERS, SETUPS
from .utils.profiling import (HAND_WRITTEN, attribute, format_attribution,
                              load_device_op_launches, load_device_op_times)


def profile_step(model: str = "biomedclip", batch: int = 64, precision: str = "amp",
                 attn_impl: str = "flash", steps: int = 5, top: int = 15,
                 trace_dir=None) -> dict:
    """Trace ``steps`` steps of ``model``'s train step and attribute them.
    Returns ``rows`` (``attribute``'s, with launches a step), ``table``
    (the printed text), ``times`` (device microseconds by kernel name over
    the traced steps), ``launches`` (each hand-written kernel wrapper's
    launches over the traced steps), ``device_ms_per_step`` (the trace's
    device total, from the profiler's events), ``wall_ms_per_step``,
    ``loss`` and ``trace``, the trace file's path."""
    setup = SETUPS[model][0]
    kw = {"attn_impl": attn_impl} if model == "biomedclip" else {}
    state, step_fn, batches = setup(batch, precision=precision, **kw)
    for i in range(3):  # warm-up outside the trace
        state, metrics = step_fn(state, batches[i % 2], 0)
    torch.cuda.synchronize()
    before = {name: w.launches for name, (w, _) in KERNEL_WRAPPERS.items()}
    keep = trace_dir is not None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="mamba_clip_prof_")
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                state, metrics = step_fn(state, batches[i % 2], 0)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        launches = {name: w.launches - before[name] for name, (w, _) in KERNEL_WRAPPERS.items()}
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        times = load_device_op_times(trace_dir)
        op_launches = load_device_op_launches(trace_dir)
    finally:
        if not keep:
            shutil.rmtree(trace_dir, ignore_errors=True)
    rows = attribute(times, steps=steps, launches=op_launches)
    top_ops = [(n, us / steps / 1e3)
               for n, us in sorted(times.items(), key=lambda kv: -kv[1])[:top]]
    loss = float(metrics["loss"])
    summary = trace_summary(prof, steps, wall_us, wall_us, "step")
    return {
        "rows": rows,
        "table": format_attribution(rows, top_ops),
        "times": times,
        "launches": launches,
        "hand_written_per_step": sum(n for c, _, n in rows if c == HAND_WRITTEN),
        "device_ms_per_step": summary["device_ms_per_step"],
        "kernels_per_step": summary["kernels_per_step"],
        "wall_ms_per_step": wall_us / steps / 1e3,
        "loss": loss,
        "trace": path if keep else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(SETUPS), default="biomedclip")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--precision", default="amp")
    ap.add_argument("--attn-impl", default="flash", help="einsum|flash (biomedclip)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace-dir", default=None,
                    help="keep the trace here (default: a temporary directory)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA card")
    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = profile_step(a.model, a.batch, a.precision, a.attn_impl, a.steps, a.top, a.trace_dir)
    print(f"{card}: model={a.model} batch={a.batch} precision={a.precision} "
          f"attn_impl={a.attn_impl} steps={a.steps} loss={r['loss']:.4f} "
          f"wall={r['wall_ms_per_step']:.1f} ms/step (traced)\n")
    print(r["table"])
    if r["trace"]:
        print(f"\nraw trace kept at {r['trace']}")
    return r


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
