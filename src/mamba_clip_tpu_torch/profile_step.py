"""Trace the bench's train step on the card and attribute its device time
by kernel class.

    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.profile_step \\
        [--batch 64] [--model biomedclip|medmamba] [--precision amp] \\
        [--quant MODE] [--attn-remat] [--attn-impl einsum|flash] \\
        [--text-ctx 224] [--steps 5] [--top 15] [--trace-dir DIR] [--grep REGEX]

Counterpart of ``tools/profile_step.py``, with its flags and defaults: the
step is built by ``bench.build_train_step``, so the profiled step is the
benchmarked one (the stage-1 contrastive step of a full-width CLIP, the
medmamba CLIP's under ``--model medmamba``; image 224, staging 256, random
weights from seed 0, one device-resident batch of uniform token ids at
``--text-ctx``, the bench's context unless given). It takes 3 warm-up
steps, traces ``steps`` steps with ``torch.profiler``, writes the Chrome
trace to ``<trace_dir>/trace.json`` (a temporary directory, removed,
unless ``--trace-dir`` is given), reads it back with
``utils/profiling.load_device_op_times`` and prints the attribution table
(``format_attribution``) with the ``top`` costliest kernels; ``--grep``
also lists the hottest kernels whose name matches the pattern (there is
no HLO to print beside them). Fails where there is no card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .bench import SEED, TEXT_CTX, build_train_step, knobs
from .profile_classify import card_name, trace_summary
from .profile_train import KERNEL_WRAPPERS
from .utils.profiling import (HAND_WRITTEN, attribute, format_attribution,
                              load_device_op_launches, load_device_op_times)

def profile_step(model: str = "biomedclip", batch: int = 64, precision: str = "amp",
                 attn_impl: str = "einsum", steps: int = 5, top: int = 15,
                 trace_dir=None, quant=None, attn_remat: bool = False,
                 text_ctx: int = TEXT_CTX, grep=None) -> dict:
    """Trace ``steps`` steps of the bench's step and attribute them.
    Returns ``rows`` (``attribute``'s, with launches a step), ``table``
    (the printed text), ``times`` (device microseconds by kernel name over
    the traced steps), ``launches`` (each hand-written kernel wrapper's
    launches over the traced steps), ``device_ms_per_step`` (the trace's
    device total, from the profiler's events), ``wall_ms_per_step``,
    ``loss``, ``trace``, the trace file's path, and ``grep``: with a
    pattern, the ``top`` hottest kernels whose name matches it, (name,
    device ms a step), and their total ms a step over all of them."""
    step_fn, state, b = build_train_step(batch, model, precision, quant, attn_remat,
                                         attn_impl, text_ctx, device="cuda")
    for _ in range(3):  # warm-up outside the trace
        state, metrics = step_fn(state, b, SEED)
    torch.cuda.synchronize()
    before = {name: w.launches for name, (w, _) in KERNEL_WRAPPERS.items()}
    keep = trace_dir is not None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="mamba_clip_prof_")
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state, metrics = step_fn(state, b, SEED)
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
    out = {
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
        "grep": None,
    }
    if grep:
        matched = sorted(((n, us / steps / 1e3) for n, us in times.items()
                          if re.search(grep, n)), key=lambda kv: -kv[1])
        out["grep"] = {"pattern": grep, "kernels": len(matched),
                       "ms_per_step": sum(ms for _, ms in matched), "top": matched[:top]}
    return out


def parser() -> argparse.ArgumentParser:
    """The JAX tool's flags, with its defaults."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--model", default="biomedclip", help="biomedclip|medmamba (the CLIP)")
    ap.add_argument("--precision", default="amp")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--attn-remat", action="store_true")
    ap.add_argument("--attn-impl", default="einsum", help="einsum|flash (ops/flash_attn)")
    ap.add_argument("--text-ctx", type=int, default=None,
                    help="padded text length (default: the bench's BENCH_TEXT_CTX, 224)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace-dir", default=None,
                    help="keep the trace here (default: a temporary directory)")
    ap.add_argument("--grep", default=None,
                    help="also list the hottest kernels whose name matches this regex")
    return ap


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA card")
    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    text_ctx = a.text_ctx or knobs().text_ctx
    r = profile_step(a.model, a.batch, a.precision, a.attn_impl, a.steps, a.top, a.trace_dir,
                     quant=a.quant, attn_remat=a.attn_remat, text_ctx=text_ctx, grep=a.grep)
    print(f"{card}: model={a.model} batch={a.batch} precision={a.precision} "
          f"quant={a.quant} attn_impl={a.attn_impl} attn_remat={a.attn_remat} "
          f"text_ctx={text_ctx} steps={a.steps} loss={r['loss']:.4f} "
          f"wall={r['wall_ms_per_step']:.1f} ms/step (traced)\n")
    print(r["table"])
    if r["grep"]:
        g = r["grep"]
        print(f"\nhottest kernels matching /{g['pattern']}/ (total {g['ms_per_step']:.3f} "
              f"ms/step over {g['kernels']} kernels):")
        for name, ms in g["top"]:
            print(f"{ms:9.3f}  {name}")
    if r["trace"]:
        print(f"\nraw trace kept at {r['trace']}")
    return r


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
