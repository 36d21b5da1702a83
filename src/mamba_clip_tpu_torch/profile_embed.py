"""Where the time of the CLIP ``image_embed``/``text_embed`` entry points
goes on the card.

    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.profile_embed \
        [--batch 64] [--iters 10] [--out FILE]

Builds the full-width BiomedCLIP serving path (ViT-B/16 at image 224,
staging 256; the 12-layer BERT at context 256; bf16 compute; random
weights from seed 0) on the CUDA card with ``attn_impl="flash"`` (every
attention interior launches the CUDA flash kernel). For each entry point,
on device-resident input (uint8 images; HashTokenizer tokens of
report-like text, padded to 256), it warms up for a second, times
``iters`` calls untraced and traces ``iters`` more with ``torch.profiler``,
as ``profile_classify.py`` does for ``classify``. Prints one JSON object:
the card, and per entry point the host ms per call and rows/s, the device
ms per call, the device's idle share, the kernels per call, the flash
kernel's launches per call and the device time of the 25 costliest
kernels by exact name. ``--out`` writes the same object with every kernel
name. Fails where there is no card or a trace holds no device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.tokenizer import HashTokenizer
from .ops.flash_attn import flash_attn_fwd
from .profile_classify import card_name, trace_summary
from .serving import make_serving_fns

WARMUP_S = 1.0
REPORT_WORDS = (
    "dermoscopy of a pigmented lesion on the upper back , diameter 6.2 mm ; border "
    "irregular , two colours , asymmetric network , blue-white veil , regression "
    "structures , dotted vessels . history of melanoma in the family ."
).split()


def report_tokens(batch: int, context: int = 256, seed: int = 0) -> np.ndarray:
    """``batch`` rows of HashTokenizer tokens of report-like strings, of
    lengths drawn between 20 and 300 words (the longest are truncated to
    the context, as the reference tokenizes)."""
    rs = np.random.RandomState(seed)
    texts = [" ".join(rs.choice(REPORT_WORDS, rs.randint(20, 300))) for _ in range(batch)]
    return HashTokenizer(context_length=context)(texts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_embed: no CUDA card")

    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, fns, meta = make_serving_fns(
        "biomedclip", is_clip=True, precision="amp", image_size=224, device="cuda",
        attn_impl="flash", generator=torch.Generator().manual_seed(0))
    S = meta["staging_size"]
    inputs = {
        "image_embed": torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (args.batch, S, S, 3), dtype=np.uint8)).cuda(),
        "text_embed": torch.from_numpy(report_tokens(args.batch, meta["context_length"])).cuda(),
    }
    result = {"card": card, "batch": args.batch, "iters": args.iters}
    for name, x in inputs.items():
        fn = fns[name]
        t_end = time.perf_counter() + WARMUP_S
        while time.perf_counter() < t_end:
            fn(model, x)
            torch.cuda.synchronize()

        def timed_calls() -> float:
            """Host microseconds for ``iters`` calls, ending in a synchronise."""
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = fn(model, x)
            torch.cuda.synchronize()
            if out.shape != (args.batch, 512) or not torch.isfinite(out).all():
                raise SystemExit(f"profile_embed: {name} gave a bad result")
            return (time.perf_counter() - t0) * 1e6

        wall_us = timed_calls()
        flash_attn_fwd.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_wall_us = timed_calls()
        entry = trace_summary(prof, args.iters, wall_us, traced_wall_us, "call")
        entry["rows_per_s"] = args.batch / (entry["host_ms_per_call"] / 1e3)
        entry["flash_launches_per_call"] = flash_attn_fwd.launches / args.iters
        result[name] = entry
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    for name in inputs:
        kernels = result[name]["kernel_ms_per_call"]
        result[name]["kernel_ms_per_call"] = dict(list(kernels.items())[:25])
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
