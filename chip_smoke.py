#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX. Phases, each of which exits non-zero
on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles every CUDA kernel of the serving path from ``csrc/``;
3. kernel against plain: ``selective_scan_fwd`` against the plain loop on
   the card at the medmamba stage shapes (batch 2), a ragged shape, fp32
   and bf16, softplus on and off; gate: max|y_k - y_p| / max|y_p| <= 5e-4.
   Then both are timed at the serving batch 64 beside the kernel's bound;
4. serving: the full-width medmamba ``classify`` (image 224, staging 256,
   bf16 compute, random weights from seed 0) answers 16 concurrent requests
   through ``MicroBatcher``; the answers are checked, the launch counter
   must show 14 kernel launches per dispatched batch, the same batch
   through the plain scan must agree, and each of the 14 scans of one
   forward of that batch must agree with the plain loop on its own inputs;
   then classify is timed at batch 64;
5. prints the kernels line, then the device line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

GATE_REL = 5e-4          # the gate bench.py put on the Pallas kernel
PROBS_ATOL = 2e-2        # kernel vs plain scan, end to end, bf16 activations
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS_PER_CLK_SM = 16  # exp2 throughput per SM per clock, compute capability 9.0
STAGES = [(3136, 64), (784, 128), (196, 256), (49, 512)]  # (L, DG) per medmamba stage
BLOCKS_PER_STAGE = [2, 2, 8, 2]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def scan_inputs(Bsz, L, DG, dtype, softplus=True, seed=0, G=4, N=16):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    delta = r(Bsz, G, L, DG) * 0.5
    if not softplus:
        delta = delta.abs()  # a raw step size is positive
    u = r(Bsz, G, L, DG).to(dtype)
    A = -torch.exp(r(G * DG, N) * 0.5)
    B = r(Bsz, G, L, N).to(dtype)
    C = r(Bsz, G, L, N).to(dtype)
    D = r(G * DG) if softplus else None
    bias = r(G * DG) * 0.1 - 2.0 if softplus else None
    return u, delta.to(dtype), A, B, C, D, bias


def scan_bound(Bsz, L, DG, itemsize, sfu_rate, G=4, N=16):
    """Least time for one forward scan: the bytes it must move (each input
    read once, y written once) over the HBM rate, against its fp32 FLOPs
    and its exps over their peaks. Returns the terms, the bound in ms and
    what bounds it."""
    from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_flops

    E = Bsz * G * L * DG
    terms = {
        "bytes": (2 * E * itemsize + 4 * E + 2 * Bsz * G * L * N * itemsize
                  + G * DG * (N + 2) * 4),
        "flops": selective_scan_flops(Bsz, G * DG, L, N),
        "exps": E * N,
    }
    t_bytes = terms["bytes"] / HBM_BYTES_PER_S
    t_ops = max(terms["flops"] / FP32_FLOPS, terms["exps"] / sfu_rate)
    terms.update(bytes_ms=1e3 * t_bytes, flops_ms=1e3 * terms["flops"] / FP32_FLOPS,
                 exps_ms=1e3 * terms["exps"] / sfu_rate,
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return terms


def main() -> None:
    if not (SRC / "mamba_clip_tpu_torch").is_dir():
        fail(f"{SRC / 'mamba_clip_tpu_torch'} not found: run from a checkout of the repository")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"cannot import {e.name}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on the card only")
    sys.path.insert(0, str(SRC))
    from mamba_clip_tpu_torch.ops import cuda_build
    from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_fwd, selective_scan_tm
    from mamba_clip_tpu_torch.serve import MicroBatcher
    from mamba_clip_tpu_torch.serving import make_serving_fns
    from mamba_clip_tpu_torch.models import build_classifier, vssm

    # 1. device
    card = nvidia_smi("name,power.limit")
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    props = torch.cuda.get_device_properties(0)
    max_clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sfu_rate = props.multi_processor_count * SFU_OPS_PER_CLK_SM * max_clk_mhz * 1e6
    say(f"{props.multi_processor_count} SMs, max SM clock {max_clk_mhz:.0f} MHz: "
        f"exp peak {sfu_rate:.4g}/s; fp32 peak {FP32_FLOPS:.3g} FLOP/s and HBM "
        f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM data sheet)")

    # 2. build
    t0 = time.time()
    cuda_build.load("selective_scan_fwd")
    say(f"build: selective_scan_fwd in {time.time() - t0:.1f} s "
        f"({cuda_build.library_path('selective_scan_fwd').name})")
    for line in cuda_build.build_logs.get("selective_scan_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # 3. kernel against plain
    def compare(Bsz, L, DG, dtype, softplus, iters_k, iters_p, seed=0):
        args = scan_inputs(Bsz, L, DG, dtype, softplus, seed)
        with torch.inference_mode():
            y_k = selective_scan_tm(*args, softplus, impl="cuda")
            y_p = selective_scan_tm(*args, softplus, impl="plain")
            torch.cuda.synchronize()
            if not torch.isfinite(y_p).all():
                fail(f"plain scan not finite at B={Bsz} L={L} DG={DG}")
            abs_err = float((y_k - y_p).abs().max())
            rel = abs_err / float(y_p.abs().max())
            ms_k = cuda_ms(lambda: selective_scan_tm(*args, softplus, impl="cuda"), iters_k)
            ms_p = cuda_ms(lambda: selective_scan_tm(*args, softplus, impl="plain"),
                           iters_p, warmup=1)
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = rel <= GATE_REL
        say(f"scan B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            f"rel_err {rel:.3e} abs_err {abs_err:.3e} kernel {ms_k:.4f} ms "
            f"plain {ms_p:.3f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"selective_scan_fwd disagrees with the plain scan: rel err {rel:.3e}")
        return rel, abs_err, ms_k, ms_p

    worst_rel = worst_abs = 0.0
    for L, DG in STAGES + [(300, 24)]:
        for dtype in (torch.float32, torch.bfloat16):
            rel, abs_err, _, _ = compare(2, L, DG, dtype, True, 20, 2)
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    for dtype in (torch.float32, torch.bfloat16):
        rel, abs_err, _, _ = compare(2, 300, 24, dtype, False, 20, 2)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)

    # at the serving batch (64) and type (bf16): one forward = 14 launches
    fwd_k = fwd_p = fwd_bound = 0.0
    bound_terms = {"bytes": 0.0, "operations": 0.0}
    shapes = []
    for (L, DG), nblk in zip(STAGES, BLOCKS_PER_STAGE):
        rel, abs_err, ms_k, ms_p = compare(64, L, DG, torch.bfloat16, True, 10, 1)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
        bound = scan_bound(64, L, DG, 2, sfu_rate)
        fwd_k += nblk * ms_k
        fwd_p += nblk * ms_p
        fwd_bound += nblk * bound["bound_ms"]
        bound_terms[bound["bound_by"]] += nblk * bound["bound_ms"]
        shapes.append({"B": 64, "G": 4, "L": L, "DG": DG, "dtype": "bf16",
                       "launches_per_forward": nblk, "ms": ms_k, "plain_ms": ms_p,
                       **bound, "max_rel_err": rel})
    say(json.dumps({"selective_scan_fwd_shapes": shapes, "card": card}))

    # 4. serving
    gen = torch.Generator().manual_seed(0)
    model, fns, meta = make_serving_fns(
        "medmamba", precision="amp", image_size=224, device="cuda", generator=gen)
    classify = fns["classify"]
    plain_model = build_classifier("medmamba", dtype=torch.bfloat16, scan_impl="plain")
    plain_model.load_state_dict(model.state_dict())
    plain_model = plain_model.to("cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"serving: medmamba {n_params / 1e6:.2f} M parameters, staging "
        f"{meta['staging_size']}, image {meta['image_size']}, precision {meta['precision']}")

    rs = np.random.RandomState(0)
    S = meta["staging_size"]
    requests = [rs.randint(0, 256, (1, S, S, 3), dtype=np.uint8) for _ in range(16)]
    classify(model, requests[0])  # first call: cuDNN/cuBLAS set-up, not counted
    torch.cuda.synchronize()
    answers = [None] * 16
    errors = []
    barrier = threading.Barrier(16)

    def client(i):
        try:
            barrier.wait(timeout=60)
            answers[i] = mb(requests[i])
        except Exception as e:  # reported below; the phase fails
            errors.append(f"request {i}: {e!r}")

    selective_scan_fwd.launches = 0
    mb = MicroBatcher(lambda x: classify(model, x), max_batch=16, max_delay_ms=100.0)
    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    mb.close()
    wall = time.time() - t0
    launches = selective_scan_fwd.launches
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving: {errors or 'a request did not finish'}")
    say(f"serving: {mb.requests} requests in {mb.batches} batches "
        f"(padded rows {mb.batch_rows}) in {wall:.3f} s; selective_scan_fwd launches {launches}")
    for i, a in enumerate(answers):
        if a is None or a.shape != (1, 2) or not np.isfinite(a).all():
            fail(f"answer {i} is {a!r}")
        if abs(float(a.sum()) - 1.0) > 1e-5:
            fail(f"answer {i} sums to {float(a.sum())}")
    if mb.requests != 16:
        fail(f"MicroBatcher answered {mb.requests} of 16 requests")
    if launches != 14 * mb.batches:
        fail(f"{launches} kernel launches for {mb.batches} batches, expected 14 each")
    batch = np.concatenate(requests)
    got = np.concatenate(answers)
    want = classify(plain_model, batch).cpu().numpy()
    diff = float(np.abs(got - want).max())
    say(f"serving: max |probs(kernel) - probs(plain scan)| = {diff:.3e} "
        f"(bound {PROBS_ATOL:g}: bf16 activations around an fp32 scan)")
    if diff > PROBS_ATOL:
        fail(f"serving probabilities differ from the plain scan by {diff:.3e}")

    # At random init the SS2D branches move the probabilities by a few 1e-3
    # at most, so the check above cannot see a wrong scan. Hold each of the
    # 14 scans of one forward of the served batch, on its own inputs,
    # against the plain loop.
    calls = []
    scan = vssm.selective_scan_tm

    def recording_scan(*args, **kw):
        y = scan(*args, **kw)
        calls.append((args, kw, y))
        return y

    vssm.selective_scan_tm = recording_scan
    try:
        classify(model, batch)
    finally:
        vssm.selective_scan_tm = scan
    if len(calls) != 14:
        fail(f"one forward made {len(calls)} scan calls, expected 14")
    for args, kw, y_k in calls:
        with torch.inference_mode():
            y_p = scan(*args, **{**kw, "impl": "plain"})
        abs_err = float((y_k - y_p).abs().max())
        rel = abs_err / float(y_p.abs().max())
        Bsz, G, L, DG = args[0].shape
        say(f"serving scan B={Bsz} L={L} DG={DG} {args[0].dtype}: rel_err {rel:.3e} "
            f"abs_err {abs_err:.3e} {'ok' if rel <= GATE_REL else 'FAIL'}")
        if not rel <= GATE_REL:
            fail(f"selective_scan_fwd disagrees with the plain scan on the served "
                 f"batch's inputs: rel err {rel:.3e}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)

    x64 = torch.from_numpy(rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda()
    iters = 10
    classify(model, x64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = classify(model, x64)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    if out.shape != (64, 2) or not torch.isfinite(out).all():
        fail("classify at batch 64 gave a bad result")
    say(f"serving: classify bs 64 on device-resident uint8: {dt * 1e3:.2f} ms/batch, "
        f"{64 / dt:.1f} img/s on {card}")

    # 5. kernels line, then the device line
    say(json.dumps({"kernels": [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "src/mamba_clip_tpu/ops/selective_scan.py:194",
        "launches": launches,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": fwd_k,
        "plain_ms": fwd_p,
        "bound_ms": fwd_bound,
        "bound_by": max(bound_terms, key=bound_terms.get),
        "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
