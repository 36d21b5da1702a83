#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX. Phases, each of which exits non-zero
on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the four CUDA sources (five kernels) from ``csrc/``, one
   nvcc each, started together, and prints ptxas' registers and spills;
3. kernel against plain: ``selective_scan_fwd`` against the plain loop on
   the card at the medmamba stage shapes (batch 2), a ragged shape, fp32
   and bf16, softplus on and off; gate: max|y_k - y_p| / max|y_p| <= 5e-4,
   and the same gate on the chunk-entry states ``hck`` the forward writes
   for training. Then both are timed at the serving batch 64 beside the
   kernel's bound;
4. serving: the full-width medmamba ``classify`` (image 224, staging 256,
   bf16 compute, random weights from seed 0) answers 16 concurrent requests
   through ``MicroBatcher``; the answers are checked, the launch counters
   must show 14 forward launches per dispatched batch and no backward
   launch, the same batch through the plain scan must agree, and each of
   the 14 scans of one forward of that batch must agree with the plain
   loop on its own inputs; then classify is timed at batch 64;
5. backward kernel against plain: ``selective_scan_bwd`` against
   ``_scan_tm_plain_bwd`` at the shapes of phase 3; gate: each of the 7
   gradients at max|g_k - g_p| / max|g_p| <= 5e-4. Then the forward (with
   ``hck``) and the backward are timed at batch 64, bf16, beside the
   backward's bound;
6. training: the stage-2 CE train step of full-width medmamba (``amp``,
   AdamW at the config defaults, cosine schedule) on device-resident uint8
   batches: 2 warm-up and 5 timed steps at batch 64 with finite loss and
   grad norm and exactly 14 forward and 14 backward launches per step;
   the 14 scans of one more step recorded with their dy, each backward
   held against the plain backward on its own inputs at 5e-4; then, at
   batch 8, 2 steps with the kernels against 2 steps with the plain scans
   from the same state (loss and grad norm within one bf16 ulp, 2^-8,
   relative). Prints ms per step, train img/s, peak device memory and the
   scan kernels' ms per step;
7. flash kernel against plain: ``flash_attn_fwd`` against the plain
   (einsum) interior at h = 12, hd = 64, batch 2: T = 197 unmasked; T = 256
   with a prefix, a non-prefix, a one-key and an all-masked key row; the
   trimmed text context 224; a ragged 77; and hd 32 and 128; fp32 and bf16;
   gate max|o_k - o_p| / max|o_p| <= 5e-4 (fp32) and 2e-2 (bf16), and the
   all-masked row must be the mean of v. Then, at batch 64 in bf16, the
   kernel, the plain interior and ``F.scaled_dot_product_attention`` (the
   library yardstick, never on the path) are timed at the ViT shape
   (T 197) and the BERT shape (T 256, masks of tokenized report-like text)
   beside the bound;
8. CLIP serving: full-width BiomedCLIP (ViT-B/16 + the 12-layer BERT, bf16
   compute, ``attn_impl="flash"``, random weights from seed 0) answers 16
   concurrent ``image_embed`` and 16 concurrent ``text_embed`` requests
   through two ``MicroBatcher``s; the embeddings must be finite unit
   vectors, the counters must show 12 flash launches per dispatched batch
   and no scan launch, and the ``attn_impl="einsum"`` model on the same
   weights must agree within 2e-2; the 24 interiors of one image and one
   text forward are each held against the plain interior at the bf16
   gate; the VSSM-towered CLIP's ``image_embed`` must make 14 scan
   launches and no flash launch, its ``text_embed`` 12 flash launches;
   then image/s and texts/s at batch 64, flash and einsum;
9. flash backward kernels against plain: ``flash_attn_bwd_dq`` and
   ``flash_attn_bwd_dkv`` against ``attention_plain_bwd`` at the shapes of
   phase 7 (the one-key and the all-masked row beside a non-prefix row,
   since their own dq and dk vanish), each gradient at
   max|g_k - g_p| / max|g_p| <= 5e-4 (fp32) and 2e-2 (bf16: the plain
   backward rounds p, dp and ds to bf16, the kernels keep fp32 and round
   dq, dk, dv once; in bf16 each case is held against the bf16 plain
   backward, a row with one valid key left out because its dq and dk vanish
   and the bf16 plain backward leaves rounding noise there, and against the
   fp32 plain backward on the same inputs, every row); the forward's
   residuals m and l against the plain ones at 5e-4; dk and dv of a masked key exactly 0 from every row that has a valid
   key, dq and dk exactly 0 for a row with none; two runs bit-identical.
   Then, at batch 64 in bf16 at the ViT and BERT shapes, the forward with
   residuals and both backward kernels are timed beside their bounds, the
   plain backward and the backward of ``F.scaled_dot_product_attention``;
10. CLIP training: the stage-1 contrastive step of full-width BiomedCLIP
   (``amp``, ``attn_impl="flash"``, batch 64, device-resident uint8 images
   at staging 256, HashTokenizer tokens of report-like text, AdamW with
   clipping at 1.0): 2 warm-up and 5 timed steps with finite loss and grad
   norm, the first loss within [3, 6] (ln 64 = 4.16 at random init),
   ``logit_scale`` within [1, 100], exactly 24 forward, 24 dk/dv and 24 dq
   launches a step and no scan launch; the 24 interiors of one more step
   recorded with their ``do``, each backward held against the fp32 plain
   backward on its own bf16 inputs and kept result at the bf16 gate (the
   bf16 plain backward, which recomputes the result, is printed beside it:
   where a row's keys are nearly alike, dq is a small remainder of terms
   that cancel and one bf16 rounding of rowsum(o * do) is of its size);
   the same step with ``attn_impl="einsum"`` for its time and peak memory.
   At batch 8: 2 steps
   with the kernels against 2 steps with the plain interiors from the same
   state (loss and grad norm within 2^-7 relative, two bf16 ulps: the plain
   backward rounds p, dp and ds to bf16 where the kernels keep fp32, and an
   optimizer step carries the difference on); one step with
   ``accum_freq=2`` and ``grad_checkpointing``
   (144 forward launches: 2 micro-batches x 24 in the no-grad bank pass, and
   x 24 x 2 in the graded pass, whose checkpoints run each forward again;
   48 dk/dv and 48 dq); one step of the ``medmamba`` CLIP (14 + 14 scan
   launches, 12 + 12 + 12 flash launches). Prints ms per step, pairs/s,
   peak memory with flash and with einsum, and the flash kernels' ms per
   step;
11. prints the kernels line, then the device line last.

Phases 1-8 run at the depth and iteration counts they had before phases
9-10 were added.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

GATE_REL = 5e-4          # the gate bench.py put on the Pallas kernel
PROBS_ATOL = 2e-2        # kernel vs plain scan, end to end, bf16 activations
TRAIN_REL = 2.0**-8      # kernel vs plain scan, train step loss and grad norm: one bf16 ulp
# flash kernel vs plain interior: fp32 as GATE_REL; bf16 also covers the plain
# interior rounding the scores and the normalized probabilities to bf16
ATTN_GATE = {"fp32": GATE_REL, "bf16": 2e-2}
# the sources under csrc/; flash_attn_bwd holds the dk/dv and the dq kernel
KERNELS = ("selective_scan_fwd", "selective_scan_bwd", "flash_attn_fwd", "flash_attn_bwd")
CLIP_TRAIN_REL = 2.0**-7  # kernel vs plain interiors, CLIP train step loss and grad norm
GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989.4e12  # dense bf16 tensor-core peak
SFU_OPS_PER_CLK_SM = 16  # exp2 throughput per SM per clock, compute capability 9.0
STAGES = [(3136, 64), (784, 128), (196, 256), (49, 512)]  # (L, DG) per medmamba stage
BLOCKS_PER_STAGE = [2, 2, 8, 2]
REPORTS = [
    "Dermoscopy of a pigmented lesion on the upper back of a 45 year old male.",
    "Lesion: left forearm, diameter 6.2 mm; border irregular, two colours, asymmetric. "
    "History of melanoma in the family; atypical network, blue-white veil, regression "
    "structures and dotted vessels; no ulceration; follow-up in 3 months advised.",
    "Benign-appearing nevus.",
    "Female, 71. Scalp. Ulcerated nodule, 11 mm, rapid growth over 3 months. ",
]


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


def bound_of(terms, sfu_rate):
    """Bound in ms from byte, FLOP and exp counts, and what bounds it."""
    t_bytes = terms["bytes"] / HBM_BYTES_PER_S
    t_ops = max(terms["flops"] / FP32_FLOPS, terms["exps"] / sfu_rate)
    terms.update(bytes_ms=1e3 * t_bytes, flops_ms=1e3 * terms["flops"] / FP32_FLOPS,
                 exps_ms=1e3 * terms["exps"] / sfu_rate,
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return terms


def scan_bwd_bound(Bsz, L, DG, itemsize, sfu_rate, G=4, N=16):
    """Least time for one backward scan. Bytes: u, delta, B, C read in
    their type, dy and hck (the state at every 16th step) in fp32, A, D and
    bias; ddelta, du, dB, dC, dA, dD and dbias written once in fp32. FLOPs
    per channel-step and state: 18 (recompute a and h: 4; dC: 1; g and its
    carry: 3; dB: 1; ddu: 2; the dA and ddt terms: 7), plus 10 per
    channel-step. Exps: a per state, and softplus (exp, log) and sigmoid
    once per channel-step."""
    E = Bsz * G * L * DG
    BC = Bsz * G * L * N
    hck = Bsz * G * (-(-L // 16)) * DG * N
    return bound_of({
        "bytes": (2 * E * itemsize + 2 * BC * itemsize + 4 * E + 4 * hck
                  + G * DG * (N + 2) * 4
                  + 8 * E + 2 * BC * 4 + G * DG * (N + 2) * 4),
        "flops": 18 * E * N + 10 * E,
        "exps": E * (N + 3),
    }, sfu_rate)


def scan_bound(Bsz, L, DG, itemsize, sfu_rate, G=4, N=16):
    """Least time for one forward scan: the bytes it must move (each input
    read once, y written once) over the HBM rate, against its fp32 FLOPs
    and its exps over their peaks. Returns the terms, the bound in ms and
    what bounds it."""
    from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_flops

    E = Bsz * G * L * DG
    return bound_of({
        "bytes": (2 * E * itemsize + 4 * E + 2 * Bsz * G * L * N * itemsize
                  + G * DG * (N + 2) * 4),
        "flops": selective_scan_flops(Bsz, G * DG, L, N),
        "exps": E * N,
    }, sfu_rate)


def attn_bound(Bsz, T, h, hd, itemsize, masked, sfu_rate, tensors=4, stats=0, products=2):
    """Least time for one attention kernel: ``tensors`` arrays of
    B*T*h*hd elements and ``stats`` fp32 arrays of B*h*T moved once (and the
    mask byte per key) over the HBM rate; ``products`` T x T x hd matrix
    products per (batch, head), 2*B*h*T^2*hd FLOPs each, over the bf16
    tensor-core peak; B*h*T^2 exps over the exp rate. The bound is the
    largest of the three. The forward (the defaults) reads q, k, v, writes o
    and takes q.k^T and p.v; dk/dv reads q, k, v, do, m, l, di, writes dk, dv
    and takes 4 products; dq reads the same, writes dq and takes 3."""
    terms = {"bytes": (tensors * Bsz * T * h * hd * itemsize + stats * Bsz * h * T * 4
                       + (Bsz * T if masked else 0)),
             "flops": products * 2 * Bsz * h * T * T * hd, "exps": Bsz * h * T * T}
    times = {"bytes": terms["bytes"] / HBM_BYTES_PER_S,
             "flops": terms["flops"] / BF16_TC_FLOPS, "exps": terms["exps"] / sfu_rate}
    worst = max(times, key=times.get)
    terms.update({f"{k}_ms": 1e3 * t for k, t in times.items()},
                 bound_ms=1e3 * times[worst],
                 bound_by="bytes" if worst == "bytes" else "operations")
    return terms


def rel_errs(got, want):
    """max|g - w| / max|w| and max|g - w| of each pair."""
    out = []
    for g, w in zip(got, want):
        abs_err = float((g.float() - w.float()).abs().max())
        out.append((abs_err / max(float(w.float().abs().max()), 1e-30), abs_err))
    return out


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
    import torch.nn.functional as F

    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer
    from mamba_clip_tpu_torch.models import vit as vit_mod
    from mamba_clip_tpu_torch.ops import cuda_build
    from mamba_clip_tpu_torch.models import build_clip
    from mamba_clip_tpu_torch.ops.flash_attn import (
        attention_plain, attention_plain_bwd, flash_attention_interior, flash_attn_bwd_dkv,
        flash_attn_bwd_dq, flash_attn_fwd)
    from mamba_clip_tpu_torch.profile_embed import report_tokens
    from mamba_clip_tpu_torch.ops.selective_scan import (
        _scan_tm_plain, _scan_tm_plain_bwd, selective_scan_bwd, selective_scan_fwd,
        selective_scan_tm)
    from mamba_clip_tpu_torch.serve import MicroBatcher
    from mamba_clip_tpu_torch.serving import make_serving_fns
    from mamba_clip_tpu_torch.models import build_classifier, vssm
    from mamba_clip_tpu_torch.profile_train import clip_train_setup, medmamba_train_setup

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

    # 2. build: one nvcc per source, all started together
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for f in [pool.submit(cuda_build.build, k) for k in KERNELS]:
            f.result()
    for k in KERNELS:
        cuda_build.load(k)
    say(f"build: {', '.join(KERNELS)} in {time.time() - t0:.1f} s")
    for k in KERNELS:
        say(f"  {cuda_build.library_path(k).name}")
        for line in cuda_build.build_logs.get(k, "").splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {k}: {line.strip()}")

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
        with torch.enable_grad():  # the training forward: y and hck
            full = [t if t is not None else torch.zeros(args[2].shape[0], device="cuda")
                    for t in args]
            _, hck_k = selective_scan_fwd(*full, softplus, with_hck=True)
            _, hck_p = _scan_tm_plain(*full, softplus, return_hck=True)
            torch.cuda.synchronize()
        (rel_h, abs_h), = rel_errs([hck_k], [hck_p])
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = rel <= GATE_REL and rel_h <= GATE_REL
        say(f"scan B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            f"rel_err {rel:.3e} abs_err {abs_err:.3e} hck rel_err {rel_h:.3e} "
            f"kernel {ms_k:.4f} ms plain {ms_p:.3f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"selective_scan_fwd disagrees with the plain scan: rel err {rel:.3e}, "
                 f"hck rel err {rel_h:.3e}")
        return max(rel, rel_h), max(abs_err, abs_h), ms_k, ms_p

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

    selective_scan_fwd.launches = selective_scan_bwd.launches = 0
    mb = MicroBatcher(lambda x: classify(model, x), max_batch=16, max_delay_ms=100.0)
    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    mb.close()
    wall = time.time() - t0
    launches, serve_bwd = selective_scan_fwd.launches, selective_scan_bwd.launches
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
    if launches != 14 * mb.batches or serve_bwd != 0:
        fail(f"{launches} forward and {serve_bwd} backward launches for {mb.batches} "
             "batches, expected 14 forward and no backward each")
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

    # 5. backward kernel against plain
    def bwd_args(Bsz, L, DG, dtype, softplus, seed=0):
        u, delta, A, B, C, D, bias = scan_inputs(Bsz, L, DG, dtype, softplus, seed)
        zeros = torch.zeros(A.shape[0], device="cuda")
        args = (u, delta, A, B, C, zeros if D is None else D, zeros if bias is None else bias)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        dy = torch.randn(u.shape, generator=g, device="cuda")
        return args, dy

    def compare_bwd(Bsz, L, DG, dtype, softplus, seed=0):
        args, dy = bwd_args(Bsz, L, DG, dtype, softplus, seed)
        _, hck = selective_scan_fwd(*args, softplus, with_hck=True)
        g_k = selective_scan_bwd(*args, softplus, dy, hck)
        _, hck_p = _scan_tm_plain(*args, softplus, return_hck=True)
        g_p = _scan_tm_plain_bwd(*args, softplus, dy, hck_p)
        torch.cuda.synchronize()
        errs = rel_errs(g_k, g_p)
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = all(r <= GATE_REL for r, _ in errs)
        say(f"scan bwd B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(GRAD_NAMES, errs))
            + (" ok" if ok else " FAIL"))
        if not ok:
            fail("selective_scan_bwd disagrees with the plain backward")
        return max(r for r, _ in errs), max(a for _, a in errs)

    bwd_rel = bwd_abs = 0.0
    for L, DG in STAGES + [(300, 24)]:
        for dtype in (torch.float32, torch.bfloat16):
            r, a = compare_bwd(2, L, DG, dtype, True)
            bwd_rel, bwd_abs = max(bwd_rel, r), max(bwd_abs, a)
    for dtype in (torch.float32, torch.bfloat16):
        r, a = compare_bwd(2, 300, 24, dtype, False)
        bwd_rel, bwd_abs = max(bwd_rel, r), max(bwd_abs, a)

    # at the training batch (64) and type (bf16): one step = 14 launches each
    fwd_hck_step = bwd_k_step = bwd_p_step = bwd_bound_step = 0.0
    bwd_terms = {"bytes": 0.0, "operations": 0.0}
    bwd_shapes = []
    for (L, DG), nblk in zip(STAGES, BLOCKS_PER_STAGE):
        args, dy = bwd_args(64, L, DG, torch.bfloat16, True)
        _, hck = selective_scan_fwd(*args, True, with_hck=True)
        ms_f = cuda_ms(lambda: selective_scan_fwd(*args, True, with_hck=True), 10)
        ms_b = cuda_ms(lambda: selective_scan_bwd(*args, True, dy, hck), 10)
        ms_bp = cuda_ms(lambda: _scan_tm_plain_bwd(*args, True, dy, hck), 1, warmup=0)
        bound = scan_bwd_bound(64, L, DG, 2, sfu_rate)
        fwd_hck_step += nblk * ms_f
        bwd_k_step += nblk * ms_b
        bwd_p_step += nblk * ms_bp
        bwd_bound_step += nblk * bound["bound_ms"]
        bwd_terms[bound["bound_by"]] += nblk * bound["bound_ms"]
        bwd_shapes.append({"B": 64, "G": 4, "L": L, "DG": DG, "dtype": "bf16",
                           "launches_per_step": nblk, "fwd_with_hck_ms": ms_f,
                           "hck_bytes": 64 * 4 * (-(-L // 16)) * DG * 16 * 4,
                           "ms": ms_b, "plain_ms": ms_bp, **bound})
        say(f"scan bwd B=64 L={L} DG={DG} bf16: kernel {ms_b:.4f} ms, forward with hck "
            f"{ms_f:.4f} ms, plain backward {ms_bp:.2f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']})")
    say(json.dumps({"selective_scan_bwd_shapes": bwd_shapes, "card": card}))

    # 6. training: the stage-2 CE step of full-width medmamba at batch 64
    TB, WARM, TIMED = 64, 2, 5
    state, step_fn, batches = medmamba_train_setup(TB)
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"training: medmamba {n_params / 1e6:.2f} M parameters, batch {TB}, image 224, "
        f"staging 256, precision amp, AdamW, cosine schedule")

    def check_metrics(m, what):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"{what}: loss {loss} grad_norm {gnorm}")
        return loss, gnorm

    selective_scan_fwd.launches = selective_scan_bwd.launches = 0
    for i in range(WARM):
        state, m = step_fn(state, batches[i % 2], 0)
        say(f"training: warm-up step {i}: loss {check_metrics(m, 'warm-up')[0]:.5f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = []
    for i in range(TIMED):
        state, m = step_fn(state, batches[i % 2], 0)
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TIMED * 1e3
    train_fwd, train_bwd = selective_scan_fwd.launches, selective_scan_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        loss, gnorm = check_metrics(m, f"timed step {i}")
        say(f"training: step {WARM + i}: loss {loss:.5f} grad_norm {gnorm:.5f} lr {m['lr']:.3e}")
    steps = WARM + TIMED
    say(f"training: selective_scan_fwd launches {train_fwd}, selective_scan_bwd launches "
        f"{train_bwd} in {steps} steps")
    if train_fwd != 14 * steps or train_bwd != 14 * steps:
        fail(f"{train_fwd} forward and {train_bwd} backward launches in {steps} steps, "
             "expected 14 of each per step")

    # The loss cannot see a wrong scan (PERF.md, Findings): record the
    # 14 scans of one step with their dy and hold each backward against the
    # plain backward on its own inputs.
    calls = []
    scan = vssm.selective_scan_tm

    def recording_scan(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=False,
                       impl=None):
        y = scan(u, delta, A, B, C, D, delta_bias, delta_softplus, impl)
        rec = {"args": [t.detach().contiguous() for t in (u, delta, A, B, C, D, delta_bias)],
               "softplus": delta_softplus}
        y.register_hook(lambda g: rec.update(dy=g.detach().float().contiguous()))
        calls.append(rec)
        return y

    vssm.selective_scan_tm = recording_scan
    try:
        state, m = step_fn(state, batches[0], 0)
    finally:
        vssm.selective_scan_tm = scan
    check_metrics(m, "recorded step")
    if len(calls) != 14 or any("dy" not in c for c in calls):
        fail(f"one step made {len(calls)} scan calls with "
             f"{sum('dy' in c for c in calls)} gradients, expected 14")
    rec_rel = 0.0
    for c in calls:
        u, delta, A, B, C, D, bias = c["args"]
        args = (u, delta, A.float().contiguous(), B, C, D.float(), bias.float())
        _, hck = selective_scan_fwd(*args, c["softplus"], with_hck=True)
        g_k = selective_scan_bwd(*args, c["softplus"], c["dy"], hck)
        _, hck_p = _scan_tm_plain(*args, c["softplus"], return_hck=True)
        g_p = _scan_tm_plain_bwd(*args, c["softplus"], c["dy"], hck_p)
        errs = rel_errs(g_k, g_p)
        worst = max(r for r, _ in errs)
        say(f"training scan B={u.shape[0]} L={u.shape[2]} DG={u.shape[3]} {u.dtype}: "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(GRAD_NAMES, errs))
            + (" ok" if worst <= GATE_REL else " FAIL"))
        if not worst <= GATE_REL:
            fail("selective_scan_bwd disagrees with the plain backward on a train "
                 f"step's own inputs: rel err {worst:.3e}")
        rec_rel = max(rec_rel, worst)
        bwd_abs = max(bwd_abs, max(a for _, a in errs))
    bwd_rel = max(bwd_rel, rec_rel)
    del calls

    # kernels against plain scans end to end: 2 steps at batch 8 from one state
    init = {k: v.clone() for k, v in build_classifier(
        "medmamba", dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(1)).state_dict().items()}
    runs = {}
    for impl in ("cuda", "plain"):
        st, fn, bs = medmamba_train_setup(8, scan_impl=impl, seed=1, model_state=init)
        runs[impl] = []
        for i in range(2):
            st, m = fn(st, bs[i], 0)
            runs[impl].append(check_metrics(m, f"batch-8 step with the {impl} scan"))
        del st, fn, bs
    e2e = 0.0
    for i, ((lk, gk), (lp, gp)) in enumerate(zip(runs["cuda"], runs["plain"])):
        rl, rg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        e2e = max(e2e, rl, rg)
        say(f"training bs 8 step {i}: loss kernel {lk:.6f} plain {lp:.6f} (rel {rl:.2e}); "
            f"grad_norm kernel {gk:.6f} plain {gp:.6f} (rel {rg:.2e})")
    if e2e > TRAIN_REL:
        fail(f"the train step with the kernels differs from the plain scans by {e2e:.3e} "
             f"relative (bound {TRAIN_REL:g}: one bf16 ulp)")
    say(json.dumps({"training": {
        "card": card, "batch": TB, "steps_timed": TIMED, "ms_per_step": step_ms,
        "train_img_per_s": TB / (step_ms / 1e3), "max_memory_allocated_bytes": peak,
        "scan_fwd_with_hck_ms_per_step": fwd_hck_step, "scan_bwd_ms_per_step": bwd_k_step,
        "scan_fwd_launches_per_step": train_fwd / steps,
        "scan_bwd_launches_per_step": train_bwd / steps,
        "recorded_scans_max_rel_err": rec_rel, "bs8_kernel_vs_plain_max_rel": e2e}}))
    say(f"training: {step_ms:.2f} ms/step, {TB / (step_ms / 1e3):.1f} train img/s, peak "
        f"{peak / 2**30:.2f} GiB allocated; scan forward {fwd_hck_step:.3f} ms and backward "
        f"{bwd_k_step:.3f} ms per step, on {card}")

    # 7. flash kernel against plain
    def attn_inputs(Bsz, T, h, hd, dtype, valid=None, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(Bsz, T, h, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        mask = None if valid is None else torch.as_tensor(valid, device="cuda")[:, None, None, :]
        return q, k, v, mask

    def rows(T, *kinds, seed=0):
        """A [len(kinds), T] key mask: ``prefix:n`` keeps the first n keys,
        ``holes`` drops about 40% of the keys at random (the first kept),
        ``one`` keeps key 0 only, ``none`` masks every key."""
        rs = np.random.RandomState(seed)
        out = np.ones((len(kinds), T), bool)
        for i, kind in enumerate(kinds):
            if kind.startswith("prefix:"):
                out[i, int(kind[7:]):] = False
            elif kind == "holes":
                out[i] = rs.rand(T) < 0.6
                out[i, 0] = True
            elif kind == "one":
                out[i, 1:] = False
            elif kind == "none":
                out[i] = False
        return out

    attn_worst = {"fp32": 0.0, "bf16": 0.0}
    attn_abs = 0.0
    cases = [
        (197, 12, 64, None, "ViT, no mask"),
        (256, 12, 64, rows(256, "prefix:180", "holes", seed=1), "prefix + non-prefix"),
        (256, 12, 64, rows(256, "one", "none"), "one valid key + all masked"),
        (224, 12, 64, HashTokenizer(context_length=224)(REPORTS[:2]) != HashTokenizer.PAD,
         "trimmed text context"),
        (77, 12, 64, rows(77, "prefix:50", "holes", seed=2), "ragged"),
        (77, 4, 32, rows(77, "holes", "none", seed=3), "hd 32"),
        (77, 2, 128, rows(77, "prefix:9", "none"), "hd 128"),
    ]
    for T, h, hd, valid, label in cases:
        for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q, k, v, mask = attn_inputs(2, T, h, hd, dtype, valid, seed=T + hd)
            with torch.inference_mode():
                o_k = flash_attention_interior(q, k, v, mask, sm_scale=hd**-0.5, impl="cuda")
                o_p = attention_plain(q, k, v, mask, sm_scale=hd**-0.5)
            torch.cuda.synchronize()
            (rel, abs_err), = rel_errs([o_k], [o_p])
            ok = bool(torch.isfinite(o_k).all()) and rel <= ATTN_GATE[name]
            if valid is not None and not valid[1].any():  # the all-masked row: the mean of v
                (rel_m, _), = rel_errs([o_k[1]], [v[1].float().mean(0).reshape(1, -1)])
                ok = ok and rel_m <= ATTN_GATE[name]
            say(f"flash B=2 T={T} h={h} hd={hd} {name} ({label}): rel_err {rel:.3e} "
                f"abs_err {abs_err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash_attn_fwd disagrees with the plain interior at T={T} hd={hd} {name}")
            attn_worst[name] = max(attn_worst[name], rel)
            attn_abs = max(attn_abs, abs_err)

    # at the serving batch (64) and type (bf16): the ViT and BERT shapes
    attn_shapes = {}
    for tower, T, valid in (("vit", 197, None),
                            ("bert", 256, report_tokens(64) != HashTokenizer.PAD)):
        q, k, v, mask = attn_inputs(64, T, 12, 64, torch.bfloat16, valid, seed=5)
        sm = 64**-0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with torch.inference_mode():
            o_k = flash_attention_interior(q, k, v, mask, sm_scale=sm, impl="cuda")
            o_p = attention_plain(q, k, v, mask, sm_scale=sm)
            (rel, abs_err), = rel_errs([o_k], [o_p])
            ms_k = cuda_ms(lambda: flash_attention_interior(q, k, v, mask, sm_scale=sm,
                                                            impl="cuda"), 20)
            ms_p = cuda_ms(lambda: attention_plain(q, k, v, mask, sm_scale=sm), 20)
            ms_l = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=sm), 20)
        if rel > ATTN_GATE["bf16"]:
            fail(f"flash_attn_fwd disagrees with the plain interior at the {tower} shape")
        attn_worst["bf16"] = max(attn_worst["bf16"], rel)
        attn_abs = max(attn_abs, abs_err)
        bound = attn_bound(64, T, 12, 64, 2, valid is not None, sfu_rate)
        attn_shapes[tower] = {"B": 64, "T": T, "h": 12, "hd": 64, "dtype": "bf16",
                              "masked": valid is not None, "launches_per_forward": 12,
                              "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l, **bound,
                              "max_rel_err": rel}
        say(f"flash B=64 T={T} bf16 ({tower}): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
            f"scaled_dot_product_attention {ms_l:.4f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}), rel_err {rel:.3e}")
        del q, k, v, qt, kt, vt, o_k, o_p
    say(json.dumps({"flash_attn_fwd_shapes": attn_shapes, "card": card}))

    # 8. CLIP serving at full width
    clip, cfns, cmeta = make_serving_fns(
        "biomedclip", is_clip=True, attn_impl="flash", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(0))
    clip_e, efns, _ = make_serving_fns(
        "biomedclip", is_clip=True, attn_impl="einsum", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(1))
    clip_e.load_state_dict(clip.state_dict())
    n_params = sum(p.numel() for p in clip.parameters())
    say(f"clip serving: biomedclip {n_params / 1e6:.2f} M parameters, image "
        f"{cmeta['image_size']}, staging {cmeta['staging_size']}, context "
        f"{cmeta['context_length']}, precision {cmeta['precision']}, attn_impl flash")
    S = cmeta["staging_size"]
    c_req = {"image_embed": [rs.randint(0, 256, (1, S, S, 3), dtype=np.uint8)
                             for _ in range(16)],
             "text_embed": list(HashTokenizer(context_length=cmeta["context_length"])(
                 [REPORTS[i % len(REPORTS)] * (1 + i % 5) for i in range(16)])[:, None])}
    for name, reqs in c_req.items():  # first calls: cuBLAS set-up, not counted
        cfns[name](clip, reqs[0])
        efns[name](clip_e, reqs[0])
    torch.cuda.synchronize()
    c_ans = {name: [None] * 16 for name in c_req}
    errors = []
    barrier = threading.Barrier(32)

    def clip_client(name, i):
        try:
            barrier.wait(timeout=60)
            c_ans[name][i] = batchers[name](c_req[name][i])
        except Exception as e:  # reported below; the phase fails
            errors.append(f"{name} request {i}: {e!r}")

    selective_scan_fwd.launches = selective_scan_bwd.launches = flash_attn_fwd.launches = 0
    batchers = {name: MicroBatcher(lambda x, f=cfns[name]: f(clip, x), max_batch=16,
                                   max_delay_ms=100.0) for name in c_req}
    t0 = time.time()
    threads = [threading.Thread(target=clip_client, args=(name, i))
               for name in c_req for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for mb in batchers.values():
        mb.close()
    wall = time.time() - t0
    clip_flash = flash_attn_fwd.launches
    clip_scans = selective_scan_fwd.launches + selective_scan_bwd.launches
    if errors or any(t.is_alive() for t in threads):
        fail(f"clip serving: {errors or 'a request did not finish'}")
    n_batches = sum(mb.batches for mb in batchers.values())
    say(f"clip serving: {sum(mb.requests for mb in batchers.values())} requests in "
        f"{n_batches} batches (image rows {batchers['image_embed'].batch_rows}, text rows "
        f"{batchers['text_embed'].batch_rows}) in {wall:.3f} s; flash_attn_fwd launches "
        f"{clip_flash}, scan launches {clip_scans}")
    if any(mb.requests != 16 for mb in batchers.values()):
        fail("MicroBatcher did not answer every CLIP request")
    if clip_flash != 12 * n_batches or clip_scans != 0:
        fail(f"{clip_flash} flash and {clip_scans} scan launches for {n_batches} batches, "
             "expected 12 flash launches each and no scan")
    clip_diff = 0.0
    for name, reqs in c_req.items():
        got = np.concatenate(c_ans[name])
        norms = np.linalg.norm(got, axis=-1)
        if got.shape != (16, 512) or not np.isfinite(got).all() or \
                np.abs(norms - 1.0).max() > 1e-3:
            fail(f"{name}: shape {got.shape}, norms {norms.min():.5f}..{norms.max():.5f}")
        want = efns[name](clip_e, np.concatenate(reqs)).cpu().numpy()
        diff = float(np.abs(got - want).max())
        clip_diff = max(clip_diff, diff)
        say(f"clip serving: {name} norms {norms.min():.6f}..{norms.max():.6f}; max "
            f"|flash - einsum| = {diff:.3e} (bound {PROBS_ATOL:g})")
        if diff > PROBS_ATOL:
            fail(f"{name} with the flash kernel differs from einsum by {diff:.3e}")

    # Hold each of the 24 attention interiors of one image and one text
    # forward, on its own inputs, against the plain interior.
    calls = []
    interior = vit_mod.flash_attention_interior

    def recording_interior(q, k, v, pad_mask=None, *, sm_scale, impl=None):
        o = interior(q, k, v, pad_mask, sm_scale=sm_scale, impl=impl)
        calls.append((q, k, v, pad_mask, sm_scale, o))
        return o

    vit_mod.flash_attention_interior = recording_interior
    try:
        for name, reqs in c_req.items():
            cfns[name](clip, np.concatenate(reqs))
    finally:
        vit_mod.flash_attention_interior = interior
    if len(calls) != 24:
        fail(f"one image and one text forward made {len(calls)} attention calls, expected 24")
    rec_attn = 0.0
    for q, k, v, pad_mask, sm_scale, o_k in calls:
        with torch.inference_mode():
            o_p = attention_plain(q, k, v, pad_mask, sm_scale=sm_scale)
        (rel, abs_err), = rel_errs([o_k], [o_p])
        rec_attn = max(rec_attn, rel)
        attn_abs = max(attn_abs, abs_err)
        if not rel <= ATTN_GATE["bf16"]:
            fail(f"flash_attn_fwd disagrees with the plain interior on a served batch's "
                 f"inputs (T={q.shape[1]}): rel err {rel:.3e}")
    say(f"clip serving: the 24 recorded interiors (12 T={calls[0][0].shape[1]}, 12 "
        f"T={calls[-1][0].shape[1]}) agree with the plain interior: worst rel_err "
        f"{rec_attn:.3e} (gate {ATTN_GATE['bf16']:g})")
    attn_worst["bf16"] = max(attn_worst["bf16"], rec_attn)
    del calls

    # the VSSM-towered CLIP: its image tower runs the scan, its text tower flash
    mm_clip, mm_fns, _ = make_serving_fns(
        "medmamba", is_clip=True, attn_impl="flash", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(2))
    mm_launches = {}
    for name, reqs in c_req.items():
        selective_scan_fwd.launches = flash_attn_fwd.launches = 0
        out = mm_fns[name](mm_clip, np.concatenate(reqs))
        torch.cuda.synchronize()
        mm_launches[name] = {"scan": selective_scan_fwd.launches, "flash": flash_attn_fwd.launches}
        if out.shape != (16, 512) or not torch.isfinite(out).all():
            fail(f"medmamba CLIP {name} gave a bad result")
    say(f"clip serving: medmamba CLIP launches {mm_launches}")
    if mm_launches != {"image_embed": {"scan": 14, "flash": 0},
                       "text_embed": {"scan": 0, "flash": 12}}:
        fail("the VSSM-towered CLIP: expected 14 scan launches for image_embed and 12 "
             "flash launches for text_embed")
    del mm_clip

    # rows/s at batch 64 on device-resident input, flash and einsum
    x64 = {"image_embed": torch.from_numpy(
        rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda(),
        "text_embed": torch.from_numpy(report_tokens(64, cmeta["context_length"])).cuda()}
    clip_rates = {}
    for impl, fns_, model_ in (("flash", cfns, clip), ("einsum", efns, clip_e)):
        for name, x in x64.items():
            fns_[name](model_, x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                out = fns_[name](model_, x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 10
            if out.shape != (64, 512) or not torch.isfinite(out).all():
                fail(f"{name} ({impl}) at batch 64 gave a bad result")
            clip_rates[f"{name}_{impl}_ms"] = dt * 1e3
            clip_rates[f"{name}_{impl}_rows_per_s"] = 64 / dt
            say(f"clip serving: {name} bs 64 attn_impl={impl}: {dt * 1e3:.2f} ms/batch, "
                f"{64 / dt:.1f} {'img' if name == 'image_embed' else 'texts'}/s on {card}")
    say(json.dumps({"clip_serving": {"card": card, "parameters": n_params, **clip_rates,
                                     "flash_launches": clip_flash, "batches": n_batches,
                                     "max_abs_flash_vs_einsum": clip_diff,
                                     "recorded_interiors_max_rel_err": rec_attn,
                                     "medmamba_clip_launches": mm_launches}}))
    del clip, clip_e, cfns, efns, batchers

    # 9. flash backward kernels against the plain backward
    def plain_residuals(q, k, mask, sm):
        sc = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) * sm
        if mask is not None:
            sc = sc.masked_fill(~mask, -1e9)
        m_p = sc.max(-1).values
        return m_p, torch.exp(sc - m_p[..., None]).sum(-1)

    def flash_bwd_inputs(Bsz, T, h, hd, dtype, valid, seed):
        q, k, v, mask = attn_inputs(Bsz, T, h, hd, dtype, valid, seed=seed)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        do = torch.randn(Bsz, T, h * hd, generator=g, device="cuda").to(dtype)
        key_mask = None if mask is None else mask.reshape(Bsz, T).contiguous()
        return q, k, v, mask, key_mask, do

    def flash_bwd(q, k, v, key_mask, do, sm):
        """(dq, dk, dv) by the kernels, as ``FlashAttnFn`` calls them, the
        kernels' other inputs (mask, do, the forward's residuals, di) and the
        forward's result."""
        B_, T_, h_, hd_ = q.shape
        out, m, l = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm, with_residuals=True)
        di = (out.float() * do.float()).view(B_, T_, h_, hd_).sum(-1).transpose(1, 2).contiguous()
        res = (key_mask, do.view(B_, T_, h_, hd_), m, l, di)
        dk, dv = flash_attn_bwd_dkv(q, k, v, *res, sm_scale=sm)
        return (flash_attn_bwd_dq(q, k, v, *res, sm_scale=sm), dk, dv), res, out

    bwd_attn_worst = {"dq": {"fp32": 0.0, "bf16": 0.0}, "dkv": {"fp32": 0.0, "bf16": 0.0}}
    bwd_attn_abs = {"dq": 0.0, "dkv": 0.0}

    def note_bwd(errs, name):
        (r_q, a_q), (r_k, a_k), (r_v, a_v) = errs
        bwd_attn_worst["dq"][name] = max(bwd_attn_worst["dq"][name], r_q)
        bwd_attn_worst["dkv"][name] = max(bwd_attn_worst["dkv"][name], r_k, r_v)
        bwd_attn_abs["dq"] = max(bwd_attn_abs["dq"], a_q)
        bwd_attn_abs["dkv"] = max(bwd_attn_abs["dkv"], a_k, a_v)

    bwd_cases = [c if c[4] != "one valid key + all masked" else
                 (256, 12, 64, rows(256, "one", "none", "holes", seed=4),
                  "one valid key + all masked + non-prefix") for c in cases]
    for T, h, hd, valid, label in bwd_cases:
        Bsz = 2 if valid is None else len(valid)
        for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q, k, v, mask, key_mask, do = flash_bwd_inputs(Bsz, T, h, hd, dtype, valid, T + hd)
            sm = hd**-0.5
            g_k, res, _ = flash_bwd(q, k, v, key_mask, do, sm)
            g_k2, _, _ = flash_bwd(q, k, v, key_mask, do, sm)
            g_p = attention_plain_bwd(q, k, v, mask, do, sm)
            m_p, l_p = plain_residuals(q, k, mask, sm)
            torch.cuda.synchronize()
            errs = rel_errs(g_k, g_p)
            if name == "bf16":
                # A row with one valid key has ds = 0: its dq and dk vanish.
                # The bf16 plain backward rounds do.v to bf16 before it takes
                # di off, which leaves rounding noise there, so such rows are
                # left out against it; every row is also held against the fp32
                # plain backward on the same inputs, whose arithmetic is the
                # kernels'.
                if valid is not None:
                    keep = torch.as_tensor(valid.sum(1) != 1, device="cuda")
                    errs = rel_errs([g[keep] for g in g_k], [g[keep] for g in g_p])
                errs32 = rel_errs(g_k, attention_plain_bwd(q.float(), k.float(), v.float(), mask,
                                                           do.float(), sm))
                errs = [max(a, b) for a, b in zip(errs, errs32)]
            res_err = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
                          for a, b in ((res[2], m_p), (res[3], l_p)))
            same_bits = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
            zeros_ok = True
            if valid is not None:
                va = torch.as_tensor(valid, device="cuda")
                dead = ~va & va.any(1, keepdim=True)   # masked keys of rows with a valid key
                empty = ~va.any(1)                      # rows with no valid key
                zeros_ok = all(float(g[dead].abs().sum()) == 0.0 for g in g_k[1:]) and \
                    all(float(g[empty].abs().sum()) == 0.0 for g in g_k[:2])
            ok = (all(bool(torch.isfinite(g).all()) for g in g_k)
                  and all(r <= ATTN_GATE[name] for r, _ in errs)
                  and res_err <= GATE_REL and same_bits and zeros_ok)
            say(f"flash bwd B={Bsz} T={T} h={h} hd={hd} {name} ({label}): "
                + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs))
                + f" residuals {res_err:.2e} same_bits {same_bits} exact_zeros {zeros_ok}"
                + (" ok" if ok else " FAIL"))
            if not ok:
                fail(f"the flash backward kernels disagree with the plain backward at T={T} "
                     f"hd={hd} {name}")
            note_bwd(errs, name)

    # at the training batch (64) and type (bf16): the ViT and BERT shapes
    bwd_shapes_attn = {}
    for tower, T, valid in (("vit", 197, None),
                            ("bert", 256, report_tokens(64) != HashTokenizer.PAD)):
        q, k, v, mask, key_mask, do = flash_bwd_inputs(64, T, 12, 64, torch.bfloat16, valid, 5)
        sm = 64**-0.5
        g_k, res, _ = flash_bwd(q, k, v, key_mask, do, sm)
        errs = rel_errs(g_k, attention_plain_bwd(q, k, v, mask, do, sm))
        if any(r > ATTN_GATE["bf16"] for r, _ in errs):
            fail(f"the flash backward kernels disagree with the plain backward at the {tower} "
                 "shape")
        note_bwd(errs, "bf16")
        ms_f = cuda_ms(lambda: flash_attn_fwd(q, k, v, key_mask, sm_scale=sm,
                                              with_residuals=True), 20)
        ms_kv = cuda_ms(lambda: flash_attn_bwd_dkv(q, k, v, *res, sm_scale=sm), 20)
        ms_q = cuda_ms(lambda: flash_attn_bwd_dq(q, k, v, *res, sm_scale=sm), 20)
        ms_p = cuda_ms(lambda: attention_plain_bwd(q, k, v, mask, do, sm), 10)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        o_l = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sm)
        do_l = do.view(64, T, 12, 64).transpose(1, 2)
        ms_l = cuda_ms(lambda: torch.autograd.grad(o_l, (qt, kt, vt), do_l, retain_graph=True),
                       20)
        masked = valid is not None
        b_kv = attn_bound(64, T, 12, 64, 2, masked, sfu_rate, tensors=6, stats=3, products=4)
        b_q = attn_bound(64, T, 12, 64, 2, masked, sfu_rate, tensors=5, stats=3, products=3)
        bwd_shapes_attn[tower] = {
            "B": 64, "T": T, "h": 12, "hd": 64, "dtype": "bf16", "masked": masked,
            "launches_per_step": 12, "fwd_with_residuals_ms": ms_f,
            "dkv": {"ms": ms_kv, **b_kv}, "dq": {"ms": ms_q, **b_q},
            "plain_bwd_ms": ms_p, "library_bwd_ms": ms_l,
            "max_rel_err": max(r for r, _ in errs)}
        say(f"flash bwd B=64 T={T} bf16 ({tower}): dk/dv {ms_kv:.4f} ms (bound "
            f"{b_kv['bound_ms']:.4f}, {b_kv['bound_by']}), dq {ms_q:.4f} ms (bound "
            f"{b_q['bound_ms']:.4f}, {b_q['bound_by']}), forward with residuals {ms_f:.4f} ms, "
            f"plain backward {ms_p:.4f} ms, scaled_dot_product_attention backward "
            f"{ms_l:.4f} ms")
        del q, k, v, do, g_k, res, qt, kt, vt, o_l, do_l
    say(json.dumps({"flash_attn_bwd_shapes": bwd_shapes_attn, "card": card}))
    flash_ms_per_step = {
        "fwd": sum(12 * sh["fwd_with_residuals_ms"] for sh in bwd_shapes_attn.values()),
        "dkv": sum(12 * sh["dkv"]["ms"] for sh in bwd_shapes_attn.values()),
        "dq": sum(12 * sh["dq"]["ms"] for sh in bwd_shapes_attn.values())}

    # 10. CLIP training: the stage-1 contrastive step of full-width BiomedCLIP
    wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq,
                "scan_fwd": selective_scan_fwd, "scan_bwd": selective_scan_bwd}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {key: w.launches for key, w in wrappers.items()}

    def timed_clip_steps(state, step_fn, batches, what, warm=WARM, timed=TIMED):
        """``warm`` + ``timed`` steps; returns the state, ms per timed step,
        the peak memory of the timed steps and every step's metrics."""
        metrics = []
        for i in range(warm):
            state, m = step_fn(state, batches[i % 2], 0)
            metrics.append(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(timed):
            state, m = step_fn(state, batches[i % 2], 0)
            metrics.append(m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed * 1e3
        peak = torch.cuda.max_memory_allocated()
        for i, m in enumerate(metrics):
            loss, gnorm = check_metrics(m, f"{what} step {i}")
            ls_ = float(m["logit_scale"])
            say(f"clip training ({what}): step {i}: loss {loss:.5f} grad_norm {gnorm:.5f} "
                f"logit_scale {ls_:.4f} lr {m['lr']:.3e}")
            if not 1.0 <= ls_ <= 100.0:
                fail(f"{what}: logit_scale {ls_} outside [1, 100]")
        return state, ms, peak, metrics

    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    state, step_fn, batches = clip_train_setup(TB)
    n_clip = sum(p.numel() for p in state.model.parameters())
    say(f"clip training: biomedclip {n_clip / 1e6:.2f} M parameters, batch {TB}, image 224, "
        f"staging 256, context 256, precision amp, attn_impl flash, AdamW, clipping 1.0; "
        f"{base_mem / 2**20:.0f} MiB allocated before it")
    reset_counts()
    state, clip_ms, clip_peak, metrics = timed_clip_steps(state, step_fn, batches, "flash")
    clip_train = read_counts()
    say(f"clip training: launches in {steps} steps: {clip_train}")
    want = {"fwd": 24 * steps, "dkv": 24 * steps, "dq": 24 * steps, "scan_fwd": 0, "scan_bwd": 0}
    if clip_train != want:
        fail(f"clip training: launches {clip_train}, expected {want}")
    first_loss = float(metrics[0]["loss"])
    if not 3.0 <= first_loss <= 6.0:
        fail(f"clip training: first loss {first_loss} outside [3, 6] (ln 64 = 4.16)")

    # Hold each of the 24 interiors of one more step, with the do its
    # backward was given, against the plain backward on its own inputs.
    calls = []

    def recording_train_interior(q, k, v, pad_mask=None, *, sm_scale, impl=None):
        o = interior(q, k, v, pad_mask, sm_scale=sm_scale, impl=impl)
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "mask": pad_mask,
               "sm": sm_scale}
        o.register_hook(lambda g: rec.update(do=g.detach()))
        calls.append(rec)
        return o

    vit_mod.flash_attention_interior = recording_train_interior
    try:
        state, m = step_fn(state, batches[0], 0)
    finally:
        vit_mod.flash_attention_interior = interior
    check_metrics(m, "recorded clip step")
    if len(calls) != 24 or any("do" not in c for c in calls):
        fail(f"one clip step made {len(calls)} attention calls with "
             f"{sum('do' in c for c in calls)} gradients, expected 24")
    # Against the fp32 plain backward on the same bf16 inputs and the same kept
    # result o, whose arithmetic is the kernels'. Beside it, not gated, the
    # bf16 plain backward, which recomputes o: at these inputs the keys of a
    # row are nearly alike, so dq = sum_j ds_j k_j is a small remainder of
    # terms that cancel, and a difference of one bf16 rounding in
    # rowsum(o * do) is of dq's own size.
    rec_bwd = rec_bwd_bf16 = 0.0
    for c in calls:
        q, k, v = (c[n].contiguous() for n in "qkv")
        B_, T_ = q.shape[:2]
        key_mask = None if c["mask"] is None else c["mask"].reshape(B_, T_).contiguous()
        do = c["do"].contiguous()
        g_k, _, out = flash_bwd(q, k, v, key_mask, do, c["sm"])
        errs = rel_errs(g_k, attention_plain_bwd(q.float(), k.float(), v.float(), c["mask"],
                                                 do.float(), c["sm"], o=out.float()))
        errs_bf16 = rel_errs(g_k, attention_plain_bwd(q, k, v, c["mask"], do, c["sm"]))
        errs_o32 = rel_errs(g_k, attention_plain_bwd(q.float(), k.float(), v.float(), c["mask"],
                                                     do.float(), c["sm"]))
        worst = max(r for r, _ in errs)
        say(f"clip training interior T={T_}: against the fp32 plain backward "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs))
            + "; with the result recomputed in fp32 "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs_o32))
            + "; against the bf16 plain backward "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs_bf16)))
        if not worst <= ATTN_GATE["bf16"]:
            fail("the flash backward kernels disagree with the plain backward on a train "
                 f"step's own inputs (T={T_}): rel err {worst:.3e}")
        rec_bwd = max(rec_bwd, worst)
        rec_bwd_bf16 = max(rec_bwd_bf16, max(r for r, _ in errs_bf16))
        note_bwd(errs, "bf16")
    say(f"clip training: the 24 recorded interiors (12 T={calls[0]['q'].shape[1]}, 12 "
        f"T={calls[-1]['q'].shape[1]}) agree with the fp32 plain backward on their own inputs: "
        f"worst rel_err {rec_bwd:.3e} (gate {ATTN_GATE['bf16']:g}); against the bf16 plain "
        f"backward {rec_bwd_bf16:.3e}")
    del calls, state, step_fn, c, q, k, v, do, g_k
    torch.cuda.empty_cache()

    # the same step with the einsum interior: its time and its peak memory
    state, step_fn, _ = clip_train_setup(TB, attn_impl="einsum")
    _, einsum_ms, einsum_peak, _ = timed_clip_steps(state, step_fn, batches, "einsum", 1, 2)
    del state, step_fn
    torch.cuda.empty_cache()

    # kernels against plain interiors end to end: 2 steps at batch 8 from one state
    init = {k: v.clone() for k, v in build_clip(
        "biomedclip", dtype=torch.bfloat16, attn_flash=True,
        generator=torch.Generator().manual_seed(1)).state_dict().items()}
    runs = {}
    for impl in ("cuda", "plain"):
        st, fn, bs = clip_train_setup(8, seed=1, model_state=init)
        vit_mod.flash_attention_interior = functools.partial(interior, impl=impl)
        try:
            runs[impl] = []
            for i in range(2):
                st, m = fn(st, bs[i], 0)
                runs[impl].append(check_metrics(m, f"batch-8 clip step, {impl} interiors"))
        finally:
            vit_mod.flash_attention_interior = interior
        del st, fn
    clip_e2e = 0.0
    for i, ((lk, gk), (lp, gp)) in enumerate(zip(runs["cuda"], runs["plain"])):
        rl, rg = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        clip_e2e = max(clip_e2e, rl, rg)
        say(f"clip training bs 8 step {i}: loss kernel {lk:.6f} plain {lp:.6f} (rel {rl:.2e}); "
            f"grad_norm kernel {gk:.6f} plain {gp:.6f} (rel {rg:.2e})")
    if clip_e2e > CLIP_TRAIN_REL:
        fail(f"the clip train step with the kernels differs from the plain interiors by "
             f"{clip_e2e:.3e} relative (bound {CLIP_TRAIN_REL:g})")

    # accum_freq=2 with grad_checkpointing: the bank pass and the recomputes launch too
    st, fn, _ = clip_train_setup(8, seed=1, model_state=init, grad_checkpointing=True,
                                 accum_freq=2)
    reset_counts()
    st, m = fn(st, bs[0], 0)
    accum_counts = read_counts()
    check_metrics(m, "accum_freq=2 checkpointed clip step")
    say(f"clip training bs 8 accum_freq=2 grad_checkpointing: launches {accum_counts}")
    if accum_counts != {"fwd": 144, "dkv": 48, "dq": 48, "scan_fwd": 0, "scan_bwd": 0}:
        fail("accum_freq=2 with grad_checkpointing: expected 144 forward (48 in the bank "
             "pass, 96 in the graded pass and its recomputes), 48 dk/dv and 48 dq launches")
    del st, fn, init

    # the VSSM-towered CLIP: scans in the image tower, flash in the text tower
    st, fn, _ = clip_train_setup(8, model_name="medmamba", seed=2)
    reset_counts()
    st, m = fn(st, bs[0], 0)
    mm_train = read_counts()
    check_metrics(m, "medmamba clip step")
    say(f"clip training bs 8 medmamba CLIP: launches {mm_train}")
    if mm_train != {"fwd": 12, "dkv": 12, "dq": 12, "scan_fwd": 14, "scan_bwd": 14}:
        fail("the VSSM-towered CLIP's train step: expected 14 + 14 scan and 12 + 12 + 12 "
             "flash launches")
    del st, fn, bs
    say(json.dumps({"clip_training": {
        "card": card, "parameters": n_clip, "batch": TB, "steps_timed": TIMED,
        "ms_per_step": clip_ms, "pairs_per_s": TB / (clip_ms / 1e3),
        "max_memory_allocated_bytes": clip_peak, "allocated_before_bytes": base_mem,
        "einsum_ms_per_step": einsum_ms, "einsum_pairs_per_s": TB / (einsum_ms / 1e3),
        "einsum_max_memory_allocated_bytes": einsum_peak,
        "flash_kernel_ms_per_step": flash_ms_per_step,
        "launches_per_step": {k: n / steps for k, n in clip_train.items()},
        "first_loss": first_loss, "recorded_interiors_max_rel_err": rec_bwd,
        "recorded_interiors_vs_bf16_plain_max_rel_err": rec_bwd_bf16,
        "bs8_kernel_vs_plain_max_rel": clip_e2e, "accum2_checkpointed_launches": accum_counts,
        "medmamba_clip_launches": mm_train}}))
    say(f"clip training: {clip_ms:.2f} ms/step, {TB / (clip_ms / 1e3):.1f} pairs/s, peak "
        f"{clip_peak / 2**30:.2f} GiB allocated with flash; einsum {einsum_ms:.2f} ms/step, "
        f"peak {einsum_peak / 2**30:.2f} GiB; flash kernels forward "
        f"{flash_ms_per_step['fwd']:.3f}, dk/dv {flash_ms_per_step['dkv']:.3f}, dq "
        f"{flash_ms_per_step['dq']:.3f} ms per step, on {card}")

    # 11. kernels line, then the device line
    per_fwd = {key: sum(12 * attn_shapes[t][key] for t in attn_shapes)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    attn_by = {"bytes": 0.0, "operations": 0.0}
    for shape in attn_shapes.values():
        attn_by[shape["bound_by"]] += shape["bound_ms"]
    say(json.dumps({"kernels": [{
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "src/mamba_clip_tpu/ops/selective_scan.py:194",
        "launches": launches + train_fwd,
        "launches_by_path": {"serve": launches, "train": train_fwd, "clip_serve": clip_scans,
                             "medmamba_clip_image_embed": mm_launches["image_embed"]["scan"]},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": fwd_k,
        "plain_ms": fwd_p,
        "bound_ms": fwd_bound,
        "bound_by": max(bound_terms, key=bound_terms.get),
        "library_ms": None,
    }, {
        "name": "selective_scan_bwd",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/selective_scan_bwd.cu",
        "replaces": "src/mamba_clip_tpu/ops/selective_scan.py:243",
        "launches": train_bwd,
        "launches_by_path": {"serve": serve_bwd, "train": train_bwd},
        "max_abs_err": bwd_abs,
        "max_rel_err": bwd_rel,
        "ms": bwd_k_step,
        "plain_ms": bwd_p_step,
        "bound_ms": bwd_bound_step,
        "bound_by": max(bwd_terms, key=bwd_terms.get),
        "library_ms": None,
    }, {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "src/mamba_clip_tpu/ops/flash_attn.py:75",
        "launches": clip_flash + clip_train["fwd"],
        "launches_by_path": {"clip_serve": clip_flash,
                             "medmamba_clip_text_embed": mm_launches["text_embed"]["flash"],
                             "clip_train": clip_train["fwd"],
                             "clip_train_accum2_checkpointed": accum_counts["fwd"],
                             "medmamba_clip_train": mm_train["fwd"]},
        "max_abs_err": attn_abs,
        "max_rel_err": attn_worst,
        # per image_embed + text_embed pair at batch 64: 12 ViT + 12 BERT launches
        "ms": per_fwd["ms"],
        "plain_ms": per_fwd["plain_ms"],
        "bound_ms": per_fwd["bound_ms"],
        "bound_by": max(attn_by, key=attn_by.get),
        "library_ms": per_fwd["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line} (reached from "
                    "src/mamba_clip_tpu/ops/flash_attn.py:122)",
        "launches": clip_train[key],
        "launches_by_path": {"clip_serve": 0, "clip_train": clip_train[key],
                             "clip_train_accum2_checkpointed": accum_counts[key],
                             "medmamba_clip_train": mm_train[key]},
        "max_abs_err": bwd_attn_abs[key],
        "max_rel_err": bwd_attn_worst[key],
        # per train step at batch 64: 12 ViT + 12 BERT launches; the plain
        # backward and the library's compute dq, dk and dv in one call
        "ms": sum(12 * bwd_shapes_attn[t][key]["ms"] for t in bwd_shapes_attn),
        "plain_ms": sum(12 * bwd_shapes_attn[t]["plain_bwd_ms"] for t in bwd_shapes_attn),
        "bound_ms": sum(12 * bwd_shapes_attn[t][key]["bound_ms"] for t in bwd_shapes_attn),
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            sh[key]["bound_ms"] for sh in bwd_shapes_attn.values()
            if sh[key]["bound_by"] == by)),
        "library_ms": sum(12 * bwd_shapes_attn[t]["library_bwd_ms"] for t in bwd_shapes_attn),
    } for name, key, line in (("flash_attn_bwd_dkv", "dkv", 796),
                              ("flash_attn_bwd_dq", "dq", 1146))]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
