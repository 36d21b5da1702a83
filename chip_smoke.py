#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX. Phases, each of which exits non-zero
on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles the five CUDA sources from ``csrc/``, one
   nvcc each, started together (always anew: an earlier run's libraries
   are removed first), and prints ptxas' registers and spills; each scan
   kernel's instances (fp32, bf16) with their registers, spills, shared
   memory a block and the ``SHFL`` and ``MUFU`` instructions in their SASS;
3. kernel against plain: ``selective_scan_fwd`` against the plain loop on
   the card at the medmamba stage shapes (batch 2) and two ragged ones
   (DG 24, below a block's 64 channels, and DG 80, above them and not a
   multiple), fp32 and bf16, softplus on and off; gate:
   max|y_k - y_p| / max|y_p| <= 5e-4, and the same gate on the chunk-entry
   states ``hck`` the forward writes for training; a second run of the
   kernel must give y and ``hck`` bit for bit. Then both are timed at the
   serving batch 64 beside the kernel's bound;
4. serving: the full-width medmamba ``classify`` (image 224, staging 256,
   bf16 compute, random weights from seed 0) answers 16 concurrent requests
   through ``MicroBatcher``; the answers are checked, the launch counters
   must show 14 forward launches per dispatched batch and no backward
   launch, the same batch through the plain scan must agree, and each of
   the 14 scans of one forward of that batch must agree with the plain
   loop on its own inputs; then classify is timed at batch 64;
5. backward kernel against plain: ``selective_scan_bwd`` against
   ``_scan_tm_plain_bwd`` at the shapes of phase 3; gate: each of the 7
   gradients at max|g_k - g_p| / max|g_p| <= 5e-4, and a second run must
   give all 7 bit for bit (no atomics). Then the forward (with ``hck``) and
   the backward are timed at batch 64, bf16, beside the backward's bound;
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
7. flash kernel against plain: first each instance of the forward that
   phase 2 built (at hd 32, 64, 128: the tensor-core body, which bf16 runs
   with and without residuals, and the CUDA-core body, which fp32 runs),
   with ptxas' registers and spills, its shared memory a block and the
   ``HMMA`` instructions in its SASS (``cuobjdump -sass``); every
   tensor-core instance must hold some, or the phase fails. Then
   ``flash_attn_fwd`` against the plain
   (einsum) interior at h = 12, hd = 64, batch 2: T = 197 unmasked; T = 256
   with a prefix, a non-prefix, a one-key and an all-masked key row; the
   trimmed text context 224; a ragged 77; and hd 32 and 128; fp32 and bf16;
   each case as serving calls it (no residuals) and as training calls it
   (with residuals); gate
   max|o_k - o_p| / max|o_p| <= 5e-4 (fp32) and 2e-2 (bf16), and the
   all-masked row must be the mean of v. Then, at batch 64 in bf16, the
   kernel, the plain interior and ``F.scaled_dot_product_attention`` (the
   library yardstick, never on the path) are timed at the ViT shape
   (T 197) and the BERT shape (T 256, masks of tokenized report-like text)
   beside the bound, and the training forward's o is held against the
   plain interior there too;
8. CLIP serving: full-width BiomedCLIP (ViT-B/16 + the 12-layer BERT, bf16
   compute, ``attn_impl="flash"``, random weights from seed 0) answers 16
   concurrent ``image_embed`` and 16 concurrent ``text_embed`` requests
   through two ``MicroBatcher``s; the embeddings must be finite unit
   vectors, the counters must show 12 flash launches per dispatched batch
   and no scan launch, every one on the tensor cores (the wrapper counts
   each body's launches apart), and the ``attn_impl="einsum"`` model on the same
   weights must agree within 2e-2; the 24 interiors of one image and one
   text forward are each held against the plain interior at the bf16
   gate; the VSSM-towered CLIP's ``image_embed`` must make 14 scan
   launches and no flash launch, its ``text_embed`` 12 flash launches;
   then image/s and texts/s at batch 64, flash and einsum;
9. flash backward kernels against plain: first each instance of the two
   backward kernels, as phase 7 lists the forward's (a tensor-core instance
   without ``HMMA`` fails). Then ``flash_attn_bwd_dq`` and
   ``flash_attn_bwd_dkv`` against ``attention_plain_bwd`` at the shapes of
   phase 7 (the one-key and the all-masked row beside a non-prefix row,
   since their own dq and dk vanish), fp32 on the CUDA-core bodies and bf16
   on the tensor-core bodies, each gradient at
   max|g_k - g_p| / max|g_p| <= 5e-4 (fp32) and 2e-2 (bf16: the plain
   backward rounds p, dp and ds to bf16, the kernels round p once for dv and
   carry ds as two bf16 terms; in bf16 each case is held against the bf16 plain
   backward, a row with one valid key left out because its dq and dk vanish
   and the bf16 plain backward leaves rounding noise there, and against the
   fp32 plain backward on the same inputs, every row); the forward's
   residuals m and l against the plain ones at 5e-4; dk and dv of a masked key exactly 0 from every row that has a valid
   key, dq and dk exactly 0 for a row with none; two runs bit-identical.
   Then, at batch 64 at the ViT and BERT shapes, in bf16 (tensor cores) and
   fp32 (CUDA cores), the forward with residuals and both backward kernels
   are timed beside their bounds, the plain forward and backward, and the
   forward (with its residuals, as training calls it) and backward of
   ``F.scaled_dot_product_attention`` in the same type;
10. CLIP training: the stage-1 contrastive step of full-width BiomedCLIP
   (``amp``, ``attn_impl="flash"``, batch 64, device-resident uint8 images
   at staging 256, HashTokenizer tokens of report-like text, AdamW with
   clipping at 1.0): 2 warm-up and 5 timed steps with finite loss and grad
   norm, the first loss within [3, 6] (ln 64 = 4.16 at random init),
   ``logit_scale`` within [1, 100], exactly 24 forward, 24 dk/dv and 24 dq
   launches a step and no scan launch, every one on the tensor cores;
   the 24 interiors of one more step recorded with their ``do``, each
   forward's o held against the plain interior at the bf16 gate and each
   backward held against the fp32 plain
   backward on its own bf16 inputs and kept result at the bf16 gate (the
   bf16 plain backward, which recomputes the result, is printed beside it:
   where a row's keys are nearly alike, dq is a small remainder of terms
   that cancel and one bf16 rounding of rowsum(o * do) is of its size);
   the same step with ``attn_impl="einsum"`` for its time and peak memory.
   At batch 8 (``clip_step_check``, seed 1): from S_0, the init, and S_1,
   the state after the kernel step, a step with the kernels, one with the
   plain interiors and one with the kernel forward and the fp32 plain
   backward on its kept o: (a) the loss with the kernels within 2^-7
   relative of the plain step's, (b) the grad norm within 2^-7 of the
   mixed step's, which sees the same o and di, so that only the backward
   kernels differ, and (c) the grad norm against the plain step's, printed
   and not gated (one rounding of o moves di, and at random init dq is a
   small remainder of its size: PERF.md, Findings). One fp32 step under the
   same gates runs the CUDA-core bodies (24 + 24 + 24 launches, every one
   on the CUDA cores); one step with ``accum_freq=2`` and
   ``grad_checkpointing``
   (144 forward launches: 2 micro-batches x 24 in the no-grad bank pass, and
   x 24 x 2 in the graded pass, whose checkpoints run each forward again;
   48 dk/dv and 48 dq, every one on the tensor cores); one step of the
   ``medmamba`` CLIP (14 + 14 scan
   launches, 12 + 12 + 12 flash launches). Prints ms per step, pairs/s,
   peak memory with flash and with einsum, and the flash kernels' ms per
   step. ``python3 chip_smoke.py --clip-check-seeds 1 2 3 4 [--src DIR]``
   runs only the batch-8 check, at those seeds, on the package under
   ``DIR`` (another tree's ``src/``), and prints its readings;
11. ceiling kernel against plain, then the roofline: ``vpu_chain`` with
   c = 0.5, d = 0 and with c = 1, d = 1 at rounds 1 to 4 must give
   x * 2^(-16 rounds) and x + 16 rounds bit for bit (every step ran, on a
   ragged element count); the exp chain at rounds = 1 must agree with 16
   plain steps and disagree with 15 at 1e-5 of the largest entry (a longer
   exp chain sits on its fixed point and shows nothing); at the roofline
   tool's constants and rounds = 64, at the tool's size and the ragged one,
   the FMA chain within 1e-5 of the plain chain that rounds once a step
   (``fused=True``, the rounding of ``fmaf``) and within 2e-4 of the one
   that rounds the product and the sum apart, the exp chain within 1e-5 of
   ``torch.exp``. Then ``scan_roofline.measure`` runs once (the kernel's
   main path: its launches are counted): the FMA, exp and HBM ceilings,
   each as a share of its data-sheet figure at the SM clock read under
   load (above 105% fails), and the scan kernels at batch 32; a
   ``roofline`` JSON line gives them and, for the scan kernels, the bound
   from the measured ceilings beside the one from the data sheet;
12. a stage-1 epoch through ``pipeline.step``: full-width BiomedCLIP,
   ``amp``, ``attn_impl="flash"``, batch 64, ``SyntheticIsicDataset`` with
   ``HashTokenizer`` (256 train samples = 4 steps, 128 validation samples),
   ``checkpoint_steps=2``: 24 + 24 + 24 flash launches in each train step,
   24 forward and no backward launches in each eval batch, finite losses
   (the contrastive validation loss within [3, 6]), the step checkpoint and
   its sidecar on disk after batch 2 and gone after ``finalize``, the epoch
   and stage-latest checkpoints there. Then exact resume: a fresh state
   loaded from the step checkpoint and run from ``start_batch=2`` must end
   with parameters, moments and step equal bit for bit to the uninterrupted
   run's. Prints an ``epoch_stage1`` JSON line: ms a step and pairs/s (the
   loop's last logged window), the loop's data and batch meters over the
   epoch, the loader's seconds a batch alone, eval rows/s, peak memory, and
   the seconds and MB/s of a checkpoint save and load;
13. a stage-2 epoch: ``ClipClassifier`` over that CLIP, loaded with
   ``load_params_only`` from phase 12's stage-latest checkpoint and frozen
   through ``freeze_submodule_mask``, class-weighted CE, batch 64, 4 steps,
   then ``evaluate``: 24 flash forward launches a step and no backward
   launch, every ``clip.*`` parameter bit-identical after the epoch, the
   head moved, ``val_loss`` finite and ``partial_auc`` within [0, 0.2] (the
   area above 80% TPR), and the validation probabilities within 2e-2 of the
   ``attn_impl="einsum"`` model on the same weights. Prints an
   ``epoch_stage2`` JSON line. Checkpoints go under ``tempfile.mkdtemp()``
   and are removed at the end;
14. prints the kernels line (nine entries: the two scan kernels, the
   roofline's chain kernel, and each flash kernel as two entries, one a
   body: ``flash_attn_fwd``, ``flash_attn_bwd_dkv`` and
   ``flash_attn_bwd_dq`` on the tensor cores, bf16, whose launches come
   from the main path, and ``..._cuda_cores``, fp32, whose launches come
   from phase 10's fp32 step; a body launched no time fails. Each flash
   entry is timed at the towers' shapes in its type beside the plain
   version and the library's, with its bound from the data sheet and from
   the ceilings phase 11 measured, its shares of both, and its instances;
   the forward's tensor-core entry is serving's pair, its training launches
   under ``training``; each scan entry with its instances), then the
   device line last.

Phases 1-10 run at the depth and iteration counts they had before phases
11-13 were added.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

GATE_REL = 5e-4          # the gate bench.py put on the Pallas kernel
PROBS_ATOL = 2e-2        # kernel vs plain scan, end to end, bf16 activations
TRAIN_REL = 2.0**-8      # kernel vs plain scan, train step loss and grad norm: one bf16 ulp
# flash kernel vs plain interior: fp32 as GATE_REL; bf16 also covers the plain
# interior rounding the scores and the normalized probabilities to bf16
ATTN_GATE = {"fp32": GATE_REL, "bf16": 2e-2}
# the sources under csrc/; flash_attn_bwd holds the dk/dv and the dq kernel
KERNELS = ("selective_scan_fwd", "selective_scan_bwd", "flash_attn_fwd", "flash_attn_bwd",
           "vpu_chain")
CHAIN_GATE = 1e-5        # the chain kernel vs its plain version, of the largest entry
CHAIN_UNFUSED_GATE = 2e-4  # fmaf vs a multiply and an add that round apart, 1024 steps
CLIP_TRAIN_REL = 2.0**-7  # kernel vs plain interiors, CLIP train step loss and grad norm
GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
STAGES = [(3136, 64), (784, 128), (196, 256), (49, 512)]  # (L, DG) per medmamba stage
BLOCKS_PER_STAGE = [2, 2, 8, 2]
# DG below a kernel block's 64 channels, and above them and not a multiple
RAGGED = [(300, 24), (300, 80)]
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


def rel_errs(got, want):
    """max|g - w| / max|w| and max|g - w| of each pair."""
    out = []
    for g, w in zip(got, want):
        abs_err = float((g.float() - w.float()).abs().max())
        out.append((abs_err / max(float(w.float().abs().max()), 1e-30), abs_err))
    return out


def clip_step_check(seed: int, precision: str = "amp", steps: int = 2, counted=None):
    """The flash path in the stage-1 contrastive step of full-width
    BiomedCLIP at batch 8 against the plain interiors, each part gated
    where it is well posed. S_0 is the init from ``seed``, S_(i+1) the state
    after the kernel step from S_i; from every S_i three steps run:

    - "kernel": the flash kernels, forward and backward, as training runs;
    - "plain": the plain interior and its backward;
    - "mixed": the kernel forward, then ``attention_plain_bwd`` in fp32 on
      the kept result o.

    (a) the kernel step's loss against the plain step's: the loss does not
    pass through di = rowsum(o * do). (b) the kernel step's grad norm against
    the mixed step's: both see the same o and so the same di, and only the
    backward kernels differ. (c) the kernel step's grad norm against the
    plain step's, printed and not gated: at random init dq is a small
    remainder of terms that cancel, and one bf16 rounding of o moves di,
    and so the grad norm, by more than 2^-7 (PERF.md, Findings).

    ``counted``: (reset, read), called around each kernel step; the reads
    come back with the readings. Returns one dict a step."""
    import torch

    from mamba_clip_tpu_torch.models import vit as vit_mod
    from mamba_clip_tpu_torch.ops.flash_attn import attention_plain_bwd, flash_attn_fwd
    from mamba_clip_tpu_torch.optim import AdamState
    from mamba_clip_tpu_torch.profile_train import clip_train_setup
    from mamba_clip_tpu_torch.train import TrainState

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, key_mask, sm):
            out = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm, with_residuals=True)[0]
            ctx.sm = sm
            ctx.save_for_backward(q, k, v, key_mask, out)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, key_mask, out = ctx.saved_tensors
            mask = None if key_mask is None else key_mask[:, None, None, :]
            grads = attention_plain_bwd(q.float(), k.float(), v.float(), mask, do.float(),
                                        ctx.sm, o=out.float())
            return (*(g.to(q.dtype) for g in grads), None, None)

    interior = vit_mod.flash_attention_interior

    def mixed(q, k, v, pad_mask=None, *, sm_scale, impl=None):
        B, T = q.shape[:2]
        key_mask = None if pad_mask is None else pad_mask.reshape(B, T).contiguous()
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return KernelFwdPlainBwd.apply(q, k, v, key_mask, sm_scale)

    interiors = {"plain": functools.partial(interior, impl="plain"), "mixed": mixed,
                 "kernel": functools.partial(interior, impl="cuda")}
    kw = {} if precision == "amp" else {"precision": precision}
    st, fn, bs = clip_train_setup(8, seed=seed, **kw)
    model = st.model

    def restore(snap):
        step, params, count, mu, nu = snap
        model.load_state_dict(params)
        return TrainState(step=step, model=model, opt_state=AdamState(
            count, {k: t.clone() for k, t in mu.items()}, {k: t.clone() for k, t in nu.items()}))

    readings = []
    for i in range(steps):
        snap = (st.step, {k: t.clone() for k, t in model.state_dict().items()},
                st.opt_state.count, st.opt_state.mu, st.opt_state.nu)
        got, counts = {}, None
        for name in ("plain", "mixed", "kernel"):  # the kernel step's state goes on
            vit_mod.flash_attention_interior = interiors[name]
            try:
                if name == "kernel" and counted is not None:
                    counted[0]()
                new, m = fn(restore(snap), bs[i % 2], 0)
                got[name] = (float(m["loss"]), float(m["grad_norm"]))
                if name == "kernel" and counted is not None:
                    counts = counted[1]()
            finally:
                vit_mod.flash_attention_interior = interior
        st = new
        (lk, gk), (lp, gp), (_, gm) = got["kernel"], got["plain"], got["mixed"]
        rl, rg, rc = abs(lk - lp) / abs(lp), abs(gk - gm) / abs(gm), abs(gk - gp) / abs(gp)
        finite = all(math.isfinite(x) for pair in got.values() for x in pair)
        readings.append({
            "seed": seed, "precision": precision, "step": i, "loss_kernel": lk,
            "loss_plain": lp, "loss_rel": rl, "grad_norm_kernel": gk, "grad_norm_mixed": gm,
            "grad_norm_rel": rg, "grad_norm_plain": gp, "grad_norm_vs_plain_rel": rc,
            "counts": counts,
            "ok": bool(finite and rl <= CLIP_TRAIN_REL and rg <= CLIP_TRAIN_REL)})
    del st, fn, bs, model, snap, new
    torch.cuda.empty_cache()
    return readings


def say_clip_step(r: dict) -> None:
    say(f"clip step check seed {r['seed']} {r['precision']} step {r['step']}: (a) loss kernel "
        f"{r['loss_kernel']:.6f} plain {r['loss_plain']:.6f} (rel {r['loss_rel']:.2e}); (b) "
        f"grad_norm kernel {r['grad_norm_kernel']:.6f} kernel forward + fp32 plain backward "
        f"{r['grad_norm_mixed']:.6f} (rel {r['grad_norm_rel']:.2e}); gate {CLIP_TRAIN_REL:g}: "
        f"{'ok' if r['ok'] else 'FAIL'}; (c, not gated) grad_norm plain "
        f"{r['grad_norm_plain']:.6f} (rel {r['grad_norm_vs_plain_rel']:.2e}: di from a "
        "differently rounded o moves dq, a small remainder, at its own size)")


def clip_check_only(seeds, src: Path) -> None:
    """``--clip-check-seeds``: only the batch-8 check, at each seed, on the
    package under ``src``; the readings as one JSON line. Exits 0 whether
    or not a seed passes: it reports."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on the card only")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi("name,power.limit")
    say(card)
    readings = []
    for seed in seeds:
        for r in clip_step_check(seed):
            say_clip_step(r)
            readings.append(r)
    say(json.dumps({"clip_step_check": readings, "src": str(src), "card": card}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one card.")
    ap.add_argument("--clip-check-seeds", type=int, nargs="+", default=None,
                    help="run only phase 10's batch-8 check, at these seeds")
    ap.add_argument("--src", default=str(SRC),
                    help="with --clip-check-seeds: the src/ directory whose package is checked")
    args = ap.parse_args(argv)
    if args.clip_check_seeds is not None:
        return clip_check_only(args.clip_check_seeds, Path(args.src).resolve())
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
        CHUNK, _scan_tm_plain, _scan_tm_plain_bwd, selective_scan_bwd, selective_scan_fwd,
        selective_scan_tm)
    from mamba_clip_tpu_torch.serve import MicroBatcher
    from mamba_clip_tpu_torch.serving import make_serving_fns
    from mamba_clip_tpu_torch.models import build_classifier, vssm
    from mamba_clip_tpu_torch.profile_train import (CLIP_TOTAL_STEPS, CLIP_TRAIN_ARGS,
                                                    TRAIN_ARGS, clip_train_setup,
                                                    medmamba_train_setup)
    from mamba_clip_tpu_torch import pipeline as port_pipeline
    from mamba_clip_tpu_torch import scan_roofline
    from mamba_clip_tpu_torch.checkpoint import (load_checkpoint, load_params_only,
                                                 parse_step_checkpoint, save_checkpoint,
                                                 validate_step_resume)
    from mamba_clip_tpu_torch.data.loader import device_prefetch, get_data
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.eval import evaluate, make_eval_step
    from mamba_clip_tpu_torch.models import ClipClassifier
    from mamba_clip_tpu_torch.ops.vpu_chain import vpu_chain, vpu_chain_plain
    from mamba_clip_tpu_torch.optim import build_optimizer, freeze_submodule_mask
    from mamba_clip_tpu_torch.roofline import (FP32_FLOPS, HBM_BYTES_PER_S, attn_bound,
                                               scan_bound, scan_bwd_bound, sfu_peak)
    from mamba_clip_tpu_torch.schedules import create_schedule
    from mamba_clip_tpu_torch.train import (create_train_state, make_classifier_train_step,
                                            make_clip_train_step, train_one_epoch)
    from mamba_clip_tpu_torch.utils.precision import get_policy

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
    sfu_rate = sfu_peak(props.multi_processor_count, max_clk_mhz)
    say(f"{props.multi_processor_count} SMs, max SM clock {max_clk_mhz:.0f} MHz: "
        f"exp peak {sfu_rate:.4g}/s; fp32 peak {FP32_FLOPS:.3g} FLOP/s and HBM "
        f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM data sheet)")

    # 2. build: one nvcc per source, all started together, always anew (phase 7
    # reads ptxas' report of this build)
    for k in KERNELS:
        cuda_build.library_path(k).unlink(missing_ok=True)
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
    # each scan instance: ptxas' registers and spills, its shared memory a
    # block (the backward's static B/C buffers and its dynamic rest), and the
    # shuffles and special-function instructions in its SASS
    bwd_dyn_smem = cuda_build.load("selective_scan_bwd").selective_scan_bwd_smem_bytes()
    scan_instances = {}
    for k in ("selective_scan_fwd", "selective_scan_bwd"):
        scan_instances[k] = {}
        sass = {op: cuda_build.sass_counts(cuda_build.library_path(k), op)
                for op in ("SHFL", "MUFU")}
        for mangled, rep in cuda_build.ptxas_report(cuda_build.build_logs.get(k, "")).items():
            inst = re.search(rf"{k}_kernelI(f|13__nv_bfloat16)E", mangled)
            if inst is None:
                continue
            name = f"{k} {'fp32' if inst.group(1) == 'f' else 'bf16'}"
            scan_instances[k][name] = {
                "registers": rep["registers"], "spill_stores": rep["spill_stores"],
                "spill_loads": rep["spill_loads"],
                "smem_bytes": rep["static_smem"] + (bwd_dyn_smem if k.endswith("bwd") else 0),
                "shfl": sass["SHFL"].get(mangled, 0), "mufu": sass["MUFU"].get(mangled, 0)}
        for name, inst in sorted(scan_instances[k].items()):
            say(f"{name}: {inst['registers']} registers, spills {inst['spill_stores']}/"
                f"{inst['spill_loads']} bytes, {inst['smem_bytes']} B shared memory a block, "
                f"{inst['shfl']} SHFL and {inst['mufu']} MUFU in its SASS")
        if len(scan_instances[k]) != 2:
            fail(f"{k}: expected 2 instances (fp32, bf16), got {sorted(scan_instances[k])}")

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
            y_h, hck_k = selective_scan_fwd(*full, softplus, with_hck=True)
            y_h2, hck_k2 = selective_scan_fwd(*full, softplus, with_hck=True)
            _, hck_p = _scan_tm_plain(*full, softplus, return_hck=True)
            torch.cuda.synchronize()
        (rel_h, abs_h), = rel_errs([hck_k], [hck_p])
        same = torch.equal(y_h, y_h2) and torch.equal(hck_k, hck_k2)
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = rel <= GATE_REL and rel_h <= GATE_REL and same
        say(f"scan B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            f"rel_err {rel:.3e} abs_err {abs_err:.3e} hck rel_err {rel_h:.3e} "
            f"{'bit-identical' if same else 'two runs DIFFER'} "
            f"kernel {ms_k:.4f} ms plain {ms_p:.3f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"selective_scan_fwd disagrees with the plain scan: rel err {rel:.3e}, "
                 f"hck rel err {rel_h:.3e}, two runs bit-identical: {same}")
        return max(rel, rel_h), max(abs_err, abs_h), ms_k, ms_p

    worst_rel = worst_abs = 0.0
    for L, DG in STAGES + RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            rel, abs_err, _, _ = compare(2, L, DG, dtype, True, 20, 2)
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
    for L, DG in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            rel, abs_err, _, _ = compare(2, L, DG, dtype, False, 20, 2)
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
        g_k2 = selective_scan_bwd(*args, softplus, dy, hck)
        _, hck_p = _scan_tm_plain(*args, softplus, return_hck=True)
        g_p = _scan_tm_plain_bwd(*args, softplus, dy, hck_p)
        torch.cuda.synchronize()
        errs = rel_errs(g_k, g_p)
        same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        name = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        ok = all(r <= GATE_REL for r, _ in errs) and same
        say(f"scan bwd B={Bsz} G=4 L={L} DG={DG} {name} softplus={softplus}: "
            + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(GRAD_NAMES, errs))
            + (" bit-identical" if same else " two runs DIFFER") + (" ok" if ok else " FAIL"))
        if not ok:
            fail("selective_scan_bwd disagrees with the plain backward, or with itself "
                 f"(two runs bit-identical: {same})")
        return max(r for r, _ in errs), max(a for _, a in errs)

    bwd_rel = bwd_abs = 0.0
    for L, DG in STAGES + RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            r, a = compare_bwd(2, L, DG, dtype, True)
            bwd_rel, bwd_abs = max(bwd_rel, r), max(bwd_abs, a)
    for L, DG in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            r, a = compare_bwd(2, L, DG, dtype, False)
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
                           "hck_bytes": 64 * 4 * (-(-L // CHUNK)) * DG * 16 * 4,
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

    # 7. flash kernel against plain. First what was built: ptxas' registers,
    # spills and shared memory of each instance of the forward, and the
    # tensor-core instructions in the bf16 instances' SASS
    def instances(library, pattern, smem_of):
        """Each kernel instance of a built library: ptxas' registers and
        spills, its shared memory a block (``smem_of(kernel, hd)`` for the
        dynamic shared memory of a tensor-core body, else the static) and
        the HMMA instructions in its SASS, by "<kernel> <body> hd<HD>"."""
        report = cuda_build.ptxas_report(cuda_build.build_logs.get(library, ""))
        hmma = cuda_build.sass_counts(cuda_build.library_path(library), "HMMA")
        out = {}
        for mangled, rep in report.items():
            inst = re.search(pattern, mangled)
            if inst is None:
                continue
            kernel, tc, hd = inst.group(1), inst.group(2) == "bf16_", int(inst.group(3))
            out[f"{kernel} {'bf16 tensor cores' if tc else 'fp32 CUDA cores'} hd{hd}"] = {
                "registers": rep["registers"], "spill_stores": rep["spill_stores"],
                "spill_loads": rep["spill_loads"],
                "smem_bytes": smem_of(kernel, hd) if tc else rep["static_smem"],
                "hmma": hmma.get(mangled, 0)}
        for name, inst in sorted(out.items()):
            say(f"{library} {name}: {inst['registers']} registers, spills "
                f"{inst['spill_stores']}/{inst['spill_loads']} bytes, {inst['smem_bytes']} B "
                f"shared memory a block, {inst['hmma']} HMMA")
        tc_hmma = [v["hmma"] for k, v in out.items() if "tensor cores" in k]
        if not tc_hmma or len(tc_hmma) * 2 != len(out) or min(tc_hmma) == 0:
            fail(f"{library}: bf16 runs on the tensor cores, so each of its bf16 instances "
                 f"needs HMMA in its SASS, beside one fp32 instance each ({out})")
        return out

    fwd_lib = cuda_build.load("flash_attn_fwd")
    fwd_instances = instances("flash_attn_fwd", r"(flash_attn_fwd)_(bf16_)?kernelILi(\d+)E",
                              lambda _, hd: fwd_lib.flash_attn_fwd_bf16_smem_bytes(hd))
    if len(fwd_instances) != 6:
        fail(f"flash_attn_fwd: expected 6 instances (hd 32, 64, 128 of two bodies), got "
             f"{sorted(fwd_instances)}")

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

    # the two bodies of each flash kernel: the tensor cores run bf16 (with
    # and without the forward's residuals), the CUDA cores fp32; each body
    # keeps its own worst errors and launch count
    flash_wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq}

    def body_of(dtype):
        return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"

    def zero_bodies():
        for w in flash_wrappers.values():
            for body in w.launches_by_body:
                w.launches_by_body[body] = 0

    def flash_bodies():
        return {key: dict(w.launches_by_body) for key, w in flash_wrappers.items()}

    attn_worst = {"tensor_cores": 0.0, "cuda_cores": 0.0}
    attn_abs = {"tensor_cores": 0.0, "cuda_cores": 0.0}

    def note_fwd(body, rel, abs_err):
        attn_worst[body] = max(attn_worst[body], rel)
        attn_abs[body] = max(attn_abs[body], abs_err)

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
            key_mask = None if mask is None else mask.reshape(2, T).contiguous()
            with torch.inference_mode():
                o_p = attention_plain(q, k, v, mask, sm_scale=hd**-0.5)
                # the interior as serving calls it, then the training forward
                o_ks = {False: flash_attention_interior(q, k, v, mask, sm_scale=hd**-0.5,
                                                        impl="cuda"),
                        True: flash_attn_fwd(q, k, v, key_mask, sm_scale=hd**-0.5,
                                             with_residuals=True)[0]}
            torch.cuda.synchronize()
            for with_res, o_k in o_ks.items():
                (rel, abs_err), = rel_errs([o_k], [o_p])
                ok = bool(torch.isfinite(o_k).all()) and rel <= ATTN_GATE[name]
                if valid is not None and not valid[1].any():  # the all-masked row: mean of v
                    (rel_m, _), = rel_errs([o_k[1]], [v[1].float().mean(0).reshape(1, -1)])
                    ok = ok and rel_m <= ATTN_GATE[name]
                body = body_of(dtype)
                say(f"flash B=2 T={T} h={h} hd={hd} {name} ({label}), "
                    f"{'with' if with_res else 'without'} residuals ({body}): rel_err {rel:.3e} "
                    f"abs_err {abs_err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"flash_attn_fwd disagrees with the plain interior at T={T} hd={hd} "
                         f"{name}, {'with' if with_res else 'without'} residuals")
                note_fwd(body, rel, abs_err)

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
            key_mask = None if mask is None else mask.reshape(64, T).contiguous()
            o_r = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm, with_residuals=True)[0]
            (rel_r, abs_r), = rel_errs([o_r], [o_p])
            ms_k = cuda_ms(lambda: flash_attention_interior(q, k, v, mask, sm_scale=sm,
                                                            impl="cuda"), 20)
            ms_p = cuda_ms(lambda: attention_plain(q, k, v, mask, sm_scale=sm), 20)
            ms_l = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=sm), 20)
        if rel > ATTN_GATE["bf16"] or rel_r > ATTN_GATE["bf16"]:
            fail(f"flash_attn_fwd disagrees with the plain interior at the {tower} shape: "
                 f"rel err {rel:.3e} without residuals, {rel_r:.3e} with them")
        note_fwd("tensor_cores", max(rel, rel_r), max(abs_err, abs_r))
        bound = attn_bound(64, T, 12, 64, 2, valid is not None, sfu_rate)
        attn_shapes[tower] = {"B": 64, "T": T, "h": 12, "hd": 64, "dtype": "bf16",
                              "masked": valid is not None, "launches_per_forward": 12,
                              "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l, **bound,
                              "max_rel_err": rel}
        say(f"flash B=64 T={T} bf16 ({tower}): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
            f"scaled_dot_product_attention {ms_l:.4f} ms, bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}), rel_err {rel:.3e}; with residuals rel_err "
            f"{rel_r:.3e}")
        del q, k, v, qt, kt, vt, o_k, o_p, o_r
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
    zero_bodies()
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
    clip_flash_bodies = flash_bodies()
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
    if clip_flash_bodies["fwd"] != {"tensor_cores": clip_flash, "cuda_cores": 0}:
        fail(f"clip serving: the forward's launches by body {clip_flash_bodies}, expected "
             "every one on the tensor cores")
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
        note_fwd("tensor_cores", rel, abs_err)
        if not rel <= ATTN_GATE["bf16"]:
            fail(f"flash_attn_fwd disagrees with the plain interior on a served batch's "
                 f"inputs (T={q.shape[1]}): rel err {rel:.3e}")
    say(f"clip serving: the 24 recorded interiors (12 T={calls[0][0].shape[1]}, 12 "
        f"T={calls[-1][0].shape[1]}) agree with the plain interior: worst rel_err "
        f"{rec_attn:.3e} (gate {ATTN_GATE['bf16']:g})")
    del calls

    # the VSSM-towered CLIP: its image tower runs the scan, its text tower flash
    mm_clip, mm_fns, _ = make_serving_fns(
        "medmamba", is_clip=True, attn_impl="flash", precision="amp", device="cuda",
        generator=torch.Generator().manual_seed(2))
    mm_launches, mm_bodies = {}, {}
    for name, reqs in c_req.items():
        selective_scan_fwd.launches = flash_attn_fwd.launches = 0
        zero_bodies()
        out = mm_fns[name](mm_clip, np.concatenate(reqs))
        torch.cuda.synchronize()
        mm_launches[name] = {"scan": selective_scan_fwd.launches, "flash": flash_attn_fwd.launches}
        mm_bodies[name] = flash_bodies()
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

    # 9. flash backward kernels against the plain backward. First what was
    # built, as phase 7 lists the forward's instances
    bwd_lib = cuda_build.load("flash_attn_bwd")
    bwd_instances = instances(
        "flash_attn_bwd", r"(flash_attn_bwd_dkv|flash_attn_bwd_dq)_(bf16_)?kernelILi(\d+)E",
        lambda kernel, hd: bwd_lib.flash_attn_bwd_bf16_smem_bytes(int(kernel.endswith("dq")), hd))
    if len(bwd_instances) != 12:
        fail(f"flash_attn_bwd: expected 12 instances (dk/dv and dq at hd 32, 64, 128 of two "
             f"bodies), got {sorted(bwd_instances)}")

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

    bwd_attn_worst = {key: {"tensor_cores": 0.0, "cuda_cores": 0.0} for key in ("dq", "dkv")}
    bwd_attn_abs = {key: {"tensor_cores": 0.0, "cuda_cores": 0.0} for key in ("dq", "dkv")}

    def note_bwd(errs, body):
        (r_q, a_q), (r_k, a_k), (r_v, a_v) = errs
        for key, rel, abs_err in (("dq", r_q, a_q), ("dkv", max(r_k, r_v), max(a_k, a_v))):
            bwd_attn_worst[key][body] = max(bwd_attn_worst[key][body], rel)
            bwd_attn_abs[key][body] = max(bwd_attn_abs[key][body], abs_err)

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
            say(f"flash bwd B={Bsz} T={T} h={h} hd={hd} {name} ({label}, {body_of(dtype)}): "
                + " ".join(f"{n} {r:.2e}" for n, (r, _) in zip(("dq", "dk", "dv"), errs))
                + f" residuals {res_err:.2e} same_bits {same_bits} exact_zeros {zeros_ok}"
                + (" ok" if ok else " FAIL"))
            if not ok:
                fail(f"the flash backward kernels disagree with the plain backward at T={T} "
                     f"hd={hd} {name}")
            note_bwd(errs, body_of(dtype))

    # at the training batch (64), the ViT and BERT shapes: bf16 on the tensor
    # cores (training under amp), fp32 on the CUDA cores; each beside the
    # plain forward and backward and the library's, in the same type. The
    # operations of an fp32 body are bound by the fp32 rate outside the
    # tensor cores.
    bwd_shapes_attn = {"tensor_cores": {}, "cuda_cores": {}}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        body, itemsize = body_of(dtype), dtype.itemsize
        rate = {} if dtype == torch.bfloat16 else {"tc_rate": FP32_FLOPS}
        for tower, T, valid in (("vit", 197, None),
                                ("bert", 256, report_tokens(64) != HashTokenizer.PAD)):
            q, k, v, mask, key_mask, do = flash_bwd_inputs(64, T, 12, 64, dtype, valid, 5)
            sm = 64**-0.5
            g_k, res, _ = flash_bwd(q, k, v, key_mask, do, sm)
            errs = rel_errs(g_k, attention_plain_bwd(q, k, v, mask, do, sm))
            if any(r > ATTN_GATE[name] for r, _ in errs):
                fail(f"the flash backward kernels disagree with the plain backward at the "
                     f"{tower} shape in {name}")
            note_bwd(errs, body)
            ms_f = cuda_ms(lambda: flash_attn_fwd(q, k, v, key_mask, sm_scale=sm,
                                                  with_residuals=True), 20)
            with torch.no_grad():
                ms_pf = cuda_ms(lambda: attention_plain(q, k, v, mask, sm_scale=sm), 20)
            ms_kv = cuda_ms(lambda: flash_attn_bwd_dkv(q, k, v, *res, sm_scale=sm), 20)
            ms_q = cuda_ms(lambda: flash_attn_bwd_dq(q, k, v, *res, sm_scale=sm), 20)
            ms_p = cuda_ms(lambda: attention_plain_bwd(q, k, v, mask, do, sm), 10)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            o_l = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=sm)
            # the library's forward as training calls it: it keeps its residuals
            ms_lf = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   scale=sm), 20)
            do_l = do.view(64, T, 12, 64).transpose(1, 2)
            ms_l = cuda_ms(lambda: torch.autograd.grad(o_l, (qt, kt, vt), do_l,
                                                       retain_graph=True), 20)
            masked = valid is not None
            b_kv = attn_bound(64, T, 12, 64, itemsize, masked, sfu_rate, tensors=6, stats=3,
                              products=4, **rate)
            b_q = attn_bound(64, T, 12, 64, itemsize, masked, sfu_rate, tensors=5, stats=3,
                             products=3, **rate)
            b_f = attn_bound(64, T, 12, 64, itemsize, masked, sfu_rate, stats=2, **rate)
            bwd_shapes_attn[body][tower] = {
                "B": 64, "T": T, "h": 12, "hd": 64, "dtype": name, "masked": masked,
                "launches_per_step": 12,
                "fwd": {"ms": ms_f, "plain_ms": ms_pf, "library_ms": ms_lf, **b_f},
                "dkv": {"ms": ms_kv, **b_kv}, "dq": {"ms": ms_q, **b_q},
                "plain_bwd_ms": ms_p, "library_bwd_ms": ms_l,
                "max_rel_err": max(r for r, _ in errs)}
            say(f"flash bwd B=64 T={T} {name} ({tower}, {body}): dk/dv {ms_kv:.4f} ms (bound "
                f"{b_kv['bound_ms']:.4f}, {b_kv['bound_by']}), dq {ms_q:.4f} ms (bound "
                f"{b_q['bound_ms']:.4f}, {b_q['bound_by']}), forward with residuals "
                f"{ms_f:.4f} ms (bound {b_f['bound_ms']:.4f}, plain {ms_pf:.4f}, "
                f"scaled_dot_product_attention {ms_lf:.4f}), plain backward {ms_p:.4f} ms, "
                f"scaled_dot_product_attention backward {ms_l:.4f} ms")
            del q, k, v, do, g_k, res, qt, kt, vt, o_l, do_l
    say(json.dumps({"flash_attn_bwd_shapes": bwd_shapes_attn, "card": card}))
    flash_ms_per_step = {key: sum(12 * sh[key]["ms"]
                                  for sh in bwd_shapes_attn["tensor_cores"].values())
                         for key in ("fwd", "dkv", "dq")}

    # 10. CLIP training: the stage-1 contrastive step of full-width BiomedCLIP
    wrappers = {"fwd": flash_attn_fwd, "dkv": flash_attn_bwd_dkv, "dq": flash_attn_bwd_dq,
                "scan_fwd": selective_scan_fwd, "scan_bwd": selective_scan_bwd}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        zero_bodies()

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
    clip_train_bodies = flash_bodies()
    say(f"clip training: launches in {steps} steps: {clip_train}; by body "
        f"{clip_train_bodies}")
    want = {"fwd": 24 * steps, "dkv": 24 * steps, "dq": 24 * steps, "scan_fwd": 0, "scan_bwd": 0}
    if clip_train != want:
        fail(f"clip training: launches {clip_train}, expected {want}")
    if any(b != {"tensor_cores": 24 * steps, "cuda_cores": 0} for b in clip_train_bodies.values()):
        fail(f"clip training: launches by body {clip_train_bodies}, expected every one on the "
             "tensor cores")
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
    rec_bwd = rec_bwd_bf16 = rec_fwd = 0.0
    for c in calls:
        q, k, v = (c[n].contiguous() for n in "qkv")
        B_, T_ = q.shape[:2]
        key_mask = None if c["mask"] is None else c["mask"].reshape(B_, T_).contiguous()
        do = c["do"].contiguous()
        g_k, _, out = flash_bwd(q, k, v, key_mask, do, c["sm"])
        # the forward's own result, held against the plain interior
        with torch.no_grad():
            (rel_o, abs_o), = rel_errs([out], [attention_plain(q, k, v, c["mask"],
                                                               sm_scale=c["sm"])])
        if not rel_o <= ATTN_GATE["bf16"]:
            fail("flash_attn_fwd with residuals disagrees with the plain interior on a train "
                 f"step's own inputs (T={T_}): rel err {rel_o:.3e}")
        rec_fwd = max(rec_fwd, rel_o)
        note_fwd("tensor_cores", rel_o, abs_o)
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
        note_bwd(errs, "tensor_cores")
    say(f"clip training: the 24 recorded interiors (12 T={calls[0]['q'].shape[1]}, 12 "
        f"T={calls[-1]['q'].shape[1]}) agree with the fp32 plain backward on their own inputs: "
        f"worst rel_err {rec_bwd:.3e} (gate {ATTN_GATE['bf16']:g}); against the bf16 plain "
        f"backward {rec_bwd_bf16:.3e}; their forward's o against the plain interior "
        f"{rec_fwd:.3e}")
    del calls, state, step_fn, c, q, k, v, do, g_k
    torch.cuda.empty_cache()

    # the same step with the einsum interior: its time and its peak memory
    state, step_fn, _ = clip_train_setup(TB, attn_impl="einsum")
    _, einsum_ms, einsum_peak, _ = timed_clip_steps(state, step_fn, batches, "einsum", 1, 2)
    del state, step_fn
    torch.cuda.empty_cache()

    # kernels against plain interiors end to end at batch 8, seed 1, from S_0
    # and S_1, each part gated where it is well posed (clip_step_check)
    clip_check = clip_step_check(1)
    for r in clip_check:
        say_clip_step(r)
    if not all(r["ok"] for r in clip_check):
        fail(f"the clip train step with the kernels differs from the plain interiors beyond "
             f"{CLIP_TRAIN_REL:g}: (a) loss or (b) grad norm, {clip_check}")
    # one fp32 step: the CUDA-core bodies through the normal entry point,
    # under the same gates; their main path, so its launches are counted
    fp32_check = clip_step_check(1, precision="fp32", steps=1,
                                 counted=(reset_counts, lambda: (read_counts(), flash_bodies())))
    say_clip_step(fp32_check[0])
    fp32_counts, fp32_bodies = fp32_check[0].pop("counts")
    say(f"clip training bs 8 fp32: launches {fp32_counts}; by body {fp32_bodies}")
    if not fp32_check[0]["ok"]:
        fail(f"the fp32 clip train step with the kernels differs from the plain interiors "
             f"beyond {CLIP_TRAIN_REL:g}: {fp32_check[0]}")
    if (fp32_counts != {"fwd": 24, "dkv": 24, "dq": 24, "scan_fwd": 0, "scan_bwd": 0}
            or any(b != {"tensor_cores": 0, "cuda_cores": 24} for b in fp32_bodies.values())):
        fail(f"the fp32 clip train step: launches {fp32_counts}, by body {fp32_bodies}; "
             "expected 24 + 24 + 24, every one on the CUDA cores")

    # accum_freq=2 with grad_checkpointing: the bank pass and the recomputes launch too
    st, fn, bs = clip_train_setup(8, seed=1, grad_checkpointing=True, accum_freq=2)
    reset_counts()
    st, m = fn(st, bs[0], 0)
    accum_counts = read_counts()
    accum_bodies = flash_bodies()
    check_metrics(m, "accum_freq=2 checkpointed clip step")
    say(f"clip training bs 8 accum_freq=2 grad_checkpointing: launches {accum_counts}")
    if accum_counts != {"fwd": 144, "dkv": 48, "dq": 48, "scan_fwd": 0, "scan_bwd": 0}:
        fail("accum_freq=2 with grad_checkpointing: expected 144 forward (48 in the bank "
             "pass, 96 in the graded pass and its recomputes), 48 dk/dv and 48 dq launches")
    if any(b["cuda_cores"] for b in accum_bodies.values()):
        fail(f"accum_freq=2 with grad_checkpointing: launches by body {accum_bodies}, "
             "expected every one on the tensor cores")
    del st, fn

    # the VSSM-towered CLIP: scans in the image tower, flash in the text tower
    st, fn, _ = clip_train_setup(8, model_name="medmamba", seed=2)
    reset_counts()
    st, m = fn(st, bs[0], 0)
    mm_train = read_counts()
    mm_train_bodies = flash_bodies()
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
        "recorded_interiors_fwd_max_rel_err": rec_fwd,
        "bs8_check": clip_check, "bs8_fp32_check": fp32_check,
        "bs8_fp32_launches": fp32_counts, "accum2_checkpointed_launches": accum_counts,
        "medmamba_clip_launches": mm_train}}))
    say(f"clip training: {clip_ms:.2f} ms/step, {TB / (clip_ms / 1e3):.1f} pairs/s, peak "
        f"{clip_peak / 2**30:.2f} GiB allocated with flash; einsum {einsum_ms:.2f} ms/step, "
        f"peak {einsum_peak / 2**30:.2f} GiB; flash kernels forward "
        f"{flash_ms_per_step['fwd']:.3f}, dk/dv {flash_ms_per_step['dkv']:.3f}, dq "
        f"{flash_ms_per_step['dq']:.3f} ms per step, on {card}")

    # 11. the ceiling kernel against its plain version, then the roofline tool
    def chain_err(got, want):
        abs_err = float((got - want).abs().max())
        return abs_err / float(want.abs().max()), abs_err

    chain_abs = chain_rel = 0.0
    n_tool = props.multi_processor_count * 2048 * 8   # the tool's size: one full wave
    g11 = torch.Generator(device="cuda").manual_seed(11)
    x_rag = torch.rand(1_000_003, generator=g11, device="cuda") + 0.5   # a ragged count
    x_tool = torch.rand(n_tool, generator=g11, device="cuda")
    ints = (torch.arange(x_rag.numel(), device="cuda") % 1000).float()
    for r in (1, 2, 3, 4):
        # exact step counts: 16 r halvings, 16 r increments
        halves = vpu_chain(x_rag, r, False, 0.5, 0.0)
        incs = vpu_chain(ints, r, False, 1.0, 1.0)
        ok = torch.equal(halves, x_rag * 2.0 ** (-16 * r)) and torch.equal(incs, ints + 16 * r)
        say(f"vpu_chain rounds={r}: x * 2^-{16 * r} and x + {16 * r} bit for bit: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"vpu_chain does not take exactly {16 * r} steps at rounds={r}")
    # the exp chain contracts toward 0.567: only a short chain can show a missing step
    e16 = vpu_chain(x_rag, 1, True)
    rel16, abs16 = chain_err(e16, vpu_chain_plain(x_rag, 1, True))
    rel15, _ = chain_err(e16, vpu_chain_plain(x_rag, 0, True, steps=15))
    say(f"vpu_chain exp rounds=1 (16 steps): rel_err {rel16:.3e} against the plain 16 steps, "
        f"{rel15:.3e} against the plain 15 steps (gate {CHAIN_GATE:g})")
    if not (rel16 <= CHAIN_GATE < rel15):
        fail("the exp chain at 16 steps: the kernel must agree with 16 plain steps and "
             "disagree with 15")
    chain_abs, chain_rel = max(chain_abs, abs16), max(chain_rel, rel16)
    for x, label in ((x_tool, "the tool's size"), (x_rag, "a ragged count")):
        k_fma = vpu_chain(x, 64)
        rel_f, abs_f = chain_err(k_fma, vpu_chain_plain(x, 64, fused=True))
        rel_u, _ = chain_err(k_fma, vpu_chain_plain(x, 64))
        rel_e, abs_e = chain_err(vpu_chain(x, 64, True), vpu_chain_plain(x, 64, True))
        say(f"vpu_chain rounds=64 at the tool's constants, {label} ({x.numel()}): FMA rel_err "
            f"{rel_f:.3e} against the plain chain rounding once a step, {rel_u:.3e} against "
            f"the one rounding twice (gate {CHAIN_UNFUSED_GATE:g}); exp rel_err {rel_e:.3e} "
            f"(gate {CHAIN_GATE:g})")
        if not (rel_f <= CHAIN_GATE and rel_e <= CHAIN_GATE and rel_u <= CHAIN_UNFUSED_GATE):
            fail(f"vpu_chain disagrees with its plain version at rounds=64 on {label}")
        chain_abs, chain_rel = max(chain_abs, abs_f, abs_e), max(chain_rel, rel_f, rel_e)
    torch.cuda.synchronize()

    # the tool's measurement: the main path of this kernel
    vpu_chain.launches = 0
    roof = scan_roofline.measure("cuda")
    chain_launches = vpu_chain.launches
    if chain_launches == 0:
        fail("scan_roofline.measure launched vpu_chain no time")
    chain_ms = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    chain_by = {"bytes": 0.0, "operations": 0.0}
    for key, use_exp in (("fma", False), ("exp", True)):
        c = roof[key]
        steps = c["rounds"] * 16
        plain_ms = cuda_ms(lambda: vpu_chain_plain(x_tool, c["rounds"], use_exp), 1, warmup=0)
        t_ops = (n_tool * steps / sfu_rate if use_exp else n_tool * steps * 2 / FP32_FLOPS)
        t_bytes = 8 * n_tool / HBM_BYTES_PER_S   # x read, the result written, fp32
        bound = 1e3 * max(t_ops, t_bytes)
        chain_by["bytes" if t_bytes >= t_ops else "operations"] += bound
        chain_ms = {"ms": chain_ms["ms"] + c["ms"], "plain_ms": chain_ms["plain_ms"] + plain_ms,
                    "bound_ms": chain_ms["bound_ms"] + bound}
        say(f"vpu_chain {key}: {c['per_s']:.4g}/s, {c['share_of_datasheet_at_clock']:.3f} of "
            f"the data sheet at {c['sm_clock_mhz']:.0f} MHz (read under load: "
            f"{c['clock_read_under_load']}); a launch of {steps} steps {c['ms']:.3f} ms, "
            f"bound {bound:.3f} ms, plain {plain_ms:.1f} ms")
    measured = scan_roofline.measured_rates(roof)
    kw_m = {k: v for k, v in measured.items() if k != "sfu_rate"}
    fwd_bound_m = sum(n * scan_bound(64, L, DG, 2, measured["sfu_rate"], **kw_m)["bound_ms"]
                      for (L, DG), n in zip(STAGES, BLOCKS_PER_STAGE))
    bwd_bound_m = sum(n * scan_bwd_bound(64, L, DG, 2, measured["sfu_rate"], **kw_m)["bound_ms"]
                      for (L, DG), n in zip(STAGES, BLOCKS_PER_STAGE))
    say(json.dumps({"roofline": {
        "card": card,
        "fma_per_s": roof["fma"]["per_s"], "fma_tflops": roof["fma_tflops"],
        "fma_share_of_datasheet_at_clock": roof["fma"]["share_of_datasheet_at_clock"],
        "exp_per_s": roof["exp"]["per_s"],
        "exp_share_of_datasheet_at_clock": roof["exp"]["share_of_datasheet_at_clock"],
        "exp_cost_in_fma_slots": roof["exp_cost_in_fma_slots"],
        "hbm_bytes_per_s": roof["hbm"]["bytes_per_s"],
        "hbm_share_of_datasheet": roof["hbm"]["share_of_datasheet"],
        "sm_clock_mhz": {k: roof[k]["sm_clock_mhz"] for k in ("fma", "exp", "hbm")},
        "clock_read_under_load": {k: roof[k]["clock_read_under_load"]
                                  for k in ("fma", "exp", "hbm")},
        "chain_rounds": {k: roof[k]["rounds"] for k in ("fma", "exp")},
        "chain_launch_ms": {k: roof[k]["ms"] for k in ("fma", "exp")},
        "vpu_chain_launches": chain_launches,
        # per batch-64 medmamba step (14 launches): the kernel's time beside both bounds
        "selective_scan_fwd": {"ms": fwd_k, "bound_ms_datasheet": fwd_bound,
                               "bound_ms_measured": fwd_bound_m},
        "selective_scan_bwd": {"ms": bwd_k_step, "bound_ms_datasheet": bwd_bound_step,
                               "bound_ms_measured": bwd_bound_m},
        "scan_batch32": {label: {k: m[k] for k in (
            "fwd_ms", "fwd_hck_ms", "bwd_ms", "fwdbwd_ms", "bwd_over_fwd",
            "fwd_pct_of_measured_bound", "bwd_pct_of_measured_bound",
            "fwd_pct_of_datasheet_bound", "bwd_pct_of_datasheet_bound")}
            for label, m in roof["scan"].items()}}}))
    del x_rag, x_tool, ints

    # 12. a stage-1 epoch: load, train, evaluate, save, resume
    wrappers["vpu_chain"] = vpu_chain
    EB, N_TRAIN, N_VAL, SEED = 64, 256, 128, 0
    policy = get_policy("amp")
    tcfg_train = get_transform_config(None, 224, is_train=True)
    tcfg_val = get_transform_config(None, 224, is_train=False)
    loop_flags = dict(
        batch_size=EB, epochs=1, workers=4, seed=SEED, synthetic_data=True, is_test=False,
        train_num_samples=N_TRAIN, val_num_samples=N_VAL, sampling=None, val_frequency=1,
        log_every_n_steps=2, save_frequency=1, delete_previous_checkpoint=False,
        save_most_recent=False, return_best=False, eval_loss=None, hopt_direction="minimize",
        trace=False)
    args1 = SimpleNamespace(**CLIP_TRAIN_ARGS, **loop_flags, stage=1, checkpoint_steps=2,
                            class_weighted_loss=False)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        def counted(fn, log, before=None):
            """``fn`` as a train step that logs each call's kernel launches."""
            def step(state, batch, seed):
                if before is not None:
                    before(len(log))
                start = read_counts()
                out = fn(state, batch, seed)
                log.append({k: v - start[k] for k, v in read_counts().items()})
                return out
            return step

        def clip_state(seed):
            model = build_clip("biomedclip", image_size=224, dtype=policy.compute_dtype,
                               attn_flash=True,
                               generator=torch.Generator().manual_seed(seed)).to("cuda")
            schedule = create_schedule(args1, CLIP_TOTAL_STEPS)
            tx = build_optimizer(args1, schedule)
            return (create_train_state(model, tx, policy),
                    make_clip_train_step(model, tx, policy, args1, tcfg_train, schedule))

        data1 = get_data(args1, tokenizer=HashTokenizer(context_length=256),
                         staging_size=tcfg_train.staging_size)
        data1["tcfg_val"] = tcfg_val
        state1, step1 = clip_state(0)
        run1 = port_pipeline.RunState(checkpoint_path=os.path.join(work, "checkpoints"))
        step_ckpt = os.path.join(run1.checkpoint_path, "stage_1_epoch_0_step_2")
        kept = os.path.join(work, "kept", "stage_1_epoch_0_step_2")
        seen = {}

        def before_step(i):
            # batch 2 is done: its step checkpoint and sidecar must be on disk; keep a
            # hard link for the resume below, finalize() removes the original
            if i == 2:
                seen["dir"] = os.path.isfile(os.path.join(step_ckpt, "state.pt"))
                seen["sidecar"] = os.path.isfile(step_ckpt + ".meta.json")
                if seen["dir"] and seen["sidecar"]:
                    os.makedirs(kept)
                    os.link(os.path.join(step_ckpt, "state.pt"), os.path.join(kept, "state.pt"))
                    shutil.copy(step_ckpt + ".meta.json", kept + ".meta.json")

        log1 = []
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics1, state1 = port_pipeline.step(
            args1, run1, state1.model, data1,
            {"state": state1, "step_fn": counted(step1, log1, before_step), "policy": policy,
             "start_epoch": 0}, "cuda", SEED, save_prefix="stage_1_", stage=1)
        torch.cuda.synchronize()
        epoch1_s = time.perf_counter() - t0
        peak1 = torch.cuda.max_memory_allocated()
        total1 = read_counts()
        total1_bodies = flash_bodies()
        names = sorted(os.listdir(run1.checkpoint_path))
        say(f"epoch stage 1: {len(log1)} steps, launches a step {log1}; in all {total1}; "
            f"metrics {metrics1}; checkpoints {names}; step checkpoint seen after batch 2: "
            f"{seen}")
        step_want = {"fwd": 24, "dkv": 24, "dq": 24, "scan_fwd": 0, "scan_bwd": 0, "vpu_chain": 0}
        if len(log1) != N_TRAIN // EB or any(c != step_want for c in log1):
            fail(f"stage-1 epoch: launches a step {log1}, expected {N_TRAIN // EB} x {step_want}")
        n_eval = -(-N_VAL // EB)
        if total1 != {**step_want, "fwd": 24 * (len(log1) + n_eval), "dkv": 24 * len(log1),
                      "dq": 24 * len(log1)}:
            fail(f"stage-1 epoch: {total1} launches in all, expected 24 forward an eval batch "
                 "and no backward there")
        if not (seen.get("dir") and seen.get("sidecar")):
            fail("stage-1 epoch: the step checkpoint or its sidecar was missing after batch 2")
        if names != ["results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]:
            fail(f"stage-1 epoch: checkpoint directory holds {names} after finalize")
        if not (metrics1 and np.isfinite(metrics1["val_loss"]) and 3.0 <= metrics1["val_loss"] <= 6.0
                and metrics1["num_samples"] == N_VAL):
            fail(f"stage-1 epoch: eval metrics {metrics1} (the contrastive loss is near ln 64)")
        m1 = run1.meters[0]
        if not all(np.isfinite(v) for v in m1["last_metrics"].values()):
            fail(f"stage-1 epoch: train metrics {m1['last_metrics']}")

        # the loader alone: the rate its threads make batches at with the GIL to themselves
        data1["train"].set_epoch(0)
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in data1["train"].loader)
        loader_s = (time.perf_counter() - t0) / n_loaded

        # one more evaluation, alone: its launches and its rate
        reset_counts()
        t0 = time.perf_counter()
        again = evaluate(state1.model, state1, data1, 1, args1, policy, tcfg_val, stage=1,
                         device="cuda")
        eval1_s = time.perf_counter() - t0
        eval1 = read_counts()
        if eval1 != {**step_want, "fwd": 24 * n_eval, "dkv": 0, "dq": 0} or \
                abs(again["val_loss"] - metrics1["val_loss"]) > 1e-6 * metrics1["val_loss"]:
            fail(f"stage-1 eval: launches {eval1}, loss {again['val_loss']} against "
                 f"{metrics1['val_loss']}")

        # exact resume: a fresh state from the step checkpoint, run from batch 2
        shutil.rmtree(os.path.join(run1.checkpoint_path, "stage_1_epoch_1"))
        state_r, step_r = clip_state(7)
        t0 = time.perf_counter()
        state_r, start_epoch = load_checkpoint(kept, state_r)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(kept, "state.pt"))
        start_batch = parse_step_checkpoint(kept)[1]
        validate_step_resume(kept, EB, num_batches=data1["train"].num_batches)
        if (start_epoch, start_batch, state_r.step, state_r.opt_state.count) != (0, 2, 2, 2):
            fail(f"resume: epoch {start_epoch} batch {start_batch} step {state_r.step}")
        state_r = train_one_epoch(step_r, state_r, data1, 0, args1, SEED, start_batch=2,
                                  device="cuda")
        torch.cuda.synchronize()
        pr, pu = dict(state_r.model.named_parameters()), dict(state1.model.named_parameters())
        differ = [k for k in pu if not torch.equal(pr[k], pu[k])]
        differ += [f"mu/{k}" for k, v in state1.opt_state.mu.items()
                   if not torch.equal(v, state_r.opt_state.mu[k])]
        differ += [f"nu/{k}" for k, v in state1.opt_state.nu.items()
                   if not torch.equal(v, state_r.opt_state.nu[k])]
        same_counts = (state_r.step, state_r.opt_state.count) == (state1.step,
                                                                  state1.opt_state.count)
        say(f"epoch stage 1: resumed from {os.path.basename(kept)} at batch {start_batch}: "
            f"{len(pu)} parameters and 2 x {len(state1.opt_state.mu)} moments, "
            f"{len(differ)} differ from the uninterrupted run; step {state_r.step}")
        if differ or not same_counts:
            fail(f"resume is not exact: {len(differ)} tensors differ, first {differ[:5]}")
        del state_r, step_r, pr

        t0 = time.perf_counter()
        save_checkpoint(run1.checkpoint_path, state1, 1, args1, name="timing")
        save_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(run1.checkpoint_path, "timing"))
        say(json.dumps({"epoch_stage1": {
            "card": card, "batch": EB, "steps": len(log1), "train_samples": N_TRAIN,
            "val_samples": N_VAL, "workers": args1.workers,
            # the last logged window: one step with no checkpoint save and no warm-up in it
            "ms_per_step": 1e3 * m1["batch_time_last"],
            "pairs_per_s": EB / m1["batch_time_last"],
            # the loop's meters over the epoch; the batch meter holds the first step's
            # warm-up and the step checkpoint's save
            "data_s": m1["data_time_avg"], "batch_s": m1["batch_time_avg"],
            "loader_alone_s_per_batch": loader_s,
            "epoch_with_eval_and_saves_s": epoch1_s,
            "eval_rows_per_s": N_VAL / eval1_s, "val_loss": metrics1["val_loss"],
            "train_metrics_last_step": m1["last_metrics"],
            "max_memory_allocated_bytes": peak1,
            "launches_per_step": log1[0], "launches_per_eval_batch": {
                k: v / n_eval for k, v in eval1.items()},
            "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
            "save_MB_per_s": ckpt_bytes / 1e6 / save_s, "load_s": load_s,
            "load_MB_per_s": ckpt_bytes / 1e6 / load_s, "resume_exact": True}}))

        # 13. a stage-2 epoch: ClipClassifier over the stage-1 CLIP, frozen
        args2 = SimpleNamespace(**TRAIN_ARGS, **loop_flags, stage=2, checkpoint_steps=0,
                                class_weighted_loss=True)
        data2 = get_data(args2, tokenizer=HashTokenizer(context_length=256),
                         staging_size=tcfg_train.staging_size)
        data2["tcfg_val"] = tcfg_val
        cw = data2["train"].class_weights

        def classifier(attn_flash, seed):
            clip_ = build_clip("biomedclip", image_size=224, dtype=policy.compute_dtype,
                               attn_flash=attn_flash,
                               generator=torch.Generator().manual_seed(seed))
            return ClipClassifier(clip_, num_classes=2,
                                  generator=torch.Generator().manual_seed(seed))

        model2 = classifier(True, 5)
        load_params_only(os.path.join(run1.checkpoint_path, "stage_1_epoch_latest"),
                         model2.clip)
        model2 = model2.to("cuda")
        stage1_params = dict(state1.model.named_parameters())
        if not all(torch.equal(p, stage1_params[k]) for k, p in model2.clip.named_parameters()):
            fail("stage 2: the CLIP loaded from stage_1_epoch_latest differs from stage 1's")
        named2 = dict(model2.named_parameters())
        schedule2 = create_schedule(args2, data2["train"].num_batches * args2.epochs)
        tx2 = build_optimizer(args2, schedule2,
                              trainable_mask=freeze_submodule_mask(named2, ["clip"]))
        state2 = create_train_state(model2, tx2, policy)
        step2 = make_classifier_train_step(model2, tx2, policy, args2, tcfg_train, schedule2,
                                           class_weights=cw, num_classes=2, takes_text=True)
        head0 = {k: p.detach().clone() for k, p in named2.items() if not k.startswith("clip.")}
        run2 = port_pipeline.RunState(checkpoint_path=os.path.join(work, "checkpoints2"))
        log2 = []
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics2, state2 = port_pipeline.step(
            args2, run2, model2, data2,
            {"state": state2, "step_fn": counted(step2, log2), "policy": policy,
             "start_epoch": 0}, "cuda", SEED, save_prefix="stage_2_", stage=2,
            takes_text=True, class_weights=cw)
        torch.cuda.synchronize()
        peak2 = torch.cuda.max_memory_allocated()
        total2 = read_counts()
        total2_bodies = flash_bodies()
        say(f"epoch stage 2: {len(log2)} steps, launches a step {log2}; in all {total2}; "
            f"metrics {metrics2}; moments kept for {sorted(state2.opt_state.mu)}")
        want2 = {**step_want, "dkv": 0, "dq": 0}
        if len(log2) != N_TRAIN // EB or any(c != want2 for c in log2):
            fail(f"stage-2 epoch: launches a step {log2}, expected {want2}")
        if total2 != {**want2, "fwd": 24 * (len(log2) + n_eval)}:
            fail(f"stage-2 epoch: {total2} launches in all")
        moved = [k for k, p in model2.clip.named_parameters()
                 if not torch.equal(p, stage1_params[k])]
        if moved:
            fail(f"stage-2 epoch: {len(moved)} frozen clip.* parameters changed: {moved[:5]}")
        if any(torch.equal(named2[k].detach(), v) for k, v in head0.items()):
            fail("stage-2 epoch: a head parameter did not move")
        pauc = metrics2.get("partial_auc", float("nan"))
        if not (np.isfinite(metrics2["val_loss"]) and np.isfinite(pauc) and 0.0 <= pauc <= 0.2):
            fail(f"stage-2 epoch: metrics {metrics2}: partial_auc must lie in [0, 0.2]")
        m2 = run2.meters[0]
        data2["train"].set_epoch(0)
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in data2["train"].loader)
        loader2_s = (time.perf_counter() - t0) / n_loaded

        # the same validation probabilities through the einsum interior
        model_e = classifier(False, 6)
        model_e.load_state_dict(model2.state_dict())
        model_e = model_e.to("cuda").eval()
        eval2 = make_eval_step(model2, policy, tcfg_val, stage=2, class_weights=cw)

        def val_probs(model):
            model.eval()
            data2["val"].loader.set_epoch(0)
            return torch.cat([eval2(model, b)[1] for b in
                              device_prefetch(iter(data2["val"].loader), "cuda")])

        t0 = time.perf_counter()
        probs_f = val_probs(model2)
        torch.cuda.synchronize()
        eval2_s = time.perf_counter() - t0
        probs_e = val_probs(model_e)
        diff2 = float((probs_f - probs_e).abs().max())
        say(f"epoch stage 2: max |probs(flash) - probs(einsum)| = {diff2:.3e} over "
            f"{probs_f.shape[0]} validation rows (bound {PROBS_ATOL:g})")
        if probs_f.shape != (N_VAL, 2) or not diff2 <= PROBS_ATOL:
            fail(f"stage-2 probabilities with the flash kernel differ from einsum by {diff2:.3e}")
        say(json.dumps({"epoch_stage2": {
            "card": card, "batch": EB, "steps": len(log2), "workers": args2.workers,
            "ms_per_step": 1e3 * m2["batch_time_last"], "img_per_s": EB / m2["batch_time_last"],
            "data_s": m2["data_time_avg"], "batch_s": m2["batch_time_avg"],
            "loader_alone_s_per_batch": loader2_s,
            "eval_rows_per_s": N_VAL / eval2_s, "val_loss": metrics2["val_loss"],
            "partial_auc": pauc, "val_positives": int(data2["val"].targets.sum()),
            "train_metrics_last_step": m2["last_metrics"],
            "max_memory_allocated_bytes": peak2, "launches_per_step": log2[0],
            "max_abs_flash_vs_einsum_probs": diff2,
            "class_weights": [float(w) for w in cw]}}))
        del model_e, model2, state2, state1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 14. kernels line, then the device line. Each attention kernel as two
    # entries, one a body: the tensor cores (bf16: what serving and training
    # under amp run, its launches from the main path) and the CUDA cores
    # (fp32, its launches from phase 10's fp32 step), each timed at the
    # towers' shapes in its own type (phase 7 serving's forward, phase 9 the
    # rest)
    def by_bound(shapes):
        by = {"bytes": 0.0, "operations": 0.0}
        for sh in shapes:
            by[sh["bound_by"]] += sh["bound_ms"]
        return max(by, key=by.get)

    flash_paths = {"clip_serve": clip_flash_bodies, "clip_train": clip_train_bodies,
                   "epoch_stage1": total1_bodies, "epoch_stage2": total2_bodies,
                   "medmamba_clip_text_embed": mm_bodies["text_embed"],
                   "clip_train_accum2_checkpointed": accum_bodies,
                   "medmamba_clip_train": mm_train_bodies, "clip_train_fp32": fp32_bodies}
    main_paths = {"fwd": ("clip_serve", "clip_train", "epoch_stage1", "epoch_stage2"),
                  "dkv": ("clip_train", "epoch_stage1"), "dq": ("clip_train", "epoch_stage1")}
    flash_launches = {key: {"tensor_cores": sum(flash_paths[p][key]["tensor_cores"]
                                                for p in paths),
                            "cuda_cores": fp32_bodies[key]["cuda_cores"]}
                      for key, paths in main_paths.items()}
    if any(n == 0 for by in flash_launches.values() for n in by.values()):
        fail(f"a flash body was launched no time: {flash_launches} (the tensor cores on the "
             "main path, the CUDA cores in the fp32 step)")
    # the attention kernels' bounds again from the ceilings phase 11 measured
    # (HBM, exp and the fp32 FMA rate; the tensor cores' rate stays the data
    # sheet's)
    attn_m = {"sfu_rate": measured["sfu_rate"], "hbm_rate": measured["hbm_rate"]}
    bound_kw = {"fwd": dict(stats=2), "dkv": dict(tensors=6, stats=3, products=4),
                "dq": dict(tensors=5, stats=3, products=3)}

    def attn_rows(key, body):
        """phase 9's rows of ``key`` in ``body`` with their plain and
        library times (the backward's: one call for dq, dk and dv)"""
        if key == "fwd":
            return [{**sh["fwd"], "T": sh["T"], "masked": sh["masked"]}
                    for sh in bwd_shapes_attn[body].values()]
        return [{**sh[key], "plain_ms": sh["plain_bwd_ms"], "library_ms": sh["library_bwd_ms"],
                 "T": sh["T"], "masked": sh["masked"]} for sh in bwd_shapes_attn[body].values()]

    def attn_times(rows, tc, kw):
        """ms, plain, bound and library ms per 12 + 12 launches at batch 64
        (a train step's, or an image_embed and a text_embed), and the shares
        of the data-sheet and the measured bounds."""
        out = {k: sum(12 * r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out["bound_by"] = by_bound(rows)
        rate = {} if tc else {"tc_rate": measured["fp32_rate"]}
        meas = sum(12 * attn_bound(64, r["T"], 12, 64, 2 if tc else 4, r["masked"], **attn_m,
                                   **kw, **rate)["bound_ms"] for r in rows)
        out.update(bound_ms_measured=meas, share_of_bound_datasheet=out["bound_ms"] / out["ms"],
                   share_of_bound_measured=meas / out["ms"])
        return out

    fwd_serving = attn_times(list(attn_shapes.values()), True, {"stats": 0})
    attn_entries = []
    for key, name, source, replaces in (
            ("fwd", "flash_attn_fwd", "flash_attn_fwd.cu", "src/mamba_clip_tpu/ops/flash_attn.py:75"),
            ("dkv", "flash_attn_bwd_dkv", "flash_attn_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:796 (reached from "
             "src/mamba_clip_tpu/ops/flash_attn.py:122)"),
            ("dq", "flash_attn_bwd_dq", "flash_attn_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1146 (reached from "
             "src/mamba_clip_tpu/ops/flash_attn.py:122)")):
        for body in ("tensor_cores", "cuda_cores"):
            tc = body == "tensor_cores"
            times = attn_times(attn_rows(key, body), tc, bound_kw[key])
            entry = {
                "name": name if tc else f"{name}_cuda_cores",
                "route": "cuda",
                "source": f"src/mamba_clip_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "body": ("bf16 (serving and training under amp), mma.sync on the tensor cores"
                         if tc else "fp32, on the CUDA cores"),
                "launches": flash_launches[key][body],
                "launches_by_path": {p: c[key][body] for p, c in flash_paths.items()},
                "max_abs_err": (attn_abs if key == "fwd" else bwd_attn_abs[key])[body],
                "max_rel_err": (attn_worst if key == "fwd" else bwd_attn_worst[key])[body],
                # the forward's tensor-core entry: an image_embed + text_embed
                # pair (serving, no residuals), its "training" the train
                # step's launches; the rest per train step in their type
                **(fwd_serving if tc and key == "fwd" else times),
                "instances": {n: i for n, i in {**fwd_instances, **bwd_instances}.items()
                              if n.startswith(f"{name} {'bf16' if tc else 'fp32'}")},
            }
            if tc and key == "fwd":
                entry["training"] = times
            attn_entries.append(entry)
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
        "instances": scan_instances["selective_scan_fwd"],
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
        "instances": scan_instances["selective_scan_bwd"],
    }] + attn_entries + [{
        "name": "vpu_chain",
        "route": "cuda",
        "source": "src/mamba_clip_tpu_torch/csrc/vpu_chain.cu",
        "replaces": "tools/scan_roofline.py:80",
        "launches": chain_launches,
        "launches_by_path": {"scan_roofline": chain_launches, "epoch_stage1": 0},
        "max_abs_err": chain_abs,
        "max_rel_err": chain_rel,
        # one FMA launch and one exp launch at the tool's size and rounds
        "ms": chain_ms["ms"],
        "plain_ms": chain_ms["plain_ms"],
        "bound_ms": chain_ms["bound_ms"],
        "bound_by": max(chain_by, key=chain_by.get),
        "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
