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
   and are removed at the end. Phases 12-13 take their flags from
   ``config.parse_args`` (checked against the values they run at) and their
   run record from ``config.RunState``;
14. the CLI: ``mamba_clip_tpu_torch.cli.main.main`` in this process, with
   SKILL.md's Drive flags (192 train and 64 validation samples, batch 64,
   ``amp``, 1 epoch) and ``--attn-impl flash``, every count set to 0 just
   before each run and read just after: (a) full-width BiomedCLIP from seed
   1 written as a converted ``.npz`` (Flax keys and layouts, numpy alone)
   and loaded into seed 2's model with ``load_torch_clip``, ``image_embed``
   of a batch-64 staging batch bit for bit; (b) stage 1 with ``--pretrained``
   that file and ``--tokenizer hash``, no ``--name``: ``Model parameters:
   195.71M``, the load logged, 3 steps of 24 + 24 + 24 flash launches, all
   on the tensor cores, 24 forward launches and no backward one an eval
   batch, the first loss within [3, 6], ``params.txt``, ``results.jsonl``,
   ``stage_1_epoch_1``, ``stage_1_epoch_latest``; (c) stage 2 with
   ``--name``, which finds (b)'s run itself: 24 + 0 + 0 a step, every
   ``clip.*`` parameter of its latest checkpoint bit-identical to (b)'s,
   ``partial_auc`` within [0, 0.2]; (d) (c) again with ``--resume latest``:
   no step, no backward launch, ``val_loss`` and ``partial_auc`` equal to
   (c)'s row bit for bit; (e) ``--model-stage-1 medmamba`` (128 train
   samples) with ``--resume latest`` and nothing to resume: its log line,
   ``Model parameters: 8.53M``, 14 + 14 scan launches a step, 14 forward
   an eval batch; (f) ``--precision bogus``, a reused ``--name`` and
   ``--stage 2 --resume latest`` in an empty logs dir, each its exception
   message for message and no launch. Prints a ``cli`` JSON line (each
   run's wall seconds, the loop's ms a step, pairs/s or img/s, eval rows/s,
   save seconds, beside phases 12 and 13's ms a step);
15. serving artifacts and the HTTP host, every count set to 0 just before
   each call and read just after: (a) full-width BiomedCLIP (seed 0,
   ``amp``, ``attn_impl="flash"``) exported with ``export_serving`` raw and
   with ``compress_weights``, and full-width medmamba ``classify`` raw,
   into ``tempfile.mkdtemp()``; each artifact's bytes and its export and
   ``load_serving(..., device="cuda")`` seconds; (b) the loaded
   ``image_embed``, ``text_embed`` and ``classify`` of a batch of 64 bit
   for bit equal to ``make_serving_fns`` in this process on the same
   weights, 12 flash forward launches a call on the tensor cores (14 scan
   forward launches for ``classify``) and no other; the compressed
   artifact's int8 values and scales equal to ``compress_params`` of the
   raw weights, its outputs bit for bit those of the in-process model given
   the decompressed weights, its lowest cosine to the raw artifact's
   embeddings above 0.999; (c) ``serve_http.make_server`` over each raw
   artifact, ``serve_forever`` in a thread: ``/healthz``; 16 JPEG bodies
   (PIL-encoded, of distinct kinds) for ``/embed_image`` and ``/classify``
   and 16 JSON texts of distinct openings for ``/embed_text``, each row's
   answer computed directly at every batch shape the batcher dispatches (1,
   2, 4, 8, 16); gates: no two rows share an answer, and the shapes move an
   answer at most 5e-3 (embeddings) or 2e-2 (probabilities); with
   ``max_batch=1`` every answer bit for bit the direct call of its row; with
   the MicroBatcher (``max_batch=16``), closed-loop clients at concurrency
   1, 4 and 16 for 2 s each, every answer a 200, bit for bit its own row's
   answer at one of those shapes (so that an answer taken from another row
   fails) and within that bound of its direct call, 12 (or 14) launches
   times the batcher's batches; an unknown path gives JAX's 404 message, a
   malformed body (bad JSON, a truncated JPEG) a 400; the servers shut
   down and the directories removed; (d) prints a ``serving_http`` JSON
   line (per endpoint: the batch shapes' largest move, the closest rows'
   distance, and per concurrency p50, p95 and p99 ms, requests/s, requests
   and padded rows a batch and the largest distance to the direct call;
   the artifacts' bytes and seconds; whether ``fastimage`` builds here and
   PIL imports, the host's two JPEG decoders);
16. the recipe on real files: behind a ``find_spec("PIL")`` check (without
   PIL the phase says what it skipped and fails), writes an ISIC-2024
   layout in a temp dir (``train-metadata.csv``: ``synthetic_metadata(640,
   16)``; a label-free ``test-metadata.csv`` of 64 rows; 704 1024-px JPEGs
   in ``train-image/image``; both CSVs with the csv module) and runs the
   CLI's main() over it with phase 14's flags less ``--synthetic-data``,
   ``--attn-impl flash`` and ``--workers 4`` at batch 64: (a) stage 1 with
   ``--undersample 320 --add-remaining-samples --cache-staging``, 2
   epochs; (b) stage 2 from it, 1 epoch; (c) ``--is-test --stage 2
   --resume latest`` on (b)'s run. Gates: the flash launches of phase 14 a
   step and a batch (24 + 24 + 24 a stage-1 step, 24 a stage-2 step, 24 an
   eval batch), all on the tensor cores; finite losses; the splits each
   run built equal to what ``get_metadata`` -> ``undersample_data`` give
   for the CSV (64 rows for the test split); every square read from the
   staging cache (stage 1's epoch 2 and second evaluation, all of stage 2)
   bit for bit the decode of the same id, and stage 2 decoding none;
   ``submission.csv`` the 64 test ids in order with probabilities in [0,
   1]. Prints a ``real_data`` JSON line: each run's wall seconds, the
   loop's ``data:`` and ``batch:`` meters and ms a step for each epoch
   (JPEG decode, then the cache) beside phases 12-14's synthetic ones,
   decodes and cache reads, eval rows/s, ``get_metadata`` seconds, and the
   train loader alone's ms a batch decoding JPEGs and from the cache;
17. prints the kernels line (nine entries: the two scan kernels, the
   roofline's chain kernel, and each flash kernel as two entries, one a
   body: ``flash_attn_fwd``, ``flash_attn_bwd_dkv`` and
   ``flash_attn_bwd_dq`` on the tensor cores, bf16, whose launches come
   from the main path, and ``..._cuda_cores``, fp32, whose launches come
   from phase 10's fp32 step; the main path's launches include phases
   14, 15 and 16's; a body launched no time fails. Each flash
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
import gc
import importlib.util
import json
import logging
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

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

GATE_REL = 5e-4          # the gate bench.py put on the Pallas kernel
PROBS_ATOL = 2e-2        # kernel vs plain scan, end to end, bf16 activations
# a batched HTTP answer against the direct call of its row: a batch shape of
# its own moves bf16 sums. An L2-normalised 512-d embedding's elements are
# about 0.04; 5e-3 is three times phase 8's flash-against-einsum distance
# (1.6e-3 and 1.8e-3 on the H100), a larger change than a batch shape.
SERVE_BATCHED_ATOL = {"image_embed": 5e-3, "text_embed": 5e-3, "classify": PROBS_ATOL}
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


class LogLines(logging.Handler):
    """The messages of a logger while this handler is installed."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def observe_cli(pipeline_mod, read_counts, read_bodies):
    """Wrap, in ``pipeline_mod`` (the port's pipeline), the two step
    factories, ``evaluate`` and ``save_checkpoint`` with recorders, and
    install a log handler. Returns (record, undo): each train step's kernel
    launches, flash bodies and loss, each evaluation's seconds and launches,
    each save's seconds, and the log lines. The wrappers observe; the calls
    they wrap are the CLI's own."""
    import torch

    rec = {"steps": [], "evals": [], "saves": [], "lines": LogLines()}
    names = ("make_clip_train_step", "make_classifier_train_step", "evaluate",
             "save_checkpoint")
    orig = {n: getattr(pipeline_mod, n) for n in names}

    def counted(fn, into, **extra):
        c0, b0 = read_counts(), read_bodies()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        into.append({"s": time.perf_counter() - t0,
                     "launches": {k: v - c0[k] for k, v in read_counts().items()},
                     "bodies": {k: {b: n - b0[k][b] for b, n in v.items()}
                                for k, v in read_bodies().items()}, **extra})
        return out

    def factory(make):
        def made(*a, **k):
            fn = make(*a, **k)

            def step(state, batch, seed):
                out = counted(lambda: fn(state, batch, seed), rec["steps"])
                rec["steps"][-1]["loss"] = float(out[1]["loss"])
                return out
            return step
        return made

    def evaluate(*a, **k):
        return counted(lambda: orig["evaluate"](*a, **k), rec["evals"])

    def save(*a, **k):
        t0 = time.perf_counter()
        out = orig["save_checkpoint"](*a, **k)
        rec["saves"].append(time.perf_counter() - t0)
        return out

    root = logging.getLogger("mamba_clip_tpu_torch")
    root.addHandler(rec["lines"])
    pipeline_mod.make_clip_train_step = factory(orig["make_clip_train_step"])
    pipeline_mod.make_classifier_train_step = factory(orig["make_classifier_train_step"])
    pipeline_mod.evaluate = evaluate
    pipeline_mod.save_checkpoint = save

    def undo():
        for n, f in orig.items():
            setattr(pipeline_mod, n, f)
        root.removeHandler(rec["lines"])
    return rec, undo


def run_cli(counters, what, argv, raises=None):
    """``cli.main.main(argv)`` with every count set to 0 just before and read
    just after, observed by ``observe_cli``; with ``raises``, the exception
    it must raise. ``counters``: (reset_counts, read_counts, flash_bodies)."""
    import torch

    from mamba_clip_tpu_torch import pipeline as port_pipeline
    from mamba_clip_tpu_torch.cli.main import main as cli_main

    reset_counts, read_counts, flash_bodies = counters
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    rec, undo = observe_cli(port_pipeline, read_counts, flash_bodies)
    t0 = time.perf_counter()
    try:
        rec["metrics"] = cli_main(argv)
        if raises is not None:
            fail(f"cli {what}: returned {rec['metrics']} where it must raise {raises}")
    except Exception as e:  # a probe's exception is its result; any other fails
        if raises is None or not isinstance(e, raises):
            fail(f"cli {what}: {type(e).__name__}: {e}")
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        undo()
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["total"], rec["total_bodies"] = read_counts(), flash_bodies()
    rec["lines"] = rec["lines"].lines
    say(f"cli {what}: {rec['wall_s']:.1f} s, {len(rec['steps'])} steps, launches a "
        f"step {[st['launches'] for st in rec['steps']]}, evaluations "
        f"{[ev['launches'] for ev in rec['evals']]}, in all {rec['total']}; saves "
        f"{[round(x, 2) for x in rec['saves']]} s; "
        f"{rec.get('metrics', rec.get('error'))}")
    return rec


def check_cli_steps(rec, what, n, want_step, want_eval, eval_batches):
    """The gates on a CLI run's launches: ``n`` train steps, each launching
    exactly ``want_step``; every evaluation ``eval_batches`` batches of
    ``want_eval``; every flash launch on the tensor cores; finite losses."""
    import numpy as np

    no_launch = {k: 0 for k in rec["total"]}
    steps = [st["launches"] for st in rec["steps"]]
    if len(steps) != n or any(st != {**no_launch, **want_step} for st in steps):
        fail(f"cli {what}: launches a step {steps}, expected {n} x {want_step}")
    if not rec["evals"]:
        fail(f"cli {what}: no evaluation")
    want = {**no_launch, **{k: v * eval_batches for k, v in want_eval.items()}}
    for ev in rec["evals"]:
        if ev["launches"] != want:
            fail(f"cli {what}: an evaluation launched {ev['launches']}, expected "
                 f"{eval_batches} x {want_eval}")
    tc = [st["bodies"] for st in rec["steps"]] + [ev["bodies"] for ev in rec["evals"]]
    if any(b["cuda_cores"] for by in tc for b in by.values()):
        fail(f"cli {what}: a flash launch on the CUDA cores: {tc}")
    if not all(np.isfinite(st["loss"]) for st in rec["steps"]):
        fail(f"cli {what}: losses {[st['loss'] for st in rec['steps']]}")


def cli_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 14: the CLI's main() drives (a) a converted checkpoint written
    and loaded, (b) stage 1 from it, (c) stage 2 finding (b)'s run, (d) (c)
    resumed, (e) the medmamba classifier, (f) the error probes, each with its
    gates. Every count is set to 0 just before each run and read just after.
    Returns (the ``cli`` line's fields, the launches of the runs (b)-(e) by
    counter, their flash launches by body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.checkpoint import load_torch_clip
    from mamba_clip_tpu_torch.convert import write_converted_npz
    from mamba_clip_tpu_torch.serving import make_serving_fns
    from mamba_clip_tpu_torch.utils.precision import _POLICIES

    no_launch = {k: 0 for k in read_counts()}
    counters = (reset_counts, read_counts, flash_bodies)
    cli_work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        logs = os.path.join(cli_work, "logs")
        drive = ["--synthetic-data", "--train-num-samples", "192", "--val-num-samples", "64",
                 "--batch-size", "64", "--epochs", "1", "--warmup", "2", "--lr", "1e-4",
                 "--precision", "amp", "--save-most-recent", "--log-every-n-steps", "1",
                 "--grad-clip-norm", "1.0", "--attn-impl", "flash", "--logs", logs]

        def cli_run(what, argv, raises=None):
            return run_cli(counters, what, argv, raises)

        def has_line(rec, line, what):
            if line not in rec["lines"]:
                fail(f"cli {what}: no log line {line!r} among {rec['lines'][:40]}")

        def check_steps(rec, what, n, want_step, want_eval):
            # 64 validation samples: one batch of 64
            check_cli_steps(rec, what, n, want_step, want_eval, eval_batches=1)

        # (a) a converted checkpoint: full-width BiomedCLIP from seed 1 written as the
        # .npz of tools/convert_weights.py with numpy alone, loaded into seed 2's model
        kw = dict(is_clip=True, attn_impl="flash")
        model_a, fns_a, _ = make_serving_fns(
            "biomedclip", generator=torch.Generator().manual_seed(1), **kw)
        npz = os.path.join(cli_work, "biomedclip_converted.npz")
        t0 = time.perf_counter()
        write_converted_npz(model_a, npz)
        npz_write_s = time.perf_counter() - t0
        npz_bytes = os.path.getsize(npz)
        model_b, _, _ = make_serving_fns(
            "biomedclip", generator=torch.Generator().manual_seed(2), **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_torch_clip(npz, model_b)
        torch.cuda.synchronize()
        npz_load_s = time.perf_counter() - t0
        stage_u8 = torch.from_numpy(np.random.RandomState(3).randint(
            0, 256, (64, 256, 256, 3), dtype=np.uint8)).to("cuda")
        emb_a = fns_a["image_embed"](model_a, stage_u8)
        emb_b = fns_a["image_embed"](model_b, stage_u8)
        converted_diff = float((emb_a - emb_b).abs().max())
        say(f"cli converted checkpoint: {npz_bytes} bytes written in {npz_write_s:.2f} s, "
            f"loaded in {npz_load_s:.2f} s; image_embed of a batch-64 staging batch, seed 2 "
            f"loaded against seed 1: max |diff| {converted_diff}")
        if not torch.equal(emb_a, emb_b):
            fail(f"cli: the converted checkpoint's image_embed differs by {converted_diff}")
        del model_a, model_b, fns_a, emb_a, emb_b, stage_u8

        # (b) stage 1 from the converted weights, the run named by the CLI
        s1 = cli_run("stage 1", drive + ["--stage", "1", "--pretrained", npz,
                                         "--tokenizer", "hash"])
        has_line(s1, "Model parameters: 195.71M", "stage 1")
        has_line(s1, f"Loaded pretrained CLIP weights from {npz}", "stage 1")
        check_steps(s1, "stage 1", 3, {"fwd": 24, "dkv": 24, "dq": 24}, {"fwd": 24})
        if not 3.0 <= s1["steps"][0]["loss"] <= 6.0:
            fail(f"cli stage 1: first loss {s1['steps'][0]['loss']} outside [3, 6] "
                 "(ln 64 = 4.159)")
        (s1_name,) = os.listdir(logs)
        s1_dir = os.path.join(logs, s1_name)
        s1_files = sorted(os.listdir(os.path.join(s1_dir, "checkpoints")))
        if not os.path.isfile(os.path.join(s1_dir, "params.txt")) or s1_files != [
                "results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]:
            fail(f"cli stage 1: {s1_name} holds {os.listdir(s1_dir)}, checkpoints {s1_files}")

        # (c) stage 2, which finds stage 1's run by itself
        s2_argv = drive + ["--stage", "2", "--name", "s2", "--tokenizer", "hash"]
        s2 = cli_run("stage 2", s2_argv)
        s1_latest = os.path.join(s1_dir, "checkpoints", "stage_1_epoch_latest")
        has_line(s2, f"Loaded stage-1 weights from {s1_latest}", "stage 2")
        check_steps(s2, "stage 2", 3, {"fwd": 24}, {"fwd": 24})
        s2_dir = os.path.join(logs, "s2", "checkpoints")
        p1 = torch.load(os.path.join(s1_latest, "state.pt"), weights_only=True)["params"]
        p2 = torch.load(os.path.join(s2_dir, "stage_2_epoch_latest", "state.pt"),
                        weights_only=True)["params"]
        moved = [k for k, v in p1.items() if not torch.equal(p2[f"clip.{k}"], v)]
        if moved or not any(k.startswith("fc") for k in p2):
            fail(f"cli stage 2: {len(moved)} clip.* parameters differ from stage 1's: "
                 f"{moved[:5]}")
        del p1, p2
        pauc2 = s2["metrics"].get("partial_auc", float("nan"))
        if not (np.isfinite(s2["metrics"]["val_loss"]) and 0.0 <= pauc2 <= 0.2):
            fail(f"cli stage 2: metrics {s2['metrics']}")
        s2_files = sorted(os.listdir(s2_dir))
        if s2_files != ["results.jsonl", "stage_2_epoch_1", "stage_2_epoch_latest"]:
            fail(f"cli stage 2: checkpoints {s2_files}")

        # (d) the finished stage-2 run resumed: it evaluates the restored state
        with open(os.path.join(s2_dir, "results.jsonl")) as f:
            row = [json.loads(line) for line in f][-1]
        rs = cli_run("stage 2 --resume latest", s2_argv + ["--resume", "latest"])
        has_line(rs, "Resuming from latest checkpoint: "
                 f"{os.path.join(s2_dir, 'stage_2_epoch_1')}", "resume")
        resume_diff = {k: abs(rs["metrics"][k] - row[k]) for k in ("val_loss", "partial_auc")}
        say(f"cli resume: val_loss and partial_auc against stage 2's last row: {resume_diff}")
        if rs["total"]["dkv"] or rs["total"]["dq"] or any(resume_diff.values()):
            fail(f"cli resume: launches {rs['total']}, metrics {rs['metrics']} against {row}")
        check_steps(rs, "resume", 0, {}, {"fwd": 24})

        # (e) the medmamba classifier (CE), which is also SKILL.md's third probe:
        # --resume latest with nothing to resume from logs its line and runs
        mm_argv = drive + ["--model-stage-1", "medmamba", "--train-num-samples", "128",
                           "--name", "mm"]
        mm = cli_run("medmamba", mm_argv + ["--resume", "latest"])
        has_line(mm, "Model parameters: 8.53M", "medmamba")
        has_line(mm, "No latest checkpoint found; starting fresh.", "medmamba")
        check_steps(mm, "medmamba", 2, {"scan_fwd": 14, "scan_bwd": 14}, {"scan_fwd": 14})

        # (f) the other error probes, message for message
        probes = {}
        for what, argv, exc, want in (
                ("--precision bogus", drive + ["--precision", "bogus"], ValueError,
                 f"ValueError: unknown precision 'bogus'; one of {sorted(_POLICIES)}"),
                ("a reused --name", mm_argv, FileExistsError,
                 "FileExistsError: Experiment mm already exists; use --name or --resume."),
                ("--stage 2 --resume latest, empty logs",
                 drive[:-1] + [os.path.join(cli_work, "empty"), "--stage", "2", "--resume",
                               "latest", "--tokenizer", "hash"], FileNotFoundError,
                 "FileNotFoundError: stage 2 has nothing to start from")):
            rec = cli_run(what, argv, raises=exc)
            if not rec["error"].startswith(want) or rec["total"] != no_launch:
                fail(f"cli probe {what}: {rec['error']!r} (launches {rec['total']}), "
                     f"expected {want!r}")
            probes[what] = rec["error"]
    finally:
        shutil.rmtree(cli_work, ignore_errors=True)

    runs = {"stage1": s1, "stage2": s2, "resume": rs, "medmamba": mm}
    launches = {k: sum(r["total"][k] for r in runs.values()) for k in no_launch}
    bodies = {k: {b: sum(r["total_bodies"][k][b] for r in runs.values())
                  for b in ("tensor_cores", "cuda_cores")} for k in ("fwd", "dkv", "dq")}

    def summary(rec, per):
        # the loop's batch meter, one logged step a line
        ms = [1e3 * float(m.group(1)) for m in
              (re.search(r" batch: ([0-9.]+)s", line) for line in rec["lines"]) if m]
        out = {"wall_s": rec["wall_s"], "steps": len(rec["steps"]), "batch_ms_by_step": ms,
               "save_s": rec["saves"], "eval_rows_per_s": [64 / ev["s"] for ev in rec["evals"]],
               "launches_per_step": rec["steps"][0]["launches"] if rec["steps"] else None,
               "launches_per_eval_batch": rec["evals"][0]["launches"],
               "metrics": rec["metrics"]}
        if ms:
            out.update(ms_per_step=ms[-1], first_loss=rec["steps"][0]["loss"],
                       **{per: 64e3 / ms[-1]})
        return out

    line = {"card": card,
            "converted": {"npz_bytes": npz_bytes, "write_s": npz_write_s,
                          "load_s": npz_load_s, "image_embed_max_abs_diff": converted_diff},
            "stage1": summary(s1, "pairs_per_s"), "stage2": summary(s2, "img_per_s"),
            "resume": {**summary(rs, "img_per_s"), "diff_to_stage2_row": resume_diff},
            "medmamba": summary(mm, "img_per_s"), "probes": probes, "launches": launches}
    return line, launches, bodies


def http_request(srv, method, path, body=None):
    """(status, body) of one request to ``srv`` over loopback."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_load(srv, path, bodies, cands, clients, seconds, tol, exact_buckets):
    """Closed-loop clients on ``srv`` for ``seconds``, each with one request
    outstanding, client j posting ``bodies[(j + k) % n]`` as its k-th.
    ``cands[i]`` maps a batch shape to body i's answer when the entry point
    is called on its row repeated to that shape. Every answer must be a 200,
    bit for bit ``cands[i][b]`` for some ``b`` in ``exact_buckets`` (so that
    an answer taken from another row cannot pass, the rows' candidates being
    pairwise different) and within ``tol`` of ``cands[i][1]``, the direct
    call of its row, or the phase fails. Returns the latency percentiles,
    requests, requests/s and the largest distance to the direct call."""
    import http.client

    import numpy as np

    key = {"/embed_image": "embedding", "/embed_text": "embeddings", "/classify": "probs"}[path]
    lats, bad, errs = [], [], [0.0]
    deadline = time.monotonic() + seconds

    def client(j):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        k = 0
        try:
            while time.monotonic() < deadline:
                i = (j + k) % len(bodies)
                k += 1
                t0 = time.perf_counter()
                conn.request("POST", path, body=bodies[i])
                resp = conn.getresponse()
                body = resp.read()
                dt = time.perf_counter() - t0
                if resp.status != 200:
                    bad.append(f"{resp.status}: {body[:300]!r}")
                    continue
                direct = cands[i][1]
                got = np.asarray(json.loads(body)[key], np.float32).reshape(direct.shape)
                err = float(np.abs(got - direct).max())
                errs.append(err)
                if not err <= tol:
                    bad.append(f"body {i}: off its direct call by {err:.3e} (bound {tol:g})")
                if not any(np.array_equal(got, cands[i][b]) for b in exact_buckets):
                    bad.append(f"body {i}: not bit for bit its row's answer at any batch "
                               f"shape of {list(exact_buckets)} (off the direct call by "
                               f"{err:.3e})")
                lats.append(dt)
        except Exception as e:  # reported below; the phase fails
            bad.append(f"client {j}: {e!r}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(j,)) for j in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 150)
    wall = time.perf_counter() - t0
    if bad or any(t.is_alive() for t in threads) or not lats:
        fail(f"http {path} at concurrency {clients}: {len(bad)} bad answers, first "
             f"{bad[:3]}, {len(lats)} good; largest distance to the direct call "
             f"{max(errs):.3e}")
    ms = 1e3 * np.asarray(lats)
    return {"clients": clients, "requests": len(lats), "wall_s": wall,
            "req_per_s": len(lats) / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)), "p99_ms": float(np.percentile(ms, 99)),
            "max_abs_err_to_direct": max(errs)}


def jpeg_rows(n, size, seed):
    """``n`` JPEG bodies (PIL, quality 90) of ``size``-square images that
    differ in kind as well as colour: a flat colour, stripes of a period of
    their own, noise of an amplitude of its own around a colour, a disc of
    a radius of its own. A random-weight model maps noise squares to nearly
    one answer; these keep the rows' answers apart."""
    import io

    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        fail("phase 15 posts JPEG bodies, and PIL, which encodes them, does not import")
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    bodies = []
    for i in range(n):
        c = rs.randint(0, 256, 3)
        kind = i % 4
        if kind == 0:
            img = np.broadcast_to(c, (size, size, 3))
        elif kind == 1:
            m = ((xx // (2 + 3 * i)) % 2)[..., None]
            img = c * m + (255 - c) * (1 - m)
        elif kind == 2:
            img = c + rs.normal(0, 10 + 10 * i, (size, size, 3))
        else:
            r = size * (0.1 + 0.05 * i)
            m = (((xx - size / 2) ** 2 + (yy - size / 2) ** 2) < r * r)[..., None]
            img = c * m + (255 - c) * (1 - m)
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="JPEG",
                                                                     quality=90)
        bodies.append(buf.getvalue())
    return bodies


def serving_phase(card, reset_counts, read_counts, flash_bodies):
    """Phase 15: export and load serving artifacts, then serve them over
    HTTP, each gate as the module docstring says. Every count is set to 0
    just before each call of a loaded artifact (directly or through a
    server) and read just after. Returns (the ``serving_http`` line's
    fields, those calls' launches by counter, their flash launches by
    body)."""
    import numpy as np
    import torch

    from mamba_clip_tpu_torch.data import fastimage
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer
    from mamba_clip_tpu_torch.serve import MicroBatcher, _bucket
    from mamba_clip_tpu_torch.serve_http import make_server, warm_buckets
    from mamba_clip_tpu_torch.serving import (compress_params, decompress_params,
                                              export_serving, load_serving, make_serving_fns)

    total = {k: 0 for k in read_counts()}
    total_bodies = {k: {"tensor_cores": 0, "cuda_cores": 0} for k in ("fwd", "dkv", "dq")}

    def counted(fn):
        """``fn()`` with every count set to 0 just before and read just after."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts(), flash_bodies()

    def check(what, entry, n, counts, bodies):
        """``n`` dispatches of ``entry``: 12 flash forwards each on the tensor
        cores (14 scan forwards for ``classify``) and nothing else. Adds the
        counts to the phase's."""
        want = {k: 0 for k in counts}
        want["scan_fwd" if entry == "classify" else "fwd"] = (
            (14 if entry == "classify" else 12) * n)
        want_bodies = {k: {"tensor_cores": want[k], "cuda_cores": 0} for k in total_bodies}
        if counts != want or bodies != want_bodies:
            fail(f"serving {what}: launches {counts}, by body {bodies}; expected {want} "
                 f"for {n} dispatches of {entry}")
        for k in total:
            total[k] += counts[k]
        for k, by in bodies.items():
            for body, c in by.items():
                total_bodies[k][body] += c

    def call(what, entry, fn):
        out, counts, bodies = counted(fn)
        check(what, entry, 1, counts, bodies)
        return out

    work = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    servers = []
    try:
        clip_kw = dict(is_clip=True, precision="amp")  # an artifact runs the flash interior
        clip, cfns, cmeta = make_serving_fns(
            "biomedclip", device="cuda", generator=torch.Generator().manual_seed(0),
            attn_impl="flash", **clip_kw)
        mm, mfns, mmeta = make_serving_fns(
            "medmamba", precision="amp", device="cuda", generator=torch.Generator().manual_seed(0))
        inproc = {"image_embed": lambda x: cfns["image_embed"](clip, x),
                  "text_embed": lambda x: cfns["text_embed"](clip, x),
                  "classify": lambda x: mfns["classify"](mm, x)}

        # (a) export and load
        arts = {}
        for name, model_name, model, kw, compress in (
                ("clip_raw", "biomedclip", clip, clip_kw, False),
                ("clip_int8", "biomedclip", clip, clip_kw, True),
                ("medmamba_raw", "medmamba", mm, dict(precision="amp"), False)):
            out = os.path.join(work, name)
            t0 = time.perf_counter()
            man = export_serving(out, model_name, variables=model.state_dict(),
                                 compress_weights=compress, **kw)
            export_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)
                         if os.path.isfile(os.path.join(out, f)))
            t0 = time.perf_counter()
            served = load_serving(out, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            arts[name] = {"dir": out, "served": served, "bytes": nbytes,
                          "params_bytes": os.path.getsize(os.path.join(out, "params.pt")),
                          "export_s": export_s, "load_s": load_s, "weights": man["weights"],
                          "parameters": sum(p.numel() for p in model.parameters())}
            say(f"serving artifact {name}: {nbytes} B ({arts[name]['params_bytes']} B of "
                f"weights, {man['weights']}), exported in {export_s:.3f} s, loaded onto the "
                f"card in {load_s:.3f} s; entry points {sorted(man['entry_points'])}")

        # (b) loaded against in-process, batch 64
        rs = np.random.RandomState(10)
        S, Sm = cmeta["staging_size"], mmeta["staging_size"]
        texts = [REPORTS[i % len(REPORTS)] * (1 + i % 5) for i in range(64)]
        inputs = {
            "image_embed": torch.from_numpy(
                rs.randint(0, 256, (64, S, S, 3), dtype=np.uint8)).cuda(),
            "text_embed": torch.from_numpy(
                HashTokenizer(context_length=cmeta["context_length"])(texts)).cuda(),
            "classify": torch.from_numpy(
                rs.randint(0, 256, (64, Sm, Sm, 3), dtype=np.uint8)).cuda()}
        for name, x in inputs.items():  # first calls: cuBLAS set-up, not counted
            inproc[name](x)
        raw_out = {}
        for art, names in (("clip_raw", ("image_embed", "text_embed")),
                           ("medmamba_raw", ("classify",))):
            for name in names:
                got = call(f"{art} {name}", name,
                           lambda: arts[art]["served"][name](inputs[name]))
                want = inproc[name](inputs[name])
                if not torch.equal(got, want):
                    fail(f"{art} {name}: the loaded artifact differs from make_serving_fns "
                         f"by {float((got - want).abs().max()):.3e}")
                if not torch.isfinite(got).all() or got.shape[0] != 64:
                    fail(f"{art} {name}: bad output {tuple(got.shape)}")
                raw_out[name] = got
        stored = torch.load(os.path.join(arts["clip_int8"]["dir"], "params.pt"),
                            weights_only=True)
        again = compress_params(clip.state_dict(), clip)
        if stored.keys() != again.keys() or not all(torch.equal(stored[k], again[k].cpu())
                                                     for k in stored):
            fail("the compressed artifact's tensors differ from compress_params of the "
                 "raw weights")
        n_int8 = sum(1 for k in stored if k.endswith(".__int8_cols__"))
        clip.load_state_dict(decompress_params(stored))  # the in-process model, decompressed
        cos = {}
        for name in ("image_embed", "text_embed"):
            got = call(f"clip_int8 {name}", name,
                       lambda: arts["clip_int8"]["served"][name](inputs[name]))
            want = inproc[name](inputs[name])
            if not torch.equal(got, want):
                fail(f"clip_int8 {name}: differs from the in-process model given the "
                     f"decompressed weights by {float((got - want).abs().max()):.3e}")
            cos[name] = float((got * raw_out[name]).sum(-1).min())
        say(f"serving: the loaded artifacts bit for bit equal to make_serving_fns "
            f"(image_embed, text_embed, classify at batch 64); {n_int8} int8 tensors equal "
            f"to compress_params; lowest cosine compressed to raw {cos} (bound 0.999)")
        if not all(c > 0.999 for c in cos.values()):
            fail(f"the compressed artifact's embeddings: lowest cosine {cos}, bound 0.999")
        del clip, mm, cfns, mfns, inproc, stored, again, raw_out, inputs
        for a in arts.values():
            a.pop("served")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the HTTP host over each raw artifact: one request a device
        # call, and the MicroBatcher at its default max_batch
        hosts = {}
        for art in ("clip_raw", "medmamba_raw"):
            for max_batch in (1, 16):
                srv = make_server(arts[art]["dir"], port=0, host="127.0.0.1",
                                  max_batch=max_batch, device="cuda")
                threading.Thread(target=srv.serve_forever, daemon=True).start()
                servers.append(srv)
                hosts[art, max_batch] = srv
                status, body = http_request(srv, "GET", "/healthz")
                health = json.loads(body) if status == 200 else {}
                if health.get("status") != "ok" or health["manifest"]["weights"] != "raw":
                    fail(f"/healthz of {art} (max_batch {max_batch}): {status} {body[:300]!r}")
        # 16 JPEG bodies an image endpoint, 16 texts of distinct openings
        pools = {"image_embed": jpeg_rows(16, S, 11), "classify": jpeg_rows(16, Sm, 12),
                 "text_embed": [json.dumps({"texts": [f"Case {i}. {t}"]}).encode()
                                for i, t in enumerate(texts[:16])]}
        shapes = sorted({_bucket(1 << k) for k in range(5)})  # the batcher's, up to 16
        endpoints = {}
        for name, path, art in (("image_embed", "/embed_image", "clip_raw"),
                                ("text_embed", "/embed_text", "clip_raw"),
                                ("classify", "/classify", "medmamba_raw")):
            one, many = hosts[art, 1], hosts[art, 16]
            tol = SERVE_BATCHED_ATOL[name]

            def row_of(body, srv=one, name=name):
                """The entry point's input row of one request body, as the host makes it."""
                if name == "text_embed":
                    return np.asarray(srv.served["tokenize"](json.loads(body)["texts"]))
                return srv.decode(body)[None]

            # each body's answer at every batch shape the batcher dispatches:
            # its row repeated to that shape, the first row's answer kept
            cands = []
            for body in pools[name]:
                x = row_of(body)
                by_shape = {}
                for b in shapes:
                    out = call(f"{name} direct call at batch {b}", name,
                               lambda x=x, b=b: one.served[name](np.repeat(x, b, axis=0)))
                    by_shape[b] = out[:1].cpu().numpy()
                    if name != "text_embed":  # an image's answer is its row; texts' a list
                        by_shape[b] = by_shape[b][0]
                cands.append(by_shape)
            shape_noise = max(float(np.abs(c[b] - c[1]).max()) for c in cands for b in shapes)
            apart = min(float(np.abs(ci[1] - cj[1]).max())
                        for i, ci in enumerate(cands) for cj in cands[:i])
            shared = [(i, j) for i, ci in enumerate(cands) for j, cj in enumerate(cands[:i])
                      if any(np.array_equal(ci[b], cj[c]) for b in shapes for c in shapes)]
            say(f"http {path}: 16 rows; their answers at batch {shapes} lie within "
                f"{shape_noise:.3e} of the direct call (bound {tol:g}); the closest two rows' "
                f"direct answers {apart:.3e} apart; rows sharing an answer: {shared}")
            if shared or not shape_noise <= tol:
                fail(f"http {path}: rows {shared} share an answer, or the batch shapes move an "
                     f"answer by {shape_noise:.3e} (bound {tol:g}): a request answered from "
                     "another row could pass")
            # one request a device call: bit for bit the direct call of its row
            r, counts, bodies = counted(
                lambda: http_load(one, path, pools[name], cands, 1, 1.0, 0.0, (1,)))
            check(f"{name} max_batch=1", name, r["requests"], counts, bodies)
            res = {"max_batch_1": r, "batch_shape_noise": shape_noise,
                   "closest_rows_apart": apart}
            # the MicroBatcher: each bucket shape once, then 1, 4 and 16 clients
            mb = many.batchers[name]
            warm = ([json.loads(pools[name][0])["texts"][0]] if name == "text_embed"
                    else pools[name][0])
            n_shapes, counts, bodies = counted(lambda: warm_buckets(many, name, warm, 16))
            check(f"{name} warm_buckets", name, n_shapes, counts, bodies)
            for clients in (1, 4, 16):
                r0, b0, k0 = mb.requests, mb.batches, len(mb.batch_rows)
                r, counts, bodies = counted(lambda: http_load(
                    many, path, pools[name], cands, clients, 2.0, tol, shapes))
                n_batches = mb.batches - b0
                check(f"{name} at concurrency {clients}", name, n_batches, counts, bodies)
                if mb.requests - r0 != r["requests"]:
                    fail(f"{name}: the batcher answered {mb.requests - r0} requests, the "
                         f"clients counted {r['requests']}")
                r.update(batches=n_batches, requests_per_batch=r["requests"] / n_batches,
                         padded_rows_per_batch=float(np.mean(mb.batch_rows[k0:])))
                res[f"c{clients}"] = r
                say(f"http {path} clients={clients}: {r['req_per_s']:.1f} req/s, p50 "
                    f"{r['p50_ms']:.2f} p95 {r['p95_ms']:.2f} p99 {r['p99_ms']:.2f} ms, "
                    f"{r['requests_per_batch']:.2f} requests a batch ({n_batches} batches); "
                    f"every answer a 200, bit for bit its row's at a batch shape, at most "
                    f"{r['max_abs_err_to_direct']:.3e} off its direct call (bound {tol:g})")
            say(f"http {path} max_batch=1: {res['max_batch_1']['requests']} requests, p50 "
                f"{res['max_batch_1']['p50_ms']:.2f} ms, each bit for bit its direct call")
            endpoints[name] = res

        # JAX's 404 message for an unknown path; a malformed body is a 400
        srv = hosts["clip_raw", 16]
        probes = {}
        for what, method, path, body, code, want in (
                ("unknown POST", "POST", "/classify", pools["image_embed"][0], 404,
                 "no handler for POST /classify (entry points: ['image_embed', "
                 "'text_embed'])"),
                ("unknown GET", "GET", "/nope", None, 404, "no handler for GET /nope"),
                ("malformed JSON", "POST", "/embed_text", b"not json", 400, None),
                ("truncated JPEG", "POST", "/embed_image", pools["image_embed"][0][:200],
                 400, None)):
            (status, out), counts, bodies = counted(
                lambda: http_request(srv, method, path, body))
            check(what, "image_embed", 0, counts, bodies)
            err = json.loads(out).get("error", "")
            if status != code or (want is not None and err != want) or not err:
                fail(f"http {what}: {status} {out[:300]!r}, expected {code} {want!r}")
            probes[what] = f"{status} {err}"
        say(f"http probes: {probes}")

        for srv in servers:
            srv.shutdown()
            srv.server_close()
        stuck = [name for srv in servers for name, b in srv.batchers.items()
                 if isinstance(b, MicroBatcher) and (b._thread.is_alive()
                                                     or b._completer.is_alive())]
        servers = []
        if stuck:
            fail(f"the batchers of {stuck} still run after server_close")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(work, ignore_errors=True)

    line = {"card": card,
            "artifacts": {name: {k: a[k] for k in ("bytes", "params_bytes", "weights",
                                                   "parameters", "export_s", "load_s")}
                          for name, a in arts.items()},
            "int8_tensors": n_int8, "lowest_cosine_int8_to_raw": cos,
            "fastimage_available": fastimage.available(),
            "pil_available": importlib.util.find_spec("PIL") is not None, "payload": "jpeg",
            "max_batch": 16, "max_delay_ms": 5.0, "endpoints": endpoints, "probes": probes,
            "launches": total}
    return line, total, total_bodies


def write_isic_layout(data_dir, n_train, n_test, side, seed):
    """An ISIC-2024 layout under ``data_dir``: ``train-metadata.csv``
    (``synthetic_metadata(n_train, seed)``), a label-free
    ``test-metadata.csv`` of ``n_test`` rows with ids of their own, and
    ``train-image/image/<isic_id>.jpg`` for every id: ``side``-square JPEGs
    (PIL, quality 92) of a smooth field, bicubic from a 4 x 4 grid, with
    noise of +-3 levels, written by 8 threads. Both CSVs are written with
    the csv module (``write_csv``, pandas' ``to_csv`` text). Returns (the
    test ids, the JPEGs' sizes in bytes)."""
    import io

    import numpy as np
    from PIL import Image

    from mamba_clip_tpu_torch.data.dataset import ColumnTable, synthetic_metadata
    from mamba_clip_tpu_torch.data.metadata import write_csv

    img_dir = os.path.join(data_dir, "train-image", "image")
    os.makedirs(img_dir)
    train = synthetic_metadata(n_train, seed)
    write_csv(train, os.path.join(data_dir, "train-metadata.csv"))
    rows = synthetic_metadata(n_test, seed + 1)
    test_ids = [f"ISIC_9{i:06d}" for i in range(n_test)]
    write_csv(ColumnTable({"isic_id": test_ids, **{
        c: rows[c] for c in rows.columns if c not in ("isic_id", "target")}}),
        os.path.join(data_dir, "test-metadata.csv"))
    ids = list(train["isic_id"]) + test_ids

    def write(k):
        rng = np.random.default_rng((seed, k))
        grid = Image.fromarray(rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
        field = np.asarray(grid.resize((side, side), Image.BICUBIC), np.int16)
        noisy = field + rng.integers(-3, 4, (side, side, 3), dtype=np.int16)
        buf = io.BytesIO()
        Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8)).save(buf, format="JPEG",
                                                                       quality=92)
        with open(os.path.join(img_dir, f"{ids[k]}.jpg"), "wb") as f:
            f.write(buf.getvalue())
        return len(buf.getvalue())

    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(write, range(len(ids))))
    return test_ids, sizes


def real_data_phase(card, reset_counts, read_counts, flash_bodies, synthetic):
    """Phase 16: the README's recipe on files in the ISIC-2024 layout
    (``write_isic_layout``: 640 train rows, 64 label-free test rows, 1024-px
    JPEGs) through the CLI's main(), full-width BiomedCLIP under
    ``--attn-impl flash`` at batch 64, ``--workers 4``: (a) stage 1,
    ``--undersample 320 --add-remaining-samples --cache-staging``, 2 epochs
    (the first decodes the JPEGs, the second reads the staging cache);
    (b) stage 2 from (a)'s run, 1 epoch; (c) ``--is-test --stage 2
    --resume latest`` on (b)'s run, which writes ``submission.csv``. Gates
    as the module docstring says. ``synthetic``: phases 12-14's figures,
    printed beside this phase's. Returns (the ``real_data`` line's fields,
    the runs' launches by counter, their flash launches by body)."""
    import csv
    import hashlib

    import numpy as np

    from mamba_clip_tpu_torch import pipeline as port_pipeline
    from mamba_clip_tpu_torch.config import parse_args
    from mamba_clip_tpu_torch.data.dataset import IsicChallengeDataset
    from mamba_clip_tpu_torch.data.loader import get_data
    from mamba_clip_tpu_torch.data.metadata import get_metadata, undersample_data
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer

    if importlib.util.find_spec("PIL") is None:
        say("real data: SKIPPED: phase 16 writes and decodes JPEGs with PIL, which is not "
            "installed; the ISIC recipe did not run")
        fail("phase 16 (the recipe on real files) cannot run without PIL")
    counters = (reset_counts, read_counts, flash_bodies)
    work = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        data_dir = os.path.join(work, "isic")
        t0 = time.perf_counter()
        test_ids, sizes = write_isic_layout(data_dir, 640, 64, 1024, seed=16)
        write_s = time.perf_counter() - t0
        say(f"real data: wrote {len(sizes)} 1024-px JPEGs (quality 92), mean "
            f"{np.mean(sizes):.0f} bytes (min {min(sizes)}, max {max(sizes)}), and both "
            f"CSVs in {write_s:.1f} s")
        base = ["--data-path", f"{data_dir}/", "--batch-size", "64", "--workers", "4",
                "--warmup", "2", "--lr", "1e-4", "--precision", "amp", "--save-most-recent",
                "--save-frequency", "0", "--log-every-n-steps", "1", "--grad-clip-norm", "1.0",
                "--attn-impl", "flash", "--tokenizer", "hash", "--undersample", "320",
                "--add-remaining-samples", "--cache-staging", os.path.join(work, "cache"),
                "--logs", os.path.join(work, "logs")]
        argv = {"stage1": base + ["--stage", "1", "--epochs", "2"],
                "stage2": base + ["--stage", "2", "--epochs", "1", "--name", "s2"],
                "is_test": base + ["--stage", "2", "--epochs", "1", "--name", "s2",
                                   "--is-test", "--resume", "latest"]}
        # the splits the port's metadata layer gives for these flags
        args = parse_args(argv["stage1"])
        train_md, val_md, _ = get_metadata(args)
        train_md, val_md = undersample_data(args, train_md, val_md)
        want_sizes = {"train": len(train_md), "val": len(val_md)}

        # observers, as observe_cli's: get_metadata's seconds, the splits
        # get_data made, and each staging square decoded or read from the cache
        seen = {"metadata_s": [], "splits": [], "decoded": {}, "hits": [], "decode_s": []}
        lock = threading.Lock()
        orig = {"get_metadata": port_pipeline.get_metadata, "get_data": port_pipeline.get_data,
                "load": IsicChallengeDataset._load_image}

        def timed_metadata(*a, **k):
            t0 = time.perf_counter()
            out = orig["get_metadata"](*a, **k)
            seen["metadata_s"].append(time.perf_counter() - t0)
            return out

        def sized_data(*a, **k):
            out = orig["get_data"](*a, **k)
            seen["splits"].append({s: len(d.loader.dataset) for s, d in out.items()})
            return out

        def load(self, isic_id, idx=None):
            hit = self.cache is not None and idx is not None and bool(self.cache.done[idx])
            t0 = time.perf_counter()
            out = orig["load"](self, isic_id, idx)
            dt = time.perf_counter() - t0
            digest = hashlib.sha1(np.ascontiguousarray(out)).hexdigest()
            with lock:
                if hit:
                    seen["hits"].append(((self.is_train, isic_id), digest))
                else:
                    seen["decoded"][(self.is_train, isic_id)] = digest
                    seen["decode_s"].append(dt)
            return out

        port_pipeline.get_metadata, port_pipeline.get_data = timed_metadata, sized_data
        IsicChallengeDataset._load_image = load
        runs = {}
        try:
            for name in ("stage1", "stage2", "is_test"):
                n_hits, n_dec = len(seen["hits"]), len(seen["decode_s"])
                runs[name] = run_cli(counters, f"real data {name}", argv[name])
                hits = seen["hits"][n_hits:]
                runs[name]["hits"] = {"train": sum(1 for (tr, _), _ in hits if tr),
                                      "eval": sum(1 for (tr, _), _ in hits if not tr)}
                runs[name]["decodes"] = len(seen["decode_s"]) - n_dec
                runs[name]["decode_ms"] = 1e3 * float(np.mean(seen["decode_s"][n_dec:] or [0]))
        finally:
            port_pipeline.get_metadata, port_pipeline.get_data = (orig["get_metadata"],
                                                                  orig["get_data"])
            IsicChallengeDataset._load_image = orig["load"]

        # gates: the launches of phase 14 a step and a batch, on the tensor cores
        n_val_batches = -(-want_sizes["val"] // 64)
        check_cli_steps(runs["stage1"], "real data stage 1", 2 * (want_sizes["train"] // 64),
                        {"fwd": 24, "dkv": 24, "dq": 24}, {"fwd": 24}, n_val_batches)
        check_cli_steps(runs["stage2"], "real data stage 2", want_sizes["train"] // 64,
                        {"fwd": 24}, {"fwd": 24}, n_val_batches)
        check_cli_steps(runs["is_test"], "real data --is-test", 0, {}, {"fwd": 24}, 1)
        # the splits each run built
        splits = seen["splits"]
        if splits != [want_sizes, want_sizes, {"test": 64}]:
            fail(f"real data: the runs built splits {splits}; get_metadata -> "
                 f"undersample_data give {want_sizes} and the test CSV 64 rows")
        # epoch 2 (and stage 2) read the squares epoch 1 decoded, bit for bit.
        # Each epoch draws (train // 64) * 64 of the train rows, so at least
        # twice that less the split's size were drawn in both epochs; the
        # second evaluation reads every validation square from the cache.
        wrong = [key for key, d in seen["hits"] if seen["decoded"].get(key) != d]
        hits1 = runs["stage1"]["hits"]
        drawn = (want_sizes["train"] // 64) * 64
        if (wrong or hits1["train"] < 2 * drawn - want_sizes["train"]
                or hits1["eval"] != want_sizes["val"] or runs["stage2"]["decodes"]):
            fail(f"real data: {len(wrong)} cached squares differ from (or were never) their "
                 f"decodes, e.g. {wrong[:3]}; stage 1 read {hits1} from the cache (at least "
                 f"{2 * drawn - want_sizes['train']} train, {want_sizes['val']} eval); stage 2 "
                 f"decoded {runs['stage2']['decodes']} again")
        # submission.csv: the 64 test ids in order, probabilities in [0, 1]
        sub_path = os.path.join(work, "logs", "s2", "checkpoints", "submission.csv")
        with open(sub_path, newline="") as f:
            sub = list(csv.reader(f))
        probs = [float(p) for _, p in sub[1:]]
        if (sub[0] != ["isic_id", "target"] or [r[0] for r in sub[1:]] != test_ids
                or not all(0.0 <= p <= 1.0 for p in probs)):
            fail(f"real data: submission.csv holds {len(sub) - 1} rows, header {sub[0]}, "
                 f"first {sub[1:3]}; expected the 64 test ids in order with probabilities "
                 "in [0, 1]")
        if runs["is_test"]["metrics"].get("num_samples") != 64:
            fail(f"real data --is-test: metrics {runs['is_test']['metrics']}")

        # the train loader alone, as stage 1 builds it, over one epoch's
        # batches twice: decoding the JPEGs (and filling a new cache), then
        # reading that cache
        info = get_data(args.replace(cache_staging=os.path.join(work, "cache_alone")),
                        train_metadata=train_md, val_metadata=val_md,
                        tokenizer=HashTokenizer(), staging_size=256)["train"]
        loader_ms = {}
        for source in ("jpeg_decode", "staging_cache"):
            info.set_epoch(0)
            t0 = time.perf_counter()
            n = sum(1 for _ in info.loader)
            loader_ms[source] = 1e3 * (time.perf_counter() - t0) / n
        say(f"real data: the train loader alone, {n} batches of 64 at --workers 4: "
            f"{loader_ms['jpeg_decode']:.1f} ms a batch decoding JPEGs, "
            f"{loader_ms['staging_cache']:.1f} ms from the staging cache")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def meters(rec):
        """The loop's meters by epoch: the batch meter of each step, the
        data meter (the epoch's mean wait for a batch) at its last step."""
        out = {}
        for line in rec["lines"]:
            m = re.match(r"Train Epoch: (\d+) .* data: ([0-9.]+)s batch: ([0-9.]+)s", line)
            if m:
                ep = out.setdefault(int(m.group(1)), {"batch_ms_by_step": []})
                ep["batch_ms_by_step"].append(1e3 * float(m.group(3)))
                ep["data_s"] = float(m.group(2))
        for ep in out.values():
            ms = ep["batch_ms_by_step"]
            ep.update(ms_per_step=ms[-1], ms_per_step_after_first=float(np.mean(ms[1:] or ms)))
        return out

    rows = {"stage1": want_sizes["val"], "stage2": want_sizes["val"], "is_test": 64}
    line = {"card": card, "jpeg_bytes_mean": float(np.mean(sizes)), "jpegs": len(sizes),
            "write_s": write_s, "splits": want_sizes, "get_metadata_s": seen["metadata_s"],
            "loader_alone_ms_per_batch": loader_ms, "synthetic": synthetic}
    for name, rec in runs.items():
        line[name] = {
            "wall_s": rec["wall_s"], "steps": len(rec["steps"]),
            "epochs": meters(rec), "decodes": rec["decodes"], "cache_reads": rec["hits"],
            "decode_ms_per_img_in_loop": rec["decode_ms"],
            "eval_s": [ev["s"] for ev in rec["evals"]],
            "eval_rows_per_s": [rows[name] / ev["s"] for ev in rec["evals"]],
            "save_s": rec["saves"], "metrics": rec["metrics"],
            "losses": [st["loss"] for st in rec["steps"]]}
    launches = {k: sum(r["total"][k] for r in runs.values()) for k in runs["stage1"]["total"]}
    bodies = {k: {b: sum(r["total_bodies"][k][b] for r in runs.values())
                  for b in ("tensor_cores", "cuda_cores")} for k in ("fwd", "dkv", "dq")}
    return line, launches, bodies


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
    from mamba_clip_tpu_torch.config import RunState, parse_args
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
    # the flags as the CLI parses them; the values these phases run at
    loop_flags = dict(
        batch_size=EB, epochs=1, workers=4, seed=SEED, synthetic_data=True, is_test=False,
        train_num_samples=N_TRAIN, val_num_samples=N_VAL, sampling=None, val_frequency=1,
        log_every_n_steps=2, save_frequency=1, delete_previous_checkpoint=False,
        save_most_recent=False, return_best=False, eval_loss=None, hopt_direction="minimize",
        trace=False)
    loop_argv = ["--synthetic-data", "--batch-size", str(EB), "--seed", str(SEED),
                 "--train-num-samples", str(N_TRAIN), "--val-num-samples", str(N_VAL),
                 "--log-every-n-steps", "2"]

    def parsed(argv, want):
        args = parse_args(argv)
        off = {k: (getattr(args, k), v) for k, v in want.items() if getattr(args, k) != v}
        if off:
            fail(f"parse_args({argv}) differs from the flags these phases run at: {off}")
        return args

    args1 = parsed(loop_argv + ["--stage", "1", "--checkpoint-steps", "2", "--grad-clip-norm",
                                "1.0"],
                   {**CLIP_TRAIN_ARGS, **loop_flags, "stage": 1, "checkpoint_steps": 2,
                    "class_weighted_loss": False})
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
        run1 = RunState(checkpoint_path=os.path.join(work, "checkpoints"))
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
        args2 = parsed(loop_argv + ["--stage", "2", "--class-weighted-loss"],
                       {**TRAIN_ARGS, **loop_flags, "stage": 2, "checkpoint_steps": 0,
                        "class_weighted_loss": True})
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
        run2 = RunState(checkpoint_path=os.path.join(work, "checkpoints2"))
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

    # 14. the CLI: the two-stage recipe through mamba_clip_tpu_torch.cli.main's
    # main(), in this process, with the Drive recipe's flags and --attn-impl flash
    cli_line, cli_launches, cli_bodies = cli_phase(card, reset_counts, read_counts,
                                                   flash_bodies)
    # phases 12 and 13 in this run: the same step functions, driven from Python
    cli_line.update(phase12_ms_per_step=1e3 * m1["batch_time_last"],
                    phase13_ms_per_step=1e3 * m2["batch_time_last"])
    say(json.dumps({"cli": cli_line}))

    # 15. serving artifacts and the HTTP host: export, load and serve over
    # loopback through mamba_clip_tpu_torch.serve_http
    gc.collect()
    torch.cuda.empty_cache()
    http_line, http_launches, http_bodies = serving_phase(card, reset_counts, read_counts,
                                                          flash_bodies)
    say(json.dumps({"serving_http": http_line}))

    # 16. the recipe on files in the ISIC-2024 layout: JPEG decode, the
    # staging cache and submission.csv, beside phases 12-14's synthetic loops
    gc.collect()
    torch.cuda.empty_cache()
    synthetic = {"phase12_ms_per_step": 1e3 * m1["batch_time_last"],
                 "phase12_data_s": m1["data_time_avg"],
                 "phase13_ms_per_step": 1e3 * m2["batch_time_last"],
                 "phase13_data_s": m2["data_time_avg"],
                 "phase14_stage1_ms_per_step": cli_line["stage1"].get("ms_per_step"),
                 "phase14_stage2_ms_per_step": cli_line["stage2"].get("ms_per_step")}
    real_line, _, real_bodies = real_data_phase(card, reset_counts, read_counts, flash_bodies,
                                                synthetic)
    say(json.dumps({"real_data": real_line}))

    # 17. kernels line, then the device line. Each attention kernel as two
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
                   "medmamba_clip_train": mm_train_bodies, "clip_train_fp32": fp32_bodies,
                   "cli": cli_bodies, "serving_http": http_bodies, "real_data": real_bodies}
    main_paths = {"fwd": ("clip_serve", "clip_train", "epoch_stage1", "epoch_stage2", "cli",
                          "serving_http", "real_data"),
                  "dkv": ("clip_train", "epoch_stage1", "cli", "real_data"),
                  "dq": ("clip_train", "epoch_stage1", "cli", "real_data")}
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
        "launches": launches + train_fwd + cli_launches["scan_fwd"] + http_launches["scan_fwd"],
        "launches_by_path": {"serve": launches, "train": train_fwd, "clip_serve": clip_scans,
                             "medmamba_clip_image_embed": mm_launches["image_embed"]["scan"],
                             "cli": cli_launches["scan_fwd"],
                             "serving_http": http_launches["scan_fwd"]},
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
        "launches": train_bwd + cli_launches["scan_bwd"],
        "launches_by_path": {"serve": serve_bwd, "train": train_bwd,
                             "cli": cli_launches["scan_bwd"],
                             "serving_http": http_launches["scan_bwd"]},
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
        "launches_by_path": {"scan_roofline": chain_launches, "epoch_stage1": 0,
                             "cli": cli_launches["vpu_chain"]},
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
