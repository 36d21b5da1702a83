"""Where the time of a train step goes on the card.

    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.profile_train \\
        [--model medmamba|biomedclip] [--batch 64] [--iters 5] [--out FILE]

``--model medmamba`` (the default) builds the stage-2 CE train step of
full-width medmamba (:func:`medmamba_train_setup`), ``--model biomedclip``
the stage-1 contrastive step of full-width BiomedCLIP under
``attn_impl="flash"`` (:func:`clip_train_setup`: ViT-B/16 at 224, the
12-layer BERT at context 256, tokens of report-like text); both at image
224, staging 256, precision ``amp``, random weights from seed 0, AdamW at
the JAX package's ``config.Args`` defaults under a cosine schedule (the
contrastive step with clipping at 1.0, as the JAX package benchmarks it),
on the CUDA card through the port's entry points. It takes 3 warm-up steps
on device-resident uint8 batches, times ``iters`` steps and traces
``iters`` more with ``torch.profiler``. Prints one JSON object: the card;
host ms per step untraced and rows (images or pairs) per second; device ms
per step summed over the kernels; the device's idle share; kernels per
step; the hand-written kernels' launches per step and their device ms per
step; the peak device memory of the timed steps; the optimizer update
alone (host and device ms, kernels, per update of the step's gradients);
and device ms per step of the 25 costliest kernels by exact name
(``--out`` writes every kernel). Fails where there is no card or the
trace holds no device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.preprocess_cfg import get_transform_config
from .models import build_classifier, build_clip
from .ops.flash_attn import (flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_fwd,
                             resolve_attn_flash)
from .ops.selective_scan import selective_scan_bwd, selective_scan_fwd
from .optim import build_optimizer
from .profile_classify import card_name, trace_summary
from .profile_embed import report_tokens
from .schedules import create_schedule
from .train import create_train_state, make_classifier_train_step, make_clip_train_step
from .utils.precision import get_policy

# The training flags the step reads, at the JAX package's config.Args defaults.
TRAIN_ARGS = dict(
    lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, wd=0.05, warmup=1,
    skip_scheduler=False, lr_scheduler="cosine", lr_restart_interval=None,
    accum_freq=1, grad_clip_norm=None, balanced_mixup=0.0,
)
TOTAL_STEPS = 1000  # the cosine schedule's horizon
# The contrastive step as the JAX package's bench.py sets it up.
CLIP_TRAIN_ARGS = dict(TRAIN_ARGS, grad_clip_norm=1.0, siglip=False, lock_image=False,
                       lock_image_freeze_bn_stats=False)
CLIP_TOTAL_STEPS = 10_000
# The wrappers of the hand-written kernels, and the kernel names they launch.
KERNEL_WRAPPERS = {
    "selective_scan_fwd": (selective_scan_fwd, "selective_scan_fwd_kernel"),
    "selective_scan_bwd": (selective_scan_bwd, "selective_scan_bwd_kernel"),
    "flash_attn_fwd": (flash_attn_fwd, "flash_attn_fwd_kernel"),
    "flash_attn_bwd_dkv": (flash_attn_bwd_dkv, "flash_attn_bwd_dkv_kernel"),
    "flash_attn_bwd_dq": (flash_attn_bwd_dq, "flash_attn_bwd_dq_kernel"),
}


def medmamba_train_setup(batch: int, device="cuda", scan_impl=None, seed: int = 0,
                         model_state=None):
    """Full-width medmamba (``amp``) with its train step, through
    ``build_classifier``, ``create_schedule``, ``build_optimizer``,
    ``create_train_state`` and ``make_classifier_train_step``; weights from
    ``seed`` (or ``model_state``), two uint8 batches with int targets made
    from a numpy seed and put on ``device``. Returns (state, step_fn,
    batches)."""
    policy = get_policy("amp")
    args = SimpleNamespace(**TRAIN_ARGS)
    tcfg = get_transform_config(None, 224, is_train=True)
    model = build_classifier("medmamba", num_classes=2, dtype=policy.compute_dtype,
                             scan_impl=scan_impl,
                             generator=torch.Generator().manual_seed(seed))
    if model_state is not None:
        model.load_state_dict(model_state)
    model = model.to(device)
    schedule = create_schedule(args, TOTAL_STEPS)
    tx = build_optimizer(args, schedule)
    state = create_train_state(model, tx, policy)
    step_fn = make_classifier_train_step(model, tx, policy, args, tcfg, schedule,
                                         num_classes=2, takes_text=False)
    rs = np.random.RandomState(seed)
    S = tcfg.staging_size
    batches = [{
        "image": torch.from_numpy(rs.randint(0, 256, (batch, S, S, 3), dtype=np.uint8)).to(device),
        "target": torch.from_numpy(rs.randint(0, 2, (batch,))).to(device),
    } for _ in range(2)]
    return state, step_fn, batches


def clip_train_setup(batch: int, device="cuda", model_name: str = "biomedclip",
                     attn_impl: str = "flash", seed: int = 0, model_state=None,
                     grad_checkpointing: bool = False, **arg_overrides):
    """A full-width CLIP (``amp``) with its contrastive train step, through
    ``build_clip``, ``create_schedule``, ``build_optimizer``,
    ``create_train_state`` and ``make_clip_train_step``; weights from
    ``seed`` (or ``model_state``); two batches of uint8 images and of
    HashTokenizer tokens of report-like text (context 256, so the key masks
    are real) made from a numpy seed and put on ``device``.
    ``arg_overrides`` replace entries of ``CLIP_TRAIN_ARGS``. Returns
    (state, step_fn, batches)."""
    policy = get_policy("amp")
    args = SimpleNamespace(**{**CLIP_TRAIN_ARGS, **arg_overrides})
    tcfg = get_transform_config(None, 224, is_train=True)
    model = build_clip(model_name, image_size=224, dtype=policy.compute_dtype,
                       grad_checkpointing=grad_checkpointing,
                       attn_flash=resolve_attn_flash(attn_impl),
                       generator=torch.Generator().manual_seed(seed))
    if model_state is not None:
        model.load_state_dict(model_state)
    model = model.to(device)
    schedule = create_schedule(args, CLIP_TOTAL_STEPS)
    tx = build_optimizer(args, schedule)
    state = create_train_state(model, tx, policy)
    step_fn = make_clip_train_step(model, tx, policy, args, tcfg, schedule)
    rs = np.random.RandomState(seed)
    S = tcfg.staging_size
    batches = [{
        "image": torch.from_numpy(rs.randint(0, 256, (batch, S, S, 3), dtype=np.uint8)).to(device),
        "tokens": torch.from_numpy(report_tokens(batch, 256, seed=seed + i)).to(device),
    } for i in range(2)]
    return state, step_fn, batches


SETUPS = {
    "medmamba": (medmamba_train_setup, TRAIN_ARGS, TOTAL_STEPS),
    "biomedclip": (clip_train_setup, CLIP_TRAIN_ARGS, CLIP_TOTAL_STEPS),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(SETUPS), default="medmamba")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA card")
    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup, train_args, total_steps = SETUPS[args.model]
    state, step_fn, batches = setup(args.batch)
    for i in range(3):
        state, _ = step_fn(state, batches[i % 2], 0)
    torch.cuda.synchronize()

    def timed_steps() -> float:
        """Host microseconds for ``iters`` steps, ending in a synchronise."""
        nonlocal state
        t0 = time.perf_counter()
        for i in range(args.iters):
            state, metrics = step_fn(state, batches[i % 2], 0)
        torch.cuda.synchronize()
        if not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])):
            raise SystemExit("profile_train: a step gave a non-finite loss or grad norm")
        return (time.perf_counter() - t0) * 1e6

    torch.cuda.reset_peak_memory_stats()
    for wrapper, _ in KERNEL_WRAPPERS.values():
        wrapper.launches = 0
    wall_us = timed_steps()
    launches = {name: wrapper.launches / args.iters
                for name, (wrapper, _) in KERNEL_WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall_us = timed_steps()

    # the optimizer layer alone: one update of the last step's gradients,
    # applied in place as the step applies it
    params = dict(state.model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}
    targs = SimpleNamespace(**train_args)
    tx = build_optimizer(targs, create_schedule(targs, total_steps))  # the step's chain

    def optimizer_update() -> float:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            updates, state.opt_state = tx.update(grads, state.opt_state, params)
            with torch.no_grad():
                for k, p in params.items():
                    p.add_(updates[k])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    opt_wall_us = optimizer_update()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as opt_prof:
        opt_traced_us = optimizer_update()
    opt = trace_summary(opt_prof, args.iters, opt_wall_us, opt_traced_us, "update")

    summary = trace_summary(prof, args.iters, wall_us, traced_wall_us, "step")
    result = {
        "card": card,
        "model": args.model,
        "batch": args.batch,
        "iters": args.iters,
        **summary,
        "launches_per_step": launches,
        "hand_written_kernel_ms_per_step": {
            name: sum(ms for k, ms in summary["kernel_ms_per_step"].items() if kernel in k)
            for name, (_, kernel) in KERNEL_WRAPPERS.items()},
        "max_memory_allocated_bytes": peak,
        "parameter_tensors": len(params),
        "optimizer": {k: v for k, v in opt.items() if k != "kernel_ms_per_update"},
    }
    # rows are images (medmamba) or image-text pairs (biomedclip)
    result["train_rows_per_s"] = args.batch / (result["host_ms_per_step"] / 1e3)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    result["kernel_ms_per_step"] = dict(list(result["kernel_ms_per_step"].items())[:25])
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
