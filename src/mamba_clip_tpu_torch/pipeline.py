"""Orchestration: run set-up, parameter preparation, the epoch loop and the
two-stage dispatch.

Counterpart of ``mamba_clip_tpu/pipeline.py``:

- stage 1: the CLIP contrastive fine-tune (ViT/PubMedBERT or the medmamba
  tower), or a ``medmamba``/``vssm``/``mambavision`` classifier trained with
  CE; checkpoints ``stage_1_epoch_<N>`` and ``stage_1_epoch_latest``;
- stage 2: ``ClipClassifier`` over the frozen stage-1 CLIP, found through
  the latest-run convention (``create_log_path(latest=True,
  containing=...)``) before this run's directory is made;
- ``--is-test`` without a train split evaluates only;
- lr is scaled by the world size at entry.

One process on one device. The device is the card: ``--device auto`` and
``--device cuda`` take ``cuda:0`` and raise when there is none;
``--device cpu`` (what the tests pass) takes the CPU. Each model is built
on the host from a generator seeded with ``--seed`` and moved to the
device in ``prepare_params``. A flag whose feature is not ported yet fails
when ``pipeline()`` starts, naming the ROADMAP.md item that lifts it.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, Optional

import torch

from .checkpoint import (StepCheckpointer, delete_previous_checkpoint, get_latest_checkpoint,
                         load_checkpoint, load_params_only, parse_step_checkpoint,
                         save_checkpoint, validate_step_resume, wait_for_checkpoints)
from .config import Args, RunState, warn_ignored_flags
from .data.loader import get_data
from .data.metadata import get_metadata, undersample_data
from .data.preprocess_cfg import get_transform_config
from .data.tokenizer import get_tokenizer
from .eval import evaluate, make_eval_step
from .models import ClipClassifier, build_classifier, build_clip, lock_mask
from .ops.flash_attn import resolve_attn_flash
from .optim import build_optimizer, freeze_submodule_mask, merge_masks
from .schedules import create_schedule
from .train import (TrainState, create_train_state, make_classifier_train_step,
                    make_clip_train_step, train_one_epoch)
from .utils.logging import ResultsWriter, create_log_path, get_logger, logger_setup
from .utils.precision import _POLICIES, get_policy

logger = get_logger(__name__)

LATEST_CHECKPOINT_NAME = "epoch_latest"

__all__ = ["RunState", "init_run", "setup_paths", "parse_aug_cfg", "setup_train",
           "prepare_params", "step", "pipeline", "load_params_only_into"]


def _not_ported(what: str, item: int, title: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1, item {item} '{title}')")


def check_ported(args: Args) -> None:
    """Raise for a flag whose feature the port does not have yet."""
    if args.quant not in (None, "none"):
        raise _not_ported(f"--quant {args.quant}", 7, "Quantized modes")
    policy = _POLICIES.get(args.precision)
    if policy is not None and policy.param_dtype != torch.float32:
        raise _not_ported(f"--precision {args.precision} (parameters kept in "
                          f"{str(policy.param_dtype).replace('torch.', '')})", 11,
                          "Low-precision parameters")
    if args.mesh_fsdp > 1 or args.mesh_model > 1:
        raise _not_ported(f"--mesh-fsdp {args.mesh_fsdp} --mesh-model {args.mesh_model}",
                          8, "Parallel layers")
    if args.local_loss:
        raise _not_ported("--local-loss", 8, "Parallel layers")
    if args.remote_sync:
        raise _not_ported("--remote-sync", 9, "HPO, integrations and the remaining utilities")
    if "wandb" in (args.report_to or "").split(","):
        raise _not_ported("--report-to wandb", 9,
                          "HPO, integrations and the remaining utilities")
    if args.hyperparameter_tuning:
        raise _not_ported("--hyperparameter-tuning", 9,
                          "HPO, integrations and the remaining utilities")


def resolve_device(device: str) -> str:
    """``--device``: ``auto``/``cuda`` -> ``cuda:0``, which must exist;
    ``cpu`` -> the CPU. Nothing falls back to the CPU unasked."""
    if device in ("auto", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device}: no CUDA card is available "
                "(torch.cuda.is_available() is False); pass --device cpu to run on the CPU")
        return "cuda:0"
    if device == "cpu":
        return "cpu"
    raise ValueError(f"--device must be auto|cuda|cpu, got {device!r}")


def init_run(args: Args) -> RunState:
    """Device, rank and logging bring-up: one process, rank 0 of 1."""
    device = resolve_device(args.device)
    logger_setup(rank=0, log_level=logging.DEBUG if args.debug else logging.INFO)
    return RunState(rank=0, world_size=1, distributed=False, device=device)


def setup_paths(args: Args, run: RunState) -> RunState:
    """Experiment naming and directories, ``params.txt``."""
    name = args.name or create_log_path(args)
    log_base = os.path.join(args.logs, name)
    if args.name is not None and os.path.exists(
        os.path.join(log_base, "checkpoints")
    ) and args.resume is None:
        raise FileExistsError(
            f"Experiment {name} already exists; use --name or --resume."
        )
    run.name = name
    run.log_path = log_base
    run.checkpoint_path = os.path.join(log_base, "checkpoints")
    run.tensorboard_path = os.path.join(log_base, "tensorboard")
    report_to = (args.report_to or "").split(",")
    run.tensorboard = "tensorboard" in report_to
    run.wandb = "wandb" in report_to
    os.makedirs(run.checkpoint_path, exist_ok=True)
    if run.tensorboard:
        os.makedirs(run.tensorboard_path, exist_ok=True)
    args.dump(os.path.join(log_base, "params.txt"))
    if args.copy_codebase:
        # snapshot the package source into the run dir
        src_dir = os.path.dirname(os.path.abspath(__file__))
        dst = os.path.join(log_base, "code", "mamba_clip_tpu_torch")
        if not os.path.exists(dst):
            shutil.copytree(src_dir, dst)
    if args.log_local:
        logger_setup(log_file=os.path.join(log_base, f"out-{run.rank}.log"), rank=run.rank)
    return run


def parse_aug_cfg(items) -> dict:
    """--aug-cfg 'scale=0.4,1.0' 'hflip=0.3' -> dict."""
    out = {}
    for item in items or []:
        if "=" not in str(item):
            continue
        k, v = str(item).split("=", 1)
        parts = v.split(",")

        def conv(s):
            try:
                return float(s) if "." in s or "e" in s.lower() else int(s)
            except ValueError:
                return s

        out[k.strip()] = conv(parts[0]) if len(parts) == 1 else tuple(
            conv(p) for p in parts
        )
    return out


def setup_train(args: Args, run: RunState, checkpoint_prefix: str = "") -> RunState:
    """Resume discovery: ``--resume latest`` or an explicit path."""
    resume = args.resume
    if resume == "latest":
        found = get_latest_checkpoint(run.checkpoint_path, prefix=checkpoint_prefix)
        run.resume_from = found
        if found:
            logger.info(f"Resuming from latest checkpoint: {found}")
        else:
            logger.info("No latest checkpoint found; starting fresh.")
    elif resume:
        run.resume_from = resume
    return run


def _tb_writer(args: Args, run: RunState):
    if not run.tensorboard:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(run.tensorboard_path)
    except Exception:
        return None


def prepare_params(
    args: Args,
    model: torch.nn.Module,
    data: Dict[str, Any],
    run: RunState,
    stage: int,
    takes_text: bool = True,
    class_weights=None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Model, optimizer, schedule and state assembly on ``run.device``.
    ``init_params`` (a state dict) replaces the model's initial weights;
    without it a stage-1 CLIP takes ``--pretrained``. Returns what ``step``
    needs: ``state``, ``step_fn``, ``schedule``, ``policy``,
    ``start_epoch``, ``start_batch``, ``writer``, ``mask``."""
    policy = get_policy(args.precision)
    tcfg_train = data.get("tcfg_train")
    if init_params is not None:
        model.load_state_dict(init_params)
    elif args.pretrained and "visual" in dict(model.named_children()):
        from .checkpoint import load_torch_clip

        load_torch_clip(args.pretrained, model)
        logger.info(f"Loaded pretrained CLIP weights from {args.pretrained}")
    model = model.to(run.device)
    # bf16/pure_bf16/pure_fp16 keep the parameters (and so the optimizer
    # moments) in the low-precision type; amp keeps fp32 masters
    if policy.param_dtype != torch.float32:
        for p in model.parameters():
            p.data = policy.cast_to_param(p.data)

    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"Model parameters: {n_params / 1e6:.2f}M")

    # one optimizer step a loader batch: accumulation splits each batch into
    # micro-batches inside the step, so the horizon is num_batches, not
    # num_batches // accum_freq
    steps_per_epoch = data["train"].num_batches if "train" in data else 0
    total_steps = steps_per_epoch * args.epochs
    schedule = create_schedule(args, total_steps) if total_steps else None

    named = dict(model.named_parameters())
    mask = None
    if stage == 1 and (args.lock_image or args.lock_text) and takes_text:
        mask = lock_mask(
            named,
            lock_image=args.lock_image,
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text,
            lock_text_unlocked_layers=args.lock_text_unlocked_layers,
            lock_text_freeze_layer_norm=args.lock_text_freeze_layer_norm,
        )
    # frozen submodules (the stage-2 CLIP, a MambaVision backbone) are left
    # out of the optimizer: no update and no weight decay
    children = dict(model.named_children())
    frozen = [
        name for name, flag in (("clip", "freeze_clip"), ("backbone", "freeze_backbone"))
        if getattr(model, flag, False) and name in children
    ]
    if frozen:
        mask = merge_masks(mask, freeze_submodule_mask(named, frozen))
    tx = build_optimizer(args, schedule, trainable_mask=mask)
    state = create_train_state(model, tx, policy)

    start_epoch = 0
    start_batch = 0
    if run.resume_from:
        # eval-only runs may restore the parameters without the optimizer
        # (their optimizer has no schedule); training resumes stay strict
        state, start_epoch = load_checkpoint(
            run.resume_from, state, allow_partial=bool(args.is_test)
        )
        parsed = parse_step_checkpoint(run.resume_from)
        if parsed is not None:
            start_batch = parsed[1]
            validate_step_resume(
                run.resume_from, args.batch_size,
                num_batches=(data["train"].num_batches if "train" in data else None),
            )
            logger.info(
                f"Resumed mid-epoch checkpoint (epoch {start_epoch}, "
                f"batch {start_batch})"
            )
        else:
            logger.info(f"Resumed checkpoint (start epoch {start_epoch})")

    if stage == 1 and takes_text:
        step_fn = make_clip_train_step(model, tx, policy, args, tcfg_train, schedule)
    else:
        step_fn = make_classifier_train_step(
            model, tx, policy, args, tcfg_train, schedule,
            class_weights=class_weights if args.class_weighted_loss else None,
            num_classes=args.num_classes or 2,
            takes_text=takes_text,
        )
    return dict(
        state=state, step_fn=step_fn, schedule=schedule, policy=policy,
        start_epoch=start_epoch, start_batch=start_batch, writer=_tb_writer(args, run),
        mask=mask,
    )


def step(
    args,
    run: RunState,
    model,
    data: Dict[str, Any],
    params: Dict[str, Any],
    device,
    seed: int,
    save_prefix: str = "",
    stage: int = 1,
    takes_text: bool = True,
    class_weights=None,
):
    """Epoch loop of one stage on ``device``. ``params`` holds ``state`` (a
    ``TrainState``), ``step_fn``, ``policy``, ``start_epoch`` and optionally
    ``start_batch`` (a mid-epoch resume) and ``writer``; ``data`` the
    ``DataInfo`` of each split and ``tcfg_val``. Returns (metrics, state)."""
    state: TrainState = params["state"]
    step_fn = params["step_fn"]
    policy = params["policy"]
    writer = params.get("writer")
    tcfg_val = data.get("tcfg_val")
    results = ResultsWriter(os.path.join(run.checkpoint_path, "results.jsonl"))
    trace_dir = (os.path.join(run.log_path or run.checkpoint_path, "trace")
                 if getattr(args, "trace", False) else None)
    cw = class_weights if getattr(args, "class_weighted_loss", False) else None
    eval_step = make_eval_step(model, policy, tcfg_val, stage=stage, class_weights=cw,
                               takes_text=takes_text)

    def run_eval(epoch):
        return evaluate(
            model, state, data, epoch, args, policy, tcfg_val, run_state=run, stage=stage,
            results_writer=results, class_weights=cw,
            takes_text=takes_text, eval_step=eval_step, device=device, tb_writer=writer)

    step_ckptr = None
    if getattr(args, "checkpoint_steps", 0) > 0:
        step_ckptr = StepCheckpointer(run.checkpoint_path, args, prefix=save_prefix)

    metrics = None
    best = None
    start_epoch = params["start_epoch"]
    for epoch in range(start_epoch, args.epochs):
        logger.info(f"Start epoch {epoch}")
        first = epoch == start_epoch
        state = train_one_epoch(
            step_fn, state, data, epoch, args, seed,
            run_state=run,
            trace_dir=trace_dir if first else None,
            start_batch=params.get("start_batch", 0) if first else 0,
            step_ckpt_cb=step_ckptr, device=device,
            meters=run.meters.setdefault(epoch, {}), tb_writer=writer,
        )
        completed = epoch + 1

        _metrics = run_eval(completed)
        if (getattr(args, "return_best", False) and getattr(args, "eval_loss", None)
                and _metrics and args.eval_loss in _metrics):
            better = (
                best is None
                or ("min" in args.hopt_direction
                    and _metrics[args.eval_loss] < best[args.eval_loss])
                or ("max" in args.hopt_direction
                    and _metrics[args.eval_loss] > best[args.eval_loss])
            )
            if better:
                best = _metrics
            metrics = best
        elif _metrics:
            metrics = _metrics

        should_save = completed == args.epochs or (
            args.save_frequency > 0 and completed % args.save_frequency == 0
        )
        if should_save:
            save_checkpoint(run.checkpoint_path, state, completed, args,
                            name=f"{save_prefix}epoch_{completed}")
        if args.delete_previous_checkpoint:
            delete_previous_checkpoint(run.checkpoint_path, completed, prefix=save_prefix)
        if args.save_most_recent:
            save_checkpoint(run.checkpoint_path, state, completed, args,
                            name=f"{save_prefix}{LATEST_CHECKPOINT_NAME}")
    if metrics is None and start_epoch >= args.epochs:
        # resuming a finished run: nothing left to train; still evaluate the
        # restored state so the caller gets metrics instead of None
        metrics = run_eval(start_epoch)
    # always leave a stage-latest checkpoint for stage 2 to start from
    if args.epochs > 0:
        save_checkpoint(run.checkpoint_path, state, args.epochs, args,
                        name=f"{save_prefix}{LATEST_CHECKPOINT_NAME}")
    wait_for_checkpoints()
    if step_ckptr is not None:
        # the stage's final numbered epoch checkpoint has committed; the
        # surviving mid-epoch checkpoints are now redundant
        step_ckptr.finalize()
    return metrics, state


def _build_data(args: Args, run: RunState, tokenizer, tcfg_train, tcfg_val,
                model_context: int = 256) -> Dict[str, Any]:
    """The splits of a run: the ISIC files' metadata (``get_metadata``, then
    ``undersample_data`` under ``--undersample``), or ``--synthetic-data``.
    The ``--text-context`` trim is measured on the splits' metadata (the
    distribution the synthetic dataset draws for a synthetic run)."""

    def resolve_ctx(mds):
        # train/val reports carry the diagnosis sentence at stage 1, the
        # test split never does (as in get_data)
        if tokenizer is None or not args.text_context:
            return
        from .data.tokenizer import resolve_text_context

        s1 = getattr(args, "stage", 1) == 1
        splits = [(md, s1 and split != "test") for md, split in mds if md is not None]
        resolve_text_context(args.text_context, tokenizer, splits,
                             model_context=model_context, logger=logger)

    if args.synthetic_data:
        if str(args.text_context).lower() == "auto":
            from .data.dataset import synthetic_metadata

            n = min(int(args.train_num_samples or 2048), 2048)
            resolve_ctx([(synthetic_metadata(n, args.seed), "train")])
        else:
            resolve_ctx([])
        data = get_data(args, tokenizer=tokenizer, staging_size=tcfg_train.staging_size,
                        rank=run.rank, world_size=run.world_size)
    else:
        train_md, val_md, test_md = get_metadata(args)
        if args.undersample and train_md is not None:
            train_md, val_md = undersample_data(args, train_md, val_md)
        resolve_ctx([(train_md, "train"), (val_md, "val"), (test_md, "test")])
        data = get_data(args, train_metadata=train_md, val_metadata=val_md,
                        test_metadata=test_md, tokenizer=tokenizer,
                        staging_size=tcfg_train.staging_size,
                        rank=run.rank, world_size=run.world_size)
    data["tcfg_train"] = tcfg_train
    data["tcfg_val"] = tcfg_val
    return data


def _evaluate_only(args, run, model, data, params, tcfg_val, stage, takes_text, cw):
    """An eval-only run (no train split): the restored or initial state."""
    return evaluate(
        model, params["state"], data, params["start_epoch"], args, params["policy"], tcfg_val,
        run_state=run, stage=stage, takes_text=takes_text, device=run.device,
        eval_step=make_eval_step(model, params["policy"], tcfg_val, stage=stage,
                                 class_weights=cw, takes_text=takes_text),
    )


def pipeline(args: Args):
    """Two-stage dispatch; returns the last evaluation's metrics."""
    check_ported(args)
    run = init_run(args)
    warn_ignored_flags(args, logger)
    args = args.replace(lr=args.lr * run.world_size)
    policy = get_policy(args.precision)

    image_size = (args.force_image_size or [224])[0]
    aug = parse_aug_cfg(args.aug_cfg)
    tcfg_train = get_transform_config(
        aug, image_size, is_train=True, mean=args.image_mean,
        std=args.image_std, interpolation=args.image_interpolation,
    )
    tcfg_val = get_transform_config(
        None, image_size, is_train=False, mean=args.image_mean,
        std=args.image_std, interpolation=args.image_interpolation,
    )

    metrics = None
    stage1_name = args.model_stage_1 or args.model or "biomedclip"
    # experiment names carry the resolved model so that stage 2's latest-run
    # lookup finds the stage-1 run
    args = args.replace(model=args.model or stage1_name)
    # classifier-family models train the CE path, not the contrastive one
    is_medmamba_cls = args.stage == 1 and (
        stage1_name.lower() in ("medmamba", "vssm")
        or "mambavision" in stage1_name.lower()
    )
    generator = torch.Generator().manual_seed(args.seed)
    attn_flash = resolve_attn_flash(args.attn_impl)

    if args.stage == 1:
        takes_text = not (args.use_visual_only or is_medmamba_cls)
        tokenizer = get_tokenizer(
            args.tokenizer or stage1_name,
            require_real=bool(args.pretrained),
        ) if takes_text else None
        if is_medmamba_cls:
            model = build_classifier(
                stage1_name, num_classes=args.num_classes or 2,
                dtype=policy.compute_dtype, grad_checkpointing=args.grad_checkpointing,
                generator=generator,
            )
        else:
            model = build_clip(
                model_name=stage1_name,
                image_size=image_size,
                quick_gelu=args.force_quick_gelu,
                patch_dropout=args.force_patch_dropout or 0.0,
                grad_checkpointing=args.grad_checkpointing,
                siglip=args.siglip,
                dtype=policy.compute_dtype,
                gelu=args.gelu,
                attn_flash=attn_flash,
                generator=generator,
            )
        data = _build_data(
            args, run, tokenizer, tcfg_train, tcfg_val,
            model_context=getattr(getattr(model, "text", None), "context_length", 256),
        )
        run = setup_paths(args, run)
        run = setup_train(args, run, checkpoint_prefix=f"stage_{args.stage}_")
        cw = data["train"].class_weights if "train" in data else None
        stage = 1 if takes_text else 2
        params = prepare_params(args, model, data, run, stage=stage,
                                takes_text=takes_text, class_weights=cw)
        model = params["state"].model
        if "train" not in data:
            metrics = _evaluate_only(args, run, model, data, params, tcfg_val, stage,
                                     takes_text, cw)
        else:
            metrics, _ = step(
                args, run, model, data, params, run.device, args.seed,
                save_prefix=f"stage_{args.stage}_", stage=stage,
                takes_text=takes_text, class_weights=cw,
            )
    elif args.stage == 2:
        tokenizer = get_tokenizer(
            args.tokenizer or stage1_name,
            require_real=bool(args.pretrained),
        )
        clip = build_clip(
            model_name=stage1_name, image_size=image_size,
            quick_gelu=args.force_quick_gelu, dtype=policy.compute_dtype,
            gelu=args.gelu, attn_flash=attn_flash, generator=generator,
        )
        model = ClipClassifier(
            clip=clip,
            num_classes=args.num_classes or 2,
            use_visual_only=args.use_visual_only,
            use_text_only=args.use_text_only,
            use_inner_prod=args.use_inner_prod,
            generator=generator,
        )
        data = _build_data(
            args, run, tokenizer, tcfg_train, tcfg_val,
            model_context=getattr(clip.text, "context_length", 256),
        )
        # locate the stage-1 run BEFORE this run's own dir is made, which
        # would otherwise shadow it in the latest-run scan
        s1_ckpt = None
        s1_missing_err = None
        if not args.use_original_model:
            s1_rel = os.path.join("checkpoints", f"stage_1_{LATEST_CHECKPOINT_NAME}")
            try:
                s1_name = create_log_path(
                    args.replace(model=stage1_name), latest=True, containing=s1_rel,
                )
                s1_ckpt = os.path.join(args.logs, s1_name, s1_rel)
            except FileNotFoundError as s1_err:
                if not args.resume:
                    raise
                # resuming a stage-2 checkpoint restores the whole
                # classifier, frozen CLIP included; a missing stage-1 run is
                # fatal only if the resume resolves to nothing (checked below)
                logger.warning(
                    "no stage-1 run with a stage_1 checkpoint found; "
                    "relying on --resume to restore the stage-2 state"
                )
                s1_missing_err = s1_err
        run = setup_paths(args, run)
        run = setup_train(args, run, checkpoint_prefix=f"stage_{args.stage}_")
        if s1_missing_err is not None and not run.resume_from:
            # neither stage-1 weights nor a resumable stage-2 checkpoint:
            # going on would train a randomly initialized CLIP
            raise FileNotFoundError(
                "stage 2 has nothing to start from: no stage-1 run with a "
                f"stage_1 checkpoint ({s1_missing_err}) and --resume "
                f"{args.resume!r} resolved to no checkpoint"
            )
        if s1_ckpt is not None:
            load_params_only_into(s1_ckpt, model.clip)
            logger.info(f"Loaded stage-1 weights from {s1_ckpt}")
        elif args.pretrained:
            # --use-original-model + --pretrained: classify over the
            # converted CLIP directly
            from .checkpoint import load_torch_clip

            load_torch_clip(args.pretrained, model.clip)
            logger.info(f"Loaded pretrained CLIP weights from {args.pretrained}")

        cw = data["train"].class_weights if "train" in data else None
        params = prepare_params(args, model, data, run, stage=2, takes_text=True,
                                class_weights=cw)
        model = params["state"].model
        if "train" not in data:
            metrics = _evaluate_only(args, run, model, data, params, tcfg_val, 2, True, cw)
        else:
            metrics, _ = step(
                args, run, model, data, params, run.device, args.seed,
                save_prefix="stage_2_", stage=2, takes_text=True, class_weights=cw,
            )
    return metrics


def load_params_only_into(ckpt_path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load a stage-1 checkpoint's parameters and buffers into ``module``."""
    return load_params_only(ckpt_path, module)
