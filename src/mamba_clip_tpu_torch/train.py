"""Train engine: the stage-1 contrastive and the stage-2 classifier train
step, in PyTorch.

Counterpart of ``mamba_clip_tpu/train.py``: ``AverageMeter``,
``TrainState``/``create_train_state``, ``_mixup``, ``_finish_step``,
``_debug_grad_stats``, ``make_clip_train_step`` and
``make_classifier_train_step``. One call of a step does what the JAX
package's jitted step does, eagerly on the batch's device:

  uint8 batch -> ``train_preprocess`` -> [balanced mixup] -> forward in
  training mode (compute dtype over fp32 parameters) -> InfoNCE, SigLIP or
  cross-entropy -> backward (``--accum-freq`` micro-batches) -> unscale ->
  global norm -> clipping + AdamW update -> [logit-scale clamp] -> [fp16:
  skip a non-finite step]

Differences that follow from the framework:

- The state is mutable: the parameters and BatchNorm's running statistics
  live in the model and are updated in place; ``TrainState`` carries the
  model, the step count, the optimizer state and the loss-scale state.
- ``jax.random.fold_in(rng, step)`` becomes explicit ``torch.Generator``s
  on the batch's device, seeded from (seed, step, stream) for the four
  streams the JAX step splits (preprocess, mix preprocess, mixup lambda,
  dropout). The draws have jax.random's distributions, not its bits.
- The fp16 path decides on the host whether to skip a step (one
  synchronisation per step), where JAX selects on the device.

The host epoch loop (``train_one_epoch``), the data loaders, the mesh
(``mesh=``, ``--local-loss``) and ``calibrate_quant`` are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .losses import clip_loss, cross_entropy_loss, siglip_loss
from .models.clip import clamp_logit_scale
from .ops.preprocess import train_preprocess
from .optim import AdamState, global_norm
from .utils.precision import LossScaleState, Policy, init_loss_scale, update_loss_scale


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


@dataclass
class TrainState:
    """The train step's state. ``model`` holds the parameters and the
    BatchNorm statistics and is updated in place; ``loss_scale`` is None
    unless the policy scales dynamically (fp16)."""

    step: int
    model: nn.Module
    opt_state: AdamState
    loss_scale: Optional[LossScaleState] = None


def create_train_state(model: nn.Module, tx, policy: Optional[Policy] = None) -> TrainState:
    return TrainState(
        step=0,
        model=model,
        opt_state=tx.init(dict(model.named_parameters())),
        loss_scale=(init_loss_scale(policy.loss_scale)
                    if policy is not None and policy.dynamic_loss_scale else None),
    )


STREAMS = ("preprocess", "mix_preprocess", "lam", "dropout")


def step_generators(seed: int, step: int, device) -> Dict[str, torch.Generator]:
    """One generator per random stream of step ``step``, on ``device``,
    each seeded from (seed, step, stream index)."""
    out = {}
    for i, name in enumerate(STREAMS):
        s = np.random.SeedSequence([int(seed), int(step), i]).generate_state(2, np.uint32)
        out[name] = torch.Generator(device=device).manual_seed(
            (int(s[0]) << 31) ^ int(s[1]))
    return out


def draw_lam(generator: torch.Generator, alpha: float) -> torch.Tensor:
    """lam ~ Beta(alpha, 1), as U ** (1 / alpha) for U uniform on [0, 1)."""
    u = torch.rand((), generator=generator, device=generator.device)
    return u ** (1.0 / alpha)


def _mixup(lam, images, tokens, targets, mix_images, mix_tokens, mix_targets,
           num_classes: int):
    """Balanced-mixup math: images (1 - lam)·x + lam·x_mix in fp32, the
    tokens of the mix stream when lam > 0.5, soft one-hot targets."""
    # JAX promotes to the fp32 of lam; a 0-d torch tensor would not
    images = (1.0 - lam) * images.float() + lam * mix_images.float()
    if tokens is not None and mix_tokens is not None:
        tokens = torch.where(lam > 0.5, mix_tokens, tokens)
    soft = None
    if targets is not None:
        one = nn.functional.one_hot(targets.long(), num_classes).float()
        two = nn.functional.one_hot(mix_targets.long(), num_classes).float()
        soft = (1.0 - lam) * one + lam * two
    return images, tokens, soft


def _finish_step(state: TrainState, grads: Dict[str, torch.Tensor], tx, s: float,
                 dynamic: bool, clamp: bool = False):
    """Unscale ``grads`` by ``s`` and apply the optimizer update in place;
    with ``clamp`` the updated log logit scale is then clamped to
    [0, ln 100].

    Dynamic path (fp16): a non-finite global norm skips the update (the
    parameters and the optimizer state keep their values) and backs the
    scale off; BatchNorm's statistics moved in the forward and stay moved.
    Returns (new_state, grads, extra_metrics)."""
    if s != 1.0:
        grads = {k: g / s for k, g in grads.items()}
    gnorm = global_norm(grads.values())
    extra = {"grad_norm": gnorm}
    loss_scale = state.loss_scale
    if dynamic:
        finite = bool(torch.isfinite(gnorm))
        extra.update(loss_scale=state.loss_scale.scale, skipped_steps=int(not finite))
        loss_scale = update_loss_scale(state.loss_scale, finite)
        if not finite:
            return replace(state, step=state.step + 1, loss_scale=loss_scale), grads, extra
    params = dict(state.model.named_parameters())
    updates, opt_state = tx.update(grads, state.opt_state, params)
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
    if clamp:
        clamp_logit_scale(params)
    new_state = replace(state, step=state.step + 1, opt_state=opt_state,
                        loss_scale=loss_scale)
    return new_state, grads, extra


def _debug_grad_stats(params: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``--debug``: the parameter and gradient norms of every top-level
    submodule (the first component of the parameter names)."""
    groups: Dict[str, list] = {}
    for k in params:
        groups.setdefault(k.split(".", 1)[0], []).append(k)
    stats = {}
    for top, names in groups.items():
        stats[f"gnorm/{top}"] = global_norm(grads[k] for k in names)
        stats[f"pnorm/{top}"] = global_norm(params[k].detach() for k in names)
    return stats


def _check_accum(batch_size: int, accum: int) -> int:
    """The micro-batch size of ``--accum-freq accum``."""
    if batch_size % accum:
        raise ValueError(
            f"--accum-freq {accum} must divide the per-host batch size "
            f"{batch_size} (micro-batches are equal-size so averaged "
            "grads match the full batch exactly)")
    return batch_size // accum


def _collect_grads(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The accumulated ``.grad`` of every parameter (zeros where none)."""
    return {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.items()}


def _preprocess_train(images_u8, generator, tcfg, policy: Policy):
    return train_preprocess(
        images_u8, generator,
        out_size=tcfg.image_size, scale=tcfg.scale, ratio=tcfg.ratio,
        hflip=tcfg.hflip, re_prob=tcfg.re_prob, mean=tcfg.mean, std=tcfg.std,
        out_dtype=policy.compute_dtype,
        interpolation=getattr(tcfg, "interpolation", "bilinear"),
    )


def make_clip_train_step(
    model: nn.Module,
    tx,
    policy: Policy,
    args,
    tcfg,
    schedule: Optional[Callable[[int], float]] = None,
    mesh=None,
):
    """Stage-1 contrastive train step. Returns ``fn(state, batch, seed) ->
    (state, metrics)``; ``batch`` holds uint8 ``image`` (B, H, W, 3) and int
    ``tokens`` (B, L) on the model's device (+ ``mix_image``/``mix_tokens``
    for balanced mixup). Metrics are 0-d tensors on that device (``lr`` a
    float); ``logit_scale`` is exp of the parameter before the update.

    ``--accum-freq N`` is the cached-negatives recipe: a no-grad pass in
    training mode caches the features of all N micro-batches (BatchNorm's
    running statistics are put back after it), then each micro-batch is
    forwarded again with grad, its slice replaces its rows of the bank, and
    the loss is taken over the whole bank. Every forward of a step draws the
    same dropout stream. The micro-batches' gradients are summed, not
    averaged; the loss metric is their mean. After the step each
    parameter's ``.grad`` holds the gradient the optimizer was given.

    ``--lock-image`` with ``--lock-image-freeze-bn-stats`` puts the visual
    tower's running statistics back after the step."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: the sharded train step and --local-loss are not ported yet "
            "(ROADMAP.md, Queue 1, item 7 'Parallel layers')")
    use_siglip = bool(args.siglip)
    accum = max(int(args.accum_freq), 1)
    ls = policy.loss_scale
    dynamic = bool(policy.dynamic_loss_scale)
    freeze_bn = bool(getattr(args, "lock_image", False)
                     and getattr(args, "lock_image_freeze_bn_stats", False))

    def contrastive(out):
        if use_siglip:
            bias = out.get("logit_bias")
            if bias is None:
                bias = torch.zeros((), device=out["logit_scale"].device)
            return siglip_loss(out["image_features"], out["text_features"],
                               out["logit_scale"], bias)
        return clip_loss(out["image_features"], out["text_features"], out["logit_scale"])

    def step_fn(state: TrainState, batch, seed: int):
        model = state.model
        model.train()
        dev = batch["image"].device
        gens = step_generators(seed, state.step, dev)
        images = _preprocess_train(batch["image"], gens["preprocess"], tcfg, policy)
        tokens = batch.get("tokens")
        if args.balanced_mixup and "mix_image" in batch:
            mix_images = _preprocess_train(batch["mix_image"], gens["mix_preprocess"],
                                           tcfg, policy)
            images, tokens, _ = _mixup(
                draw_lam(gens["lam"], args.balanced_mixup), images, tokens, None,
                mix_images, batch.get("mix_tokens"), None, 2)
        dyn = dynamic and state.loss_scale is not None
        ls_ = state.loss_scale.scale if dyn else ls
        dropout = gens["dropout"]
        dropout_start = dropout.get_state()

        def encode(sl):
            dropout.set_state(dropout_start)  # every forward of the step: one stream
            return model(image=images[sl], text=tokens[sl], generator=dropout)

        buffers = dict(model.named_buffers())
        frozen_stats = {k: b.clone() for k, b in buffers.items()
                        if freeze_bn and k.startswith("visual.")}
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum == 1:
            out = encode(slice(None))
            scaled = contrastive(out) * ls_
            scaled.backward()
            loss = scaled.detach() / ls_
        else:
            mb = _check_accum(images.shape[0], accum)
            slices = [slice(j * mb, (j + 1) * mb) for j in range(accum)]
            # Phase 1: the no-grad feature bank; its statistics are discarded
            stats = {k: b.clone() for k, b in buffers.items()}
            with torch.no_grad():
                outs = [encode(sl) for sl in slices]
                for k, b in buffers.items():
                    b.copy_(stats[k])
            bank = {key: [o[key] for o in outs] for key in ("image_features", "text_features")}
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for j, sl in enumerate(slices):
                out = encode(sl)
                full = {key: torch.cat(rows[:j] + [out[key]] + rows[j + 1:])
                        for key, rows in bank.items()}
                full["logit_scale"] = out["logit_scale"]
                if "logit_bias" in out:
                    full["logit_bias"] = out["logit_bias"]
                scaled = contrastive(full) * ls_
                scaled.backward()
                loss_sum += scaled.detach()
            loss = loss_sum / (ls_ * accum)
        logit_scale = out["logit_scale"].detach().clone()
        for k, b in frozen_stats.items():
            buffers[k].copy_(b)

        new_state, grads, extra = _finish_step(state, _collect_grads(params), tx, ls_, dyn,
                                               clamp=True)
        for k, p in params.items():
            p.grad = grads[k]
        metrics = {"loss": loss, "logit_scale": logit_scale, **extra}
        if getattr(args, "debug", False):
            metrics.update(_debug_grad_stats(params, grads))
        if schedule is not None:
            metrics["lr"] = schedule(state.step)
        return new_state, metrics

    def calibrate_quant(state, batch, seed):
        raise NotImplementedError(
            "calibrate_quant: the int8_delayed scales are not ported yet "
            "(ROADMAP.md, Queue 1, item 6 'Quantized modes')")

    step_fn.calibrate_quant = calibrate_quant
    return step_fn


def make_classifier_train_step(
    model: nn.Module,
    tx,
    policy: Policy,
    args,
    tcfg,
    schedule: Optional[Callable[[int], float]] = None,
    class_weights: Optional[np.ndarray] = None,
    num_classes: int = 2,
    takes_text: bool = True,
):
    """Stage-2 CE train step. Returns ``fn(state, batch, seed) -> (state,
    metrics)``; ``batch`` holds uint8 ``image`` (B, H, W, 3) and int
    ``target`` (B,) on the model's device (+ ``tokens`` when
    ``takes_text``, + ``mix_image``/``mix_target`` for balanced mixup).
    Metrics are 0-d tensors on that device (``lr`` a float).

    ``--accum-freq N`` splits the batch into N equal micro-batches and
    averages their gradients. After the step each parameter's ``.grad``
    holds the gradient the optimizer was given (averaged, unscaled)."""
    ls = policy.loss_scale
    dynamic = bool(policy.dynamic_loss_scale)
    accum = max(int(args.accum_freq), 1)
    weights = None
    if class_weights is not None:
        weights = torch.as_tensor(np.asarray(class_weights, np.float32))

    def step_fn(state: TrainState, batch, seed: int):
        model = state.model
        model.train()
        dev = batch["image"].device
        gens = step_generators(seed, state.step, dev)
        images = _preprocess_train(batch["image"], gens["preprocess"], tcfg, policy)
        tokens = batch.get("tokens")
        targets = batch["target"]
        soft = None
        if args.balanced_mixup and "mix_image" in batch:
            mix_images = _preprocess_train(batch["mix_image"], gens["mix_preprocess"],
                                           tcfg, policy)
            images, tokens, soft = _mixup(
                draw_lam(gens["lam"], args.balanced_mixup), images, tokens, targets,
                mix_images, batch.get("mix_tokens"), batch["mix_target"], num_classes)
        dyn = dynamic and state.loss_scale is not None
        ls_ = state.loss_scale.scale if dyn else ls
        tgt = soft if soft is not None else targets
        w = None if weights is None else weights.to(dev)
        mb = _check_accum(images.shape[0], accum)

        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(accum):
            sl = slice(j * mb, (j + 1) * mb)
            inputs = (images[sl], tokens[sl]) if takes_text else (images[sl],)
            logits = model(*inputs, generator=gens["dropout"])
            scaled = cross_entropy_loss(logits, tgt[sl], weight=w) * ls_
            scaled.backward()
            loss_sum += scaled.detach()
        grads = _collect_grads(params)
        if accum > 1:
            grads = {k: g / accum for k, g in grads.items()}
        loss = loss_sum / (ls_ * accum)

        new_state, grads, extra = _finish_step(state, grads, tx, ls_, dyn)
        for k, p in params.items():
            p.grad = grads[k]
        metrics = {"loss": loss, **extra}
        if getattr(args, "debug", False):
            metrics.update(_debug_grad_stats(params, grads))
        if schedule is not None:
            metrics["lr"] = schedule(state.step)
        return new_state, metrics

    return step_fn
