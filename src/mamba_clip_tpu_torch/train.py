"""Train engine: the stage-1 contrastive and the stage-2 classifier train
step and the host epoch loop, in PyTorch.

Counterpart of ``mamba_clip_tpu/train.py``: ``AverageMeter``,
``TrainState``/``create_train_state``, ``_mixup``, ``_finish_step``,
``_debug_grad_stats``, ``make_clip_train_step``,
``make_classifier_train_step`` and ``train_one_epoch``. One call of a step does what the JAX
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
- The delayed int8 scales of ``--quant int8_delayed*`` (the JAX
  ``quant`` collection) are buffers of the model (``ops/qdot.py``). A step
  quantizes with the stored ones and records this step's absmax aside
  (``scale_mode(..., "record")``), then writes it after the backward
  (``commit_scales``), as JAX returns the mutated collection from the
  step: a block recomputed under ``--grad-checkpointing`` quantizes with
  the same scales as its forward. Under ``--accum-freq`` each micro-batch
  commits after its backward, so micro-batch i quantizes with i-1's
  absmax; the no-grad feature bank records nothing.

``train_one_epoch`` feeds a step from a ``data/loader.py`` loader through
``device_prefetch``, meters data and batch time, calls the step-checkpoint
hook and reads the metrics only where it logs (that read is the loop's one
synchronisation with the card). On the first batch of a fresh run (step 0)
of a model with delayed scales it first calls the step's
``calibrate_quant``.

The data axis (``mesh=`` of more than one rank, ``parallel/mesh.py``): a
step over W ranks of B rows each computes what one rank computes over the
W·B rows, gradients included. Each step opens the axis
(``collectives.data_axis``) for its duration, and under it:

- the losses gather the features of every rank with gradient
  (``--local-loss``: each rank's rows against the gathered columns; the
  ranks' losses are averaged); the weighted cross-entropy takes both of
  its sums over the global batch;
- the gradients are averaged over the ranks before the global norm, the
  clipping and the update, so every rank applies the same update;
- BatchNorm takes the global batch's statistics (its sums all-reduced with
  gradient), and the running statistics come out equal on every rank;
- the preprocess, dropout, patch-dropout and DropPath draws are slices of
  one global draw from the step's generators;
- the delayed int8 scales and every absmax taken over batch rows are the
  maximum over the ranks; the fp16 loss scale's finiteness is decided on
  the averaged gradients, so every rank skips the same steps.

Under ``--accum-freq N`` micro-batch j is every rank's j-th micro-batch,
rank-major, and its features are gathered into the global feature bank.

The fsdp and model axes (a mesh with ``fsdp`` or ``model`` above 1): the
axis above is the mesh's batch axis (data × fsdp; the model peers of a
batch index take the same rows and draws), and the state is sharded
(``parallel/sharding.py``; :func:`create_train_state` with ``mesh=``
places it). A step gathers the sharded parameters layer by layer, for
each forward and again where its backward needs them (``per_layer``; the
model-sharded Dense kernels run column-parallel, their ``--quant`` dots
too); the backward reduce-scatters each fsdp leaf's gradient as it leaves
its layer (``--accum-freq``'s micro-batches each, their shards summed),
``reduce_grads`` averages the rest over the batch axis, and the global
norm, the clipping and AdamW run on the shards.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .losses import clip_loss, cross_entropy_loss, siglip_loss
from .models.clip import clamp_logit_scale
from .ops.preprocess import train_preprocess
from .ops.qdot import commit_scales, delayed_holders, delayed_scales, scale_mode
from .optim import AdamState, global_norm
from .parallel.collectives import data_axis, gather_rows, mean_grads
from .parallel.sharding import per_layer, place_model, plan_of, reduce_grads
from .utils.logging import get_logger
from .utils.precision import LossScaleState, Policy, init_loss_scale, update_loss_scale

logger = get_logger(__name__)


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


def create_train_state(model: nn.Module, tx, policy: Optional[Policy] = None,
                       mesh=None) -> TrainState:
    """The state at step 0. ``mesh`` with an fsdp or a model axis: the
    model is placed on it first (``sharding.place_model``; every rank holds
    the same parameters before), so the moments are the shards'."""
    place_model(model, mesh)
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
                 dynamic: bool, clamp: bool = False, plan=None):
    """Unscale ``grads`` by ``s`` and apply the optimizer update in place;
    with ``clamp`` the updated log logit scale is then clamped to
    [0, ln 100]. ``plan``: the shard plan of a sharded state (``grads`` are
    then the shards').

    Dynamic path (fp16): the JAX package divides by the scale as an fp32
    array, so the unscaled gradients are fp32 whatever the parameters' type
    (fp16 under ``pure_fp16``), and so are the moments they make. A
    non-finite global norm skips the update (the parameters keep their
    values, the moments too, in the type the update would have given them,
    as ``jnp.where`` promotes them) and backs the scale off; BatchNorm's
    statistics moved in the forward and stay moved. Returns (new_state,
    grads, extra_metrics)."""
    if dynamic:
        grads = {k: g.float() / s for k, g in grads.items()}
    elif s != 1.0:
        grads = {k: g / s for k, g in grads.items()}
    gnorm = global_norm(grads, plan)
    extra = {"grad_norm": gnorm}
    loss_scale = state.loss_scale
    if dynamic:
        finite = bool(torch.isfinite(gnorm))
        extra.update(loss_scale=state.loss_scale.scale, skipped_steps=int(not finite))
        loss_scale = update_loss_scale(state.loss_scale, finite)
        if not finite:
            opt = state.opt_state
            opt = replace(opt, **{name: {k: m.to(torch.promote_types(m.dtype, grads[k].dtype))
                                         for k, m in getattr(opt, name).items()}
                                  for name in ("mu", "nu")})
            return (replace(state, step=state.step + 1, opt_state=opt, loss_scale=loss_scale),
                    grads, extra)
    params = dict(state.model.named_parameters())
    updates, opt_state = tx.update(grads, state.opt_state, params, plan=plan)
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
    if clamp:
        clamp_logit_scale(params)
    new_state = replace(state, step=state.step + 1, opt_state=opt_state,
                        loss_scale=loss_scale)
    return new_state, grads, extra


def _debug_grad_stats(params: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor], plan=None) -> Dict[str, torch.Tensor]:
    """``--debug``: the parameter and gradient norms of every top-level
    submodule (the first component of the parameter names); over the
    shards of a sharded state, as the global norm takes them."""
    groups: Dict[str, list] = {}
    for k in params:
        groups.setdefault(k.split(".", 1)[0], []).append(k)
    stats = {}
    for top, names in groups.items():
        stats[f"gnorm/{top}"] = global_norm({k: grads[k] for k in names}, plan)
        stats[f"pnorm/{top}"] = global_norm({k: params[k].detach() for k in names}, plan)
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


def _running_stats(model: nn.Module, quant_keys) -> Dict[str, torch.Tensor]:
    """The model's buffers but its delayed scales (``quant_keys``):
    BatchNorm's statistics."""
    return {k: b for k, b in model.named_buffers() if k not in quant_keys}


def _calibrate(model: nn.Module, holders, quant_keys, forward) -> None:
    """``--quant int8_delayed*``: one no-grad ``forward()`` in training mode
    that records every delayed scale; the running statistics it moves are
    put back (JAX keeps only the ``quant`` collection of the pass)."""
    stats = {k: b.clone() for k, b in _running_stats(model, quant_keys).items()}
    with torch.no_grad(), scale_mode(holders, "record"):
        forward()
    for k, b in _running_stats(model, quant_keys).items():
        b.copy_(stats[k])
    commit_scales(holders)


def _mesh_axis(mesh):
    """The batch axis (data × fsdp) of ``mesh`` when it has more than one
    rank, else None."""
    if mesh is None:
        return None
    axis = mesh.axis()
    return axis if axis.world > 1 else None


def _plan(state: TrainState, mesh):
    """The shard plan of ``state``'s model; a mesh with an fsdp or a model
    axis needs the state placed on it."""
    plan = plan_of(state.model)
    if plan is None and mesh is not None and (mesh.shape["fsdp"] > 1
                                              or mesh.shape["model"] > 1):
        raise ValueError(
            f"a mesh of shape {mesh.shape} needs a sharded state: make it with "
            "create_train_state(model, tx, policy, mesh=mesh)")
    return plan


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
    parameter's ``.grad`` holds the gradient the optimizer was given, in
    the parameter's type (under ``pure_fp16`` the optimizer is given it in
    fp32, unscaled, and ``.grad`` holds it rounded to fp16).

    ``--lock-image`` with ``--lock-image-freeze-bn-stats`` puts the visual
    tower's running statistics back after the step.

    ``fn.calibrate_quant(state, batch, seed) -> state``: one forward on the
    step's images and tokens that re-anchors the delayed int8 scales (module
    docstring), no optimizer step.

    ``mesh``: the data axis (module docstring); ``--local-loss`` takes the
    per-rank logits when the axis has more than one rank."""
    axis = _mesh_axis(mesh)
    use_local = axis is not None and bool(getattr(args, "local_loss", False))
    use_siglip = bool(args.siglip)
    accum = max(int(args.accum_freq), 1)
    ls = policy.loss_scale
    dynamic = bool(policy.dynamic_loss_scale)
    freeze_bn = bool(getattr(args, "lock_image", False)
                     and getattr(args, "lock_image_freeze_bn_stats", False))
    holders, quant_keys = delayed_holders(model), set(delayed_scales(model))

    def contrastive(out, gathered: bool = False):
        """The loss of the rank; ``gathered``: the features are the global
        batch's already (the feature bank)."""
        ax = {} if axis is None or gathered else {"axis_name": "data"}
        if use_siglip:
            bias = out.get("logit_bias")
            if bias is None:
                bias = torch.zeros((), device=out["logit_scale"].device)
            return siglip_loss(out["image_features"], out["text_features"],
                               out["logit_scale"], bias, **ax)
        if ax and use_local:
            ax["local_loss"] = True
        return clip_loss(out["image_features"], out["text_features"], out["logit_scale"], **ax)

    def step_fn(state: TrainState, batch, seed: int):
        with data_axis(axis):
            return _step(state, batch, seed)

    def _step(state: TrainState, batch, seed: int):
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

        buffers = _running_stats(model, quant_keys)
        frozen_stats = {k: b.clone() for k, b in buffers.items()
                        if freeze_bn and k.startswith("visual.")}
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        plan = _plan(state, mesh)
        with per_layer(model):
            out, loss = _forward_backward(dev, encode, buffers, ls_, images.shape[0])
        grads = _collect_grads(params)
        for p in params.values():
            p.grad = None
        logit_scale = out["logit_scale"].detach().clone()
        for k, b in frozen_stats.items():
            buffers[k].copy_(b)
        if axis is not None:
            loss = mean_grads({"loss": loss})["loss"]

        new_state, grads, extra = _finish_step(state, reduce_grads(grads, plan), tx,
                                               ls_, dyn, clamp=True, plan=plan)
        for k, p in params.items():
            p.grad = grads[k].to(p.dtype)
        metrics = {"loss": loss, "logit_scale": logit_scale, **extra}
        if getattr(args, "debug", False):
            metrics.update(_debug_grad_stats(params, grads, plan))
        if schedule is not None:
            metrics["lr"] = schedule(state.step)
        return new_state, metrics

    def _forward_backward(dev, encode, buffers, ls_, rows: int):
        """The step's forwards and backwards over its ``rows`` rows
        (``--accum-freq``'s feature bank and micro-batches); returns (the
        last forward's outputs, the loss)."""
        if accum == 1:
            with scale_mode(holders, "record"):
                out = encode(slice(None))
                scaled = contrastive(out) * ls_
                scaled.backward()
            commit_scales(holders)
            loss = scaled.detach() / ls_
        else:
            mb = _check_accum(rows, accum)
            slices = [slice(j * mb, (j + 1) * mb) for j in range(accum)]
            # Phase 1: the no-grad feature bank; its statistics are discarded
            # and it records no delayed scale
            stats = {k: b.clone() for k, b in buffers.items()}
            with torch.no_grad():
                outs = [encode(sl) for sl in slices]
                for k, b in buffers.items():
                    b.copy_(stats[k])
            bank = {key: [gather_rows(o[key]) for o in outs]
                    for key in ("image_features", "text_features")}
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for j, sl in enumerate(slices):
                with scale_mode(holders, "record"):
                    out = encode(sl)
                    full = {key: torch.cat(rows[:j] + [gather_rows(out[key])] + rows[j + 1:])
                            for key, rows in bank.items()}
                    full["logit_scale"] = out["logit_scale"]
                    if "logit_bias" in out:
                        full["logit_bias"] = out["logit_bias"]
                    scaled = contrastive(full, gathered=True) * ls_
                    scaled.backward()
                commit_scales(holders)  # micro-batch j+1 quantizes with j's absmax
                loss_sum += scaled.detach()
            loss = loss_sum / (ls_ * accum)
        return out, loss

    def calibrate_quant(state, batch, seed):
        """Re-anchor the delayed scales on one real batch: the step's images
        (its preprocess stream) and tokens, its dropout stream."""
        with data_axis(axis):
            return _calibrate_quant(state, batch, seed)

    def _calibrate_quant(state, batch, seed):
        model = state.model
        model.train()
        gens = step_generators(seed, state.step, batch["image"].device)
        images = _preprocess_train(batch["image"], gens["preprocess"], tcfg, policy)
        _calibrate(model, holders, quant_keys,
                   lambda: model(image=images, text=batch.get("tokens"),
                                 generator=gens["dropout"]))
        return state

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
    mesh=None,
):
    """Stage-2 CE train step. Returns ``fn(state, batch, seed) -> (state,
    metrics)``; ``batch`` holds uint8 ``image`` (B, H, W, 3) and int
    ``target`` (B,) on the model's device (+ ``tokens`` when
    ``takes_text``, + ``mix_image``/``mix_target`` for balanced mixup).
    Metrics are 0-d tensors on that device (``lr`` a float).

    ``--accum-freq N`` splits the batch into N equal micro-batches and
    averages their gradients. After the step each parameter's ``.grad``
    holds the gradient the optimizer was given (averaged, unscaled), in the
    parameter's type.
    ``fn.calibrate_quant`` as :func:`make_clip_train_step`'s; ``mesh``: the
    data axis (module docstring)."""
    axis = _mesh_axis(mesh)
    ls = policy.loss_scale
    holders, quant_keys = delayed_holders(model), set(delayed_scales(model))
    dynamic = bool(policy.dynamic_loss_scale)
    accum = max(int(args.accum_freq), 1)
    weights = None
    if class_weights is not None:
        weights = torch.as_tensor(np.asarray(class_weights, np.float32))
    ax_name = "data" if axis is not None else None

    def step_fn(state: TrainState, batch, seed: int):
        with data_axis(axis):
            return _step(state, batch, seed)

    def _step(state: TrainState, batch, seed: int):
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
        plan = _plan(state, mesh)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with per_layer(model):
            for j in range(accum):
                sl = slice(j * mb, (j + 1) * mb)
                inputs = (images[sl], tokens[sl]) if takes_text else (images[sl],)
                with scale_mode(holders, "record"):
                    logits = model(*inputs, generator=gens["dropout"])
                    scaled = cross_entropy_loss(logits, tgt[sl], weight=w,
                                                axis_name=ax_name) * ls_
                    scaled.backward()
                commit_scales(holders)
                loss_sum += scaled.detach()
        grads = _collect_grads(params)
        for p in params.values():
            p.grad = None
        grads = reduce_grads(grads, plan)
        if accum > 1:
            grads = {k: g / accum for k, g in grads.items()}
        loss = loss_sum / (ls_ * accum)
        if axis is not None:
            loss = mean_grads({"loss": loss})["loss"]

        new_state, grads, extra = _finish_step(state, grads, tx, ls_, dyn, plan=plan)
        for k, p in params.items():
            p.grad = grads[k].to(p.dtype)
        metrics = {"loss": loss, **extra}
        if getattr(args, "debug", False):
            metrics.update(_debug_grad_stats(params, grads, plan))
        if schedule is not None:
            metrics["lr"] = schedule(state.step)
        return new_state, metrics

    def calibrate_quant(state, batch, seed):
        """See :func:`make_clip_train_step`'s ``calibrate_quant``."""
        with data_axis(axis):
            return _calibrate_quant(state, batch, seed)

    def _calibrate_quant(state, batch, seed):
        model = state.model
        model.train()
        gens = step_generators(seed, state.step, batch["image"].device)
        images = _preprocess_train(batch["image"], gens["preprocess"], tcfg, policy)
        inputs = (images, batch.get("tokens")) if takes_text else (images,)
        _calibrate(model, holders, quant_keys,
                   lambda: model(*inputs, generator=gens["dropout"]))
        return state

    step_fn.calibrate_quant = calibrate_quant
    return step_fn


def train_one_epoch(
    step_fn,
    state: TrainState,
    data: Dict[str, Any],
    epoch: int,
    args,
    seed: int,
    run_state=None,
    trace_dir: Optional[str] = None,
    start_batch: int = 0,
    step_ckpt_cb=None,
    device="cuda",
    meters: Optional[Dict[str, float]] = None,
    tb_writer=None,
) -> TrainState:
    """Host epoch loop: feeds ``device``, meters throughput. ``seed`` is
    what ``step_fn(state, batch, seed)`` takes. When ``trace_dir`` is set
    (the ``--trace`` flag) steps 3-8 of the epoch are captured with
    ``torch.profiler`` and written there as a Chrome trace.

    ``start_batch`` resumes mid-epoch (``--checkpoint-steps``): the loader
    fast-forwards to that batch of this epoch's deterministic index order,
    and the restored ``state.step`` keeps the step's random streams where
    they left off. ``step_ckpt_cb(state, epoch, batches_done,
    num_batches=)`` is called every ``args.checkpoint_steps`` optimizer
    steps, never on the epoch's last batch (the epoch-boundary checkpoint
    owns that). ``meters``, when given, receives the
    loop's data and batch times in seconds and the batches it ran.
    ``tb_writer`` (a tensorboard ``SummaryWriter``) gets each logged step's
    metrics as ``train/<name>`` at the global step. A model with delayed
    int8 scales is calibrated on the first batch
    (``step_fn.calibrate_quant``) when the run is fresh (step 0); a resumed
    run keeps its checkpointed scales."""
    from .data.loader import device_prefetch

    train_data = data["train"]
    train_data.set_epoch(epoch)
    loader = train_data.loader
    num_batches = loader.num_batches
    if start_batch >= num_batches > 0:
        raise ValueError(
            f"--resume from a mid-epoch checkpoint at batch {start_batch}, "
            f"but this run's epoch has only {num_batches} batches — the "
            "data/batch-size configuration changed since the checkpoint "
            "was written; mid-epoch resume is only exact under the same "
            "loader geometry"
        )
    loader.start_batch = start_batch
    sample_digits = math.ceil(math.log10(max(loader.num_samples, 1) + 1))
    world = getattr(run_state, "world_size", 1) if run_state else 1
    if plan_of(state.model) is not None:  # the model peers read the same rows
        world = plan_of(state.model).mesh.axis().world
    master = (getattr(run_state, "rank", 0) if run_state else 0) == 0

    batch_time_m, data_time_m = AverageMeter(), AverageMeter()
    losses_m: Dict[str, AverageMeter] = {}
    end = time.perf_counter()
    window_start = end
    window_steps = 0

    it = device_prefetch(iter(loader), device)

    prof = None
    # trace steps 3-8 of this iteration (relative to start_batch, so a
    # run resumed mid-epoch still captures a profile)
    trace_lo, trace_hi = start_batch + 3, start_batch + 8
    calibrate = getattr(step_fn, "calibrate_quant", None)
    need_calib = calibrate is not None and bool(delayed_holders(state.model))

    def stop_trace():
        nonlocal prof
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        prof = None
        logger.info(f"profiler trace written to {trace_dir}")

    try:
        for i, batch in enumerate(it, start=start_batch):
            if need_calib:
                need_calib = False
                if state.step == 0:
                    state = calibrate(state, batch, seed)
            if trace_dir and i == trace_lo and prof is None:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.device(batch["image"].device).type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            data_time_m.update(time.perf_counter() - end)
            state, metrics = step_fn(state, batch, seed)
            if prof is not None and i == trace_hi:
                stop_trace()

            if (step_ckpt_cb is not None
                    and getattr(args, "checkpoint_steps", 0) > 0
                    and (i + 1) % args.checkpoint_steps == 0
                    and i + 1 < num_batches):
                step_ckpt_cb(state, epoch, i + 1, num_batches=num_batches)

            window_steps += 1
            log_now = (
                i % args.log_every_n_steps == 0 or i == num_batches - 1
            )
            if log_now:
                # reading a metric is the loop's one wait for the card
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                batch_time_m.update((now - window_start) / window_steps, window_steps)
                for k, v in metrics.items():
                    losses_m.setdefault(k, AverageMeter()).update(v, 1)
                bs = int(batch["image"].shape[0])
                n_done = (i + 1) * bs
                pct = 100.0 * (i + 1) / num_batches
                sps = bs * world / max(batch_time_m.val, 1e-9)
                info = " ".join(
                    f"{k}: {m.val:#.5g}" for k, m in sorted(losses_m.items())
                )
                if master:
                    logger.info(
                        f"Train Epoch: {epoch} [{n_done:>{sample_digits}}/"
                        f"{loader.num_samples} ({pct:.0f}%)] {info} "
                        f"data: {data_time_m.avg:.3f}s "
                        f"batch: {batch_time_m.val:.3f}s "
                        f"samples/s: {sps:.1f} samples/s/device: {sps / max(world, 1):.1f}"
                    )
                if tb_writer is not None:
                    gstep = num_batches * epoch + i
                    for k, v in metrics.items():
                        tb_writer.add_scalar(f"train/{k}", v, gstep)
                window_start = now
                window_steps = 0
            end = time.perf_counter()
    finally:
        if prof is not None:
            stop_trace()
    if meters is not None:
        meters.update(data_time_avg=data_time_m.avg, data_time_count=data_time_m.count,
                      batch_time_avg=batch_time_m.avg, batch_time_last=batch_time_m.val,
                      batches=batch_time_m.count,
                      last_metrics={k: m.val for k, m in losses_m.items()})
    return state
