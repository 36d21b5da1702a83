"""Sharded state over the fsdp and model axes of the mesh.

The port's counterpart of JAX's ``jax.device_put(state,
param_sharding(mesh, state))`` and of what XLA inserts around a sharded
parameter. :func:`place_model` applies ``mesh.param_sharding``: between
steps a rank holds

- its shard of each sharded parameter (the parameter's storage is the
  shard; ``tx.init`` on the placed model gives shard-sized AdamW moments);
- every replicated parameter, and every buffer, whole.

:func:`gathered` all-gathers each fsdp-sharded parameter, and each
model-sharded one that is not a Dense kernel, into the module for a
forward (and its backward), and puts the shards back after, which releases
the gathered storage. A Dense kernel sharded over the model axis (the
output features, port dim 0) stays a shard: ``models/vssm.py::_linear``
runs it column-parallel through :func:`column_parallel` (each rank its
output columns, gathered along the last dim; the input's gradient summed
over the model group), so that the activations, and the gradients of every
replicated leaf, are equal on the model peers.

:func:`reduce_grads` brings each gradient to its owner:

- fsdp-sharded: a reduce-scatter over the fsdp group along its dim, an
  all-reduce over the data group, a division by D·F;
- replicated, and model-sharded: averaged over the batch group (the D·F
  ranks of one model index), a gathered one after this rank's slice is
  taken.

The checkpoint's state is :func:`full_params` and :func:`full_moments` (the
shards gathered on every rank); a load keeps the rank's slice of the
whole tensors (:func:`shard_of`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import torch

from .collectives import DataAxis, all_gather_, all_reduce_, mean_grads, reduce_scatter_
from .mesh import FSDP_AXIS, MODEL_AXIS, Mesh, param_sharding

Placement = Optional[Tuple[str, int]]


@dataclass
class ShardPlan:
    """Where each parameter of a placed model lives: ``placements`` by
    state-dict key (None: replicated; else (axis, port dim)), and the keys
    of the Dense kernels (column-parallel when model-sharded)."""

    mesh: Mesh
    placements: Dict[str, Placement]
    dense: Set[str]

    def axis(self, name: str) -> DataAxis:
        return self.mesh.sub_axis(name)

    def gathered_keys(self):
        """The keys a forward gathers: every sharded leaf but the
        column-parallel kernels."""
        return [k for k, p in self.placements.items()
                if p is not None and (p[0] == FSDP_AXIS or k not in self.dense)]


def plan_of(model: torch.nn.Module) -> Optional[ShardPlan]:
    """The plan of a placed model, else None."""
    return getattr(model, "_shard_plan", None)


def shard_of(full: torch.Tensor, placement: Placement, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``full`` (``full`` itself when
    replicated)."""
    if placement is None:
        return full
    axis, dim = placement
    ax = mesh.sub_axis(axis)
    n = full.shape[dim] // ax.world
    return full.narrow(dim, ax.rank * n, n)


def gather_leaf(shard: torch.Tensor, placement: Placement, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` along the placement's
    dim (a collective over the axis's group)."""
    if placement is None:
        return shard
    axis, dim = placement
    ax = mesh.sub_axis(axis)
    return torch.cat(all_gather_(shard, ax.world, group=ax.group).unbind(0), dim=dim)


def place_model(model: torch.nn.Module, mesh: Optional[Mesh]) -> Optional[ShardPlan]:
    """Keep this rank's shard of each parameter that ``param_sharding``
    shards (every rank must hold the same whole parameters first) and mark
    the model-sharded Dense kernels column-parallel. A no-op without an
    fsdp or a model axis, and on a model placed already. Returns the plan
    (None when nothing is sharded). The int8 dots of ``--quant`` under a
    model axis raise: their scales over a column slice are not designed."""
    if mesh is None or not mesh.sharded:
        return None
    plan = plan_of(model)
    if plan is not None:
        return plan
    from ..convert import flax_leaf_names
    from ..ops.qdot import injected

    if mesh.model > 1 and any(injected(m) is not None for m in model.modules()):
        raise NotImplementedError(
            "--quant under a model axis above 1 is not ported yet: the int8 dots' scales "
            "over a column slice are not designed (ROADMAP.md, Queue 1, item 8 'Parallel "
            "layers')")
    names = flax_leaf_names(model)
    placements = param_sharding(mesh, model)
    params = dict(model.named_parameters())
    plan = ShardPlan(mesh=mesh, placements=placements,
                     dense={k for k, p in params.items()
                            if names[k] == "kernel" and p.ndim == 2})
    with torch.no_grad():
        for k, where in placements.items():
            if where is None:
                continue
            p = params[k]
            p.data = shard_of(p.data, where, mesh).clone()
            if where[0] == MODEL_AXIS and k in plan.dense:
                p.column_parallel = mesh.sub_axis(MODEL_AXIS)
    model._shard_plan = plan
    return plan


@contextlib.contextmanager
def gathered(model: torch.nn.Module):
    """Inside the block the fsdp-sharded parameters and the model-sharded
    ones that are not Dense kernels hold their whole tensors; after it, the
    shards again. A no-op for a model that is not placed. Every rank of the
    mesh enters it together."""
    plan = plan_of(model)
    if plan is None:
        yield
        return
    params = dict(model.named_parameters())
    keys = plan.gathered_keys()
    shards = {k: params[k].data for k in keys}
    with torch.no_grad():
        for k in keys:
            params[k].data = gather_leaf(shards[k], plan.placements[k], plan.mesh)
    try:
        yield
    finally:
        for k in keys:
            params[k].data = shards[k]


def full_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter whole (gathered on every rank when placed)."""
    plan = plan_of(model)
    params = dict(model.named_parameters())
    if plan is None:
        return params
    return {k: gather_leaf(p.detach(), plan.placements[k], plan.mesh) for k, p in params.items()}


def full_moments(moments: Dict[str, torch.Tensor], plan: Optional[ShardPlan]
                 ) -> Dict[str, torch.Tensor]:
    """The moments whole (gathered on every rank)."""
    if plan is None:
        return moments
    return {k: gather_leaf(m, plan.placements[k], plan.mesh) for k, m in moments.items()}


def reduce_grads(grads: Dict[str, torch.Tensor], plan: Optional[ShardPlan]
                 ) -> Dict[str, torch.Tensor]:
    """Each gradient of the step reduced to its owner (module docstring):
    the averaged gradient of the batch axis (the active data axis), of the
    rank's shard where the parameter is sharded. ``grads`` hold the whole
    gradient of a gathered leaf and the shard's of a column-parallel one."""
    if plan is None:
        return mean_grads(grads)
    fsdp = {k: g for k, g in grads.items() if (plan.placements[k] or ("",))[0] == FSDP_AXIS}
    rest = {}
    for k, g in grads.items():
        if k in fsdp:
            continue
        where = plan.placements[k]
        if where is not None and k not in plan.dense:
            g = shard_of(g, where, plan.mesh)
        rest[k] = g
    out = mean_grads(rest)
    out.update(_fsdp_reduce(fsdp, plan))
    return {k: out[k] for k in grads}


def _fsdp_reduce(grads: Dict[str, torch.Tensor], plan: ShardPlan) -> Dict[str, torch.Tensor]:
    """Reduce-scatter over the fsdp group (one flat call per dtype: rank
    i's chunk holds its shard of every leaf), all-reduce over the data
    group, divide by D·F."""
    if not grads:
        return {}
    fa, da = plan.axis(FSDP_AXIS), plan.axis("data")
    by_dtype: Dict[torch.dtype, list] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    out = {}
    for keys in by_dtype.values():
        moved = [grads[k].movedim(plan.placements[k][1], 0) for k in keys]
        flat = torch.cat([m.reshape(fa.world, -1) for m in moved], dim=1).reshape(-1)
        mine = reduce_scatter_(flat, fa.world, group=fa.group)
        if da.world > 1:
            all_reduce_(mine, group=da.group)
        mine = mine / (fa.world * da.world)
        i = 0
        for k, m in zip(keys, moved):
            shape = (m.shape[0] // fa.world,) + tuple(m.shape[1:])
            n = m.numel() // fa.world
            out[k] = mine[i:i + n].view(shape).movedim(0, plan.placements[k][1]).contiguous()
            i += n
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each rank's columns contribute their part of the input's
    gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), group=ctx.axis.group), None


class _GatherCols(torch.autograd.Function):
    """Every model rank's columns, concatenated along the last dim; the
    backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis, ctx.n = axis, y.shape[-1]
        parts = all_gather_(y.detach(), axis.world, group=axis.group)
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


def column_parallel(x: torch.Tensor, w: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """``x @ W.T`` of a Dense kernel whose rows (the output features) are
    split over the model axis: this rank's ``w`` gives its columns, which
    are gathered. No bias (the caller adds the whole one)."""
    return _GatherCols.apply(
        torch.nn.functional.linear(_CopyToModel.apply(x, axis), w), axis)
