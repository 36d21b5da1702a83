"""Sharded state over the fsdp and model axes of the mesh.

The port's counterpart of JAX's ``jax.device_put(state,
param_sharding(mesh, state))`` and of what XLA inserts around a sharded
parameter (``param_sharding``'s docstring: "ZeRO-3 style — XLA inserts the
all-gathers before use and keeps the optimizer update sharded").
:func:`place_model` applies ``mesh.param_sharding``: between steps a rank
holds

- its shard of each sharded parameter (the parameter's storage is the
  shard; ``tx.init`` on the placed model gives shard-sized AdamW moments);
- every replicated parameter, and every buffer, whole.

A Dense kernel sharded over the model axis (the output features, port dim
0) stays a shard: ``models/vssm.py::_linear`` runs it column-parallel
through :func:`column_parallel` (each rank its output columns, gathered
along the last dim; the input's gradient summed over the model group), so
that the activations, and the gradients of every replicated leaf, are
equal on the model peers. A kernel that carries an injected int8 dot of
``--quant`` runs that dot on its columns with the global scales
(``ops/qdot.py``, ``ops/aqt.py``), whose backward returns the whole input
gradient.

Every other sharded leaf (each fsdp-sharded one, and each model-sharded one
that is not a Dense kernel) is gathered layer by layer:

- a *unit* is a module whose class sets ``gather_unit = True`` (a
  transformer or VSS block, a patch embedding or merge): its sharded leaves
  are gathered just before its forward, one flat all-gather for each axis
  and dtype, into the modules that own them, and released after it;
- a sharded leaf outside every unit is gathered where it is read, by
  :func:`whole` (the towers' embeddings and projections, the heads);
- the gather is a node of the autograd graph (:class:`_GatherBucket`):
  the backward reduce-scatters an fsdp leaf's gradient over the fsdp group
  as it leaves the unit, all-reduces it over the data group and divides by
  D·F, so the leaf's ``.grad`` is its shard's, averaged over the batch
  axis (the same numbers a whole gradient reduced after the backward
  gives; ``--accum-freq``'s micro-batches each reduce and their shards
  add up); a model-sharded leaf's keeps this rank's slice;
- inside :func:`per_layer` a gathered leaf that autograd keeps for the
  backward (the weight of a matmul, a convolution's, or their copy in the
  compute type) is kept as a note of where it came from, and gathered
  again when the backward needs it; ``torch.utils.checkpoint``'s recompute
  calls the unit again, which gathers again. So a rank holds its shards
  and about one unit's whole leaves at a time, forward and backward.

:func:`reduce_grads` then brings the rest of the gradients to their owner:
replicated and model-sharded ones are averaged over the batch group (the
D·F ranks of one model index).

The checkpoint's state is :func:`full_params` and :func:`full_moments` (the
shards gathered on every rank); a load keeps the rank's slice of the
whole tensors (:func:`shard_of`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import torch

from .collectives import DataAxis, all_gather_, all_reduce_, mean_grads, reduce_scatter_
from .mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, Mesh, param_sharding

Placement = Optional[Tuple[str, int]]


@dataclass
class ShardPlan:
    """Where each parameter of a placed model lives: ``placements`` by
    state-dict key (None: replicated; else (axis, port dim)), the keys of
    the Dense kernels (column-parallel when model-sharded), and the buckets
    of the gathered leaves (:class:`_Bucket`) by the unit that gathers them
    (its module name; a leaf read through :func:`whole` is a unit of its
    own, named by its key)."""

    mesh: Mesh
    placements: Dict[str, Placement]
    dense: Set[str]
    units: Dict[str, List["_Bucket"]] = field(default_factory=dict)

    def axis(self, name: str) -> DataAxis:
        return self.mesh.sub_axis(name)

    def gathered(self, key: str) -> bool:
        """A leaf that the per-layer gathering gathers: every sharded leaf
        but the column-parallel kernels."""
        where = self.placements[key]
        return where is not None and (where[0] == FSDP_AXIS or key not in self.dense)


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


# ---------------------------------------------------------------------------
# per-layer gathering
# ---------------------------------------------------------------------------


@dataclass
class _Leaf:
    owner: torch.nn.Module
    name: str
    param: torch.nn.Parameter
    dim: int


class _Bucket:
    """The sharded leaves of one unit over one axis, of one dtype: one flat
    all-gather gathers them, one reduce-scatter (fsdp) reduces their
    gradients, or each keeps its slice of its gradient (model)."""

    def __init__(self, plan: ShardPlan, axis: str, leaves: List[_Leaf]):
        self.plan, self.axis, self.leaves = plan, axis, leaves
        world = plan.axis(axis).world
        self.nbytes = world * sum(lf.param.numel() * lf.param.element_size() for lf in leaves)

    def gather(self) -> List[torch.Tensor]:
        """Each leaf whole (fresh contiguous tensors), from every rank's
        current shards."""
        ax = self.plan.axis(self.axis)
        moved = [lf.param.detach().movedim(lf.dim, 0) for lf in self.leaves]
        flat = torch.cat([m.reshape(-1) for m in moved])
        got = all_gather_(flat, ax.world, group=ax.group)
        out, i = [], 0
        for m, lf in zip(moved, self.leaves):
            n = m.numel()
            whole = got[:, i:i + n].reshape((ax.world * m.shape[0],) + tuple(m.shape[1:]))
            out.append(whole.movedim(0, lf.dim).clone(memory_format=torch.contiguous_format))
            i += n
        return out

    def reduce(self, grads) -> List[torch.Tensor]:
        """The shards' gradients from the whole ones: over fsdp a
        reduce-scatter (rank i's chunk of the flat buffer holds its shard of
        every leaf), an all-reduce over the data group and a division by
        D·F; over the model axis this rank's slice."""
        if self.axis == MODEL_AXIS:
            return [shard_of(g, (MODEL_AXIS, lf.dim), self.plan.mesh).contiguous()
                    for g, lf in zip(grads, self.leaves)]
        fa, da = self.plan.axis(FSDP_AXIS), self.plan.axis(DATA_AXIS)
        moved = [g.movedim(lf.dim, 0) for g, lf in zip(grads, self.leaves)]
        flat = torch.cat([m.reshape(fa.world, -1) for m in moved], dim=1).reshape(-1)
        mine = reduce_scatter_(flat, fa.world, group=fa.group)
        if da.world > 1:
            all_reduce_(mine, group=da.group)
        mine = mine / (fa.world * da.world)
        out, i = [], 0
        for m, lf in zip(moved, self.leaves):
            shape = (m.shape[0] // fa.world,) + tuple(m.shape[1:])
            n = m.numel() // fa.world
            out.append(mine[i:i + n].view(shape).movedim(0, lf.dim).contiguous())
            i += n
        return out


class _Gathered:
    """One gather of a bucket (a unit's forward, or a :func:`whole`): the
    backward's way to gather it again (:meth:`again`, once for all the
    leaves it kept, until the last of them is unpacked) and to reduce its
    gradients."""

    def __init__(self, bucket: _Bucket):
        self.bucket = bucket
        self.pending = 0
        self.cache: Optional[List[torch.Tensor]] = None

    def again(self, index: int) -> torch.Tensor:
        if self.cache is None:
            self.cache = self.bucket.gather()
        out = self.cache[index]
        self.pending -= 1
        if self.pending <= 0:
            self.cache = None
        return out


class _GatherBucket(torch.autograd.Function):
    """The bucket's leaves whole from their shards; the backward reduces
    their gradients to the shards' (:meth:`_Bucket.reduce`)."""

    @staticmethod
    def forward(ctx, call: _Gathered, *shards):
        ctx.gather_call = call
        return tuple(call.bucket.gather())

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.gather_call.bucket.reduce(grads))


def _gather(bucket: _Bucket) -> Tuple[torch.Tensor, ...]:
    return _GatherBucket.apply(_Gathered(bucket), *(lf.param for lf in bucket.leaves))


@dataclass
class _Packed:
    """A gathered leaf (or its copy in another dtype, or a view of either)
    that autograd keeps, as the means to make it again."""

    call: _Gathered
    index: int
    dtype: Optional[torch.dtype]
    view: Optional[Tuple[torch.Size, Tuple[int, ...], int]]


def _pack(t: torch.Tensor):
    base = t._base if t._is_view() else t
    fn, index, dtype = base.grad_fn, base.output_nr, None
    if fn is not None and type(fn).__name__ == "ToCopyBackward0":
        (fn, index), dtype = fn.next_functions[0], base.dtype
    call = getattr(fn, "gather_call", None)
    if call is None or base.device != call.bucket.leaves[0].param.device:
        return t
    call.pending += 1
    view = (t.size(), t.stride(), t.storage_offset()) if t is not base else None
    return _Packed(call, index, dtype, view)


def _unpack(p):
    if not isinstance(p, _Packed):
        return p
    t = p.call.again(p.index)
    if p.dtype is not None:
        t = t.to(p.dtype)
    return t if p.view is None else t.as_strided(*p.view)


@contextlib.contextmanager
def per_layer(model: torch.nn.Module):
    """The forwards and backwards of a step of a placed model: inside the
    block a gathered leaf that autograd keeps is gathered again when the
    backward needs it, so that it is released after its unit's forward
    (module docstring). A no-op for a model that is not placed."""
    if plan_of(model) is None:
        yield
        return
    with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
        yield


def whole(module: torch.nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name`` whole: gathered here for a sharded
    leaf outside every unit (a collective: every rank of its axis reads it
    at the same point), as it is otherwise (replicated, a column-parallel
    kernel, or a leaf its unit has gathered)."""
    t = module._parameters[name]
    bucket = getattr(t, "gather_bucket", None)
    return t if bucket is None else _gather(bucket)[0]


def _units(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The modules of ``model`` that gather their leaves for their forward,
    by name."""
    return {n: m for n, m in model.named_modules()
            if n and getattr(type(m), "gather_unit", False)}


def _install_units(model: torch.nn.Module, plan: ShardPlan) -> None:
    """Group the gathered leaves into buckets, by their innermost unit (a
    leaf outside every unit is a unit of its own, which :func:`whole`
    gathers), axis and dtype, and hook each unit's forward."""
    units = _units(model)
    owners = dict(model.named_modules())
    grouped: Dict[str, Dict[Tuple[str, torch.dtype], List[_Leaf]]] = {}
    for key, p in model.named_parameters():
        if not plan.gathered(key):
            continue
        owner_name, _, leaf = key.rpartition(".")
        prefixes = [u for u in units if key.startswith(u + ".")]
        unit = max(prefixes, key=len) if prefixes else key
        axis, dim = plan.placements[key]
        grouped.setdefault(unit, {}).setdefault((axis, p.dtype), []).append(
            _Leaf(owners[owner_name], leaf, p, dim))
    for unit, by in grouped.items():
        plan.units[unit] = [_Bucket(plan, axis, leaves) for (axis, _), leaves in by.items()]
        if unit not in units:
            plan.units[unit][0].leaves[0].param.gather_bucket = plan.units[unit][0]
            continue
        buckets = plan.units[unit]

        def enter(module, args, buckets=buckets):
            for bucket in buckets:
                for lf, full in zip(bucket.leaves, _gather(bucket)):
                    lf.owner._parameters[lf.name] = full

        def leave(module, args, out, buckets=buckets):
            for bucket in buckets:
                for lf in bucket.leaves:
                    lf.owner._parameters[lf.name] = lf.param

        units[unit].register_forward_pre_hook(enter)
        units[unit].register_forward_hook(leave, always_call=True)


def place_model(model: torch.nn.Module, mesh: Optional[Mesh]) -> Optional[ShardPlan]:
    """Keep this rank's shard of each parameter that ``param_sharding``
    shards (every rank must hold the same whole parameters first), mark the
    model-sharded Dense kernels column-parallel and hook the per-layer
    gathering of the rest (module docstring). A no-op without an fsdp or a
    model axis, and on a model placed already. Returns the plan (None when
    nothing is sharded)."""
    if mesh is None or not mesh.sharded:
        return None
    plan = plan_of(model)
    if plan is not None:
        return plan
    from ..convert import flax_leaf_names

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
    _install_units(model, plan)
    model._shard_plan = plan
    return plan


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
    rank's shard where the parameter is sharded. ``grads`` hold the shards'
    gradients of a sharded state, those of the fsdp leaves reduced by the
    backward already."""
    if plan is None:
        return mean_grads(grads)
    done = {k for k in grads if (plan.placements[k] or ("",))[0] == FSDP_AXIS}
    out = mean_grads({k: g for k, g in grads.items() if k not in done})
    out.update({k: grads[k] for k in done})
    return {k: out[k] for k in grads}


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


def column_parallel(x: torch.Tensor, w: torch.Tensor, axis: DataAxis,
                    dot: Optional[torch.nn.Module] = None) -> torch.Tensor:
    """``x @ W.T`` of a Dense kernel whose rows (the output features) are
    split over the model axis: this rank's ``w`` gives its columns, which
    are gathered. No bias (the caller adds the whole one).

    ``dot``: the kernel's injected int8 dot (``ops/qdot.py``,
    ``ops/aqt.py``), run on ``x`` and this rank's columns with the global
    scales (``model_axis=axis``); its backward, given this rank's columns of
    the output's gradient, returns the whole input gradient (the int32
    partial sums summed over the group), so ``x`` passes as it is."""
    if dot is None:
        return _GatherCols.apply(
            torch.nn.functional.linear(_CopyToModel.apply(x, axis), w), axis)
    y = dot(x, w.t(), (((x.ndim - 1,), (0,)), ((), ())), model_axis=axis)
    return _GatherCols.apply(y, axis)
