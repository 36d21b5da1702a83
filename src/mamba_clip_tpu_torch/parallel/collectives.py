"""The data axis's collectives, and the step's view of the axis.

A port rank is one process on one device; W ranks of B rows each compute
what one process computes over the W·B rows of the global batch, as the
JAX package's data-sharded mesh does. A train step opens the axis with
:func:`data_axis` for its duration; the code below it asks :func:`active`
and stays a no-op at world 1, so the modules that need the axis (the
losses, BatchNorm, the random draws, the int8 calibrations) take no extra
arguments:

- :func:`gather_rows`: the rows of every rank, rank-major, with gradient
  (the backward sums each rank's slice of the gradient over the ranks);
- :func:`sum_across`: an all-reduce sum with gradient (BatchNorm's global
  sums);
- :func:`max_across`: an all-reduce max without gradient (an absmax taken
  over the batch rows); :func:`max_over` the same over named groups of the
  mesh (the model group, or the batch and the model groups: an absmax of a
  column-parallel kernel's slice, or of a cotangent's rows and columns);
- :func:`sum_over`: an exact all-reduce sum over one group (an int8 dot's
  int32 partial sums over the model group);
- :func:`mean_grads`: the gradients averaged over the ranks, one flat
  all-reduce per dtype;
- :func:`draw_rows`: a random draw over the global batch, of which the rank
  keeps its rows, so that every rank takes its slice of one global draw.

The step's collectives go through :func:`all_reduce_`,
:func:`all_gather_` and :func:`reduce_scatter_`, on the tensors' own
device: ``nccl`` takes the card's tensors, and ``gloo`` (the CPU's
backend) takes them too, for ``all_reduce``, ``broadcast``,
``all_gather`` and ``reduce_scatter`` alike (checked on the H100 by
``chip_smoke.py`` phases 20 and 24), so nothing is staged through the
host. The axis of a step is the batch
axis of the mesh (data × fsdp, ``Mesh.axis``); the fsdp and model axes'
groups are used by ``parallel/sharding.py``.

:func:`permute_` is ``lax.ppermute``: point-to-point sends and receives
over a group, with the reverse permutation as its backward (the
sequence-parallel scan's carry pass and the GPipe schedule use it). nccl
takes the card's tensors; under gloo a card's tensor is staged through
the host (:func:`permute_path`).

:func:`count_collectives` counts every collective these functions issue,
by kind (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``) and output payload bytes, as the JAX package's
``tools/bench_scaling.py::collective_stats`` counts what XLA inserted.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist


@dataclass
class DataAxis:
    """A data axis of ``world`` ranks, this process being ``rank``;
    ``group`` None is the default process group."""

    rank: int
    world: int
    group: Optional[object] = None


_AXIS: Optional[DataAxis] = None


@contextlib.contextmanager
def data_axis(axis: Optional[DataAxis]):
    """Make ``axis`` the active data axis inside the block (None, or a
    world of 1, leaves none active)."""
    global _AXIS
    prev = _AXIS
    _AXIS = axis if axis is not None and axis.world > 1 else None
    try:
        yield _AXIS
    finally:
        _AXIS = prev


def active() -> Optional[DataAxis]:
    """The active data axis of more than one rank, or None."""
    return _AXIS


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_COUNTERS: List[Dict[str, Dict[str, int]]] = []


@contextlib.contextmanager
def count_collectives():
    """``{kind: {"count": n, "bytes": b}}`` of the collectives issued inside
    the block (filled as they are issued; counters nest). The bytes are the
    output's: the reduced tensor of an all-reduce, the gathered one of an
    all-gather, the rank's part of a reduce-scatter, the received tensor of
    a permute."""
    stats: Dict[str, Dict[str, int]] = {}
    _COUNTERS.append(stats)
    try:
        yield stats
    finally:
        _COUNTERS.remove(stats)


def _count(kind: str, out: torch.Tensor) -> None:
    for stats in _COUNTERS:
        s = stats.setdefault(kind, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += out.numel() * out.element_size()


# ---------------------------------------------------------------------------
# backend-aware collectives
# ---------------------------------------------------------------------------


def comm_device(group=None) -> torch.device:
    """The device the backend's collectives take: the current card for
    nccl, the host for gloo (which takes the card's tensors too)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of a contiguous ``t``; returns it."""
    dist.all_reduce(t, op=op, group=group)
    _count("all-reduce", t)
    return t


def all_gather_(t: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """The ``t`` of every rank, stacked on a new leading axis (world, ...)."""
    t = t.contiguous()
    out = torch.empty((world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t, group=group)
    _count("all-gather", out)
    return out


def reduce_scatter_(t: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """The sum over the group's ``world`` ranks of a flat ``t`` of
    ``world·n`` entries, of which this rank (its index in the group) keeps
    its ``n``: entries [i·n, (i + 1)·n). Both backends take it, gloo on the
    card's tensors too (``chip_smoke.py`` phase 24)."""
    t = t.contiguous()
    out = torch.empty(t.numel() // world, dtype=t.dtype, device=t.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, t, group=group)
    _count("reduce-scatter", out)
    return out


def permute_path(t: torch.Tensor, group=None) -> str:
    """How :func:`permute_` moves ``t`` over ``group``'s backend: ``device``
    (the tensor as it is: nccl, or any tensor on the host) or ``host-staged``
    (a card's tensor under gloo, copied to the host and back)."""
    if t.device.type != "cpu" and dist.get_backend(group) == "gloo":
        return "host-staged"
    return "device"


def _permute(x: torch.Tensor, pairs, group) -> torch.Tensor:
    """One ``ppermute``: rank ``i`` of ``group`` sends ``x`` to rank ``j``
    for each ``(i, j)`` of ``pairs``; a rank with no source gets zeros. All
    sends and receives of this rank go out in one ``batch_isend_irecv``, so
    a ring cannot deadlock."""
    me = dist.get_rank(group)
    staged = permute_path(x, group) == "host-staged"
    send = (x.to("cpu") if staged else x).contiguous()
    recv = torch.zeros_like(send)

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    ops = []
    for i, j in pairs:
        if i == j == me:
            recv.copy_(send)
            continue
        if i == me:
            ops.append(dist.P2POp(dist.isend, send, peer(j), group))
        if j == me:
            ops.append(dist.P2POp(dist.irecv, recv, peer(i), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count("collective-permute", recv)
    return recv.to(x.device) if staged else recv


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _permute(x.detach(), pairs, group)

    @staticmethod
    def backward(ctx, g):
        back = tuple((j, i) for i, j in ctx.pairs)
        return _permute(g, back, ctx.group), None, None


def permute_(x: torch.Tensor, pairs, group=None) -> torch.Tensor:
    """``lax.ppermute(x, axis, pairs)`` over ``group`` (the default group when
    None): rank ``i`` (its index in the group) sends ``x`` to rank ``j`` for
    each ``(i, j)`` of ``pairs``, and a rank that no pair names as a target
    receives zeros. Differentiable: the backward permutes the cotangent by
    the reverse pairs (``ppermute``'s transpose). Every rank of the group
    calls it with the same ``pairs``, forward and backward alike."""
    return _Permute.apply(x, tuple((int(i), int(j)) for i, j in pairs), group)


# ---------------------------------------------------------------------------
# the step's collectives
# ---------------------------------------------------------------------------


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ax = _AXIS
        ctx.axis = ax
        return all_reduce_(x.detach().clone().contiguous(), group=ax.group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone().contiguous(), group=ctx.axis.group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ax = _AXIS
        ctx.axis, ctx.rows = ax, x.shape[0]
        out = all_gather_(x.detach(), ax.world, group=ax.group)
        return out.reshape((ax.world * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        ax = ctx.axis
        total = all_reduce_(g.clone().contiguous(), group=ax.group)
        return total[ax.rank * ctx.rows:(ax.rank + 1) * ctx.rows]


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active axis's ranks, with gradient (the
    backward sums the gradient over the ranks); ``x`` at world 1."""
    return x if _AXIS is None else _SumAcross.apply(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, rank-major, with gradient; ``x`` at
    world 1."""
    return x if _AXIS is None else _GatherRows.apply(x)


def max_across(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the active axis's ranks, without
    gradient; ``x`` at world 1."""
    return max_over(x, _AXIS)


def max_over(x: torch.Tensor, *axes: Optional[DataAxis]) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of each of ``axes`` in
    turn (None, or an axis of one rank, is skipped), without gradient: over
    the batch axis and then the model axis, the max over every rank of the
    two. ``x`` itself when no axis is left."""
    axes = [ax for ax in axes if ax is not None and ax.world > 1]
    if not axes:
        return x
    out = x.detach().clone().contiguous()
    for ax in axes:
        all_reduce_(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out


def sum_over(t: torch.Tensor, axis: Optional[DataAxis]) -> torch.Tensor:
    """The sum of ``t`` over ``axis``'s ranks, without gradient (an int32
    ``t`` sums exactly); ``t`` at world 1 or without an axis."""
    if axis is None or axis.world == 1:
        return t
    return all_reduce_(t.detach().contiguous().clone(), group=axis.group)


def rank_offset(rows: int) -> int:
    """The global index of this rank's first row, for ``rows`` rows a rank."""
    return 0 if _AXIS is None else _AXIS.rank * rows


def world() -> int:
    return 1 if _AXIS is None else _AXIS.world


def draw_rows(rows: int, draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """``draw(n)`` makes a random tensor of ``n`` leading rows; at world W
    this rank draws the global W·rows and keeps its own slice, so the ranks
    together take one draw, as one process over the global batch does."""
    if _AXIS is None:
        return draw(rows)
    lo = _AXIS.rank * rows
    return draw(_AXIS.world * rows)[lo:lo + rows]


def mean_grads(grads: Dict[str, torch.Tensor], axis: Optional[DataAxis] = None
               ) -> Dict[str, torch.Tensor]:
    """Each gradient averaged over the ranks of ``axis`` (the active one by
    default): one flat all-reduce sum per dtype, then a division by W."""
    ax = axis or _AXIS
    if ax is None or ax.world == 1:
        return grads
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        all_reduce_(flat, group=ax.group)
        flat = flat / ax.world
        i = 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[i:i + n].view_as(grads[k])
            i += n
    return {k: out[k] for k in grads}
