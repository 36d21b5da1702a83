"""Pipeline parallelism (the GPipe schedule) over the ranks of a group.

Counterpart of ``mamba_clip_tpu/parallel/pipeline.py``: a homogeneous
block stack (transformer encoder blocks, VSSM layers) is split into S
stages, one a rank, and microbatches stream through with
``collectives.permute_`` handing each activation to the next stage.

- Stage parameters are stacked on a leading axis (:func:`stack_stages`,
  :func:`split_into_stages`); a rank runs its own stage's slice.
- The schedule is GPipe's fill-drain: with S stages and M microbatches
  every rank runs T = M + S - 1 ticks of its stage; stage 0 feeds
  microbatch ``min(t, M - 1)``, the last stage collects microbatch
  ``t - (S - 1)``, and after every tick but the last a ring permute hands
  each stage's output to the next. Ranks compute on garbage during fill
  and drain (the bubble, (S - 1)/(M + S - 1) of the ticks).
- The last stage's outputs are replicated on every rank by a masked sum
  over the group. Each rank's loss is then the one loss of one replicated
  output, so that sum's backward passes each rank its cotangent as it is
  (an all-reduce there would count the loss S times).
- The backward is autograd's: the permutes' backward is the reverse ring,
  and every choice between ranks is a tensor mask, so that each rank's
  graph has one shape and runs the permutes' backwards in one order.
  ``x``'s gradient on a rank is its part; summed over the group, as a
  replicated input's, it is the sequential gradient.

Every stage must keep the activation's shape and type, and the batch must
split into M equal microbatches.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .collectives import all_reduce_, permute_

__all__ = ["pipeline_apply", "stack_stages", "split_into_stages"]


def _tree_map(fn, *trees):
    """``fn`` over the leaves (tensors) of structurally identical nested
    dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stages(stage_trees: Sequence[Any]):
    """Stack per-stage parameter trees (nested dicts of tensors, e.g. state
    dicts) on a new leading axis. The trees must be structurally identical
    (homogeneous stages)."""
    return _tree_map(lambda *xs: torch.stack(xs), *stage_trees)


def split_into_stages(block_params: Sequence[Any], n_stages: int):
    """Group an ordered list of homogeneous block parameter trees into
    ``n_stages`` equal stage trees (each a dict ``sub0..subK``), then stack
    them. ``len(block_params)`` must divide evenly."""
    n = len(block_params)
    if n % n_stages:
        raise ValueError(
            f"{n} blocks do not split into {n_stages} equal pipeline stages"
        )
    k = n // n_stages
    stages = [
        {f"sub{j}": block_params[i * k + j] for j in range(k)}
        for i in range(n_stages)
    ]
    return stack_stages(stages)


class _ReplicateLast(torch.autograd.Function):
    """The sum over the group (the last stage's outputs, the others' zeros);
    the backward passes the cotangent as it is (module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    group=None,
    microbatches: int,
) -> torch.Tensor:
    """Run ``x`` through S pipelined stages, one a rank of ``group`` (the
    default group when None; S its size, the stage its rank).

    Args:
      stage_fn: ``(stage_params, h) -> h`` applying ONE stage; it must keep
        h's shape and type.
      stacked_params: a tree with a leading stage axis (:func:`stack_stages`)
        of size S, of which this rank runs its stage's slice, or of size 1,
        this rank's stage alone.
      x: the whole batch ``(B, ...)``, the same on every rank; B must split
        into ``microbatches`` equal microbatches.
      microbatches: M. A larger M shrinks the bubble, (S - 1)/(M + S - 1),
        and holds more activations.

    Returns the whole batch's output, replicated on every rank. Every rank
    of the group calls it (forward and backward)."""
    S = dist.get_world_size(group) if dist.is_initialized() else 1
    s = dist.get_rank(group) if dist.is_initialized() else 0
    B = x.shape[0]
    M = int(microbatches)
    if M <= 0 or B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    xm = x.reshape(M, B // M, *x.shape[1:])

    def mine(a):
        if a.shape[0] not in (S, 1):
            raise ValueError(f"stacked parameters of {a.shape[0]} stages on {S} ranks")
        return a[s if a.shape[0] == S else 0]

    p = _tree_map(mine, stacked_params)
    T = M + S - 1
    ring = [(i, (i + 1) % S) for i in range(S)]
    dev = x.device
    first = torch.tensor(s == 0, device=dev)
    last = torch.tensor(s == S - 1, device=dev)

    h_recv = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(M)]
    for t in range(T):
        h_in = torch.where(first, xm[min(t, M - 1)], h_recv)
        y = stage_fn(p, h_in)
        # the last stage's tick t completes microbatch t - (S - 1)
        if t >= S - 1:
            mi = t - (S - 1)
            outs[mi] = torch.where(last, y, outs[mi])
        if S > 1 and t < T - 1:
            h_recv = permute_(y, ring, group)
    stacked = torch.where(last, torch.stack(outs), torch.zeros_like(xm))
    if S > 1:
        stacked = _ReplicateLast.apply(stacked, group)
    return stacked.reshape(B, *x.shape[1:])
