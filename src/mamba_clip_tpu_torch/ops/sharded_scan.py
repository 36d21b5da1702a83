"""Sequence-parallel selective scan over the ranks of a process group.

Counterpart of ``mamba_clip_tpu/ops/sharded_scan.py``. The scan is the
linear recurrence h_t = a_t h_{t-1} + b_t with a_t = exp(dt_t A) and b_t =
(dt_t u_t) B_t, read out as y_t = <C_t, h_t> (+ u_t D). Over a shard s of
L_s consecutive steps the whole shard is an affine transfer of the incoming
state, h_out = A_s h_in + h_s with A_s = exp((sum_t dt_t) A), and each local
output needs only the decayed incoming state:
y_t = y_t^0 + <C_t, exp(csum(dt)_t A) * h_in>. So each rank

1. runs the unchanged ``selective_scan_tm`` on its L-slice with a zero
   carry: on the card the forward kernel, and the backward kernel under
   autograd; on the CPU the plain loop;
2. exchanges the (B, G, DG, N) transfer pairs (A_s, h_s) with the other
   ranks in a log-depth Kogge-Stone pass over ``collectives.permute_``
   (ceil(log2 S) rounds and one shift, A and h a permute each);
3. adds the correction term, in plain torch.

The port has no ``shard_map``: a rank is called with its own L-slice of
``u``, ``delta``, ``B`` and ``C`` (dim 2), the slices in rank order, and
with ``A``, ``D`` and ``delta_bias`` whole. Their gradients are the sum
over the ranks of each rank's part, as ``shard_map`` sums a replicated
input's cotangent: they pass through an identity whose backward all-reduces
over the group, so every rank holds the single-device gradient.

Memory: the correction holds (B, G, L_s, DG, N) fp32 decay tensors, 1.64
GB each at medmamba's first stage (B 64, G 4, DG 64, N 16) split in two.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce_, permute_
from .selective_scan import _softplus, selective_scan_tm


def _transfer_compose(own, recv):
    """Compose affine transfers: apply ``recv`` (earlier steps) first, then
    ``own``: (A_o, h_o) o (A_r, h_r) = (A_o A_r, A_o h_r + h_o)."""
    A_o, h_o = own
    A_r, h_r = recv
    return A_o * A_r, A_o * h_r + h_o


def _exclusive_carry(A_s, h_s, group=None):
    """Exclusive prefix combine of the ranks' transfers over ``group``.

    Kogge-Stone doubling: round d sends each rank's inclusive transfer to
    the rank d to its right; a rank with no source at distance d takes the
    identity transfer (A = 1, h = 0). After ceil(log2 S) rounds each rank
    holds its inclusive prefix; a shift by one gives the exclusive carry
    (the identity on rank 0). The masks are tensors, so every rank's
    autograd graph has one shape and runs the permutes' backwards in one
    order. A group of one rank permutes nothing."""
    size = dist.get_world_size(group) if dist.is_initialized() else 1
    ident = (torch.ones_like(A_s), torch.zeros_like(h_s))
    if size == 1:
        return ident
    idx = dist.get_rank(group)
    acc = (A_s, h_s)
    d = 1
    while d < size:
        perm = [(i, i + d) for i in range(size - d)]
        recv = tuple(permute_(x, perm, group) for x in acc)
        has = torch.tensor(idx >= d, device=A_s.device)
        recv = tuple(torch.where(has, r, i) for r, i in zip(recv, ident))
        acc = _transfer_compose(acc, recv)
        d *= 2
    perm = [(i, i + 1) for i in range(size - 1)]
    shifted = tuple(permute_(x, perm, group) for x in acc)
    has = torch.tensor(idx >= 1, device=A_s.device)
    return tuple(torch.where(has, s, i) for s, i in zip(shifted, ident))


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group (a
    replicated input's gradient under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), group=ctx.group), None


def _replicated(x: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Replicated.apply(x, group)
    return x


def carry_rounds(size: int) -> int:
    """The permute rounds of the carry pass over ``size`` ranks: ceil(log2
    S) doubling rounds and the shift, each permuting A and h (none for one
    rank)."""
    return math.ceil(math.log2(size)) + 1 if size > 1 else 0


def sharded_selective_scan_tm(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    group=None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Time-major selective scan with L split over the ranks of ``group``
    (the default group when None).

    Each rank passes its own L-slice of ``u``/``delta`` (batch, G, L_s, DG)
    and ``B``/``C`` (batch, G, L_s, N), rank r holding the r-th slice, and
    ``A``, ``D``, ``delta_bias`` whole; it gets its slice of the y that
    :func:`selective_scan_tm` gives on the whole sequence. Every rank of the
    group calls it (forward and backward). ``impl`` as
    :func:`selective_scan_tm`'s."""
    Bsz, G, L, DG = u.shape
    N = A.shape[1]
    f32 = torch.float32
    d_total = A.shape[0]
    if D is None:
        D = torch.zeros((d_total,), dtype=f32, device=u.device)
    if delta_bias is None:
        delta_bias = torch.zeros((d_total,), dtype=f32, device=u.device)
    A, D, delta_bias = (_replicated(t, group) for t in (A, D, delta_bias))

    # the local zero-carry scan (D skip included) through the single-device scan
    y0 = selective_scan_tm(u, delta, A, B, C, D, delta_bias, delta_softplus, impl=impl)

    # the effective dt, as the scan computes it
    dt = delta.to(f32) + delta_bias.to(f32).reshape(1, G, 1, DG)
    if delta_softplus:
        dt = _softplus(dt)

    A_g = A.to(f32).reshape(1, G, 1, DG, N)
    csum = torch.cumsum(dt, dim=2)                          # (B, G, L, DG)
    total = csum[:, :, -1, :]                               # (B, G, DG)

    # decay from each step to the shard's start and end
    decay_in = torch.exp(csum[..., None] * A_g)             # (B, G, L, DG, N)
    decay_out = torch.exp((total[:, :, None, :] - csum)[..., None] * A_g)

    b_t = (dt * u.to(f32))[..., None] * B.to(f32)[:, :, :, None, :]
    h_end = torch.sum(decay_out * b_t, dim=2)               # (B, G, DG, N)
    A_shard = torch.exp(total[..., None] * A_g[:, :, 0])    # (B, G, DG, N)

    _, h_in = _exclusive_carry(A_shard, h_end, group)

    # the correction: y_t += <C_t, prefix_decay_t * h_in>
    corr = torch.sum(decay_in * h_in[:, :, None] * C.to(f32)[:, :, :, None, :], dim=-1)
    return y0 + corr
