"""Optimizer assembly: clipping + AdamW + no-decay mask + freeze mask + schedule.

Counterpart of ``mamba_clip_tpu/optim.py``, with optax's arithmetic written
out over a flat ``{parameter name: tensor}`` dict (``named_parameters``):

    clip_by_global_norm -> scale_by_adam -> add_decayed_weights(mask=ndim>=2)
    -> scale_by_learning_rate

- Clipping scales every gradient by ``max_norm / |g|`` only when the global
  norm ``|g|`` is not below ``max_norm`` (``(g / |g|) * max_norm``, with no
  epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
- Adam keeps ``eps`` outside the square root: ``m_hat / (sqrt(v_hat) + eps)``,
  with the bias corrections ``1 - b**count`` rounded to fp32 as optax does.
- Decoupled weight decay ``wd * p`` is added to the Adam direction of the
  leaves with ndim >= 2 only.
- The learning rate of the k-th update (k from 0) is ``schedule(k)``.
- Frozen leaves (a trainable mask, ``optax.multi_transform`` with
  ``set_to_zero`` in JAX) get a zero update and no decay, keep no moments
  and are left out of the clipping norm.

Types, for the low-precision parameters of ``--precision bf16|pure_bf16|
pure_fp16``: every step rounds where optax 0.2.6 rounds, so that a bf16 or
fp16 leaf gets optax's update bit for bit. A Python constant (``1 - b1``,
``b1``, ``eps``, the weight decay, ``max_norm``, the learning rate) is a
weakly typed value in JAX, rounded to the type of the tensor it meets
before the operation (PyTorch would apply it in fp32); the bias
corrections ``1 - b**count`` are taken in fp32 and then cast to the
moment's type (``optax.tree.bias_correction``); a leaf's sum of squares
accumulates in fp32 and rounds to the leaf's type (``jnp.sum``), and the
leaves' sums add in their promoted type. Two tensors of different types
promote as ``jnp`` promotes them: fp32 gradients (the fp16 train step
unscales by an fp32 scale) against fp16 moments give fp32 moments. The
train step rounds ``p + u`` back to ``p``'s type (``optax.apply_updates``).

The transform is functional like optax's: ``init(params)`` gives the
state, ``update(grads, state, params)`` the additive updates and the next
state; the train step adds the updates to the parameters in place.

Sharded state (the fsdp and model axes, ``parallel/sharding.py``): the
update runs on the rank's shards of the parameters, moments and gradients,
elementwise as on whole leaves; the clipping norm takes each leaf's sum of
squares over its shard and sums it over that leaf's shard group, and a
replicated leaf counts once (``update(..., plan=...)``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]


def decay_mask(params: Params) -> Dict[str, bool]:
    """True where weight decay applies: leaves with ndim >= 2."""
    return {k: p.ndim >= 2 for k, p in params.items()}


def freeze_submodule_mask(params: Params, frozen: Iterable[str]) -> Dict[str, bool]:
    """Trainable mask (True = trainable) that freezes whole top-level
    submodules (the first component of the parameter name)."""
    frozen = set(frozen)
    return {k: k.split(".", 1)[0] not in frozen for k in params}


def merge_masks(a: Optional[Mapping[str, bool]],
                b: Optional[Mapping[str, bool]]) -> Optional[Dict[str, bool]]:
    """AND of two trainable masks (None = all-trainable)."""
    if a is None:
        return None if b is None else dict(b)
    if b is None:
        return dict(a)
    return {k: bool(a[k]) and bool(b[k]) for k in a}


def _weak(x: float, like: torch.Tensor):
    """The Python number ``x`` as JAX applies it to ``like``: rounded to
    ``like``'s type. A 0-d tensor on the CPU, which takes no part in the
    result's type and, beside a CUDA tensor, goes to the kernel as an
    argument (no copy to the card). For fp32 the number itself does the
    same, and stays a number."""
    return x if like.dtype == torch.float32 else _scalar(float(x), like.dtype)


@functools.lru_cache(maxsize=256)
def _scalar(x: float, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` as a 0-d CPU tensor, made once (the
    optimizer's constants recur in every leaf and step; nothing writes
    them)."""
    if dtype == torch.float16:  # numpy rounds a double to fp16 once, as JAX does
        return torch.from_numpy(np.asarray(x, np.float16))
    return torch.tensor(x, dtype=dtype)


def global_norm(tensors, plan=None) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every entry of
    ``tensors`` (an iterable, or a ``{name: tensor}`` dict). Each tensor's
    squares are rounded to its type and summed in fp32, the sum rounded to
    its type (``jnp.sum``); the sums add in their promoted type, the square
    root is taken in that type.

    With a shard ``plan`` (``parallel/sharding.ShardPlan``), ``tensors`` is
    a ``{name: shard}`` dict: a sharded leaf's fp32 sum over its shard is
    summed over its axis's group (one all-reduce an axis) before it is
    rounded; a replicated leaf counts once."""
    if plan is None:
        values = tensors.values() if isinstance(tensors, Mapping) else tensors
        return torch.sqrt(sum(torch.sum(t * t, dtype=torch.float32).to(t.dtype)
                              for t in values))
    from .parallel.collectives import all_reduce_

    sums = {k: torch.sum(t * t, dtype=torch.float32) for k, t in tensors.items()}
    for axis in ("fsdp", "model"):
        keys = [k for k in sums if (plan.placements.get(k) or ("",))[0] == axis]
        if keys:
            total = all_reduce_(torch.stack([sums[k] for k in keys]),
                                group=plan.axis(axis).group)
            sums.update(zip(keys, total.unbind(0)))
    return torch.sqrt(sum(sums[k].to(t.dtype) for k, t in tensors.items()))


@dataclass
class AdamState:
    count: int                    # updates made so far
    mu: Dict[str, torch.Tensor]   # first moments of the trainable leaves
    nu: Dict[str, torch.Tensor]   # second moments


class AdamW:
    """The chain ``build_optimizer`` assembles (see the module docstring)."""

    def __init__(self, lr, b1: float, b2: float, eps: float, wd: float,
                 clip_norm: Optional[float], trainable_mask=None):
        self.lr = lr
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.clip_norm = clip_norm
        self.trainable_mask = trainable_mask

    def _trainable(self, params: Params):
        m = self.trainable_mask
        return [k for k in params if m is None or m[k]]

    def init(self, params: Params) -> AdamState:
        names = self._trainable(params)
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(params[k]) for k in names},
            nu={k: torch.zeros_like(params[k]) for k in names})

    def update(self, grads: Params, state: AdamState, params: Params, plan=None):
        """``plan``: the shard plan of sharded ``grads`` and ``params``
        (the module docstring)."""
        names = list(state.mu)
        g = {k: grads[k] for k in names}
        if self.clip_norm is not None:
            norm = global_norm(g, plan)
            keep = norm < _weak(self.clip_norm, norm)
            g = {k: torch.where(keep, t, (t / norm.to(t.dtype)) * _weak(self.clip_norm, t))
                 for k, t in g.items()}
        b1, b2 = self.b1, self.b2
        mu = {k: _weak(1 - b1, g[k]) * g[k] + _weak(b1, state.mu[k]) * state.mu[k]
              for k in names}
        nu = {k: _weak(1 - b2, g[k]) * (g[k] * g[k]) + _weak(b2, state.nu[k]) * state.nu[k]
              for k in names}
        count = state.count + 1
        # the bias corrections in fp32, as optax takes them, then in the
        # moment's type
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in (b1, b2))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        decay = decay_mask(params)
        updates = {}
        for k, p in params.items():
            if k not in mu:
                updates[k] = torch.zeros_like(p)
                continue
            nu_hat = nu[k] / _weak(c2, nu[k])
            u = (mu[k] / _weak(c1, mu[k])) / (torch.sqrt(nu_hat) + _weak(self.eps, nu_hat))
            if self.wd and decay[k]:
                u = u + _weak(self.wd, p) * p
            updates[k] = _weak(-lr, u) * u
        return updates, AdamState(count=count, mu=mu, nu=nu)


def build_optimizer(
    args,
    schedule: Optional[Callable[[int], float]],
    trainable_mask: Optional[Mapping[str, bool]] = None,
) -> AdamW:
    """The reference recipe from ``args`` (lr, beta1, beta2, eps, wd,
    grad_clip_norm); ``schedule`` replaces the constant ``args.lr``."""
    return AdamW(
        lr=schedule if schedule is not None else args.lr,
        b1=args.beta1, b2=args.beta2, eps=args.eps, wd=args.wd,
        clip_norm=args.grad_clip_norm, trainable_mask=trainable_mask)
