"""Mixed-precision policy mapping, in torch dtypes.

Counterpart of ``mamba_clip_tpu/utils/precision.py``: ``Policy``,
``_POLICIES``, ``get_policy``, ``get_input_dtype``, and the dynamic loss-scale state of the fp16
modes (``LossScaleState``, ``init_loss_scale``, ``update_loss_scale``:
torch ``GradScaler`` semantics). ``amp`` is bf16 compute over fp32
parameters; the modules cast at each use site (``dtype=cdt`` in the JAX
package), so no ``torch.autocast`` region is involved.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LossScaleState:
    """Dynamic loss-scale state: the scale doubles after
    ``GROWTH_INTERVAL`` consecutive finite-grad steps and halves (the step
    being skipped) on any non-finite gradient."""

    scale: float
    growth_count: int


# torch GradScaler defaults (init 2^16, growth 2x, backoff 0.5x, every 2000)
GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
GROWTH_INTERVAL = 2000


def init_loss_scale(init_scale: float = 2.0**16) -> LossScaleState:
    return LossScaleState(scale=float(init_scale), growth_count=0)


def update_loss_scale(state: LossScaleState, grads_finite: bool) -> LossScaleState:
    """One GradScaler.update(): grow on a full interval of finite steps,
    back off immediately on a non-finite one (never below 1)."""
    if not grads_finite:
        return LossScaleState(max(state.scale * BACKOFF_FACTOR, 1.0), 0)
    if state.growth_count + 1 >= GROWTH_INTERVAL:
        return LossScaleState(state.scale * GROWTH_FACTOR, 0)
    return LossScaleState(state.scale, state.growth_count + 1)


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    loss_scale: float = 1.0  # static scale; 1.0 = disabled
    dynamic_loss_scale: bool = False  # GradScaler-equivalent (fp16 modes)

    def cast_to_param(self, tree):
        """Cast the floating tensors of a tree (dicts, lists, tuples of
        tensors) to ``param_dtype``; other leaves pass through."""
        if isinstance(tree, dict):
            return {k: self.cast_to_param(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_param(v) for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.param_dtype)
        return tree

    def cast_params(self, module: torch.nn.Module) -> torch.nn.Module:
        """Keep ``module``'s parameters in ``param_dtype``, in place, as the
        pipeline keeps them (bf16 under ``bf16``/``pure_bf16``, fp16 under
        ``pure_fp16``); its buffers, BatchNorm's statistics among them,
        stay as they are, as JAX casts ``params`` and not ``batch_stats``."""
        for p in module.parameters():
            p.data = self.cast_to_param(p.data)
        return module


_POLICIES = {
    "amp": Policy(torch.float32, torch.bfloat16, torch.float32),
    "amp_bf16": Policy(torch.float32, torch.bfloat16, torch.float32),
    "amp_bfloat16": Policy(torch.float32, torch.bfloat16, torch.float32),
    "bf16": Policy(torch.bfloat16, torch.bfloat16, torch.float32),
    "pure_bf16": Policy(torch.bfloat16, torch.bfloat16, torch.float32),
    "fp16": Policy(torch.float32, torch.float16, torch.float32,
                   loss_scale=2.0**16, dynamic_loss_scale=True),
    "pure_fp16": Policy(torch.float16, torch.float16, torch.float32,
                        loss_scale=2.0**16, dynamic_loss_scale=True),
    "fp32": Policy(torch.float32, torch.float32, torch.float32),
}


def get_policy(precision: str) -> Policy:
    """Map a --precision flag to a Policy."""
    try:
        return _POLICIES[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision '{precision}'; one of {sorted(_POLICIES)}"
        ) from None


def get_input_dtype(precision: str) -> torch.dtype:
    """The type a ``--precision`` casts model inputs to: its compute type."""
    return get_policy(precision).compute_dtype
