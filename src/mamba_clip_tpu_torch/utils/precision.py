"""Mixed-precision policy mapping, in torch dtypes.

Counterpart of ``mamba_clip_tpu/utils/precision.py`` (``Policy``,
``_POLICIES``, ``get_policy``). ``amp`` is bf16 compute over fp32
parameters; the modules cast at each use site (``dtype=cdt`` in the JAX
package), so no ``torch.autocast`` region is involved. The loss-scale state
of the fp16 modes and the parameter-tree casts belong to training and are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    loss_scale: float = 1.0  # static scale; 1.0 = disabled
    dynamic_loss_scale: bool = False  # GradScaler-equivalent (fp16 modes)


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
