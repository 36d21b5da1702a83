"""Model zoo + factory, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/__init__.py``; only the classifier
zoo over the VSSM family is ported so far.
"""

from __future__ import annotations

from typing import Optional

import torch

from .heads import MambaVisionClassifier
from .vssm import (
    SS2D,
    VSSM,
    ConvBranch,
    PatchEmbed2D,
    PatchMerging2D,
    SSConvSSM,
    VSSLayer,
    medmamba,
)

__all__ = [
    "MambaVisionClassifier", "VSSM", "SS2D", "SSConvSSM", "ConvBranch",
    "VSSLayer", "PatchEmbed2D", "PatchMerging2D", "medmamba",
    "build_classifier",
]


def build_classifier(
    name: Optional[str],
    num_classes: int = 2,
    dtype: torch.dtype = torch.float32,
    scan_impl: Optional[str] = None,
    quant: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
):
    """Classifier model zoo: ``None``/``vssm``/``medmamba`` -> the VSSM
    (medmamba) classifier; names containing ``mamba`` (e.g.
    ``mambavision``) -> :class:`MambaVisionClassifier` over a VSSM
    backbone. Parameters are made on the CPU from ``generator``."""
    if quant is not None:
        raise NotImplementedError(
            f"--quant {quant}: the int8 modes are not ported yet (ROADMAP.md, "
            "Queue 1, 'Quantized modes')")
    n = (name or "vssm").lower()
    if n in ("vssm", "medmamba"):
        return medmamba(num_classes=num_classes, dtype=dtype,
                        scan_impl=scan_impl, generator=generator)
    if "mamba" in n:
        backbone = VSSM(
            depths=(2, 2, 8, 2), dims=(64, 128, 256, 512), num_classes=0,
            dtype=dtype, scan_impl=scan_impl, generator=generator,
        )
        return MambaVisionClassifier(backbone=backbone, num_classes=num_classes,
                                     generator=generator)
    raise ValueError(
        f"Model {name!r} not recognized: use vssm | medmamba | mambavision")
