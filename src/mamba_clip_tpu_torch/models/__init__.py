"""Model zoo + factory, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/__init__.py``: the classifier zoo
over the VSSM family, and the CLIP model with its towers and training
helpers.
"""

from __future__ import annotations

from typing import Optional

import torch

from .clip import (
    LOGIT_SCALE_MAX,
    ClipModel,
    VssmTower,
    build_clip,
    clamp_logit_scale,
    l2_normalize,
    lock_mask,
    resolve_gelu_approx,
)
from .heads import MambaVisionClassifier
from .text_bert import BertBlock, TextBert
from .vit import EncoderBlock, FusedAttention, MlpBlock, VisionTransformer
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
    "ClipModel", "VssmTower", "build_clip", "l2_normalize", "resolve_gelu_approx",
    "LOGIT_SCALE_MAX", "clamp_logit_scale", "lock_mask",
    "VisionTransformer", "EncoderBlock", "FusedAttention",
    "MlpBlock", "TextBert", "BertBlock",
    "MambaVisionClassifier", "VSSM", "SS2D", "SSConvSSM", "ConvBranch",
    "VSSLayer", "PatchEmbed2D", "PatchMerging2D", "medmamba",
    "build_classifier",
]


def build_classifier(
    name: Optional[str],
    num_classes: int = 2,
    dtype: torch.dtype = torch.float32,
    grad_checkpointing: bool = False,
    scan_impl: Optional[str] = None,
    quant: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
):
    """Classifier model zoo: ``None``/``vssm``/``medmamba`` -> the VSSM
    (medmamba) classifier; names containing ``mamba`` (e.g.
    ``mambavision``) -> :class:`MambaVisionClassifier` over a VSSM
    backbone. ``grad_checkpointing`` recomputes each block in the backward
    (``VSSLayer(use_checkpoint=True)``). Parameters are made on the CPU
    from ``generator``."""
    if quant is not None:
        raise NotImplementedError(
            f"--quant {quant}: the int8 modes are not ported yet (ROADMAP.md, "
            "Queue 1, 'Quantized modes')")
    n = (name or "vssm").lower()
    if n in ("vssm", "medmamba"):
        return medmamba(num_classes=num_classes, dtype=dtype,
                        use_checkpoint=grad_checkpointing, scan_impl=scan_impl,
                        generator=generator)
    if "mamba" in n:
        backbone = VSSM(
            depths=(2, 2, 8, 2), dims=(64, 128, 256, 512), num_classes=0,
            dtype=dtype, use_checkpoint=grad_checkpointing, scan_impl=scan_impl,
            generator=generator,
        )
        return MambaVisionClassifier(backbone=backbone, num_classes=num_classes,
                                     generator=generator)
    raise ValueError(
        f"Model {name!r} not recognized: use vssm | medmamba | mambavision")
