"""Model zoo + factory, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/__init__.py``: the classifier zoo
over the VSSM family, the CLIP model with its towers and training helpers,
and ``init_model``, the factory from a model name to (model,
preprocess_train, preprocess_val, tokenizer).
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
from .heads import ClipClassifier, MambaVisionClassifier
from .text_bert import BertBlock, TextBert
from .vit import EncoderBlock, FusedAttention, MlpBlock, VisionTransformer
from .vssm import (
    SS2D,
    VSSM,
    ConvBranch,
    FinalPatchExpand2D,
    PatchEmbed2D,
    PatchExpand2D,
    PatchMerging2D,
    SSConvSSM,
    VSSLayer,
    VSSLayerUp,
    medmamba,
)

__all__ = [
    "ClipModel", "VssmTower", "build_clip", "l2_normalize", "resolve_gelu_approx",
    "LOGIT_SCALE_MAX", "clamp_logit_scale", "lock_mask",
    "VisionTransformer", "EncoderBlock", "FusedAttention",
    "MlpBlock", "TextBert", "BertBlock",
    "ClipClassifier", "MambaVisionClassifier", "VSSM", "SS2D", "SSConvSSM", "ConvBranch",
    "VSSLayer", "PatchEmbed2D", "PatchMerging2D", "medmamba",
    "PatchExpand2D", "FinalPatchExpand2D", "VSSLayerUp",
    "build_classifier", "init_model",
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
    (``VSSLayer(use_checkpoint=True)``). ``quant``: the ``--quant`` mode
    whose int8 dot the VSSM's Dense layers take (``ops/quant.py``).
    Parameters are made on the CPU from ``generator``."""
    from ..ops.quant import make_dot_general_cls

    dg_cls = make_dot_general_cls(quant)
    n = (name or "vssm").lower()
    if n in ("vssm", "medmamba"):
        return medmamba(num_classes=num_classes, dtype=dtype,
                        use_checkpoint=grad_checkpointing, scan_impl=scan_impl,
                        generator=generator, dot_general_cls=dg_cls)
    if "mamba" in n:
        backbone = VSSM(
            depths=(2, 2, 8, 2), dims=(64, 128, 256, 512), num_classes=0,
            dtype=dtype, use_checkpoint=grad_checkpointing, scan_impl=scan_impl,
            generator=generator, dot_general_cls=dg_cls,
        )
        return MambaVisionClassifier(backbone=backbone, num_classes=num_classes,
                                     generator=generator)
    raise ValueError(
        f"Model {name!r} not recognized: use vssm | medmamba | mambavision")


def init_model(
    model: Optional[str],
    tokenizer: Optional[str] = None,
    aug_cfg: Optional[dict] = None,
    is_clip: bool = False,
    use_tokenizer: bool = False,
    image_size: int = 224,
    num_classes: int = 2,
    dtype: torch.dtype = torch.float32,
    grad_checkpointing: bool = False,
    siglip: bool = False,
    patch_dropout: float = 0.0,
    quick_gelu: bool = False,
    scan_impl: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
):
    """Build (model, preprocess_train, preprocess_val, tokenizer):
    ``"medmamba"`` (unless ``is_clip``) -> the VSSM classifier; any other
    name -> the ViT-B/16 + PubMedBERT-shaped CLIP (``build_clip``). The
    preprocess entries are ``TransformConfig`` records; the tokenizer is
    made only with ``use_tokenizer``."""
    from ..data.preprocess_cfg import get_transform_config
    from ..data.tokenizer import get_tokenizer

    name = model or "biomedclip"
    if name == "medmamba" and not is_clip:
        module = medmamba(
            num_classes=num_classes, dtype=dtype,
            use_checkpoint=grad_checkpointing, scan_impl=scan_impl,
            generator=generator,
        )
    else:
        module = build_clip(
            model_name=name,
            image_size=image_size,
            quick_gelu=quick_gelu,
            patch_dropout=patch_dropout,
            grad_checkpointing=grad_checkpointing,
            siglip=siglip,
            dtype=dtype,
            scan_impl=scan_impl,
            generator=generator,
        )

    preprocess_train = get_transform_config(aug_cfg, image_size, is_train=True)
    preprocess_val = get_transform_config(aug_cfg, image_size, is_train=False)
    tok = get_tokenizer(tokenizer or name) if use_tokenizer else None
    return module, preprocess_train, preprocess_val, tok
