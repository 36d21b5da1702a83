"""CLIP model: vision tower + text tower + logit scale, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/clip.py``: ``l2_normalize``,
``VssmTower``, ``ClipModel`` (``encode_image``, ``encode_text``, the
forward's output dict with ``logit_scale`` and, under ``siglip``,
``logit_bias``, ``get_logits``), ``LOGIT_SCALE_MAX``,
``resolve_gelu_approx`` and ``build_clip``. ``logit_scale`` is stored as
its log, initialized to ln(1/0.07), and exp'd in the forward. The training
helpers ``clamp_logit_scale`` and ``lock_mask`` come with the contrastive
train step (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .text_bert import TextBert
from .vit import VisionTransformer, _dense
from .vssm import VSSM

LOGIT_SCALE_MAX = math.log(100.0)  # the train step clamps the log scale to ln(100)
INIT_LOGIT_SCALE = math.log(1.0 / 0.07)
INIT_LOGIT_BIAS = -10.0  # --siglip


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return (x / torch.clamp_min(n, eps)).to(x.dtype)


class VssmTower(nn.Module):
    """VSSM backbone (``num_classes=0``: pooled features) + fp32
    projection ``proj`` without bias, usable as a CLIP vision tower."""

    def __init__(self, vssm: VSSM, embed_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vssm = vssm
        self.proj = _dense(vssm.num_features, embed_dim, generator, bias=False)

    def forward(self, x):
        return F.linear(self.vssm(x).float(), self.proj.weight)


class ClipModel(nn.Module):
    """Two-tower CLIP with a shared embedding space."""

    def __init__(self, visual: nn.Module, text: nn.Module, siglip: bool = False):
        super().__init__()
        self.visual = visual
        self.text = text
        self.siglip = siglip
        self.logit_scale = nn.Parameter(torch.tensor(INIT_LOGIT_SCALE, dtype=torch.float32))
        self.logit_bias = (nn.Parameter(torch.tensor(INIT_LOGIT_BIAS, dtype=torch.float32))
                           if siglip else None)

    def encode_image(self, image, normalize: bool = False):
        feats = self.visual(image)
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, text, normalize: bool = False):
        feats = self.text(text)
        return l2_normalize(feats) if normalize else feats

    def forward(self, image=None, text=None):
        out = {"logit_scale": torch.exp(self.logit_scale)}
        if image is not None:
            out["image_features"] = self.encode_image(image, normalize=True)
        if text is not None:
            out["text_features"] = self.encode_text(text, normalize=True)
        if self.siglip:
            out["logit_bias"] = self.logit_bias
        return out

    def get_logits(self, image, text):
        """(image_logits, text_logits) pair."""
        out = self(image=image, text=text)
        logits = out["logit_scale"] * out["image_features"] @ out["text_features"].T
        if "logit_bias" in out:
            logits = logits + out["logit_bias"]
        return logits, logits.T


def resolve_gelu_approx(gelu: str, dtype: torch.dtype) -> bool:
    """Resolve the ``--gelu`` flag to the tanh form (True) or erf (False):
    "auto" picks the tanh form iff the compute dtype is bfloat16."""
    if gelu == "auto":
        return dtype == torch.bfloat16
    if gelu in ("exact", "erf"):
        return False
    if gelu == "tanh":
        return True
    raise ValueError(f"--gelu must be auto|exact|tanh, got {gelu!r}")


def build_clip(
    model_name: str = "biomedclip",
    embed_dim: int = 512,
    image_size: int = 224,
    context_length: int = 256,
    vocab_size: int = 30522,
    quick_gelu: bool = False,
    patch_dropout: float = 0.0,
    grad_checkpointing: bool = False,
    siglip: bool = False,
    dtype: torch.dtype = torch.float32,
    scan_impl: Optional[str] = None,
    quant: Optional[str] = None,
    gelu: str = "auto",
    attn_remat: bool = False,
    attn_flash: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ClipModel:
    """CLIP factory. ``biomedclip``/ViT names -> ViT-B/16 + PubMedBERT-shaped
    towers; ``medmamba``/``vssm`` -> the VSSM vision tower. Parameters are
    made on the CPU from ``generator``. ``attn_flash`` puts every attention
    interior on the flash path (``--attn-impl flash``)."""
    ai8, ai8d = quant == "int8_fast_attn", quant == "int8_delayed_attn"
    if attn_flash and (ai8 or ai8d):
        raise ValueError(
            "--attn-impl flash replaces the attention interior the "
            f"int8 attention modes quantize; drop flash or use --quant "
            f"{quant!r} without the _attn suffix"
        )
    if quant is not None:
        raise NotImplementedError(
            f"--quant {quant}: the int8 modes are not ported yet (ROADMAP.md, "
            "Queue 1, 'Quantized modes')")
    gelu_approx = resolve_gelu_approx(gelu, dtype)
    g = generator
    name = (model_name or "biomedclip").lower()
    if "medmamba" in name or "vssm" in name:
        vssm = VSSM(depths=(2, 2, 8, 2), dims=(64, 128, 256, 512), num_classes=0,
                    dtype=dtype, scan_impl=scan_impl, generator=g)
        visual = VssmTower(vssm, embed_dim=embed_dim, generator=g)
    else:
        visual = VisionTransformer(
            image_size=image_size, embed_dim=embed_dim, quick_gelu=quick_gelu,
            patch_dropout=patch_dropout, gelu_approx=gelu_approx,
            grad_checkpointing=grad_checkpointing, dtype=dtype, attn_remat=attn_remat,
            attn_flash=attn_flash, generator=g)
    text = TextBert(
        vocab_size=vocab_size, context_length=context_length, embed_dim=embed_dim,
        grad_checkpointing=grad_checkpointing, dtype=dtype, gelu_approx=gelu_approx,
        attn_remat=attn_remat, attn_flash=attn_flash, generator=g)
    return ClipModel(visual=visual, text=text, siglip=siglip)
