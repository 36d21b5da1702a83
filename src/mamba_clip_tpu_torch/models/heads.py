"""Stage-2 classification heads, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/heads.py``:

- :class:`ClipClassifier`, the frozen-CLIP MLP head: encode image and text
  with a CLIP, combine the features (concat | inner product | visual-only |
  text-only), then ``fc1`` -> ReLU -> ``fc2`` in fp32. ``freeze_clip`` runs
  the CLIP under ``torch.no_grad()`` (``jax.lax.stop_gradient`` on the
  features in the JAX package): no gradient reaches the towers, the flash
  forward keeps no residuals and no backward kernel launches.
- :class:`MambaVisionClassifier`, Dropout + Linear over a VSSM backbone.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .clip import ClipModel
from .vssm import VSSM, _apply_keep, _lecun_normal_, _linear, keep_mask


def _tower_dim(tower: nn.Module) -> int:
    """The width of a tower's output features."""
    dim = getattr(tower, "embed_dim", None)
    return int(dim) if dim is not None else int(tower.proj.out_features)


class ClipClassifier(nn.Module):
    """``fc1`` -> ReLU -> ``fc2`` over a CLIP's normalized features.

    The feature modes are those of the JAX package: concat (the default,
    ``hidden = feature_dim // 2``), ``use_visual_only``, ``use_text_only``
    and ``use_inner_prod`` (``hidden = feature_dim``); ``feature_dim``
    defaults to the width of the combined features. Both towers always
    run, as in the JAX package.

    In training mode the frozen CLIP still runs in training mode: its
    ``patch_dropout``, DropPath and dropout draw from ``generator`` and a
    VSSM tower's BatchNorm uses and moves its batch statistics, as
    ``deterministic=False`` does in the JAX package."""

    def __init__(self, clip: ClipModel, num_classes: int = 2,
                 feature_dim: Optional[int] = None, use_visual_only: bool = False,
                 use_text_only: bool = False, use_inner_prod: bool = False,
                 freeze_clip: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.clip = clip
        self.num_classes = num_classes
        self.use_visual_only = use_visual_only
        self.use_text_only = use_text_only
        self.use_inner_prod = use_inner_prod
        self.freeze_clip = freeze_clip
        img_dim, txt_dim = _tower_dim(clip.visual), _tower_dim(clip.text)
        if use_visual_only:
            in_dim = img_dim
        elif use_text_only:
            in_dim = txt_dim
        elif use_inner_prod:
            if img_dim != txt_dim:
                raise ValueError(
                    f"use_inner_prod: the towers' widths differ ({img_dim}, {txt_dim})")
            in_dim = img_dim
        else:
            in_dim = img_dim + txt_dim
        self.feature_dim = feature_dim or in_dim
        single = use_visual_only or use_text_only or use_inner_prod
        hidden = self.feature_dim if single else self.feature_dim // 2
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)
        for fc in (self.fc1, self.fc2):
            _lecun_normal_(fc.weight, generator)
            nn.init.zeros_(fc.bias)

    def forward(self, image, text, generator: Optional[torch.Generator] = None):
        with torch.no_grad() if self.freeze_clip else contextlib.nullcontext():
            out = self.clip(image=image, text=text, generator=generator)
        img, txt = out.get("image_features"), out.get("text_features")
        if self.use_visual_only:
            feats = img
        elif self.use_text_only:
            feats = txt
        elif self.use_inner_prod:
            feats = img * txt
        else:
            feats = torch.cat([img, txt], dim=-1)
        x = F.relu(_linear(feats, self.fc1, torch.float32))
        return _linear(x, self.fc2, torch.float32)

    def classify(self, image, text):
        probs = torch.softmax(self(image, text), dim=-1)
        return torch.argmax(probs, dim=-1), probs


class MambaVisionClassifier(nn.Module):
    """Dropout + Linear ``fc`` over a VSSM backbone's pooled features (the
    backbone is built with ``num_classes=0``)."""

    def __init__(self, backbone: VSSM, num_classes: int = 2, dropout: float = 0.1,
                 freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = backbone
        self.freeze_backbone = freeze_backbone
        self.dropout = dropout
        self.fc = nn.Linear(backbone.num_features, num_classes)
        _lecun_normal_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, image, text=None, generator: Optional[torch.Generator] = None):
        """``generator``: the explicit generator that training mode draws
        the backbone's and this head's dropout masks from."""
        feats = self.backbone(image, generator)
        if self.freeze_backbone:
            feats = feats.detach()
        feats = feats.float()
        if self.training and self.dropout > 0.0:
            feats = _apply_keep(
                feats, keep_mask(feats.shape, self.dropout, generator, feats.device),
                self.dropout)
        return _linear(feats, self.fc, torch.float32)
