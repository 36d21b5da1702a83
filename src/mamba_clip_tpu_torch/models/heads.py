"""Stage-2 classification heads, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/heads.py``. Only
:class:`MambaVisionClassifier` is ported; ``ClipClassifier`` waits for the
CLIP towers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .vssm import VSSM, _lecun_normal_


class MambaVisionClassifier(nn.Module):
    """Dropout + Linear ``fc`` over a VSSM backbone's pooled features (the
    backbone is built with ``num_classes=0``)."""

    def __init__(self, backbone: VSSM, num_classes: int = 2, dropout: float = 0.1,
                 freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = backbone
        self.freeze_backbone = freeze_backbone
        self.dropout = nn.Dropout(dropout)
        self.fc = nn.Linear(backbone.num_features, num_classes)
        _lecun_normal_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, image, text=None):
        feats = self.backbone(image)
        if self.freeze_backbone:
            feats = feats.detach()
        feats = self.dropout(feats.float())
        return F.linear(feats, self.fc.weight, self.fc.bias)
