"""Losses, in PyTorch.

Counterpart of ``mamba_clip_tpu/losses.py``: ``cross_entropy_loss`` (the
classifier train step), ``clip_loss`` (symmetric InfoNCE) and
``siglip_loss`` (pairwise sigmoid) over the features of the whole batch.
Logits are taken in fp32 whatever the compute policy. The JAX package's
``axis_name`` branches (features gathered across a device mesh, with
``local_loss``) belong to the parallel layers and are not ported: asked
for, they raise.
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean cross-entropy of (B, C) logits against hard integer targets
    (B,), soft float targets (B, C) (what balanced mixup makes), or hard
    targets weighted per class by ``weight`` (C,): then the mean is
    ``sum(w * nll) / sum(w)``, ``F.cross_entropy``'s weighted mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if target.is_floating_point():
        return -torch.mean(torch.sum(logp * target, dim=-1))
    picked = torch.gather(logp, -1, target[:, None].long())[:, 0]
    if weight is not None:
        w = weight.float()[target.long()]
        return -torch.sum(w * picked) / torch.clamp_min(torch.sum(w), 1e-12)
    return -torch.mean(picked)


def _no_axis(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name/local_loss: the loss over features gathered across devices "
            "is not ported yet (ROADMAP.md, Queue 1, item 7 'Parallel layers')")


def _xent_arange(logits: torch.Tensor) -> torch.Tensor:
    """Mean CE of (B, C) fp32 logits against the labels 0..B-1."""
    return -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=-1)))


def clip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    *,
    axis_name=None,
    local_loss: bool = False,
    logit_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Symmetric InfoNCE over L2-normalized features of the whole batch:
    the mean of the image-to-text and text-to-image cross-entropies of
    ``logit_scale * img @ txt.T`` (+ ``logit_bias``) against the diagonal."""
    _no_axis(axis_name)
    img, txt = image_features.float(), text_features.float()
    logits_per_image = (logit_scale.float() * img) @ txt.T
    if logit_bias is not None:
        logits_per_image = logits_per_image + logit_bias
    return 0.5 * (_xent_arange(logits_per_image) + _xent_arange(logits_per_image.T))


def siglip_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    logit_bias: torch.Tensor,
    *,
    axis_name=None,
) -> torch.Tensor:
    """Pairwise sigmoid loss (SigLIP): softplus(-z * logits) with z = +1 on
    the matched pairs and -1 elsewhere, summed over all pairs and divided
    by the number of images."""
    _no_axis(axis_name)
    img, txt = image_features.float(), text_features.float()
    logits = (logit_scale.float() * img) @ txt.T + logit_bias.float()
    z = 2.0 * torch.eye(logits.shape[0], logits.shape[1], device=logits.device) - 1.0
    return torch.sum(torch.nn.functional.softplus(-z * logits)) / logits.shape[0]
