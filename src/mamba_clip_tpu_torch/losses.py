"""Losses, in PyTorch.

Counterpart of ``mamba_clip_tpu/losses.py``: ``cross_entropy_loss`` (the
classifier train step), ``clip_loss`` (symmetric InfoNCE) and
``siglip_loss`` (pairwise sigmoid) over the features of the whole batch.
Logits are taken in fp32 whatever the compute policy.

``axis_name`` (any true value, e.g. ``"data"``): the features of every rank
of the active data axis (``parallel/collectives.py``) are gathered with
gradient, as the JAX package's ``jax.lax.all_gather`` inside ``shard_map``
gathers them. With ``local_loss`` each rank's logits are its own rows
against the gathered columns, the labels offset by the rank; the train step
averages the ranks' losses (JAX's ``pmean``). Without it every rank takes
the full logits of the global batch. ``gather_with_grad`` has no switch:
the gather always carries the gradient, as in JAX. Outside a data axis of
several ranks ``axis_name`` changes nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from .parallel.collectives import gather_rows, rank_offset, sum_across, world


def cross_entropy_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    *,
    axis_name=None,
) -> torch.Tensor:
    """Mean cross-entropy of (B, C) logits against hard integer targets
    (B,), soft float targets (B, C) (what balanced mixup makes), or hard
    targets weighted per class by ``weight`` (C,): then the mean is
    ``sum(w * nll) / sum(w)``, ``F.cross_entropy``'s weighted mean.

    ``axis_name`` under a data axis of W ranks: both sums run over the
    global batch (the denominator's across the ranks, without gradient),
    and the rank's loss is W times its share of the numerator, so that the
    ranks' mean is the global loss and the ranks' mean gradient its
    gradient."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if target.is_floating_point():
        nll = -torch.sum(logp * target, dim=-1)
        w = None
    else:
        nll = -torch.gather(logp, -1, target[:, None].long())[:, 0]
        w = None if weight is None else weight.float()[target.long()]
    if axis_name is not None and world() > 1:
        num = torch.sum(nll if w is None else w * nll)
        den = (torch.tensor(float(nll.shape[0]), device=nll.device) if w is None
               else torch.sum(w).detach())
        return world() * num / torch.clamp_min(sum_across(den), 1e-12)
    if w is not None:
        return torch.sum(w * nll) / torch.clamp_min(torch.sum(w), 1e-12)
    return torch.mean(nll)


def _xent_arange(logits: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Mean CE of (B, C) fp32 logits against the labels offset..offset+B-1."""
    return -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=-1), offset=offset))


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
    ``logit_scale * img @ txt.T`` (+ ``logit_bias``) against the diagonal;
    ``axis_name``/``local_loss`` as the module docstring says."""
    img, txt = image_features.float(), text_features.float()
    scale = logit_scale.float()
    if axis_name is not None and world() > 1:
        all_img, all_txt = gather_rows(img), gather_rows(txt)
        if local_loss:
            off = rank_offset(img.shape[0])
            per_image = (scale * img) @ all_txt.T
            per_text = (scale * txt) @ all_img.T
            if logit_bias is not None:
                per_image, per_text = per_image + logit_bias, per_text + logit_bias
            return 0.5 * (_xent_arange(per_image, off) + _xent_arange(per_text, off))
        img, txt = all_img, all_txt
    logits_per_image = (scale * img) @ txt.T
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
    by the number of images. ``axis_name``: the rank's images against the
    gathered texts, the matched pairs offset by the rank (the ranks' mean
    is the global loss)."""
    img, txt = image_features.float(), text_features.float()
    off = 0
    if axis_name is not None and world() > 1:
        txt, off = gather_rows(txt), rank_offset(img.shape[0])
    logits = (logit_scale.float() * img) @ txt.T + logit_bias.float()
    z = 2.0 * torch.eye(logits.shape[0], logits.shape[1], device=logits.device) - 1.0
    if off:
        z = torch.roll(z, off, dims=1)
    return torch.sum(torch.nn.functional.softplus(-z * logits)) / logits.shape[0]
