"""On-device eval preprocessing, in PyTorch.

Counterpart of the serving half of ``mamba_clip_tpu/ops/preprocess.py``:
uint8 NHWC images in, a center resize on the source square's fractional
pixel grid (bilinear, nearest or Catmull-Rom bicubic as separable
gathers), normalization, NHWC out in the compute dtype. The batch is a
leading dimension written out where the JAX version ``vmap``s one image.
``train_preprocess`` (random crop, flip, erase) belongs to training and is
not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def _separable_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img (B, H, W, C) at fractional row coords ys (Oh,) and column
    coords xs (Ow,) with bilinear interpolation, as two separable gathers."""
    _, H, W, _ = img.shape
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wy = (ys - y0.to(ys.dtype))[:, None, None]
    rows = img[:, y0] * (1.0 - wy) + img[:, y1] * wy  # (B, Oh, W, C)

    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wx = (xs - x0.to(xs.dtype))[None, :, None]
    return rows[:, :, x0] * (1.0 - wx) + rows[:, :, x1] * wx  # (B, Oh, Ow, C)


def _separable_nearest(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    _, H, W, _ = img.shape
    yi = torch.clamp(torch.round(ys).long(), 0, H - 1)
    xi = torch.clamp(torch.round(xs).long(), 0, W - 1)
    return img[:, yi][:, :, xi]


def _cubic_weights(t: torch.Tensor, a: float = -0.5):
    """4-tap cubic convolution weights at offsets (-1, 0, 1, 2) for
    fractional position t in [0, 1). a=-0.5 is the Catmull-Rom spline PIL
    uses."""
    def k(x):
        ax = torch.abs(x)
        w1 = (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0
        w2 = a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a
        return torch.where(
            ax <= 1.0, w1, torch.where(ax < 2.0, w2, torch.zeros_like(ax)))

    return [k(t + 1.0), k(t), k(t - 1.0), k(t - 2.0)]


def _separable_bicubic(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom bicubic as two separable 4-tap gathers (border replicate)."""
    _, H, W, _ = img.shape
    yf = torch.floor(ys)
    wy = _cubic_weights(ys - yf)
    rows = sum(
        img[:, torch.clamp(yf.long() + o, 0, H - 1)] * w[:, None, None]
        for o, w in zip((-1, 0, 1, 2), wy)
    )
    xf = torch.floor(xs)
    wx = _cubic_weights(xs - xf)
    return sum(
        rows[:, :, torch.clamp(xf.long() + o, 0, W - 1)] * w[None, :, None]
        for o, w in zip((-1, 0, 1, 2), wx)
    )


_RESAMPLERS = {
    "nearest": _separable_nearest,
    "bilinear": _separable_bilinear,
    "bicubic": _separable_bicubic,
}


def _resample(img, ys, xs, interpolation: str):
    """--image-interpolation dispatch ('random' is resolved by the caller)."""
    try:
        return _RESAMPLERS[interpolation](img, ys, xs)
    except KeyError:
        raise ValueError(
            f"unknown interpolation '{interpolation}'; one of "
            f"{sorted(_RESAMPLERS)} or 'random'"
        ) from None


def _normalize(x, mean, std):
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def eval_preprocess(
    images_u8: torch.Tensor,
    out_size: int = 224,
    mean: Sequence[float] = OPENAI_MEAN,
    std: Sequence[float] = OPENAI_STD,
    out_dtype: torch.dtype = torch.bfloat16,
    interpolation: str = "bilinear",
) -> torch.Tensor:
    """Center resize + normalize of (B, H, W, 3) uint8 images on their own
    device; returns (B, out_size, out_size, 3) in ``out_dtype``."""
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4:
        raise ValueError(
            f"expected uint8 (B, H, W, C) images, got {images_u8.dtype} "
            f"{tuple(images_u8.shape)}")
    _, H, W, _ = images_u8.shape
    img = images_u8.to(torch.float32) / 255.0
    side = min(H, W)
    ar = torch.arange(out_size, dtype=torch.float32, device=img.device)
    ys = (H - side) / 2 + (ar + 0.5) * (side / out_size) - 0.5
    xs = (W - side) / 2 + (ar + 0.5) * (side / out_size) - 0.5
    # 'random' resolves to bilinear at eval, as in the JAX package.
    interp = "bilinear" if interpolation == "random" else interpolation
    out = _resample(img, ys, xs, interp)
    return _normalize(out, mean, std).to(out_dtype)
