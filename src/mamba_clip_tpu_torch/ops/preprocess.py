"""On-device image preprocessing, in PyTorch.

Counterpart of ``mamba_clip_tpu/ops/preprocess.py``: uint8 NHWC images in,
a resample on the source's fractional pixel grid (bilinear, nearest or
Catmull-Rom bicubic as separable gathers), normalization, NHWC out in the
compute dtype. The batch is a leading dimension written out where the JAX
version ``vmap``s one image.

- ``eval_preprocess``: the center resize, one grid shared by the batch.
- ``train_preprocess``: RandomResizedCrop (timm semantics) with a crop box
  per image, horizontal flip, per-image ``random`` interpolation and
  random erasing with normal noise. Its random values come from an
  explicit ``torch.Generator`` (:func:`draw_train_params`) and are then
  applied by :func:`apply_train_params`, so a test can feed it the values
  ``jax.random`` drew; the two frameworks draw different streams.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..parallel.collectives import draw_rows

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


# The resamplers take row coords ys and column coords xs either shared by
# the batch, (Oh,) and (Ow,), or per image, (B, Oh) and (B, Ow).


def _take_rows(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) at rows idx -> (B, Oh, W, C)."""
    if idx.ndim == 1:
        return img[:, idx]
    return img[torch.arange(img.shape[0], device=img.device)[:, None], idx]


def _take_cols(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (B, Oh, W, C) at columns idx -> (B, Oh, Ow, C)."""
    if idx.ndim == 1:
        return img[:, :, idx]
    return _take_rows(img.transpose(1, 2), idx).transpose(1, 2)


def _row_w(w):
    return w[..., None, None]      # (Oh, 1, 1) or (B, Oh, 1, 1)


def _col_w(w):
    return w[..., None, :, None]   # (1, Ow, 1) or (B, 1, Ow, 1)


def _separable_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample img (B, H, W, C) at fractional row coords ys and column
    coords xs with bilinear interpolation, as two separable gathers."""
    _, H, W, _ = img.shape
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wy = _row_w(ys - y0.to(ys.dtype))
    rows = _take_rows(img, y0) * (1.0 - wy) + _take_rows(img, y1) * wy  # (B, Oh, W, C)

    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wx = _col_w(xs - x0.to(xs.dtype))
    return _take_cols(rows, x0) * (1.0 - wx) + _take_cols(rows, x1) * wx  # (B, Oh, Ow, C)


def _separable_nearest(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    _, H, W, _ = img.shape
    yi = torch.clamp(torch.round(ys).long(), 0, H - 1)
    xi = torch.clamp(torch.round(xs).long(), 0, W - 1)
    return _take_cols(_take_rows(img, yi), xi)


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
        _take_rows(img, torch.clamp(yf.long() + o, 0, H - 1)) * _row_w(w)
        for o, w in zip((-1, 0, 1, 2), wy)
    )
    xf = torch.floor(xs)
    wx = _cubic_weights(xs - xf)
    return sum(
        _take_cols(rows, torch.clamp(xf.long() + o, 0, W - 1)) * _col_w(w)
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


@dataclass
class TrainDraws:
    """The random values of one ``train_preprocess`` call, per image.

    boxes: (B, 4) float32 crop boxes (y0, x0, h, w) in source pixels;
    flip: (B,) bool; bilinear: (B,) bool, bilinear (else bicubic) under
    interpolation ``random``, else None; erase: (B, 4) float32 erase boxes
    (y0, x0, h, w) in output pixels, erase_on: (B,) bool, and noise
    (B, out, out, 3) float32, all three None when ``re_prob`` is 0.
    """

    boxes: torch.Tensor
    flip: torch.Tensor
    bilinear: Optional[torch.Tensor] = None
    erase: Optional[torch.Tensor] = None
    erase_on: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


def _uniform(u, lo, hi):
    return lo + u * (hi - lo)


def draw_train_params(
    batch: int,
    H: int,
    W: int,
    generator: torch.Generator,
    out_size: int = 224,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    hflip: float = 0.5,
    re_prob: float = 0.0,
    interpolation: str = "bilinear",
) -> TrainDraws:
    """Draw a batch's augmentation from ``generator`` on its device, with
    the distributions of ``_crop_coords`` and ``_erase``: area fraction
    U(scale), log aspect U(log ratio), a box that falls back to the
    centered full square when it does not fit, its corner uniform over the
    room left; erase area U(0.02, 1/3) of the output, log aspect
    U(log 0.3, log 1/0.3). Under a data axis of several ranks each draw is
    the rank's rows of the global batch's draw."""
    dev = generator.device
    f32 = torch.float32

    def rand(shape, dtype=f32, normal=False):
        """``shape`` (batch first) from the generator; under a data axis the
        rank's rows of the global batch's draw."""
        fn = torch.randn if normal else torch.rand
        return draw_rows(batch, lambda n: fn((n,) + shape[1:], generator=generator,
                                             device=dev, dtype=dtype))

    u = rand((batch, 4))
    target_area = H * W * _uniform(u[:, 0], *scale)
    aspect = torch.exp(_uniform(u[:, 1], math.log(ratio[0]), math.log(ratio[1])))
    w = torch.sqrt(target_area * aspect)
    h = torch.sqrt(target_area / aspect)
    ok = (w <= W) & (h <= H)
    side = float(min(H, W))
    w = torch.where(ok, w, side)
    h = torch.where(ok, h, side)
    boxes = torch.stack([u[:, 2] * (H - h), u[:, 3] * (W - w), h, w], dim=1)
    flip = rand((batch,)) < hflip
    draws = TrainDraws(boxes=boxes, flip=flip)
    if interpolation == "random":
        draws.bilinear = rand((batch,)) < 0.5
    if re_prob > 0.0:
        e = rand((batch, 5))
        area = _uniform(e[:, 1], 0.02, 1.0 / 3.0) * out_size * out_size
        asp = torch.exp(_uniform(e[:, 2], math.log(0.3), math.log(1 / 0.3)))
        eh = torch.sqrt(area / asp)
        ew = torch.sqrt(area * asp)
        draws.erase = torch.stack(
            [e[:, 3] * (out_size - eh), e[:, 4] * (out_size - ew), eh, ew], dim=1)
        draws.erase_on = e[:, 0] < re_prob
        draws.noise = rand((batch, out_size, out_size, 3), normal=True)
    return draws


def apply_train_params(
    images_u8: torch.Tensor,
    draws: TrainDraws,
    out_size: int = 224,
    mean: Sequence[float] = OPENAI_MEAN,
    std: Sequence[float] = OPENAI_STD,
    out_dtype: torch.dtype = torch.bfloat16,
    interpolation: str = "bilinear",
) -> torch.Tensor:
    """Crop-resize each image to its box, flip, normalize and erase, as
    ``train_preprocess``'s per-image body does with the given draws."""
    img = images_u8.to(torch.float32) / 255.0
    boxes = draws.boxes.to(torch.float32)
    ar = torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5
    y0, x0, h, w = (boxes[:, i:i + 1] for i in range(4))

    def grid(start, length):
        """start + ar * (length / out) with one rounding, as the fused
        multiply-add XLA makes of it; then - 0.5 in fp32."""
        step = (length / out_size).double()
        return (start.double() + ar.double() * step).float() - 0.5

    ys, xs = grid(y0, h), grid(x0, w)            # (B, out)
    xs = torch.where(draws.flip[:, None], xs.flip(1), xs)
    if interpolation == "random":
        pick = draws.bilinear[:, None, None, None]
        out = torch.where(pick, _separable_bilinear(img, ys, xs),
                          _separable_bicubic(img, ys, xs))
    else:
        out = _resample(img, ys, xs, interpolation)
    out = _normalize(out, mean, std)
    if draws.erase is not None:
        e = draws.erase.to(torch.float32)
        pix = torch.arange(out_size, dtype=torch.float32, device=img.device)
        ey0, ex0, eh, ew = (e[:, i, None, None] for i in range(4))
        yy, xx = pix[None, :, None], pix[None, None, :]
        inside = (yy >= ey0) & (yy < ey0 + eh) & (xx >= ex0) & (xx < ex0 + ew)
        inside = inside & draws.erase_on[:, None, None]
        out = torch.where(inside[..., None], draws.noise.to(out.dtype), out)
    return out.to(out_dtype)


def train_preprocess(
    images_u8: torch.Tensor,
    generator: torch.Generator,
    out_size: int = 224,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    hflip: float = 0.5,
    re_prob: float = 0.0,
    mean: Sequence[float] = OPENAI_MEAN,
    std: Sequence[float] = OPENAI_STD,
    out_dtype: torch.dtype = torch.bfloat16,
    interpolation: str = "bilinear",
) -> torch.Tensor:
    """RandomResizedCrop + flip + normalize (+ random erase) of (B, H, W, 3)
    uint8 images on their own device; returns (B, out_size, out_size, 3) in
    ``out_dtype``. ``generator`` lies on the images' device."""
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4:
        raise ValueError(
            f"expected uint8 (B, H, W, C) images, got {images_u8.dtype} "
            f"{tuple(images_u8.shape)}")
    B, H, W, _ = images_u8.shape
    draws = draw_train_params(B, H, W, generator, out_size, scale, ratio, hflip,
                              re_prob, interpolation)
    return apply_train_params(images_u8, draws, out_size, mean, std, out_dtype,
                              interpolation)
