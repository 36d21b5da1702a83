"""The aqt modes' int8 dots (``--quant int8`` and ``--quant int8_fwd``), in PyTorch.

Counterpart of the two configurations that ``mamba_clip_tpu/ops/quant.py``
builds with the ``aqt`` library (``aqt.jax.v2``, 0.9.0) and injects into the
towers' Dense layers as ``AqtDotGeneral``. The port has no aqt: this module
is its numerics, written out for the Dense pattern ``lhs[..., K] @ rhs[K, N]``,
in the same operations and roundings as the JAX package's jitted steps
compute them:

- ``int8`` (``aqt_config.fully_quantized(fwd_bits=8, bwd_bits=8,
  use_stochastic_rounding=False)``): the forward and both backward dots in
  int8 with int32 accumulators. The backward dots take the forward's int8
  operands (``use_fwd_quant``): the cotangent is first multiplied by the
  forward scale of the operand it meets, then both operands of the backward
  dot are calibrated and quantized again on their own contraction axes;
- ``int8_fwd`` (``aqt_config.config_v4(fwd_bits=8, dlhs_bits=None,
  drhs_bits=None)``): the forward in int8, both backward dots unquantized in
  the compute type on the original operands. ``config_v4`` also sets
  stochastic rounding on the backward's lhs, but those quantizers have no
  numerics (bits None) and the layer has no rng (``prng_name=None``), so no
  noise is ever drawn.

One quantization, as aqt's ``AbsMaxCalibration`` and ``IntSymmetric(bits=8,
preserve_zero=True, preserve_max_val=False)`` make it, all in the operand's
own type (fp32, bf16 or fp16):

- the scale is ``absmax / 127.5`` over the contraction axes (an all-zero
  slice takes absmax 1), one per row of the lhs and one per column of the
  rhs. 127.5 is the edge of the last of the 255 buckets. The jitted step
  multiplies by the constant's reciprocal: in fp32 the fp32 ``1/127.5``, in
  fp16 the fp16-rounded one; bf16 computes in fp32 and rounds once;
- ``q = round_half_even(clip(x * reciprocal(scale), -127, 127))``, each of
  the reciprocal and the product rounded to the operand's type (an infinite
  reciprocal is replaced by 1); clipping at 127.5 - 0.5 keeps a value at the
  bound out of a 128th bucket; NaN converts to 0 as XLA converts it;
- the dot accumulates the int8 values in int32 (``qdot.int_mm``); the
  result is cast to the operand type and multiplied by the lhs scale, then
  by the rhs scale, rounding after each.

The gradient passes straight through the clip (``clip_gradient=False``).
Under a data axis of several ranks (``parallel/collectives.py``) the
calibrations that run over the batch rows (the weight-gradient dot's) take
the absmax across the ranks, as one rank over the whole batch does. Under a
model axis (``model``: a column-parallel kernel, ``parallel/sharding.py``)
the dot runs on this rank's columns ``rhs[K, N / M]``: the forward's
scales (per lhs row over K, per rhs column over K) and the weight
gradient's (over the rows) are local, as above; the lhs gradient
contracts over the split N, so its calibrations over N take the max over
the model group, and its int32 partial sums are summed over the group as
int32 before they are dequantized (``int8_fwd``'s unquantized lhs gradient
is summed over the group in the compute type).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import collectives
from ..parallel.collectives import DataAxis, max_over, sum_over
from .qdot import _DenseDotGeneral, int_mm

BOUND = 127.5   # the edge of the last int8 bucket: 2**7 - 0.5
CLIP = 127.0    # BOUND - 0.5: what rounds cannot leave the 255 buckets


def _inv_bound(dtype: torch.dtype) -> float:
    """``1/127.5`` as the jitted step multiplies by it: rounded to fp16 for
    fp16 operands, the fp32 constant otherwise."""
    c = torch.tensor(1.0 / BOUND, dtype=torch.float32)
    if dtype == torch.float16:
        c = c.to(torch.float16)
    return float(c)


def calibrate(x: torch.Tensor, dims, across: bool = False,
              model: Optional[DataAxis] = None) -> torch.Tensor:
    """The scale of ``x`` over ``dims`` (kept as size 1), in x's type.
    ``across``: the dims hold batch rows, so the absmax is taken over the
    data axis's ranks too; ``model``: they hold this rank's columns of a
    dim split over that axis, so over its group too."""
    am = max_over(x.abs().amax(dim=dims, keepdim=True),
                  collectives.active() if across else None, model)
    am = torch.where(am == 0, torch.ones_like(am), am)
    return (am.float() * _inv_bound(x.dtype)).to(x.dtype)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values of ``x`` on ``scale`` (broadcast), in x's type until the
    cast."""
    inv = torch.reciprocal(scale)
    inv = torch.where(torch.isinf(inv), torch.ones_like(inv), inv)
    v = torch.round(torch.clamp(x * inv, -CLIP, CLIP))
    return torch.where(torch.isnan(v), torch.zeros_like(v), v).to(torch.int8)


def dequantize(acc: torch.Tensor, s_lhs: torch.Tensor, s_rhs: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``acc`` (int32) in ``dtype`` times the lhs scale, then the rhs scale."""
    return acc.to(dtype) * s_lhs.to(dtype) * s_rhs.to(dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def fwd_dot(lhs: torch.Tensor, rhs: torch.Tensor):
    """The forward dot: (out, ql, sl, qr, sr); ``sl`` (..., 1) a scale a
    row of ``lhs``, ``sr`` (1, N) one a column of ``rhs``."""
    sl = calibrate(lhs, (-1,))
    sr = calibrate(rhs, (0,))
    ql, qr = quantize(lhs, sl), quantize(rhs, sr)
    acc = int_mm(_rows(ql), qr).reshape(*ql.shape[:-1], qr.shape[1])
    return dequantize(acc, sl, sr, lhs.dtype), ql, sl, qr, sr


def dlhs_dot(g: torch.Tensor, qr: torch.Tensor, sr: torch.Tensor,
             model: Optional[DataAxis] = None):
    """``--quant int8``'s lhs gradient ``g[..., N] . rhs[K, N]``: the
    cotangent times the forward's rhs scale, against the forward's int8
    rhs, both calibrated again over N (over the model group too, and the
    int32 sums summed over it, where N is split: module docstring).
    Returns (dlhs, qg, acc)."""
    g1 = g * sr.to(g.dtype)
    r = qr.to(g.dtype)
    sg = calibrate(g1, (-1,), model=model)
    srr = calibrate(r, (1,), model=model)          # (K, 1)
    qg, qrr = quantize(g1, sg), quantize(r, srr)
    acc = sum_over(int_mm(_rows(qg), qrr.t()), model).reshape(*qg.shape[:-1], qrr.shape[0])
    return dequantize(acc, sg, srr.reshape(-1), g.dtype), qg, acc


def drhs_dot(g: torch.Tensor, ql: torch.Tensor, sl: torch.Tensor):
    """``--quant int8``'s rhs gradient ``g[..., N] . lhs[..., K]`` over the
    rows: the cotangent times the forward's lhs scale, against the
    forward's int8 lhs, both calibrated again over the rows (and the data
    axis's ranks). Returns (drhs [K, N], qg, acc [N, K])."""
    g1 = g * sl.to(g.dtype)
    r = ql.to(g.dtype)
    rows = tuple(range(g.ndim - 1))
    sg = calibrate(g1, rows, across=True)          # (1, ..., N)
    srl = calibrate(r, rows, across=True)          # (1, ..., K)
    qg, qrl = quantize(g1, sg), quantize(r, srl)
    acc = int_mm(_rows(qg).t(), _rows(qrl))        # (N, K)
    out = dequantize(acc, sg.reshape(-1, 1), srl.reshape(-1), g.dtype)
    return out.t(), qg, acc


class _AqtInt8Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, model):
        out, ql, sl, qr, sr = fwd_dot(lhs, rhs)
        ctx.save_for_backward(ql, sl, qr, sr)
        ctx.model = model
        return out

    @staticmethod
    def backward(ctx, g):
        ql, sl, qr, sr = ctx.saved_tensors
        return dlhs_dot(g, qr, sr, ctx.model)[0], drhs_dot(g, ql, sl)[0], None


class _AqtInt8FwdDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, model):
        ctx.save_for_backward(lhs, rhs)
        ctx.model = model
        return fwd_dot(lhs, rhs)[0]

    @staticmethod
    def backward(ctx, g):
        lhs, rhs = ctx.saved_tensors
        dlhs = sum_over(torch.matmul(g, rhs.t()), ctx.model)
        drhs = torch.matmul(_rows(lhs).t(), _rows(g))
        return dlhs, drhs, None


def aqt_int8_dot(lhs: torch.Tensor, rhs: torch.Tensor,
                 model: Optional[DataAxis] = None) -> torch.Tensor:
    """``--quant int8``: int8 forward and backward dots; ``model``: ``rhs``
    is this rank's columns of a kernel split over that axis."""
    return _AqtInt8Dot.apply(lhs, rhs, model)


def aqt_int8_fwd_dot(lhs: torch.Tensor, rhs: torch.Tensor,
                     model: Optional[DataAxis] = None) -> torch.Tensor:
    """``--quant int8_fwd``: an int8 forward, an unquantized backward."""
    return _AqtInt8FwdDot.apply(lhs, rhs, model)


class AqtInt8DotGeneral(_DenseDotGeneral):
    """``--quant int8``: the Dense layers' dot (JAX: ``AqtDotGeneral`` over
    ``fully_quantized``). Stateless: in training mode aqt keeps no
    variables."""

    _dot = staticmethod(aqt_int8_dot)


class AqtInt8FwdDotGeneral(_DenseDotGeneral):
    """``--quant int8_fwd``: the Dense layers' dot (JAX: ``AqtDotGeneral``
    over ``config_v4(dlhs_bits=None, drhs_bits=None)``)."""

    _dot = staticmethod(aqt_int8_fwd_dot)
