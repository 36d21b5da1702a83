"""Native int8 dots of the quantized modes, in PyTorch.

Counterpart of ``mamba_clip_tpu/ops/qdot.py``: the same seven dots, as
``torch.autograd.Function``s over ordinary ops, with the same arithmetic
in the same order, so that on the same inputs both packages make the same
int8 operands and the same int32 accumulators:

- :func:`int8_dense_dot`: the Dense pattern ``lhs[..., K] @ rhs[K, N]``,
  per-tensor scales calibrated on the call, the int8 operands kept for both
  backward dots, the cotangent calibrated once (``--quant int8_fast``);
- :func:`int8_qk_dot` and :func:`int8_pv_dot`: the attention interior's
  ``bqhd,bkhd->bhqk`` and ``bhqk,bkhd->bqhd`` with per-(batch, head) scales
  (``int8_fast_attn``);
- :func:`int8_qk_dot_delayed` and :func:`int8_pv_dot_delayed`: the same
  with the caller's (delayed) per-head scales and the static 1/127 scale
  of the probabilities (``int8_delayed_attn``);
- :func:`int8_serve_dot`: per-tensor lhs and per-output-channel rhs scales;
  its backward works on the dequantized operands in fp32 (``int8_serve``);
- :func:`int8_delayed_dot`: the Dense pattern with the caller's scales
  (``int8_delayed``). Scales get zero gradients.

Gradients are straight-through: quantization is treated as the identity.
Under a data axis of several ranks (``parallel/collectives.py``) a
per-tensor absmax of batch rows (an activation's, a cotangent's) and a
committed delayed scale are the maximum over the ranks, as one process
over the global batch takes them.

Under a model axis (``model``: the axis of a column-parallel kernel,
``parallel/sharding.py``) a Dense dot runs on this rank's columns of the
kernel, ``rhs[K, N / M]``, and keeps JAX's global per-tensor scales, which
XLA turns into cross-device reductions: the kernel's absmax is the max
over the model group; the cotangent's, which holds this rank's rows and
columns, the max over the batch and the model groups; the lhs, whole on
the model peers, keeps its batch-axis max. The lhs gradient contracts over
the split N: each rank's int32 partial sum is all-reduced over the model
group as int32 before it is scaled, the exact sum one process's int32 dot
gives, and the dequantized gradient is whole. ``int8_serve``'s per-column
kernel scales are local; its fp32 backward sums its lhs gradient over the
group. A delayed kernel scale takes the model group's max where it is
stored (``"init"``) or committed.
The rhs of a Dense dot is JAX's ``[K, N]`` kernel, which is the transpose of
``nn.Linear.weight``: a per-column scale there is a per-row scale of the
weight.

The integer products are exact. A 2-D product (the Dense dots, forward and
backward) is ``torch._int_mm``, with int32 accumulation, on both devices
(:func:`int_mm`). A batched attention product is an fp32 ``einsum`` over the
int8 values (:func:`_ei32`): each product of two int8 values is at most
127^2 and every partial sum is an integer, so the fp32 sum is exact while
the contraction is at most 2^24 / 127^2 = 1040 terms; every attention
contraction of the towers is at most 257, and a longer one raises. The
Dense contractions can be far longer (the batch times the tokens in the
backward), beyond the reach of fp32, so they stay on ``_int_mm``. Like the
JAX package, the Dense dots accumulate in int32, which wraps past 2^31.

Delayed scaling (``int8_delayed``, ``int8_delayed_attn``). A module that
keeps delayed scales registers its absmax buffers with
:func:`register_delayed` and reads them through :func:`delayed_amax`,
which also notes the fresh absmax of this call. What happens to it depends
on the module's scale mode, set for a whole model by :func:`scale_mode`:

- None (eval, serving, the no-grad feature bank): the stored scales are
  read and nothing is written;
- ``"init"``: the fresh absmax is stored before it is used, as
  ``model.init`` creates the variable from it (:func:`init_delayed_scales`);
- ``"record"`` (a train step): the stored scales quantize and the first
  fresh absmax of each buffer is kept aside; :func:`commit_scales` writes
  them after the step's backward. A recompute under
  ``torch.utils.checkpoint`` in the backward therefore quantizes with the
  same scales as the forward did, as JAX's remat does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives
from ..parallel.collectives import DataAxis, max_over, sum_over

_EPS = 1e-6
_P_SCALE = 1.0 / 127.0  # static softmax-probability scale (p in [0, 1])
_DENSE_PATTERN = "flax Dense contraction (((lhs.ndim-1,), (0,)), ((), ()))"
# the longest contraction whose fp32 sum of int8 products is exact
F32_EXACT_TERMS = 2**24 // 127**2


# ---------------------------------------------------------------------------
# scales and quantization, in JAX's fp32 arithmetic
# ---------------------------------------------------------------------------


def _over_127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as the JAX package's jitted steps compute it: XLA turns a
    division by a constant into a multiply by the constant's fp32
    reciprocal, which rounds differently from a division."""
    return x * (1.0 / 127.0)


def _absmax_scale(x: torch.Tensor, across: bool = False,
                  model: Optional[DataAxis] = None) -> torch.Tensor:
    """Per-tensor symmetric scale mapping absmax -> 127; ``across``: ``x``
    holds batch rows, so the absmax is the maximum over the data axis's
    ranks (``parallel/collectives.py``); ``model``: ``x`` holds this rank's
    columns, so it is the maximum over the model group too."""
    am = max_over(x.float().abs().amax(), collectives.active() if across else None, model)
    return _over_127(torch.clamp_min(am, _EPS))


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale), half to even, clipped to +-127, as int8."""
    return torch.clamp(torch.round(x.float() / scale), -127.0, 127.0).to(torch.int8)


def _q8_bh(x: torch.Tensor, h_axis: int):
    """Quantize with per-(batch, head) scales; returns (int8, scale) with
    the scale in x's own layout (size 1 on the reduced dims)."""
    axes = tuple(i for i in range(x.ndim) if i not in (0, h_axis))
    s = _over_127(torch.clamp_min(x.float().abs().amax(dim=axes, keepdim=True), _EPS))
    return _quantize(x, s), s


def _flip_bh(s: torch.Tensor) -> torch.Tensor:
    """Swap a 4-D scale between the (b,*,h,*) and (b,h,*,*) layouts."""
    return s.permute(0, 2, 1, 3)


def _absmax_scale_cols(x: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scales for a [K, N] rhs -> [N]."""
    return _over_127(torch.clamp_min(x.float().abs().amax(dim=0), _EPS))


def _fresh_amax(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x.detach().float().abs().amax(), _EPS)


# ---------------------------------------------------------------------------
# exact integer products
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``a8 [M, K] @ b8 [K, N]`` of int8 matrices by
    ``torch._int_mm``. Its CUDA form wants more than 16 rows, K and N
    multiples of 8, a row-major ``a`` and a column-major ``b``: the operands
    are padded with zero rows and columns, which leave every integer sum as
    it is, and laid out so, on both devices."""
    M, K = a8.shape
    N = b8.shape[1]
    Mp, Kp, Np = max(_round_up(M, 8), 24), _round_up(K, 8), _round_up(N, 8)
    a = F.pad(a8, (0, Kp - K, 0, Mp - M)).contiguous()
    b = F.pad(b8.t(), (0, Kp - K, 0, Np - N)).contiguous().t()
    return torch._int_mm(a, b)[:M, :N]


def _dense_acc(ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """``lhs[..., K] x rhs[K, N] -> [..., N]`` in int32."""
    K, N = qr.shape
    return int_mm(ql.reshape(-1, K), qr).reshape(*ql.shape[:-1], N)


def _dense_dlhs_acc(qg: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """``g[..., N] x rhs[K, N] -> [..., K]``, contracting N."""
    K, N = qr.shape
    return int_mm(qg.reshape(-1, N), qr.t()).reshape(*qg.shape[:-1], K)


def _dense_drhs_acc(ql: torch.Tensor, qg: torch.Tensor) -> torch.Tensor:
    """``lhs[..., K] x g[..., N] -> [K, N]``, contracting every leading axis."""
    return int_mm(ql.reshape(-1, ql.shape[-1]).t(), qg.reshape(-1, qg.shape[-1]))


def _ei32(pattern: str, a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """``einsum(pattern)`` of two int8 tensors, exact, as int32: an fp32
    einsum over the int8 values, refused beyond :data:`F32_EXACT_TERMS`
    contracted terms."""
    ins, out = pattern.split("->")
    a_s, _ = ins.split(",")
    terms = math.prod(a8.shape[i] for i, c in enumerate(a_s) if c not in out)
    if terms > F32_EXACT_TERMS:
        raise ValueError(
            f"_ei32({pattern!r}): {terms} contracted terms; an fp32 sum of int8 products "
            f"is exact up to {F32_EXACT_TERMS}")
    return torch.einsum(pattern, a8.float(), b8.float()).to(torch.int32)


def _out_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


# ---------------------------------------------------------------------------
# the Dense dots
# ---------------------------------------------------------------------------


def _dense_bwd(ctx, saved, g):
    """The backward of the per-tensor Dense dots: the cotangent calibrated
    once, both dots on the kept int8 operands; under a model axis the lhs
    gradient's int32 partial sums are summed over the group (module
    docstring). ``saved``: ``ctx``'s saved tensors, unpacked once (a
    checkpointed recompute allows no second unpacking)."""
    ql, sl, qr, sr = saved
    sg = _absmax_scale(g, across=True, model=ctx.model)
    qg = _quantize(g, sg)
    acc = sum_over(_dense_dlhs_acc(qg, qr), ctx.model)
    dlhs = (acc.float() * (sg * sr)).to(ctx.dtypes[0])
    drhs = (_dense_drhs_acc(ql, qg).float() * (sl * sg)).to(ctx.dtypes[1])
    return dlhs, drhs


def _dense_fwd(ctx, lhs, rhs, sl, sr, model):
    ql, qr = _quantize(lhs, sl), _quantize(rhs, sr)
    out = (_dense_acc(ql, qr).float() * (sl * sr)).to(_out_dtype(lhs, rhs))
    ctx.save_for_backward(ql, sl, qr, sr)
    ctx.dtypes = (lhs.dtype, rhs.dtype)
    ctx.model = model
    return out


class _Int8DenseDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, model):
        return _dense_fwd(ctx, lhs, rhs, _absmax_scale(lhs, across=True),
                          _absmax_scale(rhs, model=model), model)

    @staticmethod
    def backward(ctx, g):
        return (*_dense_bwd(ctx, ctx.saved_tensors, g), None)


class _Int8DelayedDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, sl, sr, model):
        return _dense_fwd(ctx, lhs, rhs, sl, sr, model)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        return (*_dense_bwd(ctx, saved, g), torch.zeros_like(saved[1]),
                torch.zeros_like(saved[3]), None)


class _Int8ServeDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, model):
        sl = _absmax_scale(lhs, across=True)
        sr = _absmax_scale_cols(rhs)
        ql, qr = _quantize(lhs, sl), _quantize(rhs, sr)
        out = (_dense_acc(ql, qr).float() * (sl * sr)).to(_out_dtype(lhs, rhs))
        ctx.save_for_backward(ql, sl, qr, sr)
        ctx.dtypes = (lhs.dtype, rhs.dtype)
        ctx.model = model
        return out

    @staticmethod
    def backward(ctx, g):
        # dequantize once; the backward runs as ordinary fp32 dots
        ql, sl, qr, sr = ctx.saved_tensors
        lhs_deq = ql.float() * sl
        rhs_deq = qr.float() * sr
        gf = g.float()
        dlhs = sum_over(torch.matmul(gf, rhs_deq.t()), ctx.model).to(ctx.dtypes[0])
        drhs = torch.matmul(lhs_deq.reshape(-1, lhs_deq.shape[-1]).t(),
                            gf.reshape(-1, gf.shape[-1])).to(ctx.dtypes[1])
        return dlhs, drhs, None


def int8_dense_dot(lhs: torch.Tensor, rhs: torch.Tensor,
                   model: Optional[DataAxis] = None) -> torch.Tensor:
    """int8 dot for the Dense pattern ``lhs[..., K] @ rhs[K, N]``; ``model``:
    ``rhs`` is this rank's columns of a kernel split over that axis."""
    return _Int8DenseDot.apply(lhs, rhs, model)


def int8_delayed_dot(lhs, rhs, sl, sr, model: Optional[DataAxis] = None) -> torch.Tensor:
    """int8 Dense dot with caller-provided (delayed) scales; the backward
    calibrates the cotangent on the call, the scales get zero gradients."""
    return _Int8DelayedDot.apply(lhs, rhs, sl, sr, model)


def int8_serve_dot(lhs: torch.Tensor, rhs: torch.Tensor,
                   model: Optional[DataAxis] = None) -> torch.Tensor:
    """Forward-optimized int8 dot: per-tensor lhs, per-channel rhs scales."""
    return _Int8ServeDot.apply(lhs, rhs, model)


# ---------------------------------------------------------------------------
# the attention interior's dots
# ---------------------------------------------------------------------------


def _scaled(acc, scale, dtype):
    return (acc.float() * scale).to(dtype)


class _Int8QKDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k):
        q8, sq = _q8_bh(q, 2)   # scales (B,1,h,1)
        k8, sk = _q8_bh(k, 2)
        ctx.save_for_backward(q8, sq, k8, sk)
        ctx.dtypes = (q.dtype, k.dtype)
        return _scaled(_ei32("bqhd,bkhd->bhqk", q8, k8), _flip_bh(sq) * _flip_bh(sk),
                       _out_dtype(q, k))

    @staticmethod
    def backward(ctx, g):
        q8, sq, k8, sk = ctx.saved_tensors
        g8, sg = _q8_bh(g, 1)   # g (B,h,T,T), scales (B,h,1,1)
        dq = _scaled(_ei32("bhqk,bkhd->bqhd", g8, k8), _flip_bh(sg) * sk, ctx.dtypes[0])
        dk = _scaled(_ei32("bhqk,bqhd->bkhd", g8, q8), _flip_bh(sg) * sq, ctx.dtypes[1])
        return dq, dk


class _Int8PVDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, v):
        p8, sp = _q8_bh(p, 1)   # scales (B,h,1,1)
        v8, sv = _q8_bh(v, 2)   # scales (B,1,h,1)
        ctx.save_for_backward(p8, sp, v8, sv)
        ctx.dtypes = (p.dtype, v.dtype)
        return _scaled(_ei32("bhqk,bkhd->bqhd", p8, v8), _flip_bh(sp) * sv, _out_dtype(p, v))

    @staticmethod
    def backward(ctx, g):
        p8, sp, v8, sv = ctx.saved_tensors
        g8, sg = _q8_bh(g, 2)   # g (B,T,h,hd), scales (B,1,h,1)
        dp = _scaled(_ei32("bqhd,bkhd->bhqk", g8, v8), _flip_bh(sg) * _flip_bh(sv),
                     ctx.dtypes[0])
        dv = _scaled(_ei32("bhqk,bqhd->bkhd", p8, g8), _flip_bh(sp) * sg, ctx.dtypes[1])
        return dp, dv


class _Int8QKDotDelayed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, sq, sk):
        q8, k8 = _quantize(q, sq), _quantize(k, sk)
        ctx.save_for_backward(q8, sq, k8, sk)
        ctx.dtypes = (q.dtype, k.dtype)
        return _scaled(_ei32("bqhd,bkhd->bhqk", q8, k8), _flip_bh(sq) * _flip_bh(sk),
                       _out_dtype(q, k))

    @staticmethod
    def backward(ctx, g):
        q8, sq, k8, sk = ctx.saved_tensors
        g8, sg = _q8_bh(g, 1)   # dynamic; scales (B,h,1,1)
        dq = _scaled(_ei32("bhqk,bkhd->bqhd", g8, k8), _flip_bh(sg) * sk, ctx.dtypes[0])
        dk = _scaled(_ei32("bhqk,bqhd->bkhd", g8, q8), _flip_bh(sg) * sq, ctx.dtypes[1])
        return dq, dk, torch.zeros_like(sq), torch.zeros_like(sk)


def _quantize_probs(p: torch.Tensor) -> torch.Tensor:
    """Probabilities in [0, 1] on the static scale: round(p * 127)."""
    return torch.clamp(torch.round(p.float() * 127.0), 0.0, 127.0).to(torch.int8)


class _Int8PVDotDelayed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, v, sv):
        p8 = _quantize_probs(p)
        v8 = _quantize(v, sv)
        ctx.save_for_backward(p8, v8, sv)
        ctx.dtypes = (p.dtype, v.dtype)
        return _scaled(_ei32("bhqk,bkhd->bqhd", p8, v8), _P_SCALE * sv, _out_dtype(p, v))

    @staticmethod
    def backward(ctx, g):
        p8, v8, sv = ctx.saved_tensors
        g8, sg = _q8_bh(g, 2)   # dynamic; scales (B,1,h,1)
        dp = _scaled(_ei32("bqhd,bkhd->bhqk", g8, v8), _flip_bh(sg) * _flip_bh(sv),
                     ctx.dtypes[0])
        dv = _scaled(_ei32("bhqk,bqhd->bkhd", p8, g8), _P_SCALE * sg, ctx.dtypes[1])
        return dp, dv, torch.zeros_like(sv)


def int8_qk_dot(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """scores[b,h,q,k] = sum_d q[b,q,h,d] k[b,k,h,d] in int8."""
    return _Int8QKDot.apply(q, k)


def int8_pv_dot(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[b,q,h,d] = sum_k p[b,h,q,k] v[b,k,h,d] in int8."""
    return _Int8PVDot.apply(p, v)


def int8_qk_dot_delayed(q, k, sq, sk) -> torch.Tensor:
    """:func:`int8_qk_dot` with caller-provided (delayed) per-head scales in
    (1,1,h,1) layout; the scales get zero gradients."""
    return _Int8QKDotDelayed.apply(q, k, sq, sk)


def int8_pv_dot_delayed(p, v, sv) -> torch.Tensor:
    """:func:`int8_pv_dot` with the static 1/127 probability scale and the
    caller's (delayed) per-head v scale in (1,1,h,1) layout."""
    return _Int8PVDotDelayed.apply(p, v, sv)


# ---------------------------------------------------------------------------
# delayed scales: state kept by the modules
# ---------------------------------------------------------------------------


def register_delayed(module: nn.Module, **shapes) -> None:
    """Give ``module`` delayed absmax buffers of these names and shapes
    (ones until set)."""
    for name, shape in shapes.items():
        module.register_buffer(name, torch.ones(shape))
    module._delayed_pending = {}
    module._scale_mode = None


def delayed_amax(module: nn.Module, name: str, fresh: torch.Tensor,
                 model: Optional[DataAxis] = None) -> torch.Tensor:
    """The stored absmax ``name`` of ``module`` to quantize with; notes
    ``fresh``, this call's absmax, as the module's scale mode says.
    ``model``: ``fresh`` is a column slice's, whose max over that axis's
    group is stored (at once, or when committed)."""
    buf = getattr(module, name)
    if module._scale_mode == "init":
        with torch.no_grad():
            buf.copy_(max_over(fresh, model))
    elif module._scale_mode == "record":
        module._delayed_pending.setdefault(name, (fresh, model))
    return buf


def delayed_holders(model: nn.Module) -> List[nn.Module]:
    """The modules of ``model`` that keep delayed scales."""
    return [m for m in model.modules() if hasattr(m, "_delayed_pending")]


def delayed_scales(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every delayed-scale buffer of ``model`` by its state-dict key: the
    port's counterpart of the JAX package's ``quant`` collection."""
    out = {}
    for mod_name, mod in model.named_modules():
        if hasattr(mod, "_delayed_pending"):
            for leaf, buf in mod.named_buffers(recurse=False):
                out[f"{mod_name}.{leaf}" if mod_name else leaf] = buf
    return out


@contextlib.contextmanager
def scale_mode(holders: List[nn.Module], mode: Optional[str]):
    """Set the scale mode of ``holders`` (:func:`delayed_holders`) inside
    the block: ``"record"`` keeps each buffer's first fresh absmax aside
    (from a fresh start), ``"init"`` stores it as it comes."""
    for m in holders:
        m._scale_mode = mode
        if mode == "record":
            m._delayed_pending = {}
    try:
        yield
    finally:
        for m in holders:
            m._scale_mode = None


def commit_scales(holders: List[nn.Module]) -> None:
    """Write the fresh absmax that a recording kept aside into the buffers
    (the maximum over the data axis's ranks, and over the model group for a
    column slice's, so that they stay equal and whole)."""
    with torch.no_grad():
        for m in holders:
            for name, (fresh, model) in m._delayed_pending.items():
                getattr(m, name).copy_(max_over(fresh, collectives.active(), model))
            m._delayed_pending = {}


def init_delayed_scales(model: nn.Module, *inputs, **kwargs) -> None:
    """Set every delayed scale of ``model`` from one forward on ``inputs``
    in eval mode, each layer's absmax stored before it quantizes with it,
    as the JAX package's ``model.init`` sets the ``quant`` collection."""
    holders = delayed_holders(model)
    if not holders:
        return
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), scale_mode(holders, "init"):
            model(*inputs, **kwargs)
    finally:
        model.train(was_training)


# ---------------------------------------------------------------------------
# the dot classes the Dense layers take
# ---------------------------------------------------------------------------


def _check_dense_pattern(name: str, lhs, dimension_numbers) -> None:
    (lc, rc), (lb, rb) = dimension_numbers
    if (tuple(lc), tuple(rc), tuple(lb), tuple(rb)) != ((lhs.ndim - 1,), (0,), (), ()):
        raise NotImplementedError(
            f"{name} supports only the {_DENSE_PATTERN}; got {dimension_numbers}")


class _DenseDotGeneral(nn.Module):
    """A Dense layer's injected dot, called with JAX's ``dot_general``
    arguments: ``lhs[..., K]``, ``rhs[K, N]`` (the Linear's weight
    transposed) and the dimension numbers, of which only the Dense pattern
    is taken. Stateless: a child of the Linear with nothing to save."""

    _dot = None  # staticmethod(lhs, rhs, model) -> out; set by subclasses

    def forward(self, lhs, rhs, dimension_numbers, precision=None,
                preferred_element_type=None, model_axis: Optional[DataAxis] = None):
        """``model_axis``: ``rhs`` is this rank's columns of a kernel split
        over that axis (``parallel/sharding.py::column_parallel``)."""
        _check_dense_pattern(type(self).__name__, lhs, dimension_numbers)
        out = type(self)._dot(lhs, rhs, model_axis)
        if preferred_element_type is not None:
            out = out.to(preferred_element_type)
        return out


class Int8FastDotGeneral(_DenseDotGeneral):
    """Shared-calibration int8 training dot (``--quant int8_fast``)."""

    _dot = staticmethod(int8_dense_dot)


class Int8ServeDotGeneral(_DenseDotGeneral):
    """Per-channel-weight int8 serving dot (``--quant int8_serve``)."""

    _dot = staticmethod(int8_serve_dot)


class Int8DelayedDotGeneral(nn.Module):
    """Delayed-scaling int8 training dot (``--quant int8_delayed``): keeps
    the per-tensor absmax of its lhs and rhs (``amax_lhs``, ``amax_rhs``,
    the JAX package's ``quant`` variables of ``Int8DelayedDotGeneral_0``),
    quantizes with the stored ones and notes this call's for the next step
    (module docstring)."""

    def __init__(self):
        super().__init__()
        register_delayed(self, amax_lhs=(), amax_rhs=())

    def forward(self, lhs, rhs, dimension_numbers, precision=None,
                preferred_element_type=None, model_axis: Optional[DataAxis] = None):
        _check_dense_pattern("Int8DelayedDotGeneral", lhs, dimension_numbers)
        amax_l = delayed_amax(self, "amax_lhs", _fresh_amax(lhs))
        amax_r = delayed_amax(self, "amax_rhs", _fresh_amax(rhs), model=model_axis)
        out = int8_delayed_dot(lhs, rhs, _over_127(amax_l), _over_127(amax_r), model_axis)
        if preferred_element_type is not None:
            out = out.to(preferred_element_type)
        return out


def inject(layer: nn.Linear, dot_general_cls) -> nn.Linear:
    """``nn.Dense(dot_general_cls=...)``: the dot as the Linear's child,
    named as Flax names the submodule it makes (``<class>_0``)."""
    if dot_general_cls is not None:
        layer.add_module(f"{dot_general_cls.__name__}_0", dot_general_cls())
    return layer


def injected(layer: nn.Module) -> Optional[nn.Module]:
    """The dot :func:`inject` gave ``layer``, or None."""
    dot = next(iter(layer.children()), None)
    return dot if isinstance(dot, (_DenseDotGeneral, Int8DelayedDotGeneral)) else None
