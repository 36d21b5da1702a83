"""Attention interior of the CLIP towers, in PyTorch and CUDA.

Counterpart of ``mamba_clip_tpu/ops/flash_attn.py``. The interior takes
q, k, v ``[B, T, h, hd]`` (the thirds of the fused qkv projection) and an
optional key mask ``[B, 1, 1, T]`` (True = attend) and returns
``[B, T, h*hd]``:

    s = (q . k^T) * sm_scale, cast to fp32; masked keys: s = -1e9
    p = softmax(s) in fp32, cast to the compute type;  out = p . v

Two implementations:

- :func:`attention_plain`, the einsum interior of the JAX package's
  ``FusedAttention`` (``models/vit.py:122-132``) with ``torch.matmul``, and
  :func:`attention_plain_bwd`, its backward written out step by step;
  ``--attn-impl einsum`` runs the plain interior on every device (under
  autograd), and the two are the references the kernels are held against;
- the hand-written CUDA kernels, which replace the three kernels of JAX's
  Pallas TPU flash attention: :func:`flash_attn_fwd`
  (``csrc/flash_attn_fwd.cu``, ``_flash_attention_kernel``; for training it
  also writes the softmax residuals m and l of every row), and
  :func:`flash_attn_bwd_dkv` and :func:`flash_attn_bwd_dq`
  (``csrc/flash_attn_bwd.cu``, ``_flash_attention_dkv_kernel`` and
  ``_flash_attention_dq_kernel``). Each wrapper launches its kernel or
  raises, and counts its launches.

:func:`flash_attention_interior` is what ``--attn-impl flash`` runs: the
kernels for CUDA tensors, the plain versions for CPU tensors. Where a
gradient is required it goes through :class:`FlashAttnFn`, whose backward
is the two backward kernels (or, on the CPU, the plain backward); under
``no_grad`` it launches the forward alone and writes no residuals. The TPU
wrapper's transposes, its padding of T to 128 and its segment ids are
artifacts of the TPU kernel and are not carried over: the kernels take T
as it is and one mask byte per key.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import cuda_build

__all__ = [
    "FlashAttnFn",
    "attention_plain",
    "attention_plain_bwd",
    "flash_attention_interior",
    "flash_attn_bwd_dkv",
    "flash_attn_bwd_dq",
    "flash_attn_fwd",
    "resolve_attn_flash",
]

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_KERNEL_HEAD_DIMS = (32, 64, 128)
_MASKED = -1e9  # the score of a masked key, as in the JAX einsum interior


def resolve_attn_flash(attn_impl: Optional[str]) -> bool:
    """``--attn-impl`` flag -> ``FusedAttention.flash_interior``.

    Only validates the value. The JAX package also refuses ``flash`` off a
    TPU, because its Pallas kernel has no CPU path; here the CPU path of the
    flash interior is the plain interior, so ``flash`` is accepted on any
    device (a CUDA tensor launches the kernel, a CPU tensor takes the plain
    interior)."""
    if attn_impl in (None, "einsum"):
        return False
    if attn_impl == "flash":
        return True
    raise ValueError(f"--attn-impl must be einsum|flash, got {attn_impl!r}")


def _plain_probs(q, k, pad_mask, sm_scale):
    """The fp32 probabilities ``[B, h, T, T]`` of the plain interior."""
    s = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * sm_scale  # [B,h,T,T]
    s = s.float()
    if pad_mask is not None:
        s = s.masked_fill(~pad_mask, _MASKED)
    return torch.softmax(s, dim=-1)


def attention_plain(q, k, v, pad_mask=None, *, sm_scale: float):
    """The einsum interior: q, k, v ``[B, T, h, hd]`` in the compute type,
    ``pad_mask`` ``[B, 1, 1, T]`` bool (True = attend) or None. Returns
    ``[B, T, h*hd]`` in q's type."""
    B, T, h, hd = q.shape
    p = _plain_probs(q, k, pad_mask, sm_scale).to(q.dtype)
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2).reshape(B, T, h * hd)


def attention_plain_bwd(q, k, v, pad_mask, do, sm_scale: float, o=None):
    """The backward of :func:`attention_plain`, written out: ``do`` is the
    gradient of its result, ``[B, T, h*hd]`` or ``[B, T, h, hd]``; returns
    (dq, dk, dv), each ``[B, T, h, hd]`` in q's type. The scores and the
    probabilities are recomputed; every product rounds to q's type where
    autograd of the plain interior rounds it, and the softmax's backward is
    in fp32. No gradient flows through the constant score of a masked key.
    ``o``: the forward's result as it was kept (any of ``do``'s shapes), for
    ``rowsum(o * do)``; recomputed when None. The flash backward takes that
    sum from the result it kept in the compute type, so it is given here to
    hold the kernels against this function on the same inputs."""
    B, T, h, hd = q.shape
    doh = do.reshape(B, T, h, hd).transpose(1, 2)               # [B,h,T,hd]
    p32 = _plain_probs(q, k, pad_mask, sm_scale)                # [B,h,T,T] fp32
    p = p32.to(q.dtype)
    vh = v.transpose(1, 2)
    oh = torch.matmul(p, vh) if o is None else o.reshape(B, T, h, hd).transpose(1, 2)
    dv = torch.matmul(p.transpose(2, 3), doh)
    dp = torch.matmul(doh, vh.transpose(2, 3)).float()          # [B,h,T,T]
    delta = (oh.float() * doh.float()).sum(-1, keepdim=True)    # rowsum(o * do)
    ds = p32 * (dp - delta)
    if pad_mask is not None:
        ds = ds.masked_fill(~pad_mask, 0.0)
    ds = ds.to(q.dtype) * sm_scale
    dq = torch.matmul(ds, k.transpose(1, 2))
    dk = torch.matmul(ds.transpose(2, 3), q.transpose(1, 2))
    return tuple(t.transpose(1, 2).contiguous() for t in (dq, dk, dv))


def _check_kernel_inputs(fn: str, tensors, key_mask, stats=None):
    """Refuse what the kernels do not take. ``tensors``: name -> q, k, v
    (and do), all ``[B, T, h, hd]`` of one type, float32 or bfloat16, hd in
    (32, 64, 128), 16-byte aligned; ``key_mask``: ``[B, T]`` bool or uint8
    or None; ``stats``: name -> ``[B, h, T]`` float32. Every tensor
    contiguous and on the CUDA device of q. Returns the mask as uint8."""
    q = tensors["q"]
    if q.ndim != 4:
        raise ValueError(f"{fn}: q must be [B, T, h, hd], got {tuple(q.shape)}")
    B, T, h, hd = q.shape
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{fn}: head dim {hd} has no kernel instance; one of {_KERNEL_HEAD_DIMS}")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype for t in tensors.values()):
        raise ValueError(
            f"{fn}: {', '.join(tensors)} must share one type of "
            f"{sorted(map(str, _KERNEL_DTYPES))}, got "
            f"{', '.join(str(t.dtype) for t in tensors.values())}")
    for name, t in tensors.items():
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
    named = dict(tensors)
    for name, t in (stats or {}).items():
        if tuple(t.shape) != (B, h, T) or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be [B, h, T] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        named[name] = t
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, T) or key_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(
                f"{fn}: key_mask must be [B, T] bool or uint8, got "
                f"{tuple(key_mask.shape)} {key_mask.dtype}")
        named["key_mask"] = key_mask
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the CUDA device of q")
        if name in tensors and t.data_ptr() % 16:  # the kernels' 16-byte loads
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
    return None if key_mask is None else key_mask.view(torch.uint8)


def _launch(fn_name: str, library: str, q, pointers, sm_scale: float):
    """Call the C entry point ``<fn_name>_<type>`` of ``csrc/<library>.cu``
    on q's device and current stream: ``pointers`` (tensors or None), the
    ints batch, T, heads and head dim, the float scale, then the stream.
    Raises if the launch is refused."""
    B, T, h, hd = q.shape
    fn = getattr(cuda_build.load(library), f"{fn_name}_{_KERNEL_DTYPES[q.dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in pointers),
                 B, T, h, hd, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")


_launches_lock = threading.Lock()  # the two towers may be served from two threads


def _count(wrapper) -> None:
    with _launches_lock:
        wrapper.launches += 1


def flash_attn_fwd(q, k, v, key_mask=None, *, sm_scale: float, with_residuals: bool = False):
    """Launch the CUDA flash-attention forward on the current stream.

    q, k, v: ``[B, T, h, hd]`` of one type, float32 or bfloat16, with hd in
    (32, 64, 128); ``key_mask``: ``[B, T]`` bool or uint8 (nonzero =
    attend) or None; every tensor contiguous and on one CUDA device, q, k
    and v 16-byte aligned. Returns ``[B, T, h*hd]`` in q's type; with
    ``with_residuals`` (training) also the softmax residuals of every row,
    its max score m and its sum l of ``exp(s - m)``, ``[B, h, T]`` fp32
    each. Counts each launch in ``flash_attn_fwd.launches``.
    """
    mask_u8 = _check_kernel_inputs("flash_attn_fwd", {"q": q, "k": k, "v": v}, key_mask)
    B, T, h, hd = q.shape
    out = torch.empty((B, T, h * hd), dtype=q.dtype, device=q.device)
    m = l = None
    if with_residuals:
        m = torch.empty((B, h, T), dtype=torch.float32, device=q.device)
        l = torch.empty((B, h, T), dtype=torch.float32, device=q.device)
    if out.numel() > 0:
        _launch("flash_attn_fwd", "flash_attn_fwd", q, (q, k, v, mask_u8, out, m, l), sm_scale)
        _count(flash_attn_fwd)
    return (out, m, l) if with_residuals else out


flash_attn_fwd.launches = 0


def flash_attn_bwd_dkv(q, k, v, key_mask, do, m, l, di, *, sm_scale: float):
    """Launch the CUDA dk/dv kernel on the current stream.

    q, k, v, key_mask as :func:`flash_attn_fwd` takes them; ``do``
    ``[B, T, h, hd]`` in q's type, contiguous; m and l the forward's
    residuals and ``di = rowsum(o * do)``, ``[B, h, T]`` fp32 each. Returns
    (dk, dv), ``[B, T, h, hd]`` in q's type. Counts each launch in
    ``flash_attn_bwd_dkv.launches``."""
    mask_u8 = _check_kernel_inputs("flash_attn_bwd_dkv", {"q": q, "k": k, "v": v, "do": do},
                                   key_mask, {"m": m, "l": l, "di": di})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() > 0:
        _launch("flash_attn_bwd_dkv", "flash_attn_bwd", q,
                (q, k, v, mask_u8, do, m, l, di, dk, dv), sm_scale)
        _count(flash_attn_bwd_dkv)
    return dk, dv


flash_attn_bwd_dkv.launches = 0


def flash_attn_bwd_dq(q, k, v, key_mask, do, m, l, di, *, sm_scale: float):
    """Launch the CUDA dq kernel on the current stream; arguments as
    :func:`flash_attn_bwd_dkv`. Returns dq, ``[B, T, h, hd]`` in q's type.
    Counts each launch in ``flash_attn_bwd_dq.launches``."""
    mask_u8 = _check_kernel_inputs("flash_attn_bwd_dq", {"q": q, "k": k, "v": v, "do": do},
                                   key_mask, {"m": m, "l": l, "di": di})
    dq = torch.empty_like(q)
    if dq.numel() > 0:
        _launch("flash_attn_bwd_dq", "flash_attn_bwd", q,
                (q, k, v, mask_u8, do, m, l, di, dq), sm_scale)
        _count(flash_attn_bwd_dq)
    return dq


flash_attn_bwd_dq.launches = 0


class FlashAttnFn(torch.autograd.Function):
    """The differentiable flash interior over contiguous q, k, v
    ``[B, T, h, hd]`` and a key mask ``[B, T]`` (or None): ``impl`` "cuda"
    launches the forward kernel (saving q, k, v, the output and the
    residuals m and l; no ``[B, h, T, T]`` tensor is kept) and in the
    backward the dk/dv and dq kernels; "plain" runs the plain interior and
    the plain backward. ``di = rowsum(o * do)`` is a PyTorch reduction, as
    the JAX package takes it outside its kernels."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale, impl):
        ctx.sm_scale, ctx.impl = sm_scale, impl
        if impl == "cuda":
            out, m, l = flash_attn_fwd(q, k, v, key_mask, sm_scale=sm_scale,
                                       with_residuals=True)
            ctx.save_for_backward(q, k, v, key_mask, out, m, l)
            return out
        ctx.save_for_backward(q, k, v, key_mask)
        return attention_plain(q, k, v, _pad_mask(key_mask), sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, do):
        if ctx.impl != "cuda":
            q, k, v, key_mask = ctx.saved_tensors
            return (*attention_plain_bwd(q, k, v, _pad_mask(key_mask), do, ctx.sm_scale),
                    None, None, None)
        q, k, v, key_mask, out, m, l = ctx.saved_tensors
        B, T, h, hd = q.shape
        do = do.contiguous()  # [B, T, h*hd], as the out projection's backward leaves it
        di = (out.float() * do.float()).view(B, T, h, hd).sum(-1).transpose(1, 2).contiguous()
        do = do.view(B, T, h, hd)
        dk, dv = flash_attn_bwd_dkv(q, k, v, key_mask, do, m, l, di, sm_scale=ctx.sm_scale)
        dq = flash_attn_bwd_dq(q, k, v, key_mask, do, m, l, di, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def _pad_mask(key_mask):
    return None if key_mask is None else key_mask[:, None, None, :]


def flash_attention_interior(q, k, v, pad_mask=None, *, sm_scale: float,
                             impl: Optional[str] = None):
    """The ``--attn-impl flash`` interior, a drop-in for
    :func:`attention_plain` with the same arguments and result.

    ``impl``: ``None`` picks by the device of ``q``: the CUDA kernels for a
    CUDA tensor, the plain versions for a CPU tensor. ``"plain"`` asks for
    the plain versions on any device, ``"cuda"`` for the kernels (which
    raise where they cannot run). Inputs that require grad go through
    :class:`FlashAttnFn`; otherwise the forward alone runs, with no
    residuals."""
    if impl is None:
        if q.device.type == "cpu":
            impl = "plain"
        elif q.device.type == "cuda":
            impl = "cuda"
        else:
            raise ValueError(f"flash_attention_interior: no implementation for device {q.device}")
    if impl not in ("plain", "cuda"):
        raise ValueError(f"unknown attention impl '{impl}'")
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if impl == "plain" and not needs_grad:
        return attention_plain(q, k, v, pad_mask, sm_scale=sm_scale)
    B, T = q.shape[:2]
    key_mask = None if pad_mask is None else pad_mask.reshape(B, T).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if needs_grad:
        return FlashAttnFn.apply(q, k, v, key_mask, sm_scale, impl)
    return flash_attn_fwd(q, k, v, key_mask, sm_scale=sm_scale)
