"""Attention interior of the CLIP towers, in PyTorch and CUDA.

Counterpart of ``mamba_clip_tpu/ops/flash_attn.py``. The interior takes
q, k, v ``[B, T, h, hd]`` (the thirds of the fused qkv projection) and an
optional key mask ``[B, 1, 1, T]`` (True = attend) and returns
``[B, T, h*hd]``:

    s = (q . k^T) * sm_scale, cast to fp32; masked keys: s = -1e9
    p = softmax(s) in fp32, cast to the compute type;  out = p . v

Two implementations:

- :func:`attention_plain`, the einsum interior of the JAX package's
  ``FusedAttention`` (``models/vit.py:122-132``) with ``torch.matmul``;
  ``--attn-impl einsum`` runs it on every device, and it is the reference
  the kernel is held against;
- :func:`flash_attn_fwd`, the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attn_fwd.cu`` (which replaces the forward of JAX's Pallas
  TPU flash attention, ``_flash_attention_kernel``). It launches the kernel
  or raises.

:func:`flash_attention_interior` is what ``--attn-impl flash`` runs: the
kernel for CUDA tensors, the plain interior for CPU tensors. The TPU
wrapper's transposes, its padding of T to 128 and its segment ids are
artifacts of the TPU kernel and are not carried over: the kernel takes T
as it is and one mask byte per key. Only the forward is ported; the
backward kernels (dq, dk/dv) come with the contrastive train step.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import cuda_build

__all__ = [
    "attention_plain",
    "flash_attention_interior",
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


def attention_plain(q, k, v, pad_mask=None, *, sm_scale: float):
    """The einsum interior: q, k, v ``[B, T, h, hd]`` in the compute type,
    ``pad_mask`` ``[B, 1, 1, T]`` bool (True = attend) or None. Returns
    ``[B, T, h*hd]`` in q's type."""
    B, T, h, hd = q.shape
    s = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * sm_scale  # [B,h,T,T]
    s = s.float()
    if pad_mask is not None:
        s = s.masked_fill(~pad_mask, _MASKED)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2).reshape(B, T, h * hd)


def flash_attn_fwd(q, k, v, key_mask=None, *, sm_scale: float):
    """Launch the CUDA flash-attention forward on the current stream.

    q, k, v: ``[B, T, h, hd]`` of one type, float32 or bfloat16, with hd in
    (32, 64, 128); ``key_mask``: ``[B, T]`` bool or uint8 (nonzero =
    attend) or None; every tensor contiguous and on one CUDA device, q, k
    and v 16-byte aligned. Returns ``[B, T, h*hd]`` in q's type. Counts
    each launch in ``flash_attn_fwd.launches``.
    """
    if q.ndim != 4:
        raise ValueError(f"flash_attn_fwd: q must be [B, T, h, hd], got {tuple(q.shape)}")
    B, T, h, hd = q.shape
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attn_fwd: head dim {hd} has no kernel instance; one of {_KERNEL_HEAD_DIMS}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attn_fwd: q, k and v must share one type of "
            f"{sorted(map(str, _KERNEL_DTYPES))}, got {q.dtype}, {k.dtype}, {v.dtype}")
    named = {"q": q, "k": k, "v": v}
    for name in ("k", "v"):
        if named[name].shape != q.shape:
            raise ValueError(f"flash_attn_fwd: {name} has shape {tuple(named[name].shape)}, "
                             f"q {tuple(q.shape)}")
    if key_mask is not None:
        if tuple(key_mask.shape) != (B, T) or key_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(
                f"flash_attn_fwd: key_mask must be [B, T] bool or uint8, got "
                f"{tuple(key_mask.shape)} {key_mask.dtype}")
        named["key_mask"] = key_mask
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"flash_attn_fwd: {name} is not contiguous")
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"flash_attn_fwd: {name} is on {t.device}, expected the CUDA device of q")
        if name != "key_mask" and t.data_ptr() % 16:  # the kernel's 16-byte loads
            raise ValueError(f"flash_attn_fwd: {name} is not 16-byte aligned")
    if key_mask is not None:
        key_mask = key_mask.view(torch.uint8)
    out = torch.empty((B, T, h * hd), dtype=q.dtype, device=q.device)
    if out.numel() > 0:
        fn = _kernel_fn(_KERNEL_DTYPES[q.dtype])
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
                     B, T, h, hd, float(sm_scale), stream)
        if err != 0:
            raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
        with _launches_lock:  # the two towers may be served from two threads
            flash_attn_fwd.launches += 1
    return out


flash_attn_fwd.launches = 0
_launches_lock = threading.Lock()


def _kernel_fn(suffix: str):
    """The C entry point ``flash_attn_fwd_<suffix>``: pointers q, k, v,
    mask and out, the ints batch, T, heads and head dim, the float scale,
    then the stream."""
    fn = getattr(cuda_build.load("flash_attn_fwd"), f"flash_attn_fwd_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_interior(q, k, v, pad_mask=None, *, sm_scale: float,
                             impl: Optional[str] = None):
    """The ``--attn-impl flash`` interior, a drop-in for
    :func:`attention_plain` with the same arguments and result.

    ``impl``: ``None`` picks by the device of ``q``: the CUDA kernel for a
    CUDA tensor, the plain interior for a CPU tensor. ``"plain"`` asks for
    the plain interior on any device, ``"cuda"`` for the kernel (which
    raises where it cannot run)."""
    if impl is None:
        if q.device.type == "cpu":
            impl = "plain"
        elif q.device.type == "cuda":
            impl = "cuda"
        else:
            raise ValueError(f"flash_attention_interior: no implementation for device {q.device}")
    if impl == "plain":
        return attention_plain(q, k, v, pad_mask, sm_scale=sm_scale)
    if impl != "cuda":
        raise ValueError(f"unknown attention impl '{impl}'")
    B, T = q.shape[:2]
    key_mask = None if pad_mask is None else pad_mask.reshape(B, T).contiguous()
    return flash_attn_fwd(q.contiguous(), k.contiguous(), v.contiguous(), key_mask,
                          sm_scale=sm_scale)
