"""Selective scan (Mamba S6 recurrence), time-major, in PyTorch and CUDA.

Counterpart of ``mamba_clip_tpu/ops/selective_scan.py``. Semantics:

    dt  = softplus(delta + delta_bias)          [if delta_softplus]
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t
    y_t = sum_n C_t[n] * h_t[n]  (+ D * u_t)

per channel with state size N over the sequence length L, in fp32.

Two implementations of the forward:

- :func:`_scan_tm_plain`, a sequential fp32 loop over L (the port of
  ``_scan_tm_xla``), used for tensors on the CPU and as the reference the
  kernel is held against;
- :func:`selective_scan_fwd`, the wrapper of the hand-written CUDA kernel
  ``csrc/selective_scan_fwd.cu`` (which replaces the Pallas ``_fwd_kernel``),
  used for tensors on a CUDA device. It launches the kernel or raises.

The backward kernel belongs to the training path and is not ported yet, so
the CUDA path refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

__all__ = [
    "selective_scan",
    "selective_scan_tm",
    "selective_scan_flops",
    "selective_scan_fwd",
]

_KERNEL = "selective_scan_fwd"
_KERNEL_N = 16  # the kernel keeps one state entry per lane of a half-warp
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), without overflow."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _scan_tm_plain(u, delta, A, Bmat, Cmat, D, bias, softplus):
    """Sequential fp32 recurrence; the same time-major canonical signature
    as ``selective_scan_tm``, with D and bias given."""
    Bsz, G, L, DG = u.shape
    N = A.shape[1]
    f32 = torch.float32
    dt = delta.to(f32) + bias.to(f32).reshape(1, G, 1, DG)
    if softplus:
        dt = _softplus(dt)
    u32 = u.to(f32)
    du = dt * u32
    A_g = A.to(f32).reshape(1, G, DG, N)
    B32 = Bmat.to(f32)
    C32 = Cmat.to(f32)
    h = torch.zeros((Bsz, G, DG, N), dtype=f32, device=u.device)
    y = torch.empty((Bsz, G, L, DG), dtype=f32, device=u.device)
    for t in range(L):
        a = torch.exp(dt[:, :, t, :, None] * A_g)                 # (B,G,DG,N)
        h = a * h + du[:, :, t, :, None] * B32[:, :, t, None, :]
        y[:, :, t] = torch.sum(h * C32[:, :, t, None, :], dim=-1)
    return y + u32 * D.to(f32).reshape(1, G, 1, DG)


def selective_scan_fwd(u, delta, A, Bmat, Cmat, D, bias, softplus: bool):
    """Launch the CUDA forward kernel on the current stream.

    u, delta: (batch, G, L, DG) and Bmat, Cmat: (batch, G, L, 16), all of
    one type, float32 or bfloat16; A: (G*DG, 16), D and bias: (G*DG,) in
    float32; every tensor contiguous and on one CUDA device. Returns y
    (batch, G, L, DG) float32. Counts each launch in
    ``selective_scan_fwd.launches``.
    """
    tensors = {"u": u, "delta": delta, "A": A, "B": Bmat, "C": Cmat, "D": D,
               "delta_bias": bias}
    dev = u.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"selective_scan_fwd: {name} is on {t.device}, expected the "
                f"CUDA device of u ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_fwd: {name} is not contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            "selective_scan_fwd has no backward kernel yet (the training "
            "slice adds it); call it under torch.no_grad/inference_mode")
    if u.ndim != 4:
        raise ValueError(f"selective_scan_fwd: u must be (batch, G, L, DG), got {tuple(u.shape)}")
    Bsz, G, L, DG = u.shape
    N = _KERNEL_N
    want = {"u": (Bsz, G, L, DG), "delta": (Bsz, G, L, DG), "A": (G * DG, N),
            "B": (Bsz, G, L, N), "C": (Bsz, G, L, N), "D": (G * DG,),
            "delta_bias": (G * DG,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(
                f"selective_scan_fwd: {name} has shape "
                f"{tuple(tensors[name].shape)}, expected {shape} (the kernel "
                f"takes state size N={N})")
    if u.dtype not in _KERNEL_DTYPES or any(
            t.dtype != u.dtype for t in (delta, Bmat, Cmat)):
        raise ValueError(
            "selective_scan_fwd: u, delta, B and C must share one type of "
            f"{sorted(map(str, _KERNEL_DTYPES))}, got "
            f"{[str(t.dtype) for t in (u, delta, Bmat, Cmat)]}")
    for name in ("A", "D", "delta_bias"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"selective_scan_fwd: {name} must be float32")
    y = torch.empty((Bsz, G, L, DG), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    fn = _kernel_fn(_KERNEL_DTYPES[u.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), D.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 Bsz, G, L, DG, int(bool(softplus)), stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan_fwd launch failed: cudaError {err}")
    selective_scan_fwd.launches += 1
    return y


selective_scan_fwd.launches = 0


def _kernel_fn(suffix: str):
    lib = cuda_build.load(_KERNEL)
    fn = getattr(lib, f"{_KERNEL}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def selective_scan_tm(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Time-major selective scan.

    Args:
      u, delta: (batch, groups, L, dg) -- dg channels per group.
      A: (groups*dg, N) real decay matrix (typically ``-exp(A_log)``).
      B, C: (batch, groups, L, N) input/output projections (shared per group).
      D: (groups*dg,) skip, optional. delta_bias: (groups*dg,), optional.
      impl: ``None`` picks by the device of ``u``: the CUDA kernel for a
        CUDA tensor, the plain loop for a CPU tensor. ``"plain"`` asks for
        the plain loop on any device (the reference the kernel is held
        against); ``"cuda"`` asks for the kernel.
    Returns:
      y: (batch, groups, L, dg) float32.
    """
    d_total = A.shape[0]
    dev = u.device
    if D is None:
        D = torch.zeros((d_total,), dtype=torch.float32, device=dev)
    if delta_bias is None:
        delta_bias = torch.zeros((d_total,), dtype=torch.float32, device=dev)
    if impl is None:
        if dev.type == "cpu":
            impl = "plain"
        elif dev.type == "cuda":
            impl = "cuda"
        else:
            raise ValueError(f"selective_scan_tm: no implementation for device {dev}")
    if impl == "plain":
        return _scan_tm_plain(u, delta, A, B, C, D, delta_bias, delta_softplus)
    if impl != "cuda":
        raise ValueError(f"unknown selective-scan impl '{impl}'")
    # fp16 has no kernel instance; fp16 -> fp32 is exact and the kernel
    # computes in fp32 regardless (as the JAX package does for Mosaic).
    if u.dtype == torch.float16:
        u, delta, B, C = (t.to(torch.float32) for t in (u, delta, B, C))
    return selective_scan_fwd(
        u.contiguous(), delta.contiguous(), A.float().contiguous(),
        B.contiguous(), C.contiguous(), D.float().contiguous(),
        delta_bias.float().contiguous(), delta_softplus)


def selective_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Channel-major selective scan, the layout of mamba_ssm's
    ``selective_scan_fn``:

      u, delta: (batch, d, L); A: (d, N); B, C: (batch, N, L) or
      (batch, groups, N, L); D: (d,); delta_bias: (d,).

    Returns y: (batch, d, L) float32.
    """
    bsz, d, L = u.shape
    if B.ndim == 3:
        B = B[:, None]
        C = C[:, None]
    G = B.shape[1]
    DG = d // G
    u_tm = u.reshape(bsz, G, DG, L).transpose(2, 3)
    delta_tm = delta.reshape(bsz, G, DG, L).transpose(2, 3)
    y_tm = selective_scan_tm(
        u_tm, delta_tm, A, B.transpose(2, 3), C.transpose(2, 3), D,
        delta_bias, delta_softplus, impl=impl,
    )
    return y_tm.transpose(2, 3).reshape(bsz, d, L)


def selective_scan_flops(
    batch: int, d: int, L: int, N: int, with_D: bool = True, with_backward: bool = False
) -> int:
    """Analytic FLOPs model: 9*B*L*D*N for the fused scan with group B/C,
    +2*B*D*L for the D skip."""
    f = 9 * batch * L * d * N
    if with_D:
        f += 2 * batch * d * L
    if with_backward:
        f *= 3
    return f
