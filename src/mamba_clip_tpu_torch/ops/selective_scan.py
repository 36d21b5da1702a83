"""Selective scan (Mamba S6 recurrence), time-major, in PyTorch and CUDA.

Counterpart of ``mamba_clip_tpu/ops/selective_scan.py``. Semantics:

    dt  = softplus(delta + delta_bias)          [if delta_softplus]
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t
    y_t = sum_n C_t[n] * h_t[n]  (+ D * u_t)

per channel with state size N over the sequence length L, in fp32.

Two implementations of each direction:

- :func:`_scan_tm_plain` and :func:`_scan_tm_plain_bwd`, sequential fp32
  loops over L (the forward is the port of ``_scan_tm_xla``), used for
  tensors on the CPU and as the references the kernels are held against;
- :func:`selective_scan_fwd` and :func:`selective_scan_bwd`, the wrappers
  of the hand-written CUDA kernels ``csrc/selective_scan_fwd.cu`` and
  ``csrc/selective_scan_bwd.cu`` (which replace the Pallas ``_fwd_kernel``
  and ``_bwd_kernel``), used for tensors on a CUDA device. Each launches its
  kernel or raises.

Where an input requires grad, :func:`selective_scan_tm` goes through
:class:`SelectiveScanFn`: its forward also writes the chunk-entry states
``hck`` (the state before every ``CHUNK``-th step), and its backward walks
the chunks in reverse, recomputing the state inside each chunk from them.
Under ``torch.no_grad``/``inference_mode`` no ``hck`` is written.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

__all__ = [
    "BLOCK_CHANNELS",
    "CHUNK",
    "SelectiveScanFn",
    "selective_scan",
    "selective_scan_tm",
    "selective_scan_flops",
    "selective_scan_fwd",
    "selective_scan_bwd",
]

_KERNEL_N = 16  # the kernels' state size: 4 lanes a channel, 4 entries a lane
_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# T: the steps between two saved chunk-entry states. The kernels stage B and
# C 16 steps at a time; the backward keeps a chunk's h_t in registers.
CHUNK = 16
# Channels a kernel block owns: the backward leaves dB and dC as one partial
# sum per block of a group, ceil(DG / BLOCK_CHANNELS) of them.
BLOCK_CHANNELS = 64


def _n_chunks(L: int) -> int:
    return -(-L // CHUNK)


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), without overflow."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _scan_tm_plain(u, delta, A, Bmat, Cmat, D, bias, softplus, return_hck=False):
    """Sequential fp32 recurrence; the same time-major canonical signature
    as ``selective_scan_tm``, with D and bias given. With ``return_hck``
    it returns ``(y, hck)``: hck (batch, G, ceil(L/CHUNK), DG, N) fp32
    holds the state before step ``c*CHUNK`` of every chunk c, the layout
    the CUDA forward writes."""
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
    hck = (torch.empty((Bsz, G, _n_chunks(L), DG, N), dtype=f32, device=u.device)
           if return_hck else None)
    for t in range(L):
        if hck is not None and t % CHUNK == 0:
            hck[:, :, t // CHUNK] = h
        a = torch.exp(dt[:, :, t, :, None] * A_g)                 # (B,G,DG,N)
        h = a * h + du[:, :, t, :, None] * B32[:, :, t, None, :]
        y[:, :, t] = torch.sum(h * C32[:, :, t, None, :], dim=-1)
    y = y + u32 * D.to(f32).reshape(1, G, 1, DG)
    return (y, hck) if return_hck else y


def _scan_tm_plain_bwd(u, delta, A, Bmat, Cmat, D, bias, softplus, dy, hck):
    """The reverse walk of ``_bwd_kernel`` as a loop over L: per chunk, from
    last to first, recompute h from ``hck``, then run
    ``g_t = C_t dy_t + a_{t+1} g_{t+1}``. Returns the fp32 gradients
    (du, ddelta, dA, dB, dC, dD, dbias) in the primal shapes."""
    Bsz, G, L, DG = u.shape
    N = A.shape[1]
    f32 = torch.float32
    dev = u.device
    raw = delta.to(f32) + bias.to(f32).reshape(1, G, 1, DG)
    dt = _softplus(raw) if softplus else raw
    u32 = u.to(f32)
    du_ = dt * u32
    A_g = A.to(f32).reshape(1, G, DG, N)
    B32 = Bmat.to(f32)
    C32 = Cmat.to(f32)
    dy32 = dy.to(f32)
    dah = torch.empty((Bsz, G, L, DG), dtype=f32, device=dev)   # sum_n g h a A
    ddu = torch.empty((Bsz, G, L, DG), dtype=f32, device=dev)   # sum_n g B
    dB = torch.empty((Bsz, G, L, N), dtype=f32, device=dev)
    dC = torch.empty((Bsz, G, L, N), dtype=f32, device=dev)
    dA = torch.zeros((Bsz, G, DG, N), dtype=f32, device=dev)
    g_next = torch.zeros((Bsz, G, DG, N), dtype=f32, device=dev)  # a_{t+1} g_{t+1}
    for c in reversed(range(_n_chunks(L))):
        t0, t1 = c * CHUNK, min(L, (c + 1) * CHUNK)
        hs = [hck[:, :, c]]  # hs[i]: the state before step t0 + i
        avals = []
        for t in range(t0, t1):
            a = torch.exp(dt[:, :, t, :, None] * A_g)
            hs.append(a * hs[-1] + du_[:, :, t, :, None] * B32[:, :, t, None, :])
            avals.append(a)
        for i in reversed(range(t1 - t0)):
            t = t0 + i
            g = C32[:, :, t, None, :] * dy32[:, :, t, :, None] + g_next
            g_next = avals[i] * g
            dC[:, :, t] = torch.sum(dy32[:, :, t, :, None] * hs[i + 1], dim=2)
            dB[:, :, t] = torch.sum(g * du_[:, :, t, :, None], dim=2)
            ddu[:, :, t] = torch.sum(g * B32[:, :, t, None, :], dim=-1)
            da = g * hs[i] * avals[i]
            dah[:, :, t] = torch.sum(da * A_g, dim=-1)
            dA += da * dt[:, :, t, :, None]
    ddelta = dah + ddu * u32
    if softplus:
        ddelta = ddelta * torch.sigmoid(raw)
    du = ddu * dt + dy32 * D.to(f32).reshape(1, G, 1, DG)
    dD = torch.sum(dy32 * u32, dim=(0, 2)).reshape(G * DG)
    dbias = torch.sum(ddelta, dim=(0, 2)).reshape(G * DG)
    return du, ddelta, dA.sum(0).reshape(G * DG, N), dB, dC, dD, dbias


def _check_kernel_inputs(who, tensors, dev):
    """Device, contiguity, shape and type checks shared by both wrappers;
    ``tensors`` maps name -> (tensor, expected shape)."""
    for name, (t, _) in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{who}: {name} is on {t.device}, expected the CUDA device of u ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{who}: {name} has shape {tuple(t.shape)}, expected {shape} (the "
                f"kernel takes state size N={_KERNEL_N})")
    u = tensors["u"][0]
    if u.dtype not in _KERNEL_DTYPES or any(
            tensors[k][0].dtype != u.dtype for k in ("delta", "B", "C")):
        raise ValueError(
            f"{who}: u, delta, B and C must share one type of "
            f"{sorted(map(str, _KERNEL_DTYPES))}, got "
            f"{[str(tensors[k][0].dtype) for k in ('u', 'delta', 'B', 'C')]}")
    for name in ("A", "D", "delta_bias", "dy", "hck"):
        if name in tensors and tensors[name][0].dtype != torch.float32:
            raise ValueError(f"{who}: {name} must be float32")
    for name in ("B", "C", "hck"):  # read by 16-byte copies
        if name in tensors and tensors[name][0].data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (a view
    at an odd offset): the kernels stage B and C by 16-byte copies."""
    return t.clone() if t.data_ptr() % 16 else t


def _scan_shapes(u):
    if u.ndim != 4:
        raise ValueError(f"selective scan: u must be (batch, G, L, DG), got {tuple(u.shape)}")
    Bsz, G, L, DG = u.shape
    N = _KERNEL_N
    return {"u": (Bsz, G, L, DG), "delta": (Bsz, G, L, DG), "A": (G * DG, N),
            "B": (Bsz, G, L, N), "C": (Bsz, G, L, N), "D": (G * DG,),
            "delta_bias": (G * DG,)}


def selective_scan_fwd(u, delta, A, Bmat, Cmat, D, bias, softplus: bool,
                       with_hck: bool = False):
    """Launch the CUDA forward kernel on the current stream.

    u, delta: (batch, G, L, DG) and Bmat, Cmat: (batch, G, L, 16), all of
    one type, float32 or bfloat16; A: (G*DG, 16), D and bias: (G*DG,) in
    float32; every tensor contiguous and on one CUDA device. Returns y
    (batch, G, L, DG) float32, and with ``with_hck`` also the chunk-entry
    states hck (batch, G, ceil(L/CHUNK), DG, 16) float32. Counts each
    launch in ``selective_scan_fwd.launches``.
    """
    shapes = _scan_shapes(u)
    args = (u, delta, A, Bmat, Cmat, D, bias)
    _check_kernel_inputs("selective_scan_fwd",
                         {k: (t, shapes[k]) for k, t in zip(shapes, args)}, u.device)
    Bsz, G, L, DG = u.shape
    y = torch.empty((Bsz, G, L, DG), dtype=torch.float32, device=u.device)
    hck = (torch.empty((Bsz, G, _n_chunks(L), DG, _KERNEL_N), dtype=torch.float32,
                       device=u.device) if with_hck else None)
    if y.numel() > 0:
        fn = _kernel_fn("selective_scan_fwd", _KERNEL_DTYPES[u.dtype], 9)
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = fn(*(t.data_ptr() for t in args), y.data_ptr(),
                     None if hck is None else hck.data_ptr(),
                     Bsz, G, L, DG, int(bool(softplus)), stream)
        if err != 0:
            raise RuntimeError(f"selective_scan_fwd launch failed: cudaError {err}")
        selective_scan_fwd.launches += 1
    return (y, hck) if with_hck else y


selective_scan_fwd.launches = 0


def selective_scan_bwd(u, delta, A, Bmat, Cmat, D, bias, softplus: bool, dy, hck):
    """Launch the CUDA backward kernel on the current stream.

    Takes the forward's inputs (as :func:`selective_scan_fwd` takes them),
    dy (batch, G, L, DG) float32 and the forward's hck, all contiguous on
    one CUDA device. Returns the float32 gradients (du, ddelta, dA, dB, dC,
    dD, dbias) in the primal shapes: the kernel's dB/dC partials (one per
    block of ``BLOCK_CHANNELS`` channels) and per-sample dA/dD/dbias are
    summed here with ``torch.sum``. Counts each launch in
    ``selective_scan_bwd.launches``.
    """
    shapes = _scan_shapes(u)
    Bsz, G, L, DG = u.shape
    N = _KERNEL_N
    shapes.update(dy=(Bsz, G, L, DG), hck=(Bsz, G, _n_chunks(L), DG, N))
    args = (u, delta, A, Bmat, Cmat, D, bias, dy, hck)
    _check_kernel_inputs("selective_scan_bwd",
                         {k: (t, shapes[k]) for k, t in zip(shapes, args)}, u.device)
    f32, dev = torch.float32, u.device
    n_tiles = -(-DG // BLOCK_CHANNELS)
    ddelta = torch.empty((Bsz, G, L, DG), dtype=f32, device=dev)
    du = torch.empty((Bsz, G, L, DG), dtype=f32, device=dev)
    dB_part = torch.empty((n_tiles, Bsz, G, L, N), dtype=f32, device=dev)
    dC_part = torch.empty((n_tiles, Bsz, G, L, N), dtype=f32, device=dev)
    dA_part = torch.empty((Bsz, G * DG, N), dtype=f32, device=dev)
    dD_part = torch.empty((Bsz, G * DG), dtype=f32, device=dev)
    dbias_part = torch.empty((Bsz, G * DG), dtype=f32, device=dev)
    outs = (ddelta, du, dB_part, dC_part, dA_part, dD_part, dbias_part)
    if du.numel() == 0:
        for t in outs:
            t.zero_()
    else:
        fn = _kernel_fn("selective_scan_bwd", _KERNEL_DTYPES[u.dtype], 16)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in args + outs),
                     Bsz, G, L, DG, int(bool(softplus)), stream)
        if err != 0:
            raise RuntimeError(f"selective_scan_bwd launch failed: cudaError {err}")
        selective_scan_bwd.launches += 1
    return (du, ddelta, dA_part.sum(0), dB_part.sum(0), dC_part.sum(0),
            dD_part.sum(0), dbias_part.sum(0))


selective_scan_bwd.launches = 0


def _kernel_fn(kernel: str, suffix: str, n_ptrs: int):
    """The C entry point ``<kernel>_<suffix>``: ``n_ptrs`` pointers, the
    ints batch, G, L, DG and softplus, then the stream."""
    fn = getattr(cuda_build.load(kernel), f"{kernel}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class SelectiveScanFn(torch.autograd.Function):
    """The differentiable scan: ``impl`` "cuda" launches both kernels,
    "plain" runs both loops. The forward saves its inputs and hck; the
    backward returns the 7 gradients in the inputs' own types, as
    ``_scan_tm_pallas_bwd`` casts them back to the primal dtypes."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, D, bias, softplus, impl):
        if impl == "cuda":
            y, hck = selective_scan_fwd(u, delta, A, Bmat, Cmat, D, bias, softplus,
                                        with_hck=True)
        else:
            y, hck = _scan_tm_plain(u, delta, A, Bmat, Cmat, D, bias, softplus,
                                    return_hck=True)
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, D, bias, hck)
        ctx.softplus, ctx.impl = softplus, impl
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, Bmat, Cmat, D, bias, hck = ctx.saved_tensors
        dy = dy.to(torch.float32).contiguous()
        bwd = selective_scan_bwd if ctx.impl == "cuda" else _scan_tm_plain_bwd
        grads = bwd(u, delta, A, Bmat, Cmat, D, bias, ctx.softplus, dy, hck)
        prim = (u, delta, A, Bmat, Cmat, D, bias)
        return (*(g.to(p.dtype) for g, p in zip(grads, prim)), None, None)


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
      impl: ``None`` picks by the device of ``u``: the CUDA kernels for a
        CUDA tensor, the plain loops for a CPU tensor. ``"plain"`` asks for
        the plain loops on any device (the references the kernels are held
        against); ``"cuda"`` asks for the kernels. Inputs that require
        grad go through :class:`SelectiveScanFn`.
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
    if impl not in ("plain", "cuda"):
        raise ValueError(f"unknown selective-scan impl '{impl}'")
    args = (u, delta, A, B, C, D, delta_bias)
    if impl == "cuda":
        # fp16 has no kernel instance; fp16 -> fp32 is exact and the kernel
        # computes in fp32 regardless (as the JAX package does for Mosaic).
        # The casts and copies are differentiable, so the gradients reach
        # the caller's tensors in their own types.
        if u.dtype == torch.float16:
            u, delta, B, C = (t.to(torch.float32) for t in (u, delta, B, C))
        args = (u.contiguous(), delta.contiguous(), A.float().contiguous(),
                _aligned(B.contiguous()), _aligned(C.contiguous()), D.float().contiguous(),
                delta_bias.float().contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SelectiveScanFn.apply(*args, delta_softplus, impl)
    if impl == "plain":
        return _scan_tm_plain(*args, delta_softplus)
    return selective_scan_fwd(*args, delta_softplus)


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
