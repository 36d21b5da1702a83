"""The port's differentiable scan against the JAX package's scan gradients.

``SelectiveScanFn`` with ``impl="plain"`` (the plain forward, which saves
the chunk-entry states ``hck``, and the plain backward, which walks the
chunks in reverse from them) is held against three references of all 7
gradients (du, ddelta, dA, dB, dC, dD, dbias) of ``sum(sin(y))``:
``jax.grad`` of ``selective_scan_tm(impl="pallas_interpret")`` (the Pallas
backward kernel in interpret mode), ``jax.grad`` with ``impl="xla"`` (the
lax.scan reference), and torch autograd through ``_scan_tm_plain``.

Tolerance, as in tests/test_selective_scan.py::test_pallas_gradients_match_scan:
each gradient divided by the reference's max |g| agrees within atol 1e-4.
Gradients of bf16 inputs come back in bf16 on both sides, each the
rounding of an fp32 gradient; two fp32 values a few ulps apart can round
to neighbouring bf16 values, so those also get rtol 2^-7, one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.ops.selective_scan import selective_scan_tm as jax_scan
from mamba_clip_tpu_torch.ops.selective_scan import (
    CHUNK,
    SelectiveScanFn,
    _scan_tm_plain,
    _scan_tm_plain_bwd,
    selective_scan_bwd,
    selective_scan_fwd,
    selective_scan_tm,
)

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
ATOL = 1e-4
RTOL_BF16 = 2.0**-7


def _inputs(seed, L, DG, softplus, Bsz=2, G=4, N=16):
    """Without softplus the step size delta + bias is drawn positive, as a
    raw step size is (a negative one grows the state without bound)."""
    rs = np.random.RandomState(seed)
    f = np.float32
    u = rs.randn(Bsz, G, L, DG).astype(f)
    delta = (rs.randn(Bsz, G, L, DG) * 0.5).astype(f)
    bias = (rs.randn(G * DG) * 0.1).astype(f)
    if not softplus:
        delta, bias = np.abs(delta), np.abs(bias)
    A = -np.exp(rs.randn(G * DG, N) * 0.5).astype(f)
    B = rs.randn(Bsz, G, L, N).astype(f)
    C = rs.randn(Bsz, G, L, N).astype(f)
    D = rs.randn(G * DG).astype(f)
    return u, delta, A, B, C, D, bias


def _jax_grads(args, softplus, impl, bf16):
    jargs = [jnp.asarray(x) for x in args]
    if bf16:
        jargs = [x.astype(jnp.bfloat16) if i in (0, 1, 3, 4) else x
                 for i, x in enumerate(jargs)]

    def loss(*a):
        return jnp.sum(jnp.sin(jax_scan(*a, softplus, impl=impl)))

    # jitted: one compile runs the gradient 2-5 times faster than op by op
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*jargs)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_grads(fn, args, bf16):
    targs = [torch.from_numpy(x) for x in args]
    if bf16:
        targs = [t.to(torch.bfloat16) if i in (0, 1, 3, 4) else t for i, t in enumerate(targs)]
    targs = [t.requires_grad_() for t in targs]
    torch.sin(fn(*targs)).sum().backward()
    for t, g in zip(targs, (t.grad for t in targs)):
        assert g.dtype == t.dtype
    return [t.grad.float().numpy() for t in targs]


def _check(got, want, bf16, label):
    for i, (name, g, w) in enumerate(zip(NAMES, got, want)):
        scale = float(np.max(np.abs(w))) + 1e-9
        rtol = RTOL_BF16 if bf16 and i in (0, 1, 3, 4) else 0.0
        np.testing.assert_allclose(g / scale, w / scale, atol=ATOL, rtol=rtol,
                                   err_msg=f"{label}: {name}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("L,DG", [(49, 24), (49, 64), (300, 24), (300, 64)])
def test_scan_grads_match_jax_and_autograd(dtype, softplus, L, DG):
    bf16 = dtype == "bf16"
    args = _inputs(L * 7 + DG + softplus, L, DG, softplus)
    if bf16:  # both sides see the same bf16 values
        args = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                if i in (0, 1, 3, 4) else x for i, x in enumerate(args)]
    got = _torch_grads(
        lambda *a: SelectiveScanFn.apply(*a, softplus, "plain"), args, bf16)
    for impl in ("pallas_interpret", "xla"):
        _check(got, _jax_grads(args, softplus, impl, bf16), bf16, impl)
    want = _torch_grads(lambda *a: _scan_tm_plain(*a, softplus), args, bf16)
    _check(got, want, bf16, "autograd through _scan_tm_plain")
    assert selective_scan_fwd.launches == 0 and selective_scan_bwd.launches == 0


def test_selective_scan_tm_routes_grads_through_the_function():
    """Inputs that require grad take ``SelectiveScanFn`` (the NotImplemented
    refusal of the forward-only port is gone); under ``no_grad`` the plain
    forward runs without saving anything."""
    args = [torch.from_numpy(x) for x in _inputs(3, 20, 8, True)]
    with torch.no_grad():
        y0 = selective_scan_tm(*args, True)
    assert y0.grad_fn is None
    targs = [t.clone().requires_grad_() for t in args]
    y = selective_scan_tm(*targs, True)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    torch.testing.assert_close(y.detach(), y0, rtol=0, atol=0)
    y.sum().backward()
    assert all(t.grad is not None for t in targs)
    assert selective_scan_fwd.launches == 0 and selective_scan_bwd.launches == 0


@pytest.mark.parametrize("L", [16, 49, 300])
def test_hck_is_the_state_at_chunk_starts(L):
    """``hck[:, :, c]`` is the plain loop's state before step c*CHUNK (zero
    for c = 0), in the (batch, G, chunk, DG, N) layout of the CUDA forward,
    and the forward's y does not change when it is asked for."""
    u, delta, A, B, C, D, bias = (torch.from_numpy(x) for x in _inputs(L, L, 8, True))
    y, hck = _scan_tm_plain(u, delta, A, B, C, D, bias, True, return_hck=True)
    Bsz, G, _, DG = u.shape
    N = A.shape[1]
    assert hck.shape == (Bsz, G, -(-L // CHUNK), DG, N)
    torch.testing.assert_close(y, _scan_tm_plain(u, delta, A, B, C, D, bias, True),
                               rtol=0, atol=0)
    dt = torch.nn.functional.softplus(delta + bias.reshape(1, G, 1, DG))
    A_g = A.reshape(1, G, DG, N)
    h = torch.zeros(Bsz, G, DG, N)
    for t in range(L):
        if t % CHUNK == 0:
            torch.testing.assert_close(hck[:, :, t // CHUNK], h, rtol=1e-5, atol=1e-6)
        h = torch.exp(dt[:, :, t, :, None] * A_g) * h \
            + (dt * u)[:, :, t, :, None] * B[:, :, t, None, :]


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU there is no backward kernel to launch: the wrapper
    raises, and the plain backward is what the CPU takes."""
    args = [torch.from_numpy(x) for x in _inputs(1, 20, 8, True)]
    y, hck = _scan_tm_plain(*args, True, return_hck=True)
    dy = torch.ones_like(y)
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_bwd(*args, True, dy, hck)
    grads = _scan_tm_plain_bwd(*args, True, dy, hck)
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in args]
    assert selective_scan_bwd.launches == 0


def test_cuda_route_writes_hck_only_for_training(monkeypatch):
    """The ``impl="cuda"`` route, with the two kernel wrappers stubbed by
    the plain loops (there is no card here): under ``inference_mode`` the
    forward wrapper is called without ``hck`` (serving keeps its bytes),
    with grad it is called with ``hck`` and the backward wrapper gets that
    ``hck``; the gradients equal the plain route's exactly."""
    import importlib

    # the module: the package exports the function ``selective_scan`` under its name
    ss = importlib.import_module("mamba_clip_tpu_torch.ops.selective_scan")

    calls = []

    def fwd(*a, with_hck=False):
        calls.append(("fwd", with_hck))
        return ss._scan_tm_plain(*a, return_hck=with_hck)

    def bwd(*a):
        calls.append(("bwd", a[-1].shape))
        return ss._scan_tm_plain_bwd(*a)

    monkeypatch.setattr(ss, "selective_scan_fwd", fwd)
    monkeypatch.setattr(ss, "selective_scan_bwd", bwd)
    args = [torch.from_numpy(x) for x in _inputs(5, 40, 8, True)]
    with torch.inference_mode():
        ss.selective_scan_tm(*args, True, impl="cuda")
    assert calls == [("fwd", False)]
    grads = []
    for impl in ("cuda", "plain"):
        targs = [t.clone().requires_grad_() for t in args]
        torch.sin(ss.selective_scan_tm(*targs, True, impl=impl)).sum().backward()
        grads.append([t.grad for t in targs])
    assert calls == [("fwd", False), ("fwd", True), ("bwd", (2, 4, 3, 8, 16))]
    for g_cuda, g_plain in zip(*grads):
        torch.testing.assert_close(g_cuda, g_plain, rtol=0, atol=0)
