"""The port's plain selective scan against the JAX package's scans.

The JAX side runs ``selective_scan_tm`` with ``impl="xla"`` (its lax.scan
reference) and ``impl="pallas_interpret"`` (the Pallas kernel in interpret
mode, as tests/test_selective_scan.py runs it on the CPU).

Tolerances, as max|y_port - y_jax| / max|y_jax|:
- fp32 inputs: 1e-5. The port repeats the lax.scan arithmetic step by
  step; the Pallas kernel sums its chunked doubling scan in another order,
  a few fp32 ulps of the state.
- bf16 inputs (the same bf16 values fed to both): 1e-4. Both upcast to
  fp32 before any arithmetic; the bound leaves room for the Pallas
  kernel's order of summation on larger-magnitude bf16-rounded data.

On the CPU the wrapper takes the plain loop, so the CUDA kernel's launch
counter must not move; the CUDA kernel itself is held against the plain
loop on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.ops.selective_scan import selective_scan as jax_scan_cm
from mamba_clip_tpu.ops.selective_scan import selective_scan_flops as jax_flops
from mamba_clip_tpu.ops.selective_scan import selective_scan_tm as jax_scan
from mamba_clip_tpu_torch.ops import selective_scan as port
from mamba_clip_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_flops,
    selective_scan_fwd,
    selective_scan_tm,
)

RTOL_F32 = 1e-5
RTOL_BF16 = 1e-4


def _inputs(seed, Bsz=2, G=4, L=49, DG=24, N=16, with_d=True):
    """Without D and bias the case runs without softplus, so delta is
    drawn positive, as a step size is (a negative one grows the state
    without bound)."""
    rs = np.random.RandomState(seed)
    f = np.float32
    u = rs.randn(Bsz, G, L, DG).astype(f)
    delta = (rs.randn(Bsz, G, L, DG) * 0.5).astype(f)
    if not with_d:
        delta = np.abs(delta)
    A = -np.exp(rs.randn(G * DG, N) * 0.5).astype(f)
    B = rs.randn(Bsz, G, L, N).astype(f)
    C = rs.randn(Bsz, G, L, N).astype(f)
    D = rs.randn(G * DG).astype(f) if with_d else None
    bias = (rs.randn(G * DG) * 0.1).astype(f) if with_d else None
    return u, delta, A, B, C, D, bias


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _run_both(args, softplus, impl, dtype):
    u, delta, A, B, C, D, bias = args
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    opt = lambda x, conv: None if x is None else conv(x)  # noqa: E731
    want = np.asarray(jax_scan(
        *(jnp.asarray(x, jdt) for x in (u, delta)), jnp.asarray(A),
        *(jnp.asarray(x, jdt) for x in (B, C)),
        opt(D, jnp.asarray), opt(bias, jnp.asarray), softplus, impl=impl))
    got = selective_scan_tm(
        *(torch.from_numpy(x).to(tdt) for x in (u, delta)), torch.from_numpy(A),
        *(torch.from_numpy(x).to(tdt) for x in (B, C)),
        opt(D, torch.from_numpy), opt(bias, torch.from_numpy), softplus)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("L,DG", [(49, 64), (300, 24)])
@pytest.mark.parametrize("softplus,with_d", [(True, True), (False, False)])
def test_plain_scan_matches_jax_fp32(impl, L, DG, softplus, with_d):
    args = _inputs(L + DG, L=L, DG=DG, with_d=with_d)
    before = selective_scan_fwd.launches
    got, want = _run_both(args, softplus, impl, "fp32")
    assert _rel(got, want) <= RTOL_F32
    assert selective_scan_fwd.launches == before == 0


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_plain_scan_matches_jax_bf16(impl):
    args = _inputs(7, L=300, DG=64)
    got, want = _run_both(args, True, impl, "bf16")
    assert _rel(got, want) <= RTOL_BF16
    assert selective_scan_fwd.launches == 0


def test_channel_major_wrapper_matches_jax():
    rs = np.random.RandomState(3)
    bsz, G, DG, L, N = 2, 2, 8, 33, 16
    d = G * DG
    u = rs.randn(bsz, d, L).astype(np.float32)
    delta = (rs.randn(bsz, d, L) * 0.5).astype(np.float32)
    A = -np.exp(rs.randn(d, N) * 0.5).astype(np.float32)
    B = rs.randn(bsz, G, N, L).astype(np.float32)
    C = rs.randn(bsz, G, N, L).astype(np.float32)
    D = rs.randn(d).astype(np.float32)
    want = np.asarray(jax_scan_cm(*map(jnp.asarray, (u, delta, A, B, C, D)),
                                  delta_softplus=True, impl="xla"))
    got = selective_scan(*map(torch.from_numpy, (u, delta, A, B, C, D)),
                         delta_softplus=True).numpy()
    assert _rel(got, want) <= RTOL_F32


def test_flops_model_matches_jax():
    for kw in (dict(with_D=True), dict(with_D=False, with_backward=True)):
        assert selective_scan_flops(64, 256, 3136, 16, **kw) == jax_flops(
            64, 256, 3136, 16, **kw)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_impl():
    args = [torch.from_numpy(x) for x in _inputs(1, L=5, DG=4)]
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_fwd(*args, True)
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_tm(*args, True, impl="cuda")
    with pytest.raises(ValueError, match="unknown selective-scan impl"):
        selective_scan_tm(*args, True, impl="pallas")
    assert selective_scan_fwd.launches == 0


def test_kernel_source_and_build_paths():
    """The kernel's source ships in the package and its library name is
    keyed by the source; building needs nvcc, which only the card's
    machine has."""
    assert (port.cuda_build.CSRC / "selective_scan_fwd.cu").is_file()
    path = port.cuda_build.library_path("selective_scan_fwd")
    assert path.parent == port.cuda_build.BUILD_DIR
    assert path.name.startswith("libselective_scan_fwd_")
