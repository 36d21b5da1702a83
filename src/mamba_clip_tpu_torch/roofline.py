"""The least time the card could take for a kernel's work: the counts of
bytes, FLOPs and exps of the port's own CUDA kernels, over the card's rates.

One count shared by ``chip_smoke.py`` and ``scan_roofline.py``. The rates
are arguments; their defaults are the H100 SXM data-sheet peaks, and
``scan_roofline.py`` passes the ceilings it measured instead. The CUDA
kernels pad nothing, so the counts are over the real shapes (the Pallas
kernels' padded-element counts are the TPU kernels' own and do not apply).
"""

from __future__ import annotations

from .ops.selective_scan import CHUNK, selective_scan_flops

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989.4e12  # dense bf16 tensor-core peak
TF32_TC_FLOPS = 494.7e12  # dense TF32 tensor-core peak; 3xTF32 takes three products a product
SFU_OPS_PER_CLK_SM = 16   # exp2 throughput per SM per clock, compute capability 9.0
FP32_LANES_PER_SM = 128   # fp32 FMA lanes per SM


def sfu_peak(sm_count: int, clock_mhz: float) -> float:
    """exp/s of ``sm_count`` SMs at ``clock_mhz``."""
    return sm_count * SFU_OPS_PER_CLK_SM * clock_mhz * 1e6


def fma_peak(sm_count: int, clock_mhz: float) -> float:
    """fp32 FMA/s (2 FLOPs each) of ``sm_count`` SMs at ``clock_mhz``."""
    return sm_count * FP32_LANES_PER_SM * clock_mhz * 1e6


def bound_of(terms, sfu_rate, hbm_rate=HBM_BYTES_PER_S, fp32_rate=FP32_FLOPS):
    """Bound in ms from byte, FLOP and exp counts, and what bounds it."""
    t_bytes = terms["bytes"] / hbm_rate
    t_ops = max(terms["flops"] / fp32_rate, terms["exps"] / sfu_rate)
    terms.update(bytes_ms=1e3 * t_bytes, flops_ms=1e3 * terms["flops"] / fp32_rate,
                 exps_ms=1e3 * terms["exps"] / sfu_rate,
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return terms


def scan_bwd_bound(Bsz, L, DG, itemsize, sfu_rate, G=4, N=16, **rates):
    """Least time for one backward scan. Bytes: u, delta, B, C read in
    their type, dy and hck (the state at every ``CHUNK``-th step) in fp32,
    A, D and bias; ddelta, du, dB, dC, dA, dD and dbias written once in
    fp32. FLOPs per channel-step and state: 18 (recompute a and h: 4; dC:
    1; g and its carry: 3; dB: 1; ddu: 2; the dA and ddt terms: 7), plus
    10 per channel-step. Exps: a per state, and softplus (exp, log) and
    sigmoid once per channel-step."""
    E = Bsz * G * L * DG
    BC = Bsz * G * L * N
    hck = Bsz * G * (-(-L // CHUNK)) * DG * N
    return bound_of({
        "bytes": (2 * E * itemsize + 2 * BC * itemsize + 4 * E + 4 * hck
                  + G * DG * (N + 2) * 4
                  + 8 * E + 2 * BC * 4 + G * DG * (N + 2) * 4),
        "flops": 18 * E * N + 10 * E,
        "exps": E * (N + 3),
    }, sfu_rate, **rates)


def scan_bound(Bsz, L, DG, itemsize, sfu_rate, G=4, N=16, **rates):
    """Least time for one forward scan: the bytes it must move (each input
    read once, y written once) over the HBM rate, against its fp32 FLOPs
    and its exps over their peaks. Returns the terms, the bound in ms and
    what bounds it."""
    E = Bsz * G * L * DG
    return bound_of({
        "bytes": (2 * E * itemsize + 4 * E + 2 * Bsz * G * L * N * itemsize
                  + G * DG * (N + 2) * 4),
        "flops": selective_scan_flops(Bsz, G * DG, L, N),
        "exps": E * N,
    }, sfu_rate, **rates)


def attn_bound(Bsz, T, h, hd, itemsize, masked, sfu_rate, tensors=4, stats=0, products=2,
               hbm_rate=HBM_BYTES_PER_S, tc_rate=BF16_TC_FLOPS):
    """Least time for one attention kernel: ``tensors`` arrays of
    B*T*h*hd elements and ``stats`` fp32 arrays of B*h*T moved once (and the
    mask byte per key) over the HBM rate; ``products`` T x T x hd matrix
    products per (batch, head), 2*B*h*T^2*hd FLOPs each, over ``tc_rate``
    (the bf16 tensor-core peak; ``TF32_TC_FLOPS / 3`` for the fp32 bodies
    that take each product as three TF32 products, ``FP32_FLOPS`` for one on
    the CUDA cores); B*h*T^2 exps over the exp rate. The bound is the
    largest of the three. The forward (the defaults) reads q, k, v, writes o
    and takes q.k^T and p.v; dk/dv reads q, k, v, do, m, l, di, writes dk, dv
    and takes 4 products; dq reads the same, writes dq and takes 3."""
    terms = {"bytes": (tensors * Bsz * T * h * hd * itemsize + stats * Bsz * h * T * 4
                       + (Bsz * T if masked else 0)),
             "flops": products * 2 * Bsz * h * T * T * hd, "exps": Bsz * h * T * T}
    times = {"bytes": terms["bytes"] / hbm_rate,
             "flops": terms["flops"] / tc_rate, "exps": terms["exps"] / sfu_rate}
    worst = max(times, key=times.get)
    terms.update({f"{k}_ms": 1e3 * t for k, t in times.items()},
                 bound_ms=1e3 * times[worst],
                 bound_by="bytes" if worst == "bytes" else "operations")
    return terms
