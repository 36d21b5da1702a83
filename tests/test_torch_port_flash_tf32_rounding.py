"""The fp32 flash bodies' 3xTF32 arithmetic, against the JAX package.

The fp32 forward, dk/dv and dq kernels (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu``) take every product on the tensor cores as
3xTF32: each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
rounded to nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds
(the kernels' ``tf32_rna``: the int32 bits ``(b + 0x1000) & ~0x1FFF``,
inf and NaN kept), and a product is lo.hi + hi.lo + hi.hi in fp32. The
forward takes S = Q K^T and O = P V with P = exp(S * scale - m) (O divided
by l at the end); dk/dv takes S^T = K Q^T, dV = P^T dO, dP^T = V dO^T and
dK = dS^T Q; dq takes S = Q K^T in the forward's order, dP = dO V^T and
dQ = dS K; both backward bodies take m and l from the forward.

``_forward``, ``_dkv`` and ``_dq`` below model exactly those rounding points
in plain PyTorch (every product as the three-term split, the rest in fp32).
They live here, not in the package: the package's plain versions are the
plain interior's, and the kernels are held against those on the card
(``chip_smoke.py``). Here the model is held against JAX's
``flash_attention_interior`` run with the ``mha_reference`` oracle, and
against ``jax.vjp`` of it for dq, dk and dv, as
``tests/test_torch_port_flash_grad.py`` runs it (B 2, h 2, hd 64; T 197
unmasked and T 77 with a prefix and a holed key mask; fp32 numpy inputs
from a seed). One jitted ``vjp`` a case serves both model tests.

Tolerance: 1e-5 relative to each output's largest entry. hi + lo carries an
operand to about 2^-22 of its size and the dropped lo.lo term is 2^-22 of
a product, so each product is fp32's within a few ulps; the sums over 64
dims or up to 197 keys, taken in another order than JAX's, add a few fp32
ulps of the largest terms, and dq and dk are remainders of terms that
cancel (the ds of a row sum to 0), which can amplify that by the ratio of
the terms to the remainder. Measured at most a few 1e-6.

With one term (plain TF32: tf32(a) . tf32(b)) each product is off by up to
2^-11 of its size; the tests print that error beside the three-term one as
the margin the card's fp32 gate (5e-4) would have left, and check that the
split buys accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.ops import flash_attn as jfa

# One intra-op thread, as every port test file: the workers share the cores.
torch.set_num_threads(1)

B, H, HD = 2, 2, 64
TOL = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the int32 bits (b + 0x1000) & ~0x1FFF of a
    finite x; inf and NaN kept as they are."""
    b = x.contiguous().view(torch.int32)
    r = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels take it: a_lo b_hi + a_hi b_lo + a_hi b_hi, the
    small terms first (``terms=1``: plain TF32, a_hi b_hi)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if terms == 1:
        return torch.matmul(ah, bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _forward(q, k, v, mask, sm, terms=3):
    """o ``[B, T, h*hd]`` and the residuals m, l ``[B, h, T, 1]``."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))          # [B,h,T,hd]
    s = _mm(qh, kh.transpose(2, 3), terms) * sm
    if mask is not None:
        s = s.masked_fill(~mask, -1e9)
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _mm(p, vh, terms) / l
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], H * HD), m, l


def _dkv(q, k, v, mask, do, sm, o, m, l, terms=3):
    """(dk, dv) ``[B, T, h, hd]`` with the dk/dv kernel's products: the
    transposed ones, S^T = K Q^T and dP^T = V dO^T, and dV = P^T dO,
    dK = dS^T Q; di from the forward's result."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    doh = do.reshape(do.shape[0], do.shape[1], H, HD).transpose(1, 2)
    oh = o.reshape(o.shape[0], o.shape[1], H, HD).transpose(1, 2)
    di = (oh * doh).sum(-1, keepdim=True)
    st = _mm(kh, qh.transpose(2, 3), terms)                      # [B,h,key,query]
    s = st.transpose(2, 3) * sm
    if mask is not None:
        s = s.masked_fill(~mask, -1e9)
    p = torch.exp(s - m) / l
    dv = _mm(p.transpose(2, 3), doh, terms)
    dp = _mm(vh, doh.transpose(2, 3), terms).transpose(2, 3)
    ds = p * (dp - di) * sm
    if mask is not None:
        ds = ds.masked_fill(~mask, 0.0)
    dk = _mm(ds.transpose(2, 3), qh, terms)
    return dk.transpose(1, 2), dv.transpose(1, 2)


def _dq(q, k, v, mask, do, sm, o, m, l, terms=3):
    """dq ``[B, T, h, hd]`` with the dq kernel's products: S = Q K^T in the
    forward's order, dP = dO V^T and dQ = dS K; di from the forward's
    result."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    doh = do.reshape(do.shape[0], do.shape[1], H, HD).transpose(1, 2)
    oh = o.reshape(o.shape[0], o.shape[1], H, HD).transpose(1, 2)
    di = (oh * doh).sum(-1, keepdim=True)
    s = _mm(qh, kh.transpose(2, 3), terms) * sm
    if mask is not None:
        s = s.masked_fill(~mask, -1e9)
    p = torch.exp(s - m) / l
    dp = _mm(doh, vh.transpose(2, 3), terms)
    ds = p * (dp - di) * sm
    if mask is not None:
        ds = ds.masked_fill(~mask, 0.0)
    return _mm(ds, kh, terms).transpose(1, 2)


def _inputs(T, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, T, H, HD).astype(np.float32) for _ in range(3))
    do = rs.randn(B, T, H * HD).astype(np.float32)
    return q, k, v, do


def _mask(T, kind, seed):
    """None, or ``[B, 1, 1, T]`` bool: ``prefix`` (row 0 keeps 2T/3 keys,
    row 1 nine) or ``holes`` (about 40% of the keys dropped at random, the
    first kept). Every row keeps a key: where none is left, the oracle's
    semantics part from the interior's."""
    if kind is None:
        return None
    valid = np.ones((B, T), bool)
    if kind == "prefix":
        valid[0, 2 * T // 3:] = False
        valid[1, 9:] = False
    else:
        valid = np.random.RandomState(seed).rand(B, T) < 0.6
        valid[:, 0] = True
    return valid[:, None, None, :]


def _mha_oracle():
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

    def oracle(q, k, v, ab, segment_ids, *, causal, sm_scale):
        return mha_reference(q * sm_scale, k, v, ab, segment_ids, causal=causal, sm_scale=1.0)

    return oracle


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


_CASES = [(197, None), (77, "prefix"), (77, "holes")]


@pytest.fixture(scope="module")
def jax_case():
    """The inputs of a case (torch tensors, the mask or None, the scale) and
    JAX's o, dq, dk and dv on them, from one jitted ``jax.vjp`` a case."""
    cache = {}

    def get(T, kind):
        if (T, kind) not in cache:
            q, k, v, do = _inputs(T, seed=T)
            mask = _mask(T, kind, seed=T + 1)
            sm = HD ** -0.5
            jm = None if mask is None else jnp.asarray(mask)

            def out(q, k, v):
                return jfa.flash_attention_interior(q, k, v, jm, sm_scale=sm,
                                                    kernel_fn=_mha_oracle())

            o_j, vjp = jax.jit(lambda q, k, v: jax.vjp(out, q, k, v))(
                *map(jnp.asarray, (q, k, v)))
            want = [np.asarray(o_j), *(np.asarray(g) for g in vjp(jnp.asarray(do)))]
            tm = None if mask is None else torch.from_numpy(mask)
            cache[T, kind] = ((*map(torch.from_numpy, (q, k, v)), tm,
                               torch.from_numpy(do), sm), want)
        return cache[T, kind]

    return get


@pytest.mark.parametrize("T, kind", _CASES)
def test_3xtf32_model_matches_jax(T, kind, jax_case):
    (tq, tk, tv, tm, tdo, sm), (o_j, _, dk_j, dv_j) = jax_case(T, kind)
    errs = {}
    for terms in (3, 1):
        o, m, l = _forward(tq, tk, tv, tm, sm, terms)
        dk, dv = _dkv(tq, tk, tv, tm, tdo, sm, o, m, l, terms)
        errs[terms] = [_rel(g, w) for g, w in zip((o, dk, dv), (o_j, dk_j, dv_j))]
    three, one = errs[3], errs[1]
    print(f"T={T} {kind}: 3xTF32 o {three[0]:.2e} dk {three[1]:.2e} dv {three[2]:.2e}; "
          f"plain TF32 o {one[0]:.2e} dk {one[1]:.2e} dv {one[2]:.2e} (card gate 5e-4)")
    assert max(three) <= TOL, three
    assert all(a < b for a, b in zip(three, one)), (three, one)


@pytest.mark.parametrize("T, kind", _CASES)
def test_3xtf32_dq_model_matches_jax(T, kind, jax_case):
    (tq, tk, tv, tm, tdo, sm), (_, dq_j, _, _) = jax_case(T, kind)
    errs = {}
    for terms in (3, 1):
        o, m, l = _forward(tq, tk, tv, tm, sm, terms)
        errs[terms] = _rel(_dq(tq, tk, tv, tm, tdo, sm, o, m, l, terms), dq_j)
    print(f"T={T} {kind}: dq 3xTF32 {errs[3]:.2e}; plain TF32 {errs[1]:.2e} "
          f"(card gate 5e-4)")
    assert errs[3] <= TOL, errs
    assert errs[3] < errs[1], errs


def _bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.uint32))


def _from_bits(b: int) -> float:
    return float(np.array(b, np.uint32).view(np.float32))


@pytest.mark.parametrize("x_bits, want_bits", [
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero to 1 + 2^-10
    (0xBF801000, 0xBF802000),  # its negative, away from zero too
    (0x3F800FFF, 0x3F800000),  # just under the tie: down to 1
    (0x7F7FEFFF, 0x7F7FE000),  # just under the largest float's tie: the largest tf32
    (0x7F7FFFFF, 0x7F800000),  # the largest float: rounds past the largest tf32, to inf
    (0x7F800000, 0x7F800000),  # inf kept
    (0x7FFFFFFF, 0x7FFFFFFF),  # NaN kept (the add would carry it into the sign bit)
])
def test_tf32_rounding_of_picked_values(x_bits, want_bits):
    x = torch.tensor([_from_bits(x_bits)], dtype=torch.float32)
    got = int(_tf32(x).view(torch.int32).numpy().view(np.uint32)[0])
    assert got == want_bits, hex(got)


def test_split_carries_fp32():
    """hi and lo are tf32 values (low 13 bits zero) and hi + lo is within
    2^-22 of x (relative), over values of every magnitude."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy((rs.randn(4096) * np.exp2(rs.randint(-60, 60, 4096))).astype(np.float32))
    hi, lo = _split(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0**-22
