"""The port's int8 dots (``ops/qdot.py``) against the JAX package's, on the CPU.

Each of the seven dots takes the same numpy inputs, made from a seed, on
both sides; the JAX side runs jitted, as the train steps run it. Gates:

- the int8 operands (the forward's and the cotangent's) equal;
- the int32 accumulators of the forward and of both backward dots equal,
  computed by each package from those operands;
- the forward and both gradients within rel 1e-6 of the largest entry in
  fp32 (only the serve dot's backward, an fp32 dot on dequantized operands,
  sums in another order; the rest differ by no rounding at all).

Also: the batched fp32 route is exact against an int32 einsum at T = 257
(the longest attention contraction of the towers) and refuses a longer
one than it can sum exactly; ``int_mm``'s padding is exact on ragged
shapes; the Dense-pattern refusal, the ``int8``/``int8_fwd`` mapping to the aqt dots and
the unknown-mode error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mamba_clip_tpu.ops import qdot as jq
from mamba_clip_tpu.ops import quant as jquant
from mamba_clip_tpu_torch.ops import qdot as tq
from mamba_clip_tpu_torch.ops import quant as tquant

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

REL = 1e-6
B, T, H, HD = 2, 9, 3, 8
DENSE = ((2, 5, 20), (20, 12))  # ragged K and N: int_mm pads them
DENSE_PATTERN = (((2,), (0,)), ((), ()))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _probs(rs, shape):
    x = rs.standard_normal(shape).astype(np.float32) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(name, rs):
    """The dot's inputs (arrays), the cotangent of its output."""
    n = rs.standard_normal
    qkv = (B, T, H, HD)
    if name in ("dense", "serve"):
        lhs, rhs = n(DENSE[0]).astype(np.float32), (n(DENSE[1]) * 0.1).astype(np.float32)
        # one column with a small range: per-channel scales differ per column
        rhs[:, 3] *= 0.01
        return (lhs, rhs), n(DENSE[0][:-1] + DENSE[1][-1:]).astype(np.float32)
    if name == "delayed":
        lhs, rhs = n(DENSE[0]).astype(np.float32), (n(DENSE[1]) * 0.1).astype(np.float32)
        # stale scales: 0.8 of this call's absmax clips the largest entries
        sl = np.float32(0.8 * np.abs(lhs).max() / 127)
        sr = np.float32(1.3 * np.abs(rhs).max() / 127)
        return (lhs, rhs, sl, sr), n(DENSE[0][:-1] + DENSE[1][-1:]).astype(np.float32)
    if name == "qk":
        return (n(qkv).astype(np.float32), n(qkv).astype(np.float32)), \
            n((B, H, T, T)).astype(np.float32)
    if name == "pv":
        return (_probs(rs, (B, H, T, T)), n(qkv).astype(np.float32)), n(qkv).astype(np.float32)
    if name == "qk_delayed":
        q, k = n(qkv).astype(np.float32), n(qkv).astype(np.float32)
        sq = (0.7 * np.abs(q).max(axis=(0, 1, 3)) / 127).astype(np.float32).reshape(1, 1, H, 1)
        sk = (1.2 * np.abs(k).max(axis=(0, 1, 3)) / 127).astype(np.float32).reshape(1, 1, H, 1)
        return (q, k, sq, sk), n((B, H, T, T)).astype(np.float32)
    if name == "pv_delayed":
        v = n(qkv).astype(np.float32)
        sv = (0.9 * np.abs(v).max(axis=(0, 1, 3)) / 127).astype(np.float32).reshape(1, 1, H, 1)
        return (_probs(rs, (B, H, T, T)), v, sv), n(qkv).astype(np.float32)
    raise KeyError(name)


DOTS = {
    "dense": (jq.int8_dense_dot, tq.int8_dense_dot),
    "delayed": (jq.int8_delayed_dot, tq.int8_delayed_dot),
    "serve": (jq.int8_serve_dot, tq.int8_serve_dot),
    "qk": (jq.int8_qk_dot, tq.int8_qk_dot),
    "pv": (jq.int8_pv_dot, tq.int8_pv_dot),
    "qk_delayed": (jq.int8_qk_dot_delayed, tq.int8_qk_dot_delayed),
    "pv_delayed": (jq.int8_pv_dot_delayed, tq.int8_pv_dot_delayed),
}


def _jax_dense_acc(a, b):
    return lax.dot_general(a, b, (((a.ndim - 1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)


def _jax_dense_dl(g, b):
    return lax.dot_general(g, b, (((g.ndim - 1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)


def _jax_dense_dr(a, g):
    axes = tuple(range(g.ndim - 1))
    return lax.dot_general(a, g, ((axes, axes), ((), ())), preferred_element_type=jnp.int32)


def _operands(name, xs, g):
    """{what: (JAX's int8 or int32 array, the port's)} for the dot ``name``
    on inputs ``xs`` and cotangent ``g``: the int8 operands of the forward
    and the backward and the accumulators of all three dots."""
    j = [jnp.asarray(x) for x in xs]
    t = [torch.from_numpy(np.asarray(x)) for x in xs]
    jg, tg = jnp.asarray(g), torch.from_numpy(g)
    out = {}
    if name in ("dense", "delayed", "serve"):
        # jitted, as the steps run them: XLA turns "/ 127.0" into a multiply
        # by the reciprocal, and so does the port
        absmax, cols = jax.jit(jq._absmax_scale), jax.jit(jq._absmax_scale_cols)
        if name == "dense":
            jsl, jsr = absmax(j[0]), absmax(j[1])
            tsl, tsr = tq._absmax_scale(t[0]), tq._absmax_scale(t[1])
        elif name == "delayed":
            jsl, jsr, tsl, tsr = j[2], j[3], t[2], t[3]
        else:
            jsl, jsr = absmax(j[0]), cols(j[1])
            tsl, tsr = tq._absmax_scale(t[0]), tq._absmax_scale_cols(t[1])
        jql, jqr = jax.jit(jq._quantize)(j[0], jsl), jax.jit(jq._quantize)(j[1], jsr)
        tql, tqr = tq._quantize(t[0], tsl), tq._quantize(t[1], tsr)
        out.update(lhs8=(jql, tql), rhs8=(jqr, tqr), lhs_scale=(jsl, tsl),
                   rhs_scale=(jsr, tsr),
                   acc=(jax.jit(_jax_dense_acc)(jql, jqr), tq._dense_acc(tql, tqr)))
        if name != "serve":  # the serve backward dequantizes instead
            jqg = jax.jit(lambda x: jq._quantize(x, jq._absmax_scale(x)))(jg)
            tqg = tq._quantize(tg, tq._absmax_scale(tg))
            out.update(g8=(jqg, tqg),
                       dlhs_acc=(jax.jit(_jax_dense_dl)(jqg, jqr), tq._dense_dlhs_acc(tqg, tqr)),
                       drhs_acc=(jax.jit(_jax_dense_dr)(jql, jqg), tq._dense_drhs_acc(tql, tqg)))
        return out
    jq8 = jax.jit(jq._q8_bh, static_argnums=1)
    if name in ("qk", "qk_delayed"):
        pattern, bwd = "bqhd,bkhd->bhqk", ("bhqk,bkhd->bqhd", "bhqk,bqhd->bkhd")
        if name == "qk":
            (ja, _), (jb, _) = jq8(j[0], 2), jq8(j[1], 2)
            (ta, _), (tb, _) = tq._q8_bh(t[0], 2), tq._q8_bh(t[1], 2)
        else:
            quantize = jax.jit(jq._quantize)
            ja, jb = quantize(j[0], j[2]), quantize(j[1], j[3])
            ta, tb = tq._quantize(t[0], t[2]), tq._quantize(t[1], t[3])
        (jg8, _), (tg8, _) = jq8(jg, 1), tq._q8_bh(tg, 1)
        # dq from (g8, k8), dk from (g8, q8)
        bwd_ops = ((jg8, jb, tg8, tb), (jg8, ja, tg8, ta))
    else:
        pattern, bwd = "bhqk,bkhd->bqhd", ("bqhd,bkhd->bhqk", "bhqk,bqhd->bkhd")
        if name == "pv":
            (ja, _), (jb, _) = jq8(j[0], 1), jq8(j[1], 2)
            (ta, _), (tb, _) = tq._q8_bh(t[0], 1), tq._q8_bh(t[1], 2)
        else:
            ja = jax.jit(lambda p: jnp.clip(jnp.round(p.astype(jnp.float32) * 127.0),
                                            0.0, 127.0).astype(jnp.int8))(j[0])
            jb = jax.jit(jq._quantize)(j[1], j[2])
            ta, tb = tq._quantize_probs(t[0]), tq._quantize(t[1], t[2])
        (jg8, _), (tg8, _) = jq8(jg, 2), tq._q8_bh(tg, 2)
        # dp from (g8, v8), dv from (p8, g8)
        bwd_ops = ((jg8, jb, tg8, tb), (ja, jg8, ta, tg8))
    ei = jax.jit(jq._ei32, static_argnums=0)
    out.update(a8=(ja, ta), b8=(jb, tb), g8=(jg8, tg8),
               acc=(ei(pattern, ja, jb), tq._ei32(pattern, ta, tb)))
    for k, (pat, (x, y, u, w)) in enumerate(zip(bwd, bwd_ops)):
        out[f"bwd{k}_acc"] = (ei(pat, x, y), tq._ei32(pat, u, w))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DOTS))
def test_int8_operands_and_accumulators_equal_jax(name, dtype):
    rs = np.random.RandomState(sorted(DOTS).index(name))
    xs, g = _inputs(name, rs)
    if dtype == "bfloat16":
        # the towers' case: values rounded to bf16 before the quantization
        # (scales stay fp32); both sides read the same bf16 values
        def to_bf16(x):
            return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        n_in = 2
        xs = tuple(to_bf16(x) if i < n_in else x for i, x in enumerate(xs))
        g = to_bf16(g)
    pairs = _operands(name, xs, g)
    for what, (j, t) in pairs.items():
        j = np.asarray(j)
        t = t.numpy()
        assert j.dtype == t.dtype, (what, j.dtype, t.dtype)
        assert j.shape == t.shape, (what, j.shape, t.shape)
        np.testing.assert_array_equal(t, j, err_msg=f"{name} {what}")
    assert pairs[next(k for k in pairs if k.endswith("8"))][1].dtype == torch.int8
    assert pairs["acc"][1].dtype == torch.int32


@pytest.mark.parametrize("name", sorted(DOTS))
def test_forward_and_gradients_match_jax(name):
    rs = np.random.RandomState(100 + sorted(DOTS).index(name))
    xs, g = _inputs(name, rs)
    jfn, tfn = DOTS[name]
    n_diff = 2  # the operands; delayed scales get zero gradients

    def jrun(*a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp(jnp.asarray(g))

    jout, jgrads = jax.jit(jrun)(*[jnp.asarray(x) for x in xs])
    targs = [torch.from_numpy(np.asarray(x, np.float32)).requires_grad_(True) for x in xs]
    tout = tfn(*targs)
    tout.backward(torch.from_numpy(g))
    assert tout.dtype == torch.float32 and tuple(tout.shape) == jout.shape
    assert _rel(tout.detach().numpy(), jout) <= REL, name
    for i, (t, j) in enumerate(zip(targs, jgrads)):
        if i < n_diff:
            assert _rel(t.grad.numpy(), j) <= REL, (name, i)
        else:  # straight-through: the scales carry no gradient
            assert not np.any(np.asarray(j)) and not torch.any(t.grad), (name, i)


def test_batched_fp32_route_is_exact_at_t257():
    """Every attention einsum at T = 257 and hd 64, against int32 einsums:
    random int8 values, and the extreme case (every entry -127 or 127, the
    largest sums: 257 * 127^2 = 4,145,153 < 2^24)."""
    rs = np.random.RandomState(7)
    T_, h, hd = 257, 2, 64
    shapes = {"q": (1, T_, h, hd), "s": (1, h, T_, T_)}
    patterns = (("bqhd,bkhd->bhqk", "q", "q"), ("bhqk,bkhd->bqhd", "s", "q"),
                ("bhqk,bqhd->bkhd", "s", "q"))
    for extreme in (False, True):
        for pattern, sa, sb in patterns:
            if extreme:
                a = np.where(rs.rand(*shapes[sa]) < 0.5, -127, 127).astype(np.int8)
                b = np.full(shapes[sb], 127, np.int8) * np.sign(a.sum()).astype(np.int8)
            else:
                a = rs.randint(-127, 128, shapes[sa]).astype(np.int8)
                b = rs.randint(-127, 128, shapes[sb]).astype(np.int8)
            got = tq._ei32(pattern, torch.from_numpy(a), torch.from_numpy(b))
            want = np.einsum(pattern, a.astype(np.int64), b.astype(np.int64))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=pattern)
    worst = np.einsum("bhqk,bkhd->bqhd", np.full((1, 1, T_, T_), 127, np.int64),
                      np.full((1, T_, 1, 1), 127, np.int64)).max()
    assert worst == 257 * 127**2 < 2**24
    # beyond what an fp32 sum holds exactly: refused
    n = tq.F32_EXACT_TERMS + 1
    with pytest.raises(ValueError, match="exact up to 1040"):
        tq._ei32("bhqk,bkhd->bqhd", torch.zeros((1, 1, 2, n), dtype=torch.int8),
                 torch.zeros((1, n, 1, 4), dtype=torch.int8))


@pytest.mark.parametrize("shape", [(1, 3, 5), (17, 8, 8), (23, 33, 9), (300, 40, 24)])
def test_int_mm_is_exact_on_ragged_shapes(shape):
    """Zero padding of rows, K and N leaves every integer sum as it is; the
    extreme values of a long contraction too."""
    M, K, N = shape
    rs = np.random.RandomState(M)
    for a, b in ((rs.randint(-127, 128, (M, K)), rs.randint(-127, 128, (K, N))),
                 (np.full((M, K), -127), np.full((K, N), 127))):
        a, b = a.astype(np.int8), b.astype(np.int8)
        got = tq.int_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    # the transposed views the backward dots pass
    a = rs.randint(-127, 128, (K, M)).astype(np.int8)
    got = tq.int_mm(torch.from_numpy(a).t(), torch.from_numpy(b).t().contiguous().t())
    np.testing.assert_array_equal(got.numpy(), a.T.astype(np.int64) @ b.astype(np.int64))


def test_dense_pattern_refusal_matches_jax():
    lhs = np.ones((2, 3, 4), np.float32)
    rhs = np.ones((3, 5), np.float32)
    bad = (((1,), (0,)), ((), ()))
    with pytest.raises(NotImplementedError) as want:
        jq.Int8FastDotGeneral()(jnp.asarray(lhs), jnp.asarray(rhs), bad)
    with pytest.raises(NotImplementedError) as got:
        tq.Int8FastDotGeneral()(torch.from_numpy(lhs), torch.from_numpy(rhs), bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as want:
        jq.Int8DelayedDotGeneral().init(jax.random.PRNGKey(0), jnp.asarray(lhs),
                                        jnp.asarray(rhs), bad)
    with pytest.raises(NotImplementedError) as got:
        tq.Int8DelayedDotGeneral()(torch.from_numpy(lhs), torch.from_numpy(rhs), bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="Int8ServeDotGeneral supports only"):
        tq.Int8ServeDotGeneral()(torch.from_numpy(lhs), torch.from_numpy(rhs), bad)
    # the Dense pattern itself goes through, preferred_element_type applied
    good = tq.Int8FastDotGeneral()(torch.from_numpy(lhs).reshape(2, 4, 3),
                                   torch.from_numpy(rhs), (((2,), (0,)), ((), ())),
                                   preferred_element_type=torch.bfloat16)
    assert good.dtype == torch.bfloat16 and tuple(good.shape) == (2, 4, 5)


@pytest.mark.parametrize("quant", ["int8", "int8_fwd"])
def test_aqt_modes_refuse_naming_item_7(quant):
    """The aqt modes no longer refuse: they map to the dots of
    ``ops/aqt.py`` (held against the aqt library in test_torch_port_aqt.py),
    which take the Dense pattern only and leave the interior alone."""
    from mamba_clip_tpu_torch.ops import aqt as taqt

    cls = tquant.make_dot_general_cls(quant)
    assert cls is {"int8": taqt.AqtInt8DotGeneral, "int8_fwd": taqt.AqtInt8FwdDotGeneral}[quant]
    assert issubclass(cls, tq._DenseDotGeneral)
    assert not tquant.attn_int8(quant) and not tquant.attn_int8_delayed(quant)
    lhs = torch.ones((2, 3, 4))
    with pytest.raises(NotImplementedError, match=f"{cls.__name__} supports only"):
        cls()(lhs, torch.ones((4, 5)), (((1,), (0,)), ((), ())))


def test_mode_map_and_unknown_mode_match_jax():
    assert tquant._VALID == jquant._VALID
    for q in (None, "none"):
        assert tquant.make_dot_general_cls(q) is None
    for q in jquant._VALID + (None, "none", "bogus"):
        assert tquant.attn_int8(q) == jquant.attn_int8(q)
        assert tquant.attn_int8_delayed(q) == jquant.attn_int8_delayed(q)
    for q, cls in (("int8_fast", tq.Int8FastDotGeneral), ("int8_fast_attn", tq.Int8FastDotGeneral),
                   ("int8_delayed", tq.Int8DelayedDotGeneral),
                   ("int8_delayed_attn", tq.Int8DelayedDotGeneral),
                   ("int8_serve", tq.Int8ServeDotGeneral)):
        assert tquant.make_dot_general_cls(q) is cls
        assert jquant.make_dot_general_cls(q).__name__ == cls.__name__
    with pytest.raises(ValueError) as want:
        jquant.make_dot_general_cls("int4")
    with pytest.raises(ValueError) as got:
        tquant.make_dot_general_cls("int4")
    assert str(got.value) == str(want.value)
