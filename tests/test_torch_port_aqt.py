"""The port's aqt dots (``ops/aqt.py``) against the ``aqt`` library, on the CPU.

The JAX package's ``--quant int8`` and ``--quant int8_fwd`` inject
``AqtDotGeneral`` over the configurations that
``mamba_clip_tpu.ops.quant.make_dot_general_cls`` builds; the port writes
their numerics out. Each dot takes the same numpy inputs, made from a
seed, on both sides; the JAX side runs jitted, as the train steps run it.

- the int8 operands of the forward and of both backward dots, and the int32
  accumulators computed from them, equal bit for bit (the library exposes
  the operands through ``DotGeneralRaw``'s residuals);
- the output and both gradients: fp32 within rel 1e-6 of the largest
  entry. In bf16 and fp16 every product runs through the same roundings,
  but the unquantized dots of ``int8_fwd``'s backward sum in another order
  and round once at the end: within one rounding of the type, 2^-8 (bf16)
  and 2^-11 (fp16), relative to the largest entry;
- edge cases: an all-zero row (absmax 1), a value at the clip edge and
  half-way ties (round half to even), and an fp16 cotangent that the
  forward's scale overflows (non-finite exactly where aqt's is).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aqt.jax.v2 import aqt_dot_general as adg
from jax import lax

from mamba_clip_tpu.ops import quant as jquant
from mamba_clip_tpu_torch.ops import aqt as taqt
from mamba_clip_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

DIMS = (((2,), (0,)), ((), ()))
# a token batch through a Dense of the towers, cut narrow: ragged K and N
SHAPES = [((2, 9, 40), (40, 24)), ((3, 5, 20), (20, 12))]
JT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}
TT = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
TOL = {"fp32": 1e-6, "bf16": 2.0**-8, "fp16": 2.0**-11}


def _cfg(mode):
    return jquant.make_dot_general_cls(mode).args[0]


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _npw(x):
    return np.array(_np(x))


def _tn(x):
    return x.detach().float().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _close(t, j, tol):
    """Non-finite at the same entries (fp16 can overflow in the dequantize
    of a tiny-range row), the finite ones within ``tol`` of the largest."""
    t, j = _tn(t), _np(j)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    fin = np.isfinite(j)
    assert _rel(t[fin], j[fin]) <= tol


def _inputs(shapes, rs, scale_g=1.0):
    (ls, rsh) = shapes
    lhs = rs.standard_normal(ls).astype(np.float32)
    rhs = (rs.standard_normal(rsh) * 0.1).astype(np.float32)
    rhs[:, 3] *= 0.01            # a column with a small range
    lhs[0, 1] = 0.0              # an all-zero row
    g = (rs.standard_normal(ls[:-1] + rsh[-1:]) * scale_g).astype(np.float32)
    return lhs, rhs, g


def _jax_dot(mode, dt):
    """Jitted aqt: (out, dlhs, drhs) and the forward's int8 operands."""
    cfg = _cfg(mode)

    def f(lhs, rhs, g):
        out, vjp = jax.vjp(lambda a, b: cfg(a, b, DIMS), lhs, rhs)
        dl, dr = vjp(g)
        c = copy.deepcopy(cfg)
        for raw in (c.fwd, c.dlhs, c.drhs):
            raw.dg_quantizer.init_calibration()
        _, res = c.fwd(lhs, rhs, None, None, DIMS)
        return out, dl, dr, res.lhs.mt.qx.qvalue, res.rhs.mt.qx.qvalue, res

    return jax.jit(f)


def _jax_bwd_raw(dt):
    """The ``int8`` backward dots' int8 operands and int32 accumulators, as
    aqt's ``DotGeneralRaw`` makes them from the forward's residuals."""
    cfg = _cfg("int8")

    def f(lhs, rhs, g):
        c = copy.deepcopy(cfg)
        for raw in (c.fwd, c.dlhs, c.drhs):
            raw.dg_quantizer.init_calibration()
        _, res = c.fwd(lhs, rhs, None, None, DIMS)
        out = {}
        for name, raw, y, y_is_lhs in (("dlhs", c.dlhs, res.rhs, False),
                                       ("drhs", c.drhs, res.lhs, True)):
            dims, _ = adg._update_dimension_numbers_for_backward(DIMS, y_is_lhs, g.ndim,
                                                                 y.mt.x.ndim)
            _, r = raw(g, y.mt, None, None, dims)
            acc = lax.dot_general(r.lhs.mt.qx.qvalue, r.rhs.mt.qx.qvalue, dims,
                                  preferred_element_type=jnp.int32)
            out[name] = (r.lhs.mt.qx.qvalue, r.rhs.mt.qx.qvalue, acc)
        return out

    return jax.jit(f)


@pytest.mark.parametrize("shapes", SHAPES, ids=["s0", "s1"])
@pytest.mark.parametrize("prec", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("mode", ["int8", "int8_fwd"])
def test_dot_matches_aqt(mode, prec, shapes):
    rs = np.random.RandomState(len(mode) + 7 * len(prec) + shapes[0][2])
    lhs, rhs, g = _inputs(shapes, rs)
    jdt, tdt = JT[prec], TT[prec]
    jl, jr, jg = (jnp.asarray(a).astype(jdt) for a in (lhs, rhs, g))
    out, dl, dr, jql, jqr, _ = _jax_dot(mode, jdt)(jl, jr, jg)

    tl = torch.from_numpy(_npw(jl)).to(tdt).requires_grad_()
    tr = torch.from_numpy(_npw(jr)).to(tdt).requires_grad_()
    tg = torch.from_numpy(_npw(jg)).to(tdt)
    dot = tquant.make_dot_general_cls(mode)()
    tout = dot(tl, tr, DIMS)
    tout.backward(tg)
    _, tql, _, tqr, _ = taqt.fwd_dot(tl.detach(), tr.detach())

    # the forward's int8 operands and its int32 accumulator, bit for bit
    np.testing.assert_array_equal(tql.numpy(), np.asarray(jql))
    np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
    jacc = np.asarray(lax.dot_general(jql, jqr, DIMS, preferred_element_type=jnp.int32))
    tacc = torch.einsum("bmk,kn->bmn", tql.long(), tqr.long()).numpy()
    np.testing.assert_array_equal(tacc, jacc)
    assert tout.dtype == tdt and tl.grad.dtype == tdt and tr.grad.dtype == tdt
    # the forward is the same roundings in the same order: equal
    np.testing.assert_array_equal(_tn(tout), _np(out))
    tol = TOL[prec] if mode == "int8_fwd" else 1e-6
    _close(tl.grad, dl, tol)
    _close(tr.grad, dr, tol)


@pytest.mark.parametrize("prec", ["fp32", "bf16", "fp16"])
def test_int8_backward_operands_and_accumulators_match_aqt(prec):
    """``use_fwd_quant``: the cotangent times the forward scale, the
    forward's int8 operand requantized on the backward dot's axes."""
    rs = np.random.RandomState(3)
    lhs, rhs, g = _inputs(SHAPES[0], rs)
    jdt, tdt = JT[prec], TT[prec]
    jl, jr, jg = (jnp.asarray(a).astype(jdt) for a in (lhs, rhs, g))
    want = _jax_bwd_raw(jdt)(jl, jr, jg)
    tl, tr, tg = (torch.from_numpy(_npw(a)).to(tdt) for a in (jl, jr, jg))
    _, ql, sl, qr, sr = taqt.fwd_dot(tl, tr)
    dl, qg_l, acc_l = taqt.dlhs_dot(tg, qr, sr)
    dr, qg_r, acc_r = taqt.drhs_dot(tg, ql, sl)
    np.testing.assert_array_equal(qg_l.numpy(), np.asarray(want["dlhs"][0]))
    np.testing.assert_array_equal(acc_l.numpy(), np.asarray(want["dlhs"][2]))
    np.testing.assert_array_equal(qg_r.numpy(), np.asarray(want["drhs"][0]))
    np.testing.assert_array_equal(acc_r.numpy(), np.asarray(want["drhs"][2]))


def test_edge_cases_zero_row_clip_edge_and_ties():
    """An all-zero row takes absmax 1 (scale 1/127.5) and quantizes to 0; a
    value at the absmax lands on 127.5 and clips to 127; x * (1/scale) at a
    half sits on its even neighbour."""
    x = torch.zeros((3, 8))
    x[1] = torch.tensor([127.5, -127.5, 2.5, 3.5, -2.5, 0.5, 1.5, 0.0])
    x[2] = torch.tensor([1.0, 0.25, -0.5, 0.0, 0.0, 0.0, 0.0, 0.0])
    s = taqt.calibrate(x, (-1,))
    q = taqt.quantize(x, s)
    assert float(s[0]) == pytest.approx(1 / 127.5, rel=1e-7)
    assert q[0].abs().sum() == 0
    assert q[1].tolist() == [127, -127, 2, 4, -2, 0, 2, 0]
    assert q[2].tolist()[:3] == [127, 32, -64]
    # the same through aqt's quantizer
    cfg = copy.deepcopy(_cfg("int8"))
    cfg.fwd.dg_quantizer.init_calibration()
    qt = cfg.fwd.dg_quantizer.lhs.calibrate(jnp.asarray(x.numpy()), calibration_axes=(1,))
    jq, _ = cfg.fwd.dg_quantizer.lhs.calculate_qvalue(jnp.asarray(x.numpy()), qt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.qvalue))


def test_fp16_cotangent_overflowed_by_the_forward_scale():
    """A weight column above 127.5 gives a forward scale above 1; an fp16
    cotangent near its range then overflows when ``use_fwd_quant``
    multiplies it: the gradients are non-finite exactly where aqt's are."""
    rs = np.random.RandomState(5)
    lhs, rhs, g = _inputs(SHAPES[1], rs)
    rhs[:, 2] *= 4000.0
    g[1, 2] = 60000.0
    jl, jr, jg = (jnp.asarray(a).astype(jnp.float16) for a in (lhs, rhs, g))
    out, dl, dr, *_ = _jax_dot("int8", jnp.float16)(jl, jr, jg)
    tl, tr = (torch.from_numpy(_npw(a)).half().requires_grad_() for a in (jl, jr))
    tquant.make_dot_general_cls("int8")()(tl, tr, DIMS).backward(
        torch.from_numpy(_npw(jg)).half())
    for t, j in ((tl.grad, dl), (tr.grad, dr)):
        assert not np.isfinite(_np(j)).all()
        _close(t, j, 1e-6)


def test_no_aqt_collection_and_no_rng_in_training_mode():
    """aqt's freezer keeps no variables in training mode and the layer draws
    no rng: ``model.init`` returns the params only, and the port's dots are
    stateless."""
    import flax.linen as fnn

    cls = jquant.make_dot_general_cls("int8_fwd")
    dense = fnn.Dense(8, dot_general_cls=cls)
    v = jax.eval_shape(lambda: dense.init(jax.random.PRNGKey(0), jnp.zeros((2, 4))))
    assert set(v) == {"params"}
    for mode in ("int8", "int8_fwd"):
        assert not list(tquant.make_dot_general_cls(mode)().state_dict())
