"""The gradient of the port's attention interior against the JAX package.

``attention_plain_bwd`` (the plain backward, written out) and
``FlashAttnFn`` (on the CPU: the plain interior forward and the plain
backward) are held against

- ``jax.grad`` of the JAX einsum interior (``models/vit.py:122-132``),
- ``jax.grad`` of JAX's ``flash_attention_interior`` run with the
  ``mha_reference`` oracle in place of the TPU kernel (scale folded into q,
  as ``tests/test_flash_attn.py`` runs it), where its semantics are the
  einsum interior's (no row without a valid key: the oracle adds the mask
  value to the score instead of replacing it, and JAX's wrapper pads T),
- autograd of the port's ``attention_plain``.

Inputs come from numpy seeds; everything is fp32. The loss is
``sum(out * w)`` for a random ``w``, so ``do = w``. Tolerance: 5e-5 absolute
and relative, the tolerance ``tests/test_flash_attn.py`` puts on the JAX
wrapper's gradients (summation order of four matmuls and the softmax, a
few fp32 ulps of gradients of order 1); against the port's own autograd
1e-5. In bfloat16 the plain backward rounds where autograd of the plain
interior rounds: the two agree within 2 bf16 ulps (2^-7 relative to the
largest entry).

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
``attention_plain_bwd`` there); here the tests check that their wrappers
refuse what the kernels do not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.ops import flash_attn as jfa
from mamba_clip_tpu_torch.ops import flash_attn as tfa

TOL = 5e-5


def _jax_einsum_interior(q, k, v, pad_mask, sm_scale):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    s = s.astype(jnp.float32)
    if pad_mask is not None:
        s = jnp.where(pad_mask, s, jnp.float32(-1e9))
    p = jax.nn.softmax(s, axis=-1).astype(q.dtype)
    B, T, h, hd = q.shape
    return jnp.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, h * hd)


def _mha_oracle():
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

    def oracle(q, k, v, ab, segment_ids, *, causal, sm_scale):
        return mha_reference(q * sm_scale, k, v, ab, segment_ids, causal=causal, sm_scale=1.0)

    return oracle


def _inputs(B, T, h, hd, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, T, h, hd).astype(np.float32) for _ in range(3))
    w = rs.randn(B, T, h * hd).astype(np.float32)
    return q, k, v, w


def _mask(B, T, kind, seed):
    """[B, 1, 1, T] bool: ``prefix`` (row 0 keeps 100 keys, row 1 seven),
    ``nonprefix`` (random holes, the first key kept), ``all_masked_row``
    (row 1 masks every key), or None."""
    if kind == "none":
        return None
    valid = np.ones((B, T), bool)
    if kind == "prefix":
        valid[0, 100:] = False
        valid[1, 7:] = False
    elif kind == "nonprefix":
        valid = np.random.RandomState(seed).rand(B, T) < 0.6
        valid[:, 0] = True
    elif kind == "all_masked_row":
        valid[0, T // 3:] = False
        valid[1, :] = False
    return valid[:, None, None, :]


def _jax_grads(fn, q, k, v, w):
    loss = lambda q, k, v: jnp.sum(fn(q, k, v) * w)  # noqa: E731
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


def _port_grads(q, k, v, mask, w, sm):
    """(dq, dk, dv) by the plain backward, by ``FlashAttnFn`` through the
    flash interior, and by autograd of the plain interior."""
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    tm = None if mask is None else torch.from_numpy(mask)
    written = tfa.attention_plain_bwd(tq, tk, tv, tm, tw, sm)
    out = {}
    for name, interior in (("function", tfa.flash_attention_interior),
                           ("autograd", tfa.attention_plain)):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        o = interior(*leaves, tm, sm_scale=sm)
        out[name] = torch.autograd.grad((o * tw).sum(), leaves)
    return written, out["function"], out["autograd"]


@pytest.mark.parametrize("T", [128, 197])
@pytest.mark.parametrize("kind", ["none", "prefix", "nonprefix", "all_masked_row"])
def test_plain_backward_matches_jax_grad(T, kind):
    B, h, hd = 2, 3, 16
    q, k, v, w = _inputs(B, T, h, hd, seed=T)
    mask = _mask(B, T, kind, seed=T + 1)
    sm = hd ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    want = _jax_grads(lambda q, k, v: _jax_einsum_interior(q, k, v, jm, sm), q, k, v, w)
    written, function, autograd = _port_grads(q, k, v, mask, w, sm)
    for name, got in (("attention_plain_bwd", written), ("FlashAttnFn", function)):
        for g, a, x, leaf in zip(got, autograd, want, ("dq", "dk", "dv")):
            assert g.shape == (B, T, h, hd)
            np.testing.assert_allclose(g.numpy(), x, atol=TOL, rtol=TOL, err_msg=f"{name} {leaf}")
            np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {leaf} against autograd")
    # the written backward and the Function's are one computation
    assert all(torch.equal(a, b) for a, b in zip(written, function))
    if kind == "all_masked_row":
        # a row without a valid key: no gradient through its constant scores,
        # and do / T to every dv
        assert float(written[0][1].abs().max()) == 0.0 and float(written[1][1].abs().max()) == 0.0
        np.testing.assert_allclose(
            written[2][1].numpy(),
            np.broadcast_to(w[1].reshape(T, h, hd).mean(0), (T, h, hd)), atol=TOL, rtol=TOL)
    else:
        # JAX's flash wrapper with the oracle in place of the TPU kernel
        flash = _jax_grads(lambda q, k, v: jfa.flash_attention_interior(
            q, k, v, jm, sm_scale=sm, kernel_fn=_mha_oracle()), q, k, v, w)
        for g, x, leaf in zip(written, flash, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), x, atol=TOL, rtol=TOL, err_msg=leaf)
    if mask is not None:
        # a masked key gets no dk, and no dv from a row that has a valid key
        dead = ~mask.reshape(B, T) & mask.reshape(B, T).any(1, keepdims=True)
        assert float(written[1][torch.from_numpy(dead)].abs().max()) == 0.0
        assert float(written[2][torch.from_numpy(dead)].abs().max()) <= 1e-30


def test_padded_query_rows_contribute_to_dk_and_dv():
    """The mask covers keys only: a padded token as a query attends the
    valid keys, so its ``do`` reaches their dk and dv."""
    B, T, h, hd = 1, 12, 2, 8
    q, k, v, w = _inputs(B, T, h, hd, seed=5)
    mask = np.ones((B, 1, 1, T), bool)
    mask[..., 8:] = False
    only_pad_rows = w.copy()
    only_pad_rows[:, :8] = 0.0  # do is zero at every valid query row
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    dq, dk, dv = tfa.attention_plain_bwd(tq, tk, tv, torch.from_numpy(mask),
                                         torch.from_numpy(only_pad_rows), hd ** -0.5)
    assert float(dk[:, :8].abs().max()) > 1e-3 and float(dv[:, :8].abs().max()) > 1e-3
    assert float(dk[:, 8:].abs().max()) == 0.0
    assert float(dq[:, :8].abs().max()) == 0.0 and float(dq[:, 8:].abs().max()) > 1e-3


def test_plain_backward_in_bf16_rounds_where_autograd_rounds():
    B, T, h, hd = 2, 33, 2, 16
    q, k, v, w = (torch.from_numpy(a).bfloat16() for a in _inputs(B, T, h, hd, seed=9))
    mask = torch.from_numpy(_mask(B, T, "nonprefix", seed=10))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.attention_plain(*leaves, mask, sm_scale=0.25)
    want = torch.autograd.grad((o.float() * w.float()).sum(), leaves)
    got = tfa.attention_plain_bwd(q, k, v, mask, w, 0.25)
    for g, x in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - x.float()).abs().max()) <= 2.0**-7 * float(x.float().abs().max())


def test_no_grad_takes_the_forward_alone_and_grad_the_function(monkeypatch):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 9, 2, 32, seed=1))
    seen = []
    real = tfa.FlashAttnFn.apply
    monkeypatch.setattr(tfa.FlashAttnFn, "apply",
                        lambda *a: seen.append(a[-1]) or real(*a))
    tfa.flash_attention_interior(q, k, v, None, sm_scale=0.5)
    with torch.no_grad():
        tfa.flash_attention_interior(q.clone().requires_grad_(), k, v, None, sm_scale=0.5)
    assert seen == []
    for impl in (None, "plain"):
        tfa.flash_attention_interior(q.clone().requires_grad_(), k, v, None, sm_scale=0.5,
                                     impl=impl)
    assert seen == ["plain", "plain"]
    # asked for on the CPU, the kernels raise in the Function too: no fallback
    with pytest.raises(ValueError, match="expected the CUDA device"):
        tfa.flash_attention_interior(q.clone().requires_grad_(), k, v, None, sm_scale=0.5,
                                     impl="cuda")


def _bwd_args(T=16, hd=64, dtype=torch.float32):
    q, k, v, w = (torch.from_numpy(a).to(dtype) for a in _inputs(2, T, 2, hd, seed=3))
    stats = [torch.ones(2, 2, T) for _ in range(3)]
    return q, k, v, None, w.view(2, T, 2, hd), *stats


@pytest.mark.parametrize("wrapper", [tfa.flash_attn_bwd_dkv, tfa.flash_attn_bwd_dq],
                         ids=["dkv", "dq"])
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    q, k, v, km, do, m, l, di = _bwd_args()
    with pytest.raises(ValueError, match="expected the CUDA device"):
        wrapper(q, k, v, km, do, m, l, di, sm_scale=0.125)
    with pytest.raises(ValueError, match="do is not contiguous"):
        wrapper(q, k, v, km, do.transpose(1, 2).contiguous().transpose(1, 2), m, l, di,
                sm_scale=0.125)
    with pytest.raises(ValueError, match="head dim 48"):
        wrapper(*_bwd_args(hd=48), sm_scale=0.125)
    with pytest.raises(ValueError, match="one type"):
        wrapper(q, k, v, km, do.bfloat16(), m, l, di, sm_scale=0.125)
    with pytest.raises(ValueError, match=r"l must be \[B, h, T\] float32"):
        wrapper(q, k, v, km, do, m, l[:, :, :8], di, sm_scale=0.125)
    with pytest.raises(ValueError, match=r"di must be \[B, h, T\] float32"):
        wrapper(q, k, v, km, do, m, l, di.double(), sm_scale=0.125)
    with pytest.raises(ValueError, match="key_mask"):
        wrapper(q, k, v, torch.ones(2, 15, dtype=torch.bool), do, m, l, di, sm_scale=0.125)
    with pytest.raises(ValueError, match="do has shape"):
        wrapper(q, k, v, km, do[:, :8].contiguous(), m, l, di, sm_scale=0.125)
    assert wrapper.launches == 0 and tfa.flash_attn_fwd.launches == 0
