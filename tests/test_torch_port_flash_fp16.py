"""The port's flash interior in fp16 on the CPU, against the JAX package.

Under ``--precision fp16`` and ``pure_fp16`` the attention interior runs in
fp16: on the card through the fp16 instances of the three flash kernels
(``chip_smoke.py`` holds them against the plain versions there), on the
CPU through the plain interior and the plain backward, held here. Inputs
come from a numpy seed; the loss is ``sum(out * w)`` in fp32. Against
JAX's einsum interior in fp16 (``models/vit.py:122-132``) the forward and
the three gradients agree within 2^-10 of their largest entry, one fp16
rounding of a score or of p apart; against JAX's
``flash_attention_interior`` run with the ``mha_reference`` oracle in place
of the TPU kernel (scale folded into q, as ``tests/test_flash_attn.py``
runs it) within 2^-8, since the oracle takes the scores and the softmax in
fp16 where the einsum interior takes them in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.ops import flash_attn as jfa
from mamba_clip_tpu_torch.ops import flash_attn as tfa

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)


def _max_rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())




def _jax_einsum_interior(q, k, v, pad_mask, sm_scale):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    s = s.astype(jnp.float32)
    if pad_mask is not None:
        s = jnp.where(pad_mask, s, jnp.float32(-1e9))
    p = jax.nn.softmax(s, axis=-1).astype(q.dtype)
    B, T, h, hd = q.shape
    return jnp.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, h * hd)


def _mha_oracle(q, k, v, ab, segment_ids, *, causal, sm_scale):
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

    return mha_reference(q * sm_scale, k, v, ab, segment_ids, causal=causal, sm_scale=1.0)


@pytest.mark.parametrize("T,kind", [(128, "none"), (197, "holes"), (197, "prefix")])
def test_flash_interior_in_fp16_matches_jax(T, kind):
    B, h, hd = 2, 3, 16
    rs = np.random.RandomState(T)
    q, k, v, w = (rs.randn(*s).astype(np.float16)
                  for s in ((B, T, h, hd),) * 3 + ((B, T, h * hd),))
    mask = None
    if kind != "none":
        valid = np.ones((B, T), bool)
        if kind == "prefix":
            valid[0, 100:], valid[1, 7:] = False, False
        else:
            valid = rs.rand(B, T) < 0.6
            valid[:, 0] = True
        mask = valid[:, None, None, :]
    jm = None if mask is None else jnp.asarray(mask)
    sm = hd ** -0.5

    def jax_run(fn):
        def loss(a, b, c):
            return jnp.sum(fn(a, b, c).astype(jnp.float32) * w.astype(np.float32))

        args = tuple(map(jnp.asarray, (q, k, v)))
        return [fn(*args)] + list(jax.grad(loss, argnums=(0, 1, 2))(*args))

    einsum = jax_run(lambda a, b, c: _jax_einsum_interior(a, b, c, jm, sm))
    oracle = jax_run(lambda a, b, c: jfa.flash_attention_interior(
        a, b, c, jm, sm_scale=sm, kernel_fn=_mha_oracle))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    o = tfa.flash_attention_interior(*leaves, tm, sm_scale=sm)  # the CPU: the plain path
    grads = torch.autograd.grad((o.float() * torch.from_numpy(w).float()).sum(), leaves)
    got = [o.detach()] + list(grads)
    for name, want, tol in (("einsum", einsum, 2.0**-10), ("flash oracle", oracle, 2.0**-8)):
        for leaf, g, x in zip(("o", "dq", "dk", "dv"), got, want):
            assert g.dtype == torch.float16, leaf
            assert _max_rel(g, x) <= tol, (name, leaf, _max_rel(g, x))


def test_fp16_takes_the_plain_interior_on_cpu_and_no_kernel():
    """fp16 is a kernel type now: on the CPU the wrapper still takes the
    plain interior, because the tensors lie on the CPU, and launches
    nothing; asked for the kernel it raises for the device, not the type."""
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(2, 9, 2, 32).astype(np.float16)) for _ in range(3))
    before = dict(tfa.flash_attn_fwd.launches_by_body)
    got = tfa.flash_attention_interior(q, k, v, None, sm_scale=0.25)
    assert torch.equal(got, tfa.attention_plain(q, k, v, None, sm_scale=0.25))
    with pytest.raises(ValueError, match="expected the CUDA device"):
        tfa.flash_attn_fwd(q, k, v, sm_scale=0.25)
    assert tfa.flash_attn_fwd.launches_by_body == before
