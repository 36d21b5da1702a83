"""The port's attention interior (ops/flash_attn.py) against the JAX package.

The port's plain interior is held against JAX's einsum interior (the
``FusedAttention`` path, ``models/vit.py:122-132``) and against JAX's
``flash_attention_interior`` run with the ``mha_reference`` oracle in place
of the TPU kernel, as ``tests/test_flash_attn.py`` runs it on the CPU.
Inputs come from numpy seeds; everything is fp32. Tolerance: 2e-5 absolute
and relative, the tolerance that test puts on the JAX wrapper (summation
order of the two matmuls and the softmax, a few fp32 ulps).

The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 7
holds it against the plain interior there); here the tests check that its
wrapper refuses what the kernel does not take, and that a CPU tensor takes
the plain interior.
"""

import re

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

TOL = 2e-5


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


def _qkv(B, T, h, hd, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, h, hd).astype(np.float32) for _ in range(3)]


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


@pytest.mark.parametrize("T", [128, 197, 256])
@pytest.mark.parametrize("kind", ["none", "prefix", "nonprefix", "all_masked_row"])
def test_plain_interior_matches_jax(T, kind):
    B, h, hd = 2, 3, 16
    q, k, v = _qkv(B, T, h, hd, seed=T)
    mask = _mask(B, T, kind, seed=T + 1)
    sm = hd ** -0.5
    got = tfa.attention_plain(*map(torch.from_numpy, (q, k, v)),
                              None if mask is None else torch.from_numpy(mask),
                              sm_scale=sm).numpy()
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(_jax_einsum_interior(*map(jnp.asarray, (q, k, v)), jm, sm))
    assert got.shape == (B, T, h * hd)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if kind == "all_masked_row":
        # the plain answer for a row with no valid key: the mean of v over T
        np.testing.assert_allclose(got[1], np.broadcast_to(
            v[1].mean(0).reshape(1, h * hd), (T, h * hd)), atol=TOL, rtol=TOL)
    # JAX's wrapper pads T to 128 with masked keys; a row with no valid key
    # then averages the padding too, so it is held there only where T needs
    # no padding
    if kind != "all_masked_row" or T % 128 == 0:
        flash = np.asarray(jfa.flash_attention_interior(
            *map(jnp.asarray, (q, k, v)), jm, sm_scale=sm, kernel_fn=_mha_oracle()))
        np.testing.assert_allclose(got, flash, atol=TOL, rtol=TOL)


def test_resolve_attn_flash():
    assert tfa.resolve_attn_flash("einsum") is False
    assert tfa.resolve_attn_flash(None) is False
    # the port's CPU path is the plain interior, so flash is accepted here
    assert tfa.resolve_attn_flash("flash") is True
    with pytest.raises(ValueError) as t_err:
        tfa.resolve_attn_flash("bogus")
    with pytest.raises(ValueError) as j_err:
        jfa.resolve_attn_flash("bogus")
    assert str(t_err.value) == str(j_err.value)


def _tensors(T=16, hd=64, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(2, T, 2, hd, seed=3))
    return q, k, v


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _tensors()
    with pytest.raises(ValueError, match="expected the CUDA device"):
        tfa.flash_attn_fwd(q, k, v, sm_scale=0.125)
    with pytest.raises(ValueError, match="not contiguous"):
        tfa.flash_attn_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                           sm_scale=0.125)
    q48, k48, v48 = _tensors(hd=48)
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.flash_attn_fwd(q48, k48, v48, sm_scale=0.125)
    with pytest.raises(ValueError, match="one type"):
        tfa.flash_attn_fwd(q.double(), k.double(), v.double(), sm_scale=0.125)
    with pytest.raises(ValueError, match="key_mask"):
        tfa.flash_attn_fwd(q, k, v, torch.ones(2, 15, dtype=torch.bool), sm_scale=0.125)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attn_fwd(q, k[:, :8].contiguous(), v, sm_scale=0.125)
    # asked for on the CPU, the flash interior raises: there is no fallback
    with pytest.raises(ValueError, match="expected the CUDA device"):
        tfa.flash_attention_interior(q, k, v, None, sm_scale=0.125, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tfa.flash_attention_interior(q, k, v, None, sm_scale=0.125, impl="pallas")
    assert tfa.flash_attn_fwd.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_interior_takes_the_plain_interior_on_cpu(dtype):
    q, k, v = _tensors(T=33, dtype=dtype)
    mask = torch.from_numpy(_mask(2, 33, "nonprefix", seed=9))
    got = tfa.flash_attention_interior(q, k, v, mask, sm_scale=0.125)
    want = tfa.attention_plain(q, k, v, mask, sm_scale=0.125)
    assert got.dtype == dtype and got.shape == (2, 33, 128)
    assert torch.equal(got, want)
    assert tfa.flash_attn_fwd.launches == 0


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_attn_fwd_kernelIfLi64EEEvPKT_S3_S3_PKhPS1_PfS7_iif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_attn_fwd_kernelIfLi64EEEvPKT_S3_S3_PKhPS1_PfS7_iif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 33024 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126flash_attn_fwd_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKhPS1_PfS7_iif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126flash_attn_fwd_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKhPS1_PfS7_iif
    0 bytes stack frame, 60 bytes spill stores, 94 bytes spill loads
ptxas info    : Used 128 registers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    """chip_smoke.py reports the forward's instances from ptxas' -v log:
    registers, spills and static shared memory, by mangled name."""
    from mamba_clip_tpu_torch.ops import cuda_build

    rep = cuda_build.ptxas_report(_PTXAS_LOG)
    fp32, bf16 = sorted(rep, key=lambda name: "bf16" in name)
    assert rep[fp32] == {"registers": 96, "spill_stores": 0, "spill_loads": 0,
                         "static_smem": 33024}
    assert rep[bf16] == {"registers": 128, "spill_stores": 60, "spill_loads": 94,
                         "static_smem": 0}
    assert cuda_build.ptxas_report("") == {}


def test_library_path_is_one_per_source():
    """Each source builds into one library under the build directory, keyed
    by its text, the shared headers and the flags."""
    from mamba_clip_tpu_torch.ops import cuda_build

    fwd = cuda_build.library_path("flash_attn_fwd")
    bwd = cuda_build.library_path("flash_attn_bwd")
    assert fwd != bwd and fwd == cuda_build.library_path("flash_attn_fwd")
    assert fwd.parent == bwd.parent == cuda_build.BUILD_DIR
    assert re.fullmatch(r"libflash_attn_fwd_[0-9a-f]{16}\.so", fwd.name)
