"""The port's VSSM modules against the Flax modules, weights via convert.py.

The Flax side runs with ``scan_impl="xla"`` (its lax.scan reference); the
port runs on the CPU, where the scan takes its plain loop. Variables are
shaped by ``jax.eval_shape`` of the Flax init and filled from a numpy seed
(non-trivial LayerNorm scales, BatchNorm running statistics and SS2D
parameters, so that every mapping of the bridge is exercised), then given
to both sides.

Tolerance: fp32 atol 1e-4 on outputs of order 1. Both sides compute in
fp32 with the same operation order in the scan; they differ in GEMM and
convolution summation order and in Flax's one-pass LayerNorm variance
(E[x^2] - E[x]^2) against torch's two-pass one, each a few ulps per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.models import vssm as jv
from mamba_clip_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from mamba_clip_tpu_torch.models import vssm as tv

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

ATOL = 1e-4


def _fill(shapes, seed):
    """numpy values for a Flax variable tree of ShapeDtypeStructs."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("x_proj_weight", "dt_projs_weight"):
            v = rs.randn(*shape) / np.sqrt(shape[-1])
        elif name == "dt_projs_bias":
            dt = rs.uniform(1e-3, 0.1, shape)
            v = dt + np.log(-np.expm1(-dt))
        elif name == "A_logs":
            v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rs.randn(*shape)
        elif name in ("scale", "Ds"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "var":
            v = rs.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rs.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _check(jax_module, port_module, x, seed=0, **apply_kw):
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _fill(shapes, seed)
    want = np.asarray(jax.jit(lambda v, x: jax_module.apply(v, x, **apply_kw))(
        variables, jnp.asarray(x)))
    load_jax_variables(port_module.eval(), variables)
    with torch.no_grad():
        got = port_module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return variables


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_ss2d_matches_flax():
    _check(jv.SS2D(d_model=16, scan_impl="xla"), tv.SS2D(d_model=16), _x((2, 6, 5, 16)))


def test_ssconvssm_matches_flax():
    variables = _check(jv.SSConvSSM(hidden_dim=32, scan_impl="xla"),
                       tv.SSConvSSM(hidden_dim=32), _x((2, 6, 6, 32)))
    assert "batch_stats" in variables


def test_patch_embed_matches_flax():
    _check(jv.PatchEmbed2D(embed_dim=16), tv.PatchEmbed2D(embed_dim=16),
           _x((2, 16, 16, 3)))


def test_patch_merging_matches_flax():
    _check(jv.PatchMerging2D(dim=8), tv.PatchMerging2D(dim=8), _x((2, 6, 6, 8)))


@pytest.mark.parametrize("num_classes", [3, 0])
def test_vssm_matches_flax(num_classes):
    kw = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=num_classes)
    _check(jv.VSSM(scan_impl="xla", **kw), tv.VSSM(**kw), _x((2, 32, 32, 3)))


def test_channel_shuffle_matches_flax():
    x = _x((2, 3, 3, 8))
    np.testing.assert_array_equal(
        tv.channel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jv.channel_shuffle(jnp.asarray(x), 2)))


def test_bridge_maps_every_layout():
    """Dense (in,out) -> (out,in); conv HWIO -> OIHW incl. depthwise;
    BatchNorm statistics -> running buffers."""
    shapes = jax.eval_shape(jv.SSConvSSM(hidden_dim=32, scan_impl="xla").init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32)))
    v = _fill(shapes, 0)
    sd = state_dict_from_jax(v)
    p, bs = v["params"], v["batch_stats"]
    np.testing.assert_array_equal(sd["self_attention.in_proj.weight"].numpy(),
                                  p["self_attention"]["in_proj"]["kernel"].T)
    assert tuple(sd["self_attention.conv2d.weight"].shape) == (32, 1, 3, 3)
    np.testing.assert_array_equal(
        sd["conv_branch.conv0.weight"].numpy(),
        p["ConvBranch_0"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["conv_branch.bn2.running_var"].numpy(),
                                  bs["ConvBranch_0"]["BatchNorm_2"]["var"])
    np.testing.assert_array_equal(sd["ln_1.weight"].numpy(), p["ln_1"]["scale"])


def test_init_mirrors_jax_distributions():
    """The port's own init (used on the card, where there is no JAX) draws
    the JAX inits' distributions: shapes match leaf for leaf, the fixed
    inits match exactly, the random ones in scale."""
    jm = jv.SS2D(d_model=32, scan_impl="xla")
    jvars = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32)))["params"]
    tm = tv.SS2D(d_model=32, generator=torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jvars)})
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for k in ("A_logs", "Ds"):
        torch.testing.assert_close(sd[k], ref[k])
    for k in ("in_proj.weight", "conv2d.weight", "x_proj_weight", "dt_projs_weight",
              "dt_projs_bias", "out_proj.weight"):
        s_port, s_jax = float(sd[k].std()), float(ref[k].std())
        assert abs(s_port - s_jax) <= 0.15 * s_jax, k
