"""The VSSM decoder modules and the package API of the port, on the CPU.

- ``PatchExpand2D``, ``FinalPatchExpand2D`` and ``VSSLayerUp(upsample=True)``
  against the Flax modules, with the Flax variables (shaped by
  ``jax.eval_shape``, filled from a numpy seed as
  ``tests/test_torch_port_vssm.py`` fills them) carried over by
  ``convert.py``: outputs within 1e-5 (fp32) in eval mode and in training
  mode, where BatchNorm takes the batch's statistics and updates the
  running ones (``mutable=["batch_stats"]`` on the Flax side), those
  within 1e-5 too, and the input's gradient of the training-mode output
  within 1e-5 of its largest entry (entries up to about 6: a weighted sum
  over the output, summed in another order on each side);
- every name of the JAX package's ``__all__`` lists (the package and its
  ``data``, ``models``, ``ops``, ``parallel`` and ``utils``) imports from
  the port's (``ITEM_8``, the names left out while ROADMAP item 8 was
  open, is empty since the sequence-parallel scan was ported); the
  package's lazy submodules.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_vssm import _fill, _x

from mamba_clip_tpu.models import vssm as jv
from mamba_clip_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from mamba_clip_tpu_torch.models import vssm as tv

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

TOL = 1e-5
X = (2, 4, 4, 16)
CASES = {
    "patch_expand": (lambda: jv.PatchExpand2D(dim=8), lambda: tv.PatchExpand2D(dim=8),
                     (2, 8, 8, 8)),
    "final_patch_expand": (lambda: jv.FinalPatchExpand2D(dim=16, dim_scale=4),
                           lambda: tv.FinalPatchExpand2D(dim=16, dim_scale=4),
                           (2, 16, 16, 4)),
    "vss_layer_up": (lambda: jv.VSSLayerUp(dim=8, depth=2, d_state=4, upsample=True,
                                           scan_impl="xla"),
                     lambda: tv.VSSLayerUp(dim=8, depth=2, d_state=4, upsample=True),
                     (2, 8, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_module_matches_flax(case):
    make_j, make_t, out_shape = CASES[case]
    jm, tm = make_j(), make_t()
    x = _x(X)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _fill(shapes, 0)
    load_jax_variables(tm, variables)

    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == out_shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    # training mode: BatchNorm on the batch's statistics, the running ones
    # updated; the input's gradient of a weighted sum of the output
    w = _x(out_shape, seed=2)

    def jloss(x):
        kw = {"deterministic": False} if case == "vss_layer_up" else {}
        out, upd = jm.apply(variables, x, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
        return jnp.sum(out * w), (out, upd)

    (_, (want, upd)), want_dx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm.train()(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    want_dx = np.asarray(want_dx)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=TOL * np.abs(want_dx).max(),
                               rtol=0)
    stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, upd.get("batch_stats", {}))})
    assert (len(stats) > 0) == (case == "vss_layer_up")
    sd = tm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=TOL, rtol=0, err_msg=k)


def test_decoder_parameters_map_both_ways():
    """Every decoder parameter has its Flax leaf (``expand`` a Dense kernel,
    ``norm`` a LayerNorm) and the shapes agree with Flax's."""
    from mamba_clip_tpu_torch.convert import flax_shapes

    jm = jv.VSSLayerUp(dim=8, depth=1, d_state=4, upsample=True, scan_impl="xla")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(X))["params"]
    want = {"/".join(k.key for k in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = flax_shapes(tv.VSSLayerUp(dim=8, depth=1, d_state=4, upsample=True))
    assert got == want
    assert got["upsample/expand/kernel"] == (16, 32) and got["upsample/norm/scale"] == (8,)


JAX_ALL = ["", "data", "models", "ops", "parallel", "utils"]
ITEM_8 = {}


@pytest.mark.parametrize("sub", JAX_ALL)
def test_every_jax_export_imports_from_the_port(sub):
    jmod = importlib.import_module("mamba_clip_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("mamba_clip_tpu_torch" + (f".{sub}" if sub else ""))
    absent = ITEM_8.get(sub, set())
    want = set(jmod.__all__) - absent
    missing = sorted(n for n in want if not hasattr(tmod, n))
    assert missing == []
    assert want <= set(tmod.__all__)
    for n in absent:
        assert not hasattr(tmod, n) and n not in tmod.__all__
    ns = {}
    exec(f"from {tmod.__name__} import *", ns)
    assert want <= set(ns)


def test_package_lazy_submodules():
    import mamba_clip_tpu as jp
    import mamba_clip_tpu_torch as tp

    for name in jp._LAZY:
        assert getattr(tp, name).__name__ == f"mamba_clip_tpu_torch.{name}"
    assert tp.integrations.__name__ == "mamba_clip_tpu_torch.integrations"
    with pytest.raises(AttributeError):
        tp.not_a_module
    assert tp.parse_args(["--lr", "3e-4"]).lr == 3e-4 and tp.Args().seed == 0
