"""The port's whole serving slice against the JAX package.

JAX ``make_serving_fns("medmamba", precision="fp32", image_size=32,
scan_impl="xla")`` -- the full-width medmamba (dims 64-512, depths
2/2/8/2) at a small image -- against the port's on ``device="cpu"``, with
the JAX weights carried over by convert.py and random BatchNorm
statistics. Tolerance: probabilities within atol 1e-4 (fp32 on both sides;
14 blocks of the per-layer differences that test_torch_port_vssm.py bounds
at 1e-4 in the activations, squashed by the softmax).

Also: ``MicroBatcher`` coalescing and fan-out, the bridge's refusal of a
missing or extra leaf, the entry points' refusals, and that the port
imports neither JAX nor the JAX package.
"""

import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.serving import make_serving_fns as jax_make_serving_fns
from mamba_clip_tpu_torch.convert import load_jax_variables
from mamba_clip_tpu_torch.models import build_classifier
from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_fwd
from mamba_clip_tpu_torch.serve import MicroBatcher, _bucket
from mamba_clip_tpu_torch.serving import make_serving_fns

ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_pair():
    """(jax classify, jax variables, port model, port classify, meta)."""
    _, jvars, jfns, jmeta = jax_make_serving_fns(
        "medmamba", precision="fp32", image_size=32, scan_impl="xla")
    rs = np.random.RandomState(5)

    def stat(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rs.randn(*a.shape)).astype(np.float32)

    jvars = {"params": jax.tree_util.tree_map(np.asarray, jvars["params"]),
             "batch_stats": jax.tree_util.tree_map_with_path(stat, jvars["batch_stats"])}
    model, fns, meta = make_serving_fns(
        "medmamba", precision="fp32", image_size=32, device="cpu")
    load_jax_variables(model, jvars)
    return jax.jit(jfns["classify"]), jvars, model, fns["classify"], meta, jmeta


def _images(n, seed=0, size=36):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


def test_classify_matches_jax(slice_pair):
    jclassify, jvars, model, classify, meta, jmeta = slice_pair
    assert meta == jmeta
    imgs = _images(2, size=meta["staging_size"])
    want = np.asarray(jclassify(jvars, jnp.asarray(imgs)))
    got = classify(model, imgs)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
    assert selective_scan_fwd.launches == 0  # the CPU takes the plain scan


def test_microbatcher_pads_and_fans_out(slice_pair):
    _, _, model, classify, meta, _ = slice_pair
    imgs = _images(8, seed=1, size=meta["staging_size"])
    direct = classify(model, imgs).numpy()
    results = [None] * 8
    with MicroBatcher(lambda x: classify(model, x), max_batch=16,
                      max_delay_ms=200.0) as mb:
        barrier = threading.Barrier(8)

        def client(i):
            barrier.wait(timeout=30)
            results[i] = mb(imgs[i:i + 1])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert mb.requests == 8
    assert all(m in (1, 2, 4, 8) for m in mb.batch_rows)
    assert sum(mb.batch_rows) >= 8
    for i in range(8):
        assert results[i].shape == (1, 2)
        np.testing.assert_allclose(results[i][0], direct[i], atol=1e-6, rtol=0)


def test_microbatcher_fans_exceptions_out():
    def boom(x):
        raise RuntimeError("device fault")

    with MicroBatcher(boom, max_batch=4, max_delay_ms=1.0) as mb:
        with pytest.raises(RuntimeError, match="device fault"):
            mb(np.zeros((1, 2), np.float32))


@pytest.mark.parametrize("n,mult,want", [(1, 1, 1), (3, 1, 4), (5, 1, 8),
                                         (16, 1, 16), (3, 3, 6), (0, 1, 1)])
def test_bucket(n, mult, want):
    assert _bucket(n, mult) == want


def test_bridge_refuses_missing_and_extra_leaves(slice_pair):
    _, jvars, model, _, _, _ = slice_pair
    params = dict(jvars["params"])
    head = params.pop("head")
    with pytest.raises(KeyError, match="missing.*head.weight"):
        load_jax_variables(model, {"params": params, "batch_stats": jvars["batch_stats"]})
    params["head"] = head
    params["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unexpected.*stray.weight"):
        load_jax_variables(model, {"params": params, "batch_stats": jvars["batch_stats"]})
    bad = dict(params, head={"kernel": head["kernel"], "bias": head["bias"],
                             "gamma": np.zeros(2, np.float32)})
    bad.pop("stray")
    with pytest.raises(KeyError, match="unmapped params leaf"):
        load_jax_variables(model, {"params": bad, "batch_stats": jvars["batch_stats"]})
    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(model, {**jvars, "cache": {}})


def test_entry_points_refuse_unported_modes():
    with pytest.raises(NotImplementedError, match="Quantized modes"):
        make_serving_fns("biomedclip", quant="int8_serve", device="cpu")
    with pytest.raises(ValueError, match="einsum|flash"):
        make_serving_fns("biomedclip", attn_impl="bogus", device="cpu")
    with pytest.raises(ValueError, match="TRAINING mode"):
        make_serving_fns("medmamba", quant="int8_delayed", device="cpu")
    with pytest.raises(NotImplementedError, match="Quantized modes"):
        build_classifier("medmamba", quant="int8_serve")
    with pytest.raises(ValueError, match="unknown precision"):
        make_serving_fns("medmamba", precision="bogus", device="cpu")


def test_precision_policies_match_jax():
    from mamba_clip_tpu.utils import precision as jp
    from mamba_clip_tpu_torch.utils import precision as tp

    assert sorted(tp._POLICIES) == sorted(jp._POLICIES)
    for name, jpol in jp._POLICIES.items():
        tpol = tp.get_policy(name)
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(tpol, field)).removeprefix("torch.") == \
                jnp.dtype(getattr(jpol, field)).name
        assert (tpol.loss_scale, tpol.dynamic_loss_scale) == (
            jpol.loss_scale, jpol.dynamic_loss_scale)
    with pytest.raises(ValueError) as t_err:
        tp.get_policy("bogus")
    with pytest.raises(ValueError) as j_err:
        jp.get_policy("bogus")
    assert str(t_err.value) == str(j_err.value)


def test_mambavision_classifier_bridge():
    """``*mamba*`` names build MambaVisionClassifier; its tree maps too."""
    from mamba_clip_tpu.models import build_classifier as jax_build

    jm = jax_build("mambavision", num_classes=3, scan_impl="xla")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = build_classifier("mambavision", num_classes=3)
    load_jax_variables(model, variables)
    assert float(model.fc.weight.detach().abs().sum()) == 0.0


def test_port_imports_no_jax():
    """Every module of the port imports with JAX, Flax and the JAX package
    made unimportable, and none of them is loaded afterwards."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BANNED = ('jax', 'jaxlib', 'flax', 'mamba_clip_tpu')\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in BANNED]:\n"
        "    del sys.modules[k]\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BANNED:\n"
        "            raise ImportError('port imports ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mamba_clip_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not [k for k in sys.modules if k.split('.')[0] in BANNED]\n"
        "print(len(names))\n"
    )
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
