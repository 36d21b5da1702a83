"""Data-sharded serving artifacts of the port (``export_serving(...,
data_shards=S)``, ``load_serving(..., devices=)``) and the HTTP host over
them, on the CPU.

Modelled on JAX's ``tests/test_serving.py::test_data_parallel_export`` and
``::test_http_host_sharded_artifact``. Full-width BiomedCLIP at JAX's
``_tiny_clip_kw`` sizes (image 32, context 16; vocab 128) and medmamba at
image 32, fp32, their JAX variables shaped by ``jax.eval_shape`` and
filled from a numpy seed (``test_torch_port_artifacts._shaped_init``),
carried over by ``convert.py``; the port exports each at S = 1 and S = 4
from the same weights and loads the S = 4 one with ``devices=["cpu"] * 4``.

Gates: the manifest records ``data_shards`` 4 and ``"4*b"``; at batch 16
the S = 4 entry points equal the S = 1 artifact run on each 4-row slice bit
for bit (the same shapes, so the same sums), and ``image_embed`` and
``classify`` are within 5e-5 (JAX's bound) of JAX's S = 1 entry points,
the functions its S = 1 export serializes, jitted at the test's batch:
exporting them with the symbolic batch takes about 46 s for medmamba and
17 s for the CLIP on a CPU, the jit 5 s, and
``tests/test_torch_port_artifacts.py`` holds the port's S = 1 artifacts
against JAX's exported ones. A batch of 10 raises ``ValueError`` naming
``data_shards``. The host pads every dispatch to a multiple of 4 (also at
``max_batch`` 1), warms the buckets {4, 8, 16}, and answers a JPEG as the
S = 1 host does.
"""

import functools
import io
import json
import shutil
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn
from PIL import Image
from test_torch_port_artifacts import _shaped_init

from mamba_clip_tpu.serving import make_serving_fns as jax_make_serving_fns
from mamba_clip_tpu_torch import serve_http
from mamba_clip_tpu_torch.convert import load_jax_variables
from mamba_clip_tpu_torch.serve import MicroBatcher
from mamba_clip_tpu_torch.serving import export_serving, load_serving, make_serving_fns

torch.set_num_threads(1)

SHARDS, BATCH = 4, 16
CLIP_KW = dict(precision="fp32", image_size=32, context_length=16, vocab_size=128)
MM_KW = dict(precision="fp32", image_size=32, scan_impl="xla")
JAX_ATOL = 5e-5


def _export(tmp, name, model_name, kw, seed):
    """JAX's S = 1 entry points (jitted), and the port's S = 1 and S = 4
    exports of the same weights, loaded (the S = 4 one on four CPU
    devices)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _shaped_init(seed))
        _, jvars, jfns, _ = jax_make_serving_fns(model_name, **kw)
        jvars = jax.tree_util.tree_map(np.asarray, jvars)
    jax_fns = {k: functools.partial(jax.jit(f), jvars) for k, f in jfns.items()}
    port_kw = {k: v for k, v in kw.items() if k != "scan_impl"}
    model, _, meta = make_serving_fns(model_name, device="cpu", attn_impl="flash", **port_kw)
    load_jax_variables(model, jvars)
    dirs = {}
    for S in (1, SHARDS):
        dirs[S] = str(tmp / f"{name}_s{S}")
        export_serving(dirs[S], model_name, variables=model.state_dict(), data_shards=S,
                       **port_kw)
    return {"jax": jax_fns, "dirs": dirs, "meta": meta,
            1: load_serving(dirs[1], device="cpu"),
            SHARDS: load_serving(dirs[SHARDS], devices=["cpu"] * SHARDS)}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serving")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def clip(work):
    return _export(work, "clip", "biomedclip", CLIP_KW, seed=0)


@pytest.fixture(scope="module")
def mm(work):
    return _export(work, "mm", "medmamba", MM_KW, seed=4)


def _inputs(entry, meta, n, seed):
    rs = np.random.RandomState(seed)
    if entry == "text_embed":
        return rs.randint(1, 128, (n, meta["context_length"])).astype(np.int32)
    s = meta["staging_size"]
    return rs.randint(0, 256, (n, s, s, 3)).astype(np.uint8)


CASES = [("clip", "image_embed"), ("clip", "text_embed"), ("mm", "classify")]


@pytest.mark.parametrize("which,entry", CASES)
def test_manifest_records_the_shards(request, which, entry):
    art = request.getfixturevalue(which)
    man = art[SHARDS]["manifest"]
    assert man["data_shards"] == SHARDS
    assert man["entry_points"][entry]["input_shape"][0] == f"{SHARDS}*b"
    assert art[1]["manifest"]["entry_points"][entry]["input_shape"][0] == "b"


@pytest.mark.parametrize("which,entry", CASES)
def test_sharded_equals_unsharded_slices(request, which, entry):
    art = request.getfixturevalue(which)
    x = _inputs(entry, art["meta"], BATCH, seed=5)
    got = art[SHARDS][entry](x).numpy()
    k = BATCH // SHARDS
    want = np.concatenate([art[1][entry](x[i * k:(i + 1) * k]).numpy()
                           for i in range(SHARDS)])
    assert got.shape == want.shape and np.array_equal(got, want)
    if entry != "text_embed":  # JAX's test holds the image entry points
        ref = np.asarray(art["jax"][entry](x))
        np.testing.assert_allclose(got, ref, atol=JAX_ATOL, rtol=0)


@pytest.mark.parametrize("which,entry", CASES)
def test_indivisible_batch_raises(request, which, entry):
    art = request.getfixturevalue(which)
    with pytest.raises(ValueError, match=f"data_shards={SHARDS}"):
        art[SHARDS][entry](_inputs(entry, art["meta"], 10, seed=6))


def _jpeg(seed=0):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (48, 56, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _post(srv, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(*servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def test_http_host_sharded_artifact(clip):
    blob = _jpeg(seed=3)
    sharded = _serve(serve_http.make_server(clip["dirs"][SHARDS], port=0, max_batch=16,
                                            max_delay_ms=1.0, device="cpu"))
    try:
        assert sharded.batchers["image_embed"].pad_multiple == SHARDS
        assert serve_http.warm_buckets(sharded, "image_embed", blob, 16) == 3  # {4, 8, 16}
        code, got = _post(sharded, "/embed_image", blob)
        assert code == 200 and len(got["embedding"]) == 512
        # the S = 1 host's answer: one request, one row, a batch of 1; the
        # sharded host's slice of the padded batch is that row alone
        want = clip[1]["image_embed"](sharded.decode(blob)[None])[0]
        assert got["embedding"] == want.tolist()
    finally:
        _stop(sharded)


def test_http_host_sharded_pads_at_max_batch_1(mm):
    srv = _serve(serve_http.make_server(mm["dirs"][SHARDS], port=0, max_batch=1,
                                        device="cpu"))
    try:
        b = srv.batchers["classify"]
        assert isinstance(b, MicroBatcher) and b.pad_multiple == SHARDS
        code, got = _post(srv, "/classify", _jpeg(seed=4))
        assert code == 200 and len(got["probs"]) == 2
        assert b.batch_rows == [SHARDS]
    finally:
        _stop(srv)
