"""The port's HTTP host (``serve_http.py``) against JAX's
(``tools/serve_http.py``), with its JPEG decode and its benchmarks.

- The decoders: the port's ``fastimage.decode_resize`` and
  ``_decode_to_square`` against JAX's, bit for bit, on JPEGs written here.
- The host: JAX's ``make_server`` is run over the same port artifact with
  ``load_serving`` swapped for the port's, so both hosts serve the same
  functions. Every answer (the 200s, the 404 and 400 bodies, a ``.npy``
  body's included, ``/healthz``) must be byte for byte JAX's.
- JPEG bodies answer as the loaded function does on the decoded square;
  concurrent requests coalesce (``/healthz`` batching stats);
  ``warm_buckets`` counts as JAX's; the sharded-artifact check gives JAX's
  message.
- ``bench_serving --tiny`` (0.5 s, clients 1,2) and ``bench_infer
  --artifact`` print their JSON lines; without PIL ``bench_serving``
  raises an error that names it.

Artifacts: full-width BiomedCLIP at image 32 and context 16 with the hash
tokenizer's vocabulary (the one full-width case), and medmamba at image
32; fp32, seed-0 weights.
"""

import http.client
import io
import json
import os
import re
import shutil
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from mamba_clip_tpu.data import fastimage as jfast
from mamba_clip_tpu.data.dataset import _decode_to_square as jax_decode_to_square
from mamba_clip_tpu_torch import bench_infer, bench_serving, serve_http
from mamba_clip_tpu_torch.data import fastimage as tfast
from mamba_clip_tpu_torch.data.dataset import _decode_to_square
from mamba_clip_tpu_torch.serve import MicroBatcher
from mamba_clip_tpu_torch.serving import export_serving, load_serving

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import serve_http as jax_http  # noqa: E402  (JAX's host, tools/serve_http.py)

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

KW = dict(precision="fp32", image_size=32)
TEXTS = ["a clinical photo of a skin lesion", "torso, 6 mm"]


def _jpeg(h, w, seed=0, mode="RGB"):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(*servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    d = tmp_path_factory.mktemp("http")
    export_serving(str(d / "clip"), "biomedclip", is_clip=True, context_length=16, **KW)
    export_serving(str(d / "mm"), "medmamba", **KW)
    yield {"clip": str(d / "clip"), "mm": str(d / "mm"), "dir": d}
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def hosts(arts):
    """{name: (the port's host, JAX's host)} over each artifact, one request
    a device call, both serving the port's loaded functions."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("mamba_clip_tpu.serving.load_serving",
                   lambda path: load_serving(path, device="cpu"))
        for name in ("clip", "mm"):
            out[name] = (_start(serve_http.make_server(arts[name], port=0, max_batch=1,
                                                       device="cpu")),
                         _start(jax_http.make_server(arts[name], port=0, max_batch=1)))
    yield out
    _stop(*[s for pair in out.values() for s in pair])


def test_decoders_equal_jax():
    assert tfast.available() == jfast.available()
    assert tfast.available()  # g++ and libjpeg are here
    assert tfast._SO.parent.parent.name == "build"
    blobs = [_jpeg(40, 56), _jpeg(96, 64, seed=1), _jpeg(301, 203, seed=2),
             _jpeg(64, 64, seed=3), _jpeg(50, 80, seed=4, mode="L")]
    for blob in blobs:
        for side in (32, 64, 256):
            got = tfast.decode_resize(blob, side)
            assert got.shape == (side, side, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, jfast.decode_resize(blob, side))
            pil = _decode_to_square(Image.open(io.BytesIO(blob)), side)
            np.testing.assert_array_equal(
                pil, jax_decode_to_square(Image.open(io.BytesIO(blob)), side))
    assert tfast.decode_resize(b"not a jpeg", 32) is None
    assert jfast.decode_resize(b"not a jpeg", 32) is None


def test_bodies_answer_as_the_loaded_functions(hosts):
    """JPEG bodies answer as the loaded function does on the decoded
    square, bit for bit; texts through the artifact's tokenizer."""
    for name, path, key, fn in (("clip", "/embed_image", "embedding", "image_embed"),
                                ("mm", "/classify", "probs", "classify")):
        srv = hosts[name][0]
        for jpeg in (_jpeg(48, 72, seed=5), _jpeg(80, 64, seed=6, mode="L")):
            x = srv.decode(jpeg)
            np.testing.assert_array_equal(x, tfast.decode_resize(jpeg, srv.staging))
            status, out = _request(srv, "POST", path, jpeg)
            assert status == 200, out
            got = np.asarray(json.loads(out)[key], np.float32)
            want = srv.served[fn](x[None])[0].numpy()
            np.testing.assert_array_equal(got, want)
    srv = hosts["clip"][0]
    status, out = _request(srv, "POST", "/embed_text", json.dumps({"texts": TEXTS}))
    assert status == 200, out
    got = np.asarray(json.loads(out)["embeddings"], np.float32)
    want = srv.served["text_embed"](srv.served["tokenize"](TEXTS)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_array_equal(got, want)


def test_answers_equal_jax_host(hosts):
    """Byte for byte JAX's answers: 200s, 404s, 400s (a ``.npy`` body's
    among them) and /healthz."""
    jpeg = _jpeg(40, 56, seed=7)
    address = re.compile(rb"0x[0-9a-f]+")
    cases = {
        "clip": [("GET", "/healthz", None), ("GET", "/nope", None),
                 ("POST", "/embed_image", jpeg),
                 ("POST", "/embed_text", json.dumps({"texts": TEXTS}).encode()),
                 ("POST", "/classify", jpeg), ("POST", "/nope", b""),
                 ("POST", "/embed_text", b"not json"),
                 ("POST", "/embed_text", json.dumps({"text": TEXTS}).encode()),
                 ("POST", "/embed_image", b"not a jpeg"),
                 ("POST", "/embed_image", _npy(np.zeros((64, 64, 3), np.uint8)))],
        "mm": [("GET", "/healthz", None), ("POST", "/classify", jpeg),
               ("POST", "/embed_image", jpeg), ("POST", "/embed_text", b"{}"),
               ("POST", "/classify", b"\xff\xd8 truncated")],
    }
    seen = set()
    for name, reqs in cases.items():
        port, jax_host = hosts[name]
        for method, path, body in reqs:
            got, want = _request(port, method, path, body), _request(jax_host, method, path,
                                                                     body)
            seen.add(got[0])
            # a PIL error names the address of its buffer object
            assert (got[0], address.sub(b"", got[1])) == \
                (want[0], address.sub(b"", want[1])), (name, method, path)
    assert seen == {200, 400, 404}
    health = json.loads(_request(hosts["clip"][0], "GET", "/healthz")[1])
    assert health["status"] == "ok" and health["batching"] == {}
    assert set(health["manifest"]["entry_points"]) == {"image_embed", "text_embed"}
    # a .npy body is no image to either host
    for bad in (np.zeros((64, 64, 3), np.uint8), np.zeros((32, 32, 3), np.float32)):
        got = _request(hosts["mm"][0], "POST", "/classify", _npy(bad))
        want = _request(hosts["mm"][1], "POST", "/classify", _npy(bad))
        assert got[0] == 400 and b"UnidentifiedImageError" in got[1]
        assert (got[0], address.sub(b"", got[1])) == (want[0], address.sub(b"", want[1]))


def test_no_decoder_is_a_400_that_names_them(hosts, monkeypatch):
    srv, jpeg = hosts["mm"][0], _jpeg(40, 40)
    monkeypatch.setattr(tfast, "decode_resize", lambda blob, side: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    status, out = _request(srv, "POST", "/classify", jpeg)
    assert status == 400
    assert b"fastimage" in out and b"PIL is not installed" in out


def test_concurrent_requests_coalesce(arts):
    """Eight concurrent requests through the MicroBatcher: fewer device
    calls than requests in /healthz, each answer the direct call's row
    (within 1e-6: another batch shape), and ``server_close`` stops the
    batchers' threads."""
    srv = _start(serve_http.make_server(arts["mm"], port=0, max_batch=8,
                                        max_delay_ms=300.0, device="cpu"))
    try:
        jpegs = [_jpeg(40 + 8 * i, 56, seed=8 + i) for i in range(8)]
        squares = np.stack([srv.decode(j) for j in jpegs])
        answers = [None] * 8
        barrier = threading.Barrier(8)

        def client(i):
            barrier.wait(timeout=30)
            answers[i] = _request(srv, "POST", "/classify", jpegs[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        direct = srv.served["classify"](squares).numpy()
        for i, (status, out) in enumerate(answers):
            assert status == 200, out
            np.testing.assert_allclose(json.loads(out)["probs"], direct[i], atol=1e-6, rtol=0)
        stats = json.loads(_request(srv, "GET", "/healthz")[1])["batching"]["classify"]
        assert stats["requests"] == 8 and 1 <= stats["batches"] < 8
        mb = srv.batchers["classify"]
        assert isinstance(mb, MicroBatcher) and sum(mb.batch_rows) >= 8
    finally:
        _stop(srv)
    assert srv.request_queue_size == 256
    assert not mb._thread.is_alive() and not mb._completer.is_alive()


def test_warm_buckets_counts_as_jax(hosts, arts):
    jpeg = _jpeg(40, 56, seed=9)
    port, jax_host = hosts["clip"]
    for max_batch in (1, 5, 16):
        want = jax_http.warm_buckets(jax_host, "image_embed", jpeg, max_batch)
        assert serve_http.warm_buckets(port, "image_embed", jpeg, max_batch) == want
    assert serve_http.warm_buckets(port, "text_embed", TEXTS, 3) == \
        jax_http.warm_buckets(jax_host, "text_embed", TEXTS, 3) == 3
    batching = serve_http.make_server(arts["mm"], port=0, max_batch=6, device="cpu")
    try:
        assert serve_http.warm_buckets(batching, "classify", jpeg, 6) == 4  # 1, 2, 4, 8
    finally:
        batching.server_close()


def test_sharded_artifact_refused_as_jax(arts, tmp_path):
    import jax

    n_jax = jax.local_device_count()
    with open(os.path.join(arts["mm"], "manifest.json")) as f:
        man = json.load(f)
    (tmp_path / "manifest.json").write_text(json.dumps(dict(man, data_shards=n_jax + 1)))
    with pytest.raises(ValueError) as got:
        serve_http.make_server(str(tmp_path), port=0, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_http.make_server(str(tmp_path), port=0)
    # each package counts its own devices: no card here, JAX's CPU devices
    assert str(got.value).replace("has 0 device(s)", f"has {n_jax} device(s)") == \
        str(want.value)


def test_bench_serving_prints_its_json(arts, capsys, monkeypatch):
    out = bench_serving.main(["--tiny", "--device", "cpu", "--clients", "1,2",
                              "--duration", "0.5", "--max-batch", "4",
                              "--max-delay-ms", "10", "--jpeg-size", "48"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["payload"] == "jpeg" and line["device"] == "cpu"
    assert [r["clients"] for r in line["rows"]] == [1, 2]
    for r in line["rows"]:
        assert r["requests"] > 0 and r["errors"] == 0 and r["req_per_s"] > 0
        assert r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
        assert r["mean_batch_fill"] >= 1.0
    # without PIL there is no JPEG to post: an error that names PIL
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="encodes with PIL, and PIL does not import"):
        bench_serving.main(["--artifact", arts["mm"], "--endpoint", "classify",
                            "--device", "cpu", "--clients", "2", "--duration", "0.5"])


def test_bench_infer_artifact_mode(arts, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_INFER_BATCH", "2")
    monkeypatch.setenv("BENCH_INFER_STEPS", "2")
    monkeypatch.setenv("BENCH_INFER_WARMUP", "1")
    bench_infer.main(["--artifact", arts["clip"], "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert {ln["metric"] for ln in lines} == {
        "infer_artifact_image_embed_images_per_sec_per_chip",
        "infer_artifact_text_embed_images_per_sec_per_chip"}
    assert all(ln["value"] > 0 and ln["batch"] == 2 and ln["device"] == "cpu"
               and ln["unit"] == "images/sec/chip" for ln in lines)
