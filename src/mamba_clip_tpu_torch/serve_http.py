"""HTTP serving host over an exported artifact (standard library only).

Counterpart of ``tools/serve_http.py``: load an ``export_serving`` artifact
directory (``mamba_clip_tpu_torch.export_serving``) with
``serving.load_serving`` and serve it over HTTP.

Endpoints (per the artifact's entry points):

- ``GET  /healthz``      -> ``{"status": "ok", "manifest": {...},
  "batching": {entry point: {"requests": n, "batches": n}}}``
- ``POST /embed_image``  -> body = JPEG bytes -> ``{"embedding": [512]}``
- ``POST /embed_text``   -> body = ``{"texts": [...]}`` ->
  ``{"embeddings": [[512], ...]}`` (tokenized with the artifact's
  tokenizer)
- ``POST /classify``     -> body = JPEG bytes -> ``{"probs": [C]}``

A JPEG decodes through the native libjpeg path (``data/fastimage.py``),
else PIL, into the staging square the artifact's on-device eval preprocess
expects. Any failure in a request is answered with a 400 that names it, as
JAX's host answers it.

Concurrent requests are coalesced into one device call per entry point by
``serve.MicroBatcher`` (up to ``--max-batch`` rows, waiting at most
``--max-delay-ms`` after the first, padded to a power of two);
``--max-batch 1`` calls the entry point directly for each request.

Usage:
    python -m mamba_clip_tpu_torch.serve_http --artifact DIR [--port 8000] \\
        [--max-batch 16] [--max-delay-ms 5] [--device cuda|cpu]
    curl -s -X POST --data-binary @lesion.jpg :8000/embed_image
"""

from __future__ import annotations

import argparse
import io
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .serve import MicroBatcher, _bucket, _to_numpy

_ENTRY_POINTS = ("image_embed", "text_embed", "classify")


def make_server(artifact: str, port: int = 0, host: str = "127.0.0.1",
                max_batch: int = 16, max_delay_ms: float = 5.0,
                in_flight: int = 2, device: str | torch.device = "cuda"):
    """Build (not start) a ThreadingHTTPServer over the artifact dir, its
    entry points on ``device`` (the card unless the caller asks for the
    CPU).

    ``max_batch``/``max_delay_ms``/``in_flight`` tune the cross-request
    MicroBatcher; ``max_batch=1`` dispatches each request directly.
    ``server_close()`` also stops the batchers' threads."""
    from .data import fastimage
    from .data.dataset import _decode_to_square
    from .serving import load_serving

    # check the manifest before load_serving, as JAX's host does
    with open(os.path.join(artifact, "manifest.json")) as f:
        shards = int(json.load(f).get("data_shards", 1))
    if shards > 1 and torch.cuda.device_count() < shards:
        raise ValueError(
            f"artifact exported with data_shards={shards} but this "
            f"host has {torch.cuda.device_count()} device(s); export "
            f"with --data-shards 1 for this host (or serve on a "
            f"{shards}-device host)"
        )
    served = load_serving(artifact, device=device)
    manifest = served["manifest"]
    staging = int(manifest["staging_size"])

    if max_batch > 1:
        batchers = {
            name: MicroBatcher(served[name], max_batch, max_delay_ms,
                               pad_multiple=shards, in_flight=in_flight)
            for name in _ENTRY_POINTS if name in served
        }
    else:
        batchers = {name: (lambda x, f=served[name]: _to_numpy(f(x)))
                    for name in _ENTRY_POINTS if name in served}

    def decode(blob: bytes) -> np.ndarray:
        out = fastimage.decode_resize(blob, staging)
        if out is None:
            try:
                from PIL import Image
            except ImportError as e:
                raise RuntimeError(
                    "cannot decode the JPEG body: the native decoder (fastimage, "
                    "libjpeg) is unavailable and PIL is not installed") from e
            out = _decode_to_square(Image.open(io.BytesIO(blob)), staging)
        return out

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                stats = {
                    name: {"requests": b.requests, "batches": b.batches}
                    for name, b in batchers.items()
                    if isinstance(b, MicroBatcher)
                }
                self._json(200, {"status": "ok", "manifest": manifest,
                                 "batching": stats})
            else:
                self._json(404, {"error": f"no handler for GET {self.path}"})

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.path == "/embed_image" and "image_embed" in served:
                    out = np.asarray(
                        batchers["image_embed"](decode(body)[None]))[0]
                    self._json(200, {"embedding": out.tolist()})
                elif self.path == "/embed_text" and "text_embed" in served:
                    texts = json.loads(body)["texts"]
                    ids = np.asarray(served["tokenize"](texts))
                    out = np.asarray(batchers["text_embed"](ids))
                    self._json(200, {"embeddings": out.tolist()})
                elif self.path == "/classify" and "classify" in served:
                    probs = np.asarray(
                        batchers["classify"](decode(body)[None]))[0]
                    self._json(200, {"probs": probs.tolist()})
                else:
                    self._json(
                        404, {"error": f"no handler for POST {self.path} "
                                       f"(entry points: "
                                       f"{sorted(manifest['entry_points'])})"})
            except Exception as e:  # surface as a client-visible error
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet server; health is /healthz
            pass

    class Server(ThreadingHTTPServer):
        # the standard library's backlog of 5 resets a burst of concurrent
        # connects instead of queueing them
        request_queue_size = 256

        def server_close(self):
            super().server_close()
            for b in batchers.values():
                if isinstance(b, MicroBatcher):
                    b.close()

    srv = Server((host, port), Handler)
    # internals for warm-up and measurement harnesses (bench_serving.py)
    srv.batchers = batchers
    srv.served = served
    srv.decode = decode
    srv.staging = staging
    return srv


def warm_buckets(server, endpoint: str, payload, max_batch: int) -> int:
    """Run every power-of-two batch shape the MicroBatcher can dispatch for
    ``endpoint`` (1, 2, 4, ... up to the bucket covering ``max_batch``)
    once, bypassing the queue, so that library set-up and allocator growth
    land outside a timed window. ``payload`` is a body for an image
    endpoint (a JPEG) or a list[str] for text. Returns the number
    of shapes warmed."""
    if endpoint == "text_embed":
        row = np.asarray(server.served["tokenize"](list(payload)))[:1]
    else:
        row = server.decode(payload)[None]
    b = server.batchers[endpoint]
    if isinstance(b, MicroBatcher):
        fn, padm = b.fn, b.pad_multiple
    else:
        fn, padm = b, 1
    top = 1 << (max(int(max_batch), 1) - 1).bit_length()
    shapes, m = set(), 1
    while m <= top:
        shapes.add(_bucket(m, padm))
        m <<= 1
    for s in sorted(shapes):
        _to_numpy(fn(np.repeat(row, s, axis=0)))
    return len(shapes)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True,
                   help="exported serving dir (mamba_clip_tpu_torch.export_serving)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=16,
                   help="max rows coalesced into one device call "
                        "(1 = dispatch each request directly)")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="max wait after the first queued request before "
                        "dispatching a partial batch")
    p.add_argument("--in-flight", type=int, default=2,
                   help="outstanding device calls the batcher pipelines "
                        "(1 = synchronous dispatch)")
    p.add_argument("--device", default="cuda",
                   help="where the entry points run: cuda (the card) or cpu")
    a = p.parse_args(argv)
    srv = make_server(a.artifact, port=a.port, host=a.host,
                      max_batch=a.max_batch, max_delay_ms=a.max_delay_ms,
                      in_flight=a.in_flight, device=a.device)
    print(f"serving {a.artifact} on http://{a.host}:{srv.server_address[1]}",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
