"""Serving-under-load benchmark for the HTTP host (``serve_http.py``).

Counterpart of ``tools/bench_serving.py``: starts the server in-process
over an exported artifact, drives it with N concurrent closed-loop clients
posting one image (or one text) a request for a fixed duration, and
reports per concurrency the throughput, the latency percentiles and the
MicroBatcher's batch formation (requests per device call against
``--max-batch``). The image payload is a JPEG where PIL is importable,
else the ``.npy`` staging square (``serve_http``'s one wire addition); the
output says which was sent. Prints one line per concurrency, then the
result as one JSON line (also written to ``--json``).

Usage:
    python -m mamba_clip_tpu_torch.bench_serving --artifact DIR \\
        [--clients 1,4,16,32] [--duration 10] [--max-batch 16] \\
        [--max-delay-ms 5] [--endpoint embed_image] [--json out.json] \\
        [--device cuda|cpu]

    # self-contained smoke run (exports a small artifact into a tmpdir):
    python -m mamba_clip_tpu_torch.bench_serving --tiny --device cpu \\
        --clients 1,4 --duration 2
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np

_PATHS = {"image_embed": "/embed_image", "classify": "/classify",
          "text_embed": "/embed_text"}
TEXT = "a clinical photo of a skin lesion"


def _make_jpeg(size: int = 256, seed: int = 0) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def make_npy(staging: int, seed: int = 0) -> bytes:
    """A random uint8 (staging, staging, 3) square as a ``.npy`` body."""
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    np.save(buf, rng.integers(0, 256, (staging, staging, 3), dtype=np.uint8))
    return buf.getvalue()


def image_payload(jpeg_size: int, staging: int, seed: int = 0):
    """(body, content type, kind): a JPEG where PIL is importable, else the
    ``.npy`` staging square."""
    try:
        return _make_jpeg(jpeg_size, seed), "image/jpeg", "jpeg"
    except ImportError:
        return make_npy(staging, seed), "application/octet-stream", "npy"


def _client_loop(host, port, path, payload, headers, deadline, lats, errs):
    """Closed-loop client: one outstanding request at a time. Transport
    errors (reset/refused under burst) are counted and the connection is
    rebuilt -- a dead client thread would silently shrink offered load."""
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            try:
                conn.request("POST", path, body=payload, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
            except (ConnectionError, http.client.HTTPException, OSError) as e:
                errs.append(f"transport: {type(e).__name__}: {e}".encode())
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=120)
                continue
            dt = time.monotonic() - t0
            if resp.status == 200:
                lats.append(dt)
            else:
                errs.append(body[:200])
    finally:
        conn.close()


def _healthz(host, port):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def run_load(server, endpoint: str, payload: bytes, headers: dict,
             n_clients: int, duration: float, max_batch: int) -> dict:
    host, port = server.server_address[0], server.server_address[1]
    before = _healthz(host, port).get("batching", {}).get(endpoint, {})
    lats: list = []
    errs: list = []
    deadline = time.monotonic() + duration
    threads = [
        threading.Thread(
            target=_client_loop,
            args=(host, port, _PATHS[endpoint], payload, headers,
                  deadline, lats, errs),
            daemon=True)
        for _ in range(n_clients)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + 150)
    wall = time.monotonic() - t0
    after = _healthz(host, port).get("batching", {}).get(endpoint, {})
    if errs and not lats:
        raise RuntimeError(f"{len(errs)} failed requests; first: {errs[0]}")
    reqs = after.get("requests", 0) - before.get("requests", 0)
    calls = after.get("batches", 0) - before.get("batches", 0)
    arr = np.sort(np.asarray(lats))
    fill = reqs / calls if calls else float("nan")
    return {
        "clients": n_clients,
        "requests": len(lats),
        "errors": len(errs),
        "wall_s": wall,
        "req_per_s": len(lats) / wall,
        "p50_ms": float(np.percentile(arr, 50)) * 1e3,
        "p95_ms": float(np.percentile(arr, 95)) * 1e3,
        "p99_ms": float(np.percentile(arr, 99)) * 1e3,
        "device_calls": calls,
        "mean_batch_fill": fill,
        "batch_efficiency": fill / max_batch if calls else float("nan"),
    }


def device_name(device) -> str:
    """The card's name for a CUDA device, else the device type."""
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def export_tiny(out_dir: str) -> str:
    """Export a small artifact (full-width BiomedCLIP at image 32, context
    16, fp32) for self-contained smoke runs and tests."""
    from .serving import export_serving

    out = os.path.join(out_dir, "tiny_artifact")
    export_serving(out, "biomedclip", image_size=32, context_length=16,
                   precision="fp32")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="export a small artifact into a tmpdir first")
    ap.add_argument("--endpoint", default="image_embed", choices=sorted(_PATHS))
    ap.add_argument("--clients", default="1,4,16,32")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--in-flight", type=int, default=2,
                    help="outstanding device calls the batcher pipelines "
                         "(1 = synchronous dispatch)")
    ap.add_argument("--jpeg-size", type=int, default=256)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the entry points run: cuda (the card) or cpu")
    a = ap.parse_args(argv)

    tmp = None
    if a.tiny:
        tmp = tempfile.mkdtemp(prefix="serve_bench_")
        a.artifact = export_tiny(tmp)
    if not a.artifact:
        ap.error("--artifact or --tiny required")

    from .serve_http import make_server, warm_buckets

    server = make_server(a.artifact, port=0, max_batch=a.max_batch,
                         max_delay_ms=a.max_delay_ms, in_flight=a.in_flight,
                         device=a.device)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    try:
        if a.endpoint == "text_embed":
            payload = json.dumps({"texts": [TEXT]}).encode()
            headers = {"Content-Type": "application/json"}
            kind = "json"
        else:
            payload, ctype, kind = image_payload(a.jpeg_size, server.staging)
            headers = {"Content-Type": ctype}

        # every power-of-two bucket shape the batcher can dispatch once, then
        # one end-to-end HTTP request, outside the timed windows
        warm_payload = [TEXT] if a.endpoint == "text_embed" else payload
        t0 = time.monotonic()
        n_shapes = warm_buckets(server, a.endpoint, warm_payload, a.max_batch)
        print(f"warmed {n_shapes} bucket shapes in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        host, port = server.server_address[0], server.server_address[1]
        conn = http.client.HTTPConnection(host, port, timeout=600)
        try:
            conn.request("POST", _PATHS[a.endpoint], body=payload, headers=headers)
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"warm-up request answered {resp.status}: {body[:500]!r}")

        rows = []
        for n in [int(x) for x in str(a.clients).split(",") if x]:
            r = run_load(server, a.endpoint, payload, headers, n, a.duration,
                         a.max_batch)
            rows.append(r)
            print(f"clients={r['clients']:3d}  {r['req_per_s']:8.1f} req/s  "
                  f"p50={r['p50_ms']:7.1f} ms  p95={r['p95_ms']:7.1f} ms  "
                  f"p99={r['p99_ms']:7.1f} ms  "
                  f"fill={r['mean_batch_fill']:5.2f}/{a.max_batch} "
                  f"(eff={r['batch_efficiency']:.2f})"
                  + (f"  errors={r['errors']}" if r["errors"] else ""),
                  flush=True)
    finally:
        server.shutdown()
        server.server_close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    out = {"artifact": a.artifact, "endpoint": a.endpoint, "payload": kind,
           "device": device_name(a.device), "max_batch": a.max_batch,
           "max_delay_ms": a.max_delay_ms, "in_flight": a.in_flight,
           "duration_s": a.duration, "rows": rows}
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {a.json}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
