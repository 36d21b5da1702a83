"""Cross-request micro-batching for the serving entry points.

A copy of ``_bucket`` and ``MicroBatcher`` from ``tools/serve_http.py``:
concurrent requests are coalesced into one device call, padded to a power
of two, and the results fanned back out. The HTTP host over them, with its
JPEG decode, is ``serve_http.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

_STOP = object()


def _bucket(n: int, pad_multiple: int = 1) -> int:
    """Next power-of-two >= n, rounded up to a multiple of pad_multiple."""
    m = 1 << (max(n, 1) - 1).bit_length()
    if m % pad_multiple:
        m = -(-m // pad_multiple) * pad_multiple
    return m


def _to_numpy(out) -> np.ndarray:
    """Materialize a result on the host; for a CUDA tensor this waits for
    the device call to finish."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class MicroBatcher:
    """Coalesce concurrent row-batches into one device call.

    Items are arrays with a leading batch dim (k >= 1 rows). The
    dispatcher thread concatenates queued items (up to ``max_batch``
    total rows, waiting at most ``max_delay_ms`` after the first), pads
    to the next power-of-two row count (rounded up to ``pad_multiple``),
    runs ``fn`` once and splits the output back per request. Exceptions
    propagate to every coalesced caller.

    ``in_flight`` > 1 pipelines dispatch: CUDA launches are asynchronous,
    so the dispatcher enqueues the device call and moves on to forming the
    next batch while a completion thread copies results back in order.
    ``in_flight=1`` restores fully synchronous dispatch. ``close()`` stops
    both threads."""

    def __init__(self, fn, max_batch: int = 16, max_delay_ms: float = 5.0,
                 pad_multiple: int = 1, in_flight: int = 2):
        self.fn = fn
        self.max_batch = max(int(max_batch), 1)
        self.pad_multiple = max(int(pad_multiple), 1)
        self.max_delay = max(float(max_delay_ms), 0.0) / 1e3
        self.q: "queue.Queue" = queue.Queue()
        self.requests = 0
        self.batches = 0
        self.batch_rows: list = []  # padded row count of each dispatched batch
        self._sem = threading.BoundedSemaphore(max(int(in_flight), 1))
        self._done_q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._completer.start()

    def __call__(self, item: np.ndarray) -> np.ndarray:
        fut: Future = Future()
        self.q.put((np.asarray(item), fut))
        return fut.result(timeout=120.0)

    def close(self, timeout: float = 30.0) -> None:
        """Finish the queued requests, then stop both threads."""
        self.q.put(_STOP)
        self._thread.join(timeout)
        self._completer.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self):
        stopping = False
        while not stopping:
            first = self.q.get()
            if first is _STOP:
                break
            batch = [first]
            rows = first[0].shape[0]
            deadline = time.monotonic() + self.max_delay
            while rows < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                batch.append(nxt)
                rows += nxt[0].shape[0]
            items = np.concatenate([b[0] for b in batch], axis=0)
            n = items.shape[0]
            m = _bucket(n, self.pad_multiple)  # pad: bounded set of shapes
            if m != n:
                items = np.concatenate(
                    [items, np.repeat(items[-1:], m - n, axis=0)], axis=0)
            self._sem.acquire()  # bound outstanding device calls
            try:
                out = self.fn(items)  # async dispatch (not materialized)
            except Exception as e:
                self._sem.release()
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._done_q.put((out, batch, m))
        self._done_q.put(_STOP)

    def _complete_loop(self):
        while True:
            entry = self._done_q.get()
            if entry is _STOP:
                return
            out, batch, m = entry
            try:
                out = _to_numpy(out)  # blocks until the call finishes
                self.batches += 1
                self.requests += len(batch)
                self.batch_rows.append(m)
                off = 0
                for arr, fut in batch:
                    k = arr.shape[0]
                    fut.set_result(out[off:off + k])
                    off += k
            except Exception as e:  # fan the failure out to every caller
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                self._sem.release()
