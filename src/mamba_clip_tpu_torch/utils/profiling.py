"""Device time of a traced step, attributed by kernel class.

Counterpart of ``mamba_clip_tpu/utils/profiling.py``. ``--trace`` makes
``train_one_epoch`` write a ``torch.profiler`` Chrome trace
(``<trace_dir>/trace.json``), as ``profile_step`` does; this module reads
the newest such trace and turns its device events into the attribution
table of PERF.md, without TensorBoard:

- :func:`load_device_op_times`: device microseconds by kernel name, summed
  over the traced steps, from the events of categories ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` (one device: the busiest, where the
  trace holds several); :func:`load_device_op_launches` the launches by
  name;
- :func:`classify_op`: a kernel's class, by its name;
- :func:`attribute` and :func:`format_attribution`: the JAX package's
  arithmetic and layout (ms a step, share, kernels a step, class).
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

__all__ = [
    "load_device_op_times",
    "load_device_op_launches",
    "classify_op",
    "attribute",
    "format_attribution",
]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

HAND_WRITTEN = "hand-written kernel (csrc/)"
# The JAX package classes XLA's fusions by the shapes of their HLO outputs,
# since a fusion's name says nothing of what it computes. A CUDA kernel's
# name does: the library and the operation are in it. So the classes here
# are by name, first match wins.
_NAME_CLASSES: List[Tuple[str, str]] = [
    (r"\b(selective_scan_(fwd|bwd)|flash_attn_(fwd|bwd_dkv|bwd_dq)(_tc)?|vpu_chain)_kernel\b",
     HAND_WRITTEN),
    (r"(?i)nccl", "NCCL collective"),
    (r"(?i)gemm|gemv|cutlass|cublas|cudnn|nvjet|xmma|conv(?!ert)|dgrad|wgrad|fprop",
     "GEMM / convolution (cuBLAS, cuDNN, CUTLASS)"),
    (r"multi_tensor_apply|foreach", "optimizer (foreach / multi-tensor)"),
    (r"(?i)^mem(cpy|set)|copy|transpose|permute|CatArray|cat_|index|gather|scatter"
     r"|im2col|col2im|flip|pad|nchwToNhwc|nhwcToNchw", "layout / copy"),
    (r"(?i)reduce|softmax|norm|welford|argmax|cub::|scan", "reduction"),
    (r"elementwise", "elementwise"),
]


def _device_events(trace_dir: str) -> List[dict]:
    """The device events (``DEVICE_CATEGORIES``) of the newest Chrome trace
    under ``trace_dir``, of one device: the busiest where there are
    several."""
    files = sorted(
        [f for pat in ("*trace.json", "*trace.json.gz")
         for f in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)],
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no *trace.json or *trace.json.gz under {trace_dir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    per_pid = collections.Counter()
    for e in device:
        per_pid[e["pid"]] += e.get("dur", 0)
    if len(per_pid) > 1:
        # ms on one card: summing the cards of a multi-card trace would
        # count a step's time once a card
        busiest = per_pid.most_common(1)[0][0]
        device = [e for e in device if e["pid"] == busiest]
    return device


def load_device_op_times(trace_dir: str) -> Dict[str, float]:
    """Device time in microseconds by kernel name (``{name: total_us}``),
    summed over every traced step, from the newest ``*trace.json`` (or
    ``.gz``) under ``trace_dir``; ``FileNotFoundError`` where there is
    none."""
    agg: Dict[str, float] = collections.defaultdict(float)
    for e in _device_events(trace_dir):
        agg[e["name"]] += e.get("dur", 0)
    return dict(agg)


def load_device_op_launches(trace_dir: str) -> Dict[str, int]:
    """Launches by kernel name over every traced step, from the trace
    :func:`load_device_op_times` reads."""
    return dict(collections.Counter(e["name"] for e in _device_events(trace_dir)))


def classify_op(name: str) -> str:
    """The class of a device event by its kernel name: the hand-written
    kernels of ``csrc/``, NCCL, GEMMs and convolutions, the optimizer's
    foreach kernels, layout and copies (memcpy, memset, transposes,
    concatenations, indexing), reductions (and the normalizations and
    softmax, which reduce), elementwise, or other."""
    for pat, label in _NAME_CLASSES:
        if re.search(pat, name):
            return label
    return "other"


def attribute(
    op_times_us: Dict[str, float],
    steps: int = 1,
    launches: Optional[Dict[str, int]] = None,
) -> List[Tuple[str, float, int]]:
    """``[(class, ms_per_step, kernels)]``, costliest first. Times are
    summed over the traced steps, so ms divides by ``steps``. ``kernels``
    is the class's launches a step where ``launches`` (by name, over the
    traced steps) is given, else the number of distinct names in it (a
    CUDA kernel's name repeats within a step, where an XLA op's is
    unique)."""
    agg = collections.Counter()
    cnt = collections.Counter()
    for name, us in op_times_us.items():
        c = classify_op(name)
        agg[c] += us
        cnt[c] += 1 if launches is None else launches.get(name, 0)
    if launches is not None:
        cnt = {c: int(round(n / steps)) for c, n in cnt.items()}
    return [(c, us / steps / 1e3, cnt[c]) for c, us in agg.most_common()]


def format_attribution(
    rows: List[Tuple[str, float, int]],
    top_ops: Optional[List[Tuple[str, float]]] = None,
) -> str:
    """The table: ms a step, its share, kernels a step and the class a row,
    then the total; with ``top_ops`` (``[(name, ms_per_step)]``) the
    hottest kernels and their classes."""
    total = sum(r[1] for r in rows)
    out = [f"{'ms/step':>9s}  {'%':>5s}  {'ops':>5s}  class"]
    for c, ms, n in rows:
        out.append(f"{ms:9.3f}  {100 * ms / max(total, 1e-9):5.1f}  "
                   f"{n:5d}  {c}")
    out.append(f"{total:9.3f}  100.0  {'':5s}  TOTAL on-device")
    if top_ops:
        out.append("\nhottest individual ops:")
        for name, ms in top_ops:
            out.append(f"{ms:9.3f}  {name[:48]:48s} [{classify_op(name)}]")
    return "\n".join(out)
