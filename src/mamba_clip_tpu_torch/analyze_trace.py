"""Device time of a captured trace by kernel base name.

    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.profile_step --trace-dir DIR ...
    PYTHONPATH=src python3 -m mamba_clip_tpu_torch.analyze_trace DIR [--steps 5] \\
        [--top 30] [--grep REGEX]

Counterpart of ``tools/analyze_trace.py``, beside ``profile_step`` (which
attributes by class): the device time of the newest Chrome trace under
``DIR`` (``utils/profiling.load_device_op_times``), grouped by each
kernel's base name, the name without its template arguments and
parameters (``void flash_attn_fwd_tc_kernel<__nv_bfloat16, 64>(...)`` ->
``flash_attn_fwd_tc_kernel``), so that the instances of one kernel at
several shapes or types read as one row.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys

from .utils.profiling import load_device_op_launches, load_device_op_times

_RETURN_TYPE = re.compile(r"^(void|int|float)\s+")


def base_name(op: str) -> str:
    """A kernel name without its return type, template arguments and
    parameter list."""
    name = _RETURN_TYPE.sub("", op.strip())
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return re.sub(r"<.*>", "", name).strip() or op


def group(times, launches):
    """``[(base name, us, launches)]``, costliest first."""
    groups = collections.defaultdict(lambda: [0.0, 0])
    for name, us in times.items():
        g = groups[base_name(name)]
        g[0] += us
        g[1] += launches.get(name, 0)
    return sorted(((n, us, k) for n, (us, k) in groups.items()), key=lambda r: -r[1])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace_dir")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--grep", default=None, help="only groups whose base name matches")
    a = p.parse_args(argv)
    rows = group(load_device_op_times(a.trace_dir), load_device_op_launches(a.trace_dir))
    total = sum(us for _, us, _ in rows) / a.steps / 1e3
    if a.grep:
        pat = re.compile(a.grep)
        rows = [r for r in rows if pat.search(r[0])]
    print(f"{'ms/step':>9s}  {'%':>5s}  {'ops':>5s}  base name")
    for name, us, n in rows[: a.top]:
        ms = us / a.steps / 1e3
        print(f"{ms:9.3f}  {100 * ms / max(total, 1e-9):5.1f}  {n // a.steps:5d}  {name}")
    print(f"{total:9.3f}  100.0         TOTAL on-device")


if __name__ == "__main__":
    main(sys.argv[1:])
