"""The port's remaining utilities on the CPU, against the JAX package's:
the remote sync (``checkpoint.remote_sync``, ``RemoteSyncThread``, and
``--remote-sync`` with ``--resume latest`` through the CLI), the wandb
sink (``--report-to wandb`` with and without a stand-in ``wandb``), trace
attribution (``utils/profiling.py`` on a synthetic ``torch.profiler``
Chrome trace; ``analyze_trace.base_name``) and ``get_input_dtype``.

The CLI runs train a small medmamba classifier (depths (1, 1), dims (8,
16), d_state 4) put in place of ``build_classifier``, at image 32, batch 8.
"""

import gzip
import json
import logging
import os
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu import checkpoint as jckpt
from mamba_clip_tpu.utils import precision as jprec
from mamba_clip_tpu.utils import profiling as jprof
from mamba_clip_tpu_torch import checkpoint as tckpt
from mamba_clip_tpu_torch import pipeline as tpipe
from mamba_clip_tpu_torch.analyze_trace import base_name, group
from mamba_clip_tpu_torch.cli.main import main
from mamba_clip_tpu_torch.utils import precision as tprec
from mamba_clip_tpu_torch.utils import profiling as tprof
from mamba_clip_tpu_torch.utils import wandb_utils

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

TINY = dict(depths=(1, 1), dims=(8, 16), d_state=4, drop_path_rate=0.0)


def _write(p, content):
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "w") as f:
        f.write(content)


def _tree(root):
    """{relative path: content} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            out[os.path.relpath(p, root)] = open(p).read()
    return out


def _local_run(local):
    _write(str(local / "checkpoints" / "results.jsonl"), "{}\n")
    _write(str(local / "checkpoints" / "stage_1_epoch_latest" / "state.pt"), "AAAA")
    _write(str(local / "checkpoints" / "stage_1_epoch_1" / "state.pt"), "BBBB")
    _write(str(local / "checkpoints" / "stage_1_epoch_1_step_2" / "state.pt"), "CCCC")
    _write(str(local / "checkpoints" / "stage_1_epoch_1_step_2.meta.json"), "{}")
    _write(str(local / "params.txt"), "seed: 0\n")


def test_remote_sync_copies_and_skips_as_jax(tmp_path):
    local = tmp_path / "local"
    _local_run(local)
    rj, rt = tmp_path / "rj", tmp_path / "rt"
    assert jckpt.remote_sync(str(local), str(rj)) and tckpt.remote_sync(str(local), str(rt))
    assert _tree(rt) == _tree(rj) == {
        "params.txt": "seed: 0\n", "checkpoints/results.jsonl": "{}\n",
        "checkpoints/stage_1_epoch_1/state.pt": "BBBB"}
    # a file of the same size is not copied again; one of another size is
    first = (rt / "params.txt").stat().st_mtime_ns
    time.sleep(0.01)
    assert tckpt.remote_sync(str(local), str(rt))
    assert (rt / "params.txt").stat().st_mtime_ns == first
    _write(str(local / "params.txt"), "seed: 0\nextra: 1\n")
    _write(str(local / "checkpoints" / "results.jsonl"), "{}\n{}\n")
    assert jckpt.remote_sync(str(local), str(rj)) and tckpt.remote_sync(str(local), str(rt))
    assert _tree(rt) == _tree(rj) and _tree(rt)["params.txt"].endswith("extra: 1\n")
    # an fsspec URL as the remote
    assert tckpt.remote_sync(str(local), f"file://{tmp_path}/ru")
    assert _tree(tmp_path / "ru") == _tree(rt)


def test_remote_sync_tolerates_a_failed_probe_and_a_vanished_file(tmp_path, monkeypatch):
    from fsspec.implementations.local import LocalFileSystem

    local = tmp_path / "local"
    _local_run(local)
    monkeypatch.setattr(LocalFileSystem, "size",
                        lambda self, p: (_ for _ in ()).throw(OSError("HTTP 503")))
    put = LocalFileSystem.put

    def vanishing_put(self, lpath, rpath, *a, **k):
        if lpath.endswith("results.jsonl"):
            raise FileNotFoundError(lpath)
        return put(self, lpath, rpath, *a, **k)

    monkeypatch.setattr(LocalFileSystem, "put", vanishing_put)
    outcomes = {}
    for name, mod in (("jax", jckpt), ("port", tckpt)):
        assert mod.remote_sync(str(local), str(tmp_path / name))  # a pass that failed nothing
        assert mod.remote_sync(str(local), str(tmp_path / name))  # the probe fails: upload again
        outcomes[name] = _tree(tmp_path / name)
    assert outcomes["port"] == outcomes["jax"] == {
        "params.txt": "seed: 0\n", "checkpoints/stage_1_epoch_1/state.pt": "BBBB"}
    # a remote that cannot be reached fails the pass, as JAX's does
    monkeypatch.setattr(LocalFileSystem, "makedirs",
                        lambda self, *a, **k: (_ for _ in ()).throw(PermissionError("ro")))
    assert not jckpt.remote_sync(str(local), str(tmp_path / "x"))
    assert not tckpt.remote_sync(str(local), str(tmp_path / "y"))


def test_sync_thread_starts_and_stops(tmp_path):
    local = tmp_path / "l"
    _write(str(local / "a.txt"), "x")
    t = tckpt.start_sync_process(str(local), str(tmp_path / "r"), frequency=3600)
    assert t.is_alive() and t.daemon
    t.stop()
    t.join(timeout=5)
    assert not t.is_alive()
    t = tckpt.RemoteSyncThread(str(local), str(tmp_path / "r"), frequency=0.05)
    t.start()
    deadline = time.time() + 10
    while not (tmp_path / "r" / "a.txt").exists() and time.time() < deadline:
        time.sleep(0.02)
    t.stop()
    t.join(timeout=5)
    assert (tmp_path / "r" / "a.txt").read_text() == "x" and not t.is_alive()


@pytest.fixture()
def tiny(monkeypatch):
    from mamba_clip_tpu_torch.models.vssm import VSSM

    monkeypatch.setattr(tpipe, "build_classifier",
                        lambda name, generator=None, **kw: VSSM(num_classes=2, **TINY,
                                                                generator=generator))


def _argv(logs, *extra):
    return ["--model-stage-1", "medmamba", "--batch-size", "8", "--epochs", "2",
            "--train-num-samples", "16", "--val-num-samples", "8", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--logs", str(logs), "--workers", "1",
            "--force-image-size", "32", "--synthetic-data", "--device", "cpu", *extra]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _stop_sync_threads():
    for t in threading.enumerate():
        if isinstance(t, tckpt.RemoteSyncThread):
            t.stop()
            t.join(timeout=10)


def test_remote_sync_then_resume_latest_from_the_remote_copy(tiny, tmp_path):
    """Run 1 mirrors its run directory to a ``file://`` URL every second;
    once its last checkpoint is there, its local checkpoints are deleted and
    run 2 (``--resume latest``, the same name) finds the remote one, loads
    it through fsspec and evaluates it: the metrics of run 1 bit for bit."""
    remote = f"file://{tmp_path}/remote"
    logs = tmp_path / "logs"
    try:
        m1 = main(_argv(logs, "--name", "r", "--remote-sync", remote,
                        "--remote-sync-frequency", "1"))
        local = logs / "r" / "checkpoints" / "stage_1_epoch_2" / "state.pt"
        mirror = tmp_path / "remote" / "r" / "checkpoints" / "stage_1_epoch_2" / "state.pt"
        deadline = time.time() + 60
        while time.time() < deadline and not (
                mirror.exists() and mirror.stat().st_size == local.stat().st_size):
            time.sleep(0.1)
        _stop_sync_threads()
        assert mirror.read_bytes() == local.read_bytes()
        assert (tmp_path / "remote" / "r" / "params.txt").exists()
        assert not os.path.exists(tmp_path / "remote" / "r" / "checkpoints" /
                                  "stage_1_epoch_latest")
        for n in os.listdir(logs / "r" / "checkpoints"):
            if n.startswith("stage_1_epoch"):
                import shutil

                shutil.rmtree(logs / "r" / "checkpoints" / n)
        grab = _Lines()
        logging.getLogger("mamba_clip_tpu_torch").addHandler(grab)
        try:
            m2 = main(_argv(logs, "--name", "r", "--resume", "latest",
                            "--remote-sync", remote))
        finally:
            logging.getLogger("mamba_clip_tpu_torch").removeHandler(grab)
    finally:
        _stop_sync_threads()
    want = f"{remote}/r/checkpoints/stage_1_epoch_2"
    assert f"Resuming from latest checkpoint: {want}" in grab.lines
    assert m2 == m1 and np.isfinite(m1["val_loss"])


def test_remote_startup_validation_fails_as_jax(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(tpipe, "remote_sync", lambda *a: False)
    with pytest.raises(RuntimeError, match="^remote sync startup validation failed$"):
        main(_argv(tmp_path / "logs", "--remote-sync", str(tmp_path / "remote")))


@pytest.fixture()
def fresh_wandb(monkeypatch):
    from mamba_clip_tpu_torch.utils import logging as tlog

    monkeypatch.setattr(wandb_utils, "_checked", False)
    monkeypatch.setattr(wandb_utils, "_wandb", None)
    monkeypatch.setattr(tlog, "_seen_warnings", set())


def test_report_to_wandb_without_wandb_warns_once(tiny, tmp_path, monkeypatch, fresh_wandb):
    monkeypatch.setitem(sys.modules, "wandb", None)
    grab = _Lines()
    logging.getLogger("mamba_clip_tpu_torch").addHandler(grab)
    try:
        m = main(_argv(tmp_path, "--report-to", "wandb", "--stage", "1"))
        main(_argv(tmp_path, "--report-to", "wandb", "--epochs", "1"))
    finally:
        logging.getLogger("mamba_clip_tpu_torch").removeHandler(grab)
    assert np.isfinite(m["val_loss"])
    msg = "wandb requested via --report-to but not installed"
    assert grab.lines.count(msg) == 1
    assert not wandb_utils.available()


def test_report_to_wandb_with_a_stand_in_wandb(tiny, tmp_path, monkeypatch, fresh_wandb):
    calls = []
    fake = types.ModuleType("wandb")
    fake.run = None

    def init(**kw):
        calls.append(("init", kw))
        fake.run = object()
        return fake.run

    def finish():
        calls.append(("finish",))
        fake.run = None

    fake.init, fake.finish = init, finish
    fake.log = lambda data, step=None: calls.append(("log", data, step))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    main(_argv(tmp_path, "--report-to", "wandb", "--name", "w", "--wandb-notes", "n1"))
    assert [c[0] for c in calls] == ["init", "finish"]
    kw = calls[0][1]
    assert kw["project"] == "mamba-clip" and kw["name"] == "w" and kw["notes"] == "n1"
    assert kw["resume"] is None and kw["config"]["report_to"] == "wandb"
    wandb_utils.log({"x": 1.0}, step=3)  # no run: nothing logged
    fake.run = object()
    wandb_utils.log({"x": 1.0}, step=3)
    assert calls[-1] == ("log", {"x": 1.0}, 3)


def _trace_events():
    """A torch.profiler Chrome trace's events: host ops and runtime calls,
    a GPU annotation, and device kernels, copies and sets on two cards, the
    second busier."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 100, "tid": 1, "dur": 900},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 100, "tid": 1,
         "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#3", "pid": 1,
         "tid": 7, "dur": 99999},
        {"ph": "i", "cat": "kernel", "name": "marker", "pid": 1, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "void flash_attn_fwd_tc_kernel<__nv_bfloat16, 64>"
         "(FwdParams)", "pid": 0, "tid": 7, "dur": 500},
    ]
    card = [
        ("kernel", "void flash_attn_fwd_tc_kernel<__nv_bfloat16, 64>(FwdParams)", 300, 4),
        ("kernel", "void flash_attn_bwd_dq_tc_kernel<__nv_bfloat16, 64>(BwdParams)", 500, 2),
        ("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 1200, 6),
        ("kernel", "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<X>(Y)",
         200, 2),
        ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 40, 2),
        ("gpu_memset", "Memset (Device)", 10, 2),
        ("kernel", "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(Z)",
         60, 2),
        ("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::silu>(W)",
         80, 4),
        ("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 120, 2),
        ("kernel", "some_kernel_of_another_kind", 8, 2),
    ]
    for cat, name, dur, n in card:
        ev += [{"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7, "ts": i,
                "dur": dur / n} for i in range(n)]
    return ev


def _write_trace(d, events, name="trace.json"):
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(p, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return p


def test_trace_attribution_on_a_torch_profiler_trace(tmp_path):
    old = _write_trace(str(tmp_path / "a"), [{"ph": "X", "cat": "kernel", "name": "old",
                                              "pid": 0, "dur": 1}], "w.pt.trace.json.gz")
    os.utime(old, (1, 1))
    _write_trace(str(tmp_path / "b"), _trace_events())
    times = tprof.load_device_op_times(str(tmp_path))
    launches = tprof.load_device_op_launches(str(tmp_path))
    assert "old" not in times and sum(launches.values()) == 28 and len(times) == 10
    assert times["sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"] == 1200
    rows = tprof.attribute(times, steps=2, launches=launches)
    by = {c: (ms, n) for c, ms, n in rows}
    assert by == {
        "GEMM / convolution (cuBLAS, cuDNN, CUTLASS)": (0.6, 3),
        tprof.HAND_WRITTEN: (0.4, 3),
        "optimizer (foreach / multi-tensor)": (0.1, 1),
        "NCCL collective": (0.06, 1),
        "elementwise": (0.04, 2),
        "reduction": (0.03, 1),
        "layout / copy": (0.025, 2),
        "other": (0.004, 1),
    }
    assert [c for c, _, _ in rows][:2] == ["GEMM / convolution (cuBLAS, cuDNN, CUTLASS)",
                                           tprof.HAND_WRITTEN]
    # the classes sum to the trace's device total
    assert abs(sum(ms for _, ms, _ in rows) - 2518 / 2 / 1e3) < 1e-12
    # without launches: distinct names a class, as JAX counts its ops
    assert dict((c, n) for c, _, n in tprof.attribute(times, steps=2))[tprof.HAND_WRITTEN] == 2
    # the table: JAX's layout for the same rows
    assert tprof.format_attribution(rows) == jprof.format_attribution(rows)
    top = [("void flash_attn_fwd_tc_kernel<__nv_bfloat16, 64>(FwdParams)", 0.15)]
    text = tprof.format_attribution(rows, top)
    assert text.startswith(jprof.format_attribution(rows) + "\n\nhottest individual ops:\n")
    assert text.endswith(f"{0.15:9.3f}  {top[0][0][:48]:48s} [{tprof.HAND_WRITTEN}]")
    # analyze_trace's base names
    grouped = {n: (us, k) for n, us, k in group(times, launches)}
    assert grouped["flash_attn_fwd_tc_kernel"] == (300, 4)
    assert base_name("void at::native::reduce_kernel<512, 1, X<Y> >(Z)") == \
        "at::native::reduce_kernel"


def test_missing_trace_raises(tmp_path):
    for fn in (tprof.load_device_op_times, jprof.load_device_op_times):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path))


@pytest.mark.parametrize("precision", sorted(jprec._POLICIES))
def test_get_input_dtype_equals_jax(precision):
    want = jnp.dtype(jprec.get_input_dtype(precision)).name
    got = tprec.get_input_dtype(precision)
    assert str(got).replace("torch.", "") == {"bfloat16": "bfloat16", "float16": "float16",
                                              "float32": "float32"}[want]
