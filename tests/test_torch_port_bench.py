"""The port's bench (``mamba_clip_tpu_torch.bench``) against the repo-root
``bench.py``, on the CPU.

- ``choose_secondary`` equals JAX's over its five cases; every knob's
  default and the two A100 anchors equal JAX's module constants under a
  clean environment.
- The JSON line: under several environments, with ``measure`` stubbed to
  fixed rates on both sides (and on JAX's side its kernel check and
  compilation cache stubbed, so nothing is compiled or written), the
  port's line equals JAX's key for key and value for value.
- The batch is bit for bit the numpy draw of ``bench.py``'s
  ``build_train_step``; the step's ``Args`` fields and the schedule's lr at
  steps 0, 1, 5,000 and 9,999 equal JAX's.
- ``measure`` divides by the one card its step runs on (JAX's divides by
  ``jax.local_device_count()``; ROADMAP Queue 3).
- ``verify_kernels``: with a planted divergence (the plain scan, or the
  plain flash interior, times 1 + 1e-3) at a small shape the run ends in
  ``SystemExit`` and prints no JSON line; without one it prints its line.
- ``main --device cpu`` end to end with small towers (ViT and BERT of
  width 32, depth 1, at the bench's image 224 and context 224) prints one
  line with a finite, positive value. The full-width case (BiomedCLIP at
  batch 2) took about 38 s alone on the CPU, above this file's budget, so
  it runs on the card only (``chip_smoke.py`` phase 27).
- ``profile_step`` takes the JAX tool's flags with its defaults.
"""

import importlib.util
import json
import os
import re
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mamba_clip_tpu.parallel.mesh as jmesh
from mamba_clip_tpu.config import Args as JArgs
from mamba_clip_tpu.schedules import create_schedule as jcreate_schedule
from mamba_clip_tpu_torch import bench, profile_step
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.ops import quant as tquant
from mamba_clip_tpu_torch.ops.flash_attn import FlashAttnFn
from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_tm
from mamba_clip_tpu_torch.schedules import create_schedule

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling when the
# test workers share the machine's cores.
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
KNOBS = ("BENCH_BATCH", "BENCH_WARMUP", "BENCH_STEPS", "BENCH_MODEL", "BENCH_PRECISION",
         "BENCH_QUANT", "BENCH_ATTN", "BENCH_TEXT_CTX", "BENCH_SECONDARY")
# a rate a recipe, each with digits past both roundings
RATES = {"int8_delayed": 118.987654, None: 301.234567, "int8_fast": 250.555555}
SMALL_SCAN = (1, 2, 32, 8, 4)


def _env(monkeypatch, env):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


def _jax_bench(monkeypatch, env):
    """The repo-root bench.py, loaded under ``env`` (it reads its knobs at
    import)."""
    _env(monkeypatch, env)
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("env_value,quant", [(None, None), (None, "int8_fast"),
                                             (None, "int8_delayed"), ("", None),
                                             ("int8", None)])
def test_choose_secondary_equals_jax(env_value, quant, monkeypatch):
    jbench = _jax_bench(monkeypatch, {})
    assert bench.choose_secondary(env_value, quant) == jbench.choose_secondary(env_value, quant)


def test_knob_defaults_and_anchors_equal_jax(monkeypatch):
    jbench = _jax_bench(monkeypatch, {})
    k = bench.knobs()
    assert (k.batch, k.warmup, k.steps, k.model, k.precision, k.quant, k.attn,
            k.text_ctx) == (jbench.BATCH, jbench.WARMUP, jbench.STEPS, jbench.MODEL,
                            jbench.PRECISION, jbench.QUANT, jbench.ATTN, jbench.TEXT_CTX)
    assert k.secondary is None and os.environ.get("BENCH_SECONDARY") is None
    assert bench.A100_BASELINE_IMG_S == jbench.A100_BASELINE_IMG_S == 185.0
    assert bench.A100_BASELINE_CONSERVATIVE_IMG_S == jbench.A100_BASELINE_CONSERVATIVE_IMG_S
    assert profile_step.parser().parse_args([]).text_ctx is None  # -> the bench's, as JAX's


def _lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("env", [{}, {"BENCH_QUANT": ""}, {"BENCH_ATTN": "flash"},
                                 {"BENCH_TEXT_CTX": "256"}, {"BENCH_SECONDARY": ""},
                                 {"BENCH_QUANT": "", "BENCH_SECONDARY": "int8_fast"}],
                         ids=["default", "no-quant", "flash", "ctx256", "no-secondary",
                              "secondary-int8_fast"])
def test_json_line_equals_jax(env, monkeypatch, capsys):
    jbench = _jax_bench(monkeypatch, env)
    monkeypatch.setattr(jbench, "verify_compiled_kernel", lambda: None)
    monkeypatch.setattr(jmesh, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jbench, "measure", lambda quant: RATES[quant])
    jbench.main()
    want = _lines(capsys.readouterr().out)

    calls = []
    monkeypatch.setattr(bench, "measure",
                        lambda quant, k, device: calls.append((quant, device)) or RATES[quant])
    got_ret = bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    got = _lines(captured.out)
    assert len(want) == len(got) == 1 and captured.out.count("\n") == 1
    assert list(got[0]) == list(want[0]) and got[0] == want[0] == got_ret
    assert all(device == "cpu" for _, device in calls)


def test_batch_is_jax_draw_bit_for_bit():
    b = bench.make_batch(4, 224)
    rng = np.random.default_rng(0)  # bench.py's build_train_step
    image = rng.integers(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    tokens = rng.integers(4, 30522, (4, 224), dtype=np.int32)
    assert b["image"].dtype == torch.uint8 and b["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(b["image"].numpy(), image)
    np.testing.assert_array_equal(b["tokens"].numpy(), tokens)


STEP_FIELDS = ("batch_size", "epochs", "precision", "warmup", "lr", "beta1", "beta2", "eps",
               "wd", "lr_scheduler", "skip_scheduler", "lr_restart_interval",
               "epochs_cooldown", "lr_cooldown_end", "lr_cooldown_power", "accum_freq",
               "grad_clip_norm", "balanced_mixup", "siglip", "lock_image",
               "lock_image_freeze_bn_stats", "local_loss")


@pytest.mark.parametrize("precision", ["amp", "fp32"])
def test_args_and_schedule_equal_jax(precision):
    args = bench.bench_args(64, precision)
    jargs = JArgs(batch_size=64, epochs=1, precision=precision, warmup=1, lr=1e-4,
                  grad_clip_norm=1.0)  # bench.py's build_train_step
    assert {f: getattr(args, f) for f in STEP_FIELDS} == {f: getattr(jargs, f)
                                                          for f in STEP_FIELDS}
    sched, jsched = create_schedule(args, bench.SCHEDULE_STEPS), jcreate_schedule(jargs, 10_000)
    # JAX evaluates the cosine in fp32: at step 9,999 the lr is 3e-12 (of
    # 1e-4) and fp32's rounding of cos near -1 is most of it, so the bound is
    # 1e-6 of the base lr beside rel 1e-6
    for step in (0, 1, 5_000, 9_999):
        np.testing.assert_allclose(sched(step), float(jsched(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-6 * args.lr)


class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def test_measure_divides_by_the_one_card(monkeypatch):
    seen = []

    def build(batch, model, precision, quant, attn_impl, text_ctx, device):
        seen.append((batch, model, precision, quant, attn_impl, text_ctx, device))

        def step(state, b, seed):
            return state + 1, {"loss": torch.tensor(4.0)}
        return step, 0, {}

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(bench.time, "perf_counter", _Clock([10.0, 12.5]))
    k = bench.knobs({"BENCH_BATCH": "8", "BENCH_WARMUP": "2", "BENCH_STEPS": "5"})
    assert bench.measure("int8_fast", k, "cpu", build=build) == 8 * 5 / 2.5
    assert seen == [(8, "biomedclip", "amp", "int8_fast", "einsum", 224, "cpu")]

    def diverging(batch, *a, **kw):
        return (lambda state, b, seed: (state, {"loss": torch.tensor(float("nan"))})), 0, {}
    monkeypatch.setattr(bench.time, "perf_counter", _Clock([0.0, 1.0]))
    with pytest.raises(SystemExit, match="non-finite training loss"):
        bench.measure(None, k, "cpu", build=diverging)


def _scan_plain(*a, **kw):
    return selective_scan_tm(*a, impl="plain", **kw)


def _attn_plain(*a):
    return FlashAttnFn.apply(*a, "plain")


# the planted factor 1 + f lies above the gate: 5e-4 (the scan; flash in
# fp32), 2e-2 (flash in bf16, the step's compute type under amp)
@pytest.mark.parametrize("planted,precision,f", [(None, "amp", 0.0), ("scan", "amp", 1e-3),
                                                 ("flash", "fp32", 1e-3),
                                                 ("flash", "amp", 5e-2)])
def test_verify_kernels_refuses_a_planted_divergence(planted, precision, f, monkeypatch,
                                                     capsys):
    _env(monkeypatch, {"BENCH_ATTN": "flash", "BENCH_BATCH": "2", "BENCH_TEXT_CTX": "16",
                       "BENCH_PRECISION": precision})
    scan = (_scan_plain, (lambda *a, **kw: _scan_plain(*a, **kw) * (1 + f))
            if planted == "scan" else _scan_plain)
    attn = (_attn_plain, (lambda *a: _attn_plain(*a) * (1 + f))
            if planted == "flash" else _attn_plain)
    checked = []
    verify = partial(bench.verify_kernels, scan=scan, attn=attn, scan_shape=SMALL_SCAN)
    monkeypatch.setattr(bench, "verify_kernels", lambda *a, **kw: checked.append(verify(*a)))
    monkeypatch.setattr(bench, "measure", lambda quant, k, device: RATES[quant])
    if planted:
        with pytest.raises(SystemExit, match="refusing to report"):
            bench.main(["--device", "cpu"])
        captured = capsys.readouterr()
        assert captured.out == "" and f"{planted}" in captured.err
        return
    bench.main(["--device", "cpu"])
    assert len(_lines(capsys.readouterr().out)) == 1
    errs = checked[0]
    assert sorted(errs) == sorted(
        ["scan loss", "scan du", "scan ddelta"]
        + [f"flash T {T} {p}" for T in (197, 16) for p in ("o", "dq", "dk", "dv")])
    assert all(e == 0.0 for e in errs.values())


def test_verify_kernels_checks_nothing_on_the_cpu():
    assert bench.verify_kernels("cpu", bench.knobs({"BENCH_ATTN": "flash"})) == {}


def _small_clip(model_name="biomedclip", image_size=224, dtype=torch.float32, quant=None,
                attn_flash=False, generator=None, **kw):
    q = dict(dot_general_cls=tquant.make_dot_general_cls(quant),
             attn_int8=tquant.attn_int8(quant), attn_int8_delayed=tquant.attn_int8_delayed(quant),
             generator=generator, dtype=dtype, attn_flash=attn_flash)
    small = dict(width=32, depth=1, num_heads=2, embed_dim=16)
    return tclip.ClipModel(tvit.VisionTransformer(image_size=image_size, patch_size=16,
                                                  **small, **q),
                           tbert.TextBert(vocab_size=30522, context_length=256, **small, **q))


@pytest.mark.parametrize("quant", ["", "int8_delayed"])
def test_main_on_the_cpu_prints_one_line(quant, monkeypatch, capsys):
    _env(monkeypatch, {"BENCH_BATCH": "2", "BENCH_WARMUP": "1", "BENCH_STEPS": "1",
                       "BENCH_QUANT": quant, "BENCH_SECONDARY": ""})
    monkeypatch.setattr(bench, "build_clip", _small_clip)
    out = bench.main(["--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert lines == [out] and np.isfinite(out["value"]) and out["value"] > 0
    assert out.get("quant") == (quant or None) and out["text_context"] == 224


def test_main_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])


def test_profile_step_takes_the_jax_tools_flags():
    src = open(os.path.join(ROOT, "tools", "profile_step.py")).read()
    jax_flags = dict(re.findall(r'add_argument\("(--[a-z-]+)"(?:, [^)]*?default=([^,)\n]+))?',
                                src))
    ap = profile_step.parser()
    ours = {a.option_strings[0]: a for a in ap._actions if a.option_strings[0] != "-h"}
    assert sorted(ours) == sorted(jax_flags)
    defaults = ap.parse_args([])
    for flag, default in jax_flags.items():
        want = {"": False, "None": None}.get(default, default)
        if isinstance(want, str):
            want = json.loads(want) if not want.startswith('"') else want.strip('"')
        assert getattr(defaults, flag[2:].replace("-", "_")) == want, flag
