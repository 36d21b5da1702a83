"""Benchmark: stage-1 contrastive training throughput (images/sec/chip).

Counterpart of the repo-root ``bench.py``, with its knobs, its defaults and
its JSON keys. It builds the stage-1 contrastive step of a full-width CLIP
(ViT-B/16 + the PubMedBERT-shaped text tower unless ``BENCH_MODEL`` says
``medmamba``; image 224, staging 256; random weights from seed 0) on one
device-resident batch, runs ``BENCH_WARMUP`` steps, then times
``BENCH_STEPS`` steps by the host's clock up to ``torch.cuda.synchronize()``
(the host's time is in the number, as in the JAX bench's), and reports
images/sec over the one card the step runs on.

    PYTHONPATH=src python -m mamba_clip_tpu_torch.bench [--device auto|cuda|cpu]

The knobs come from the environment, read when :func:`main` runs:
``BENCH_BATCH`` (64), ``BENCH_WARMUP`` (3), ``BENCH_STEPS`` (30),
``BENCH_MODEL`` (``biomedclip`` | ``medmamba``), ``BENCH_PRECISION``
(``amp``), ``BENCH_QUANT`` (``int8_delayed``; an empty string means none),
``BENCH_ATTN`` (``einsum`` | ``flash``), ``BENCH_TEXT_CTX`` (224) and
``BENCH_SECONDARY`` (unset: a second recipe, see :func:`choose_secondary`;
an empty string: none). It runs on the card unless ``--device cpu`` is
given; the default fails, naming ``--device cpu``, where there is no card.

Before any number, :func:`verify_kernels` holds the hand-written kernels
that the step may run against their plain versions on the card, and ends
the run without a JSON line if one disagrees. It prints the card's name and
power limit on stderr, then exactly one JSON line on stdout:
``{"metric": "stage1_contrastive_images_per_sec_per_chip", "value": N,
"unit": "images/sec/chip", "vs_baseline": N, ...}``. ``vs_baseline`` and
``vs_baseline_conservative`` keep the JAX bench's A100 anchors (185 and
350 img/s, derived for the reference recipe in BASELINE.md); they are no
target for this card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from .config import Args
from .data.preprocess_cfg import get_transform_config
from .flash_sweep import inputs
from .models import build_clip
from .ops.flash_attn import FlashAttnFn, resolve_attn_flash
from .ops.selective_scan import selective_scan_tm
from .optim import build_optimizer
from .pipeline import init_quant_state, resolve_device
from .profile_classify import card_name
from .schedules import create_schedule
from .train import create_train_state, make_clip_train_step
from .utils.precision import get_policy

METRIC = "stage1_contrastive_images_per_sec_per_chip"
A100_BASELINE_IMG_S = 185.0
A100_BASELINE_CONSERVATIVE_IMG_S = 350.0
SCHEDULE_STEPS = 10_000
TEXT_CTX = 224  # the padded text length: --text-context auto's bucket for ISIC reports
SEED = 0  # the weights' generator and every step's dropout stream
# verify_kernels: the JAX bench's scan shape (B, G, L, DG, N) and gate, and
# the flash kernels' gates of chip_smoke.py by compute type
SCAN_SHAPE = (2, 2, 320, 128, 16)
SCAN_GATE = 5e-4
ATTN_GATE = {torch.float32: 5e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
VIT_TOKENS, HEADS, HEAD_DIM = 197, 12, 64  # ViT-B/16 at 224 and both towers' heads


@dataclass(frozen=True)
class Knobs:
    batch: int
    warmup: int
    steps: int
    model: str
    precision: str
    quant: Optional[str]
    attn: str
    text_ctx: int
    secondary: Optional[str]  # None: unset


def knobs(env=None) -> Knobs:
    """The ``BENCH_*`` knobs of ``env`` (the process environment unless
    given), at the JAX bench's defaults."""
    env = os.environ if env is None else env
    return Knobs(
        batch=int(env.get("BENCH_BATCH", 64)),
        warmup=int(env.get("BENCH_WARMUP", 3)),
        steps=int(env.get("BENCH_STEPS", 30)),
        model=env.get("BENCH_MODEL", "biomedclip"),
        precision=env.get("BENCH_PRECISION", "amp"),
        quant=env.get("BENCH_QUANT", "int8_delayed") or None,
        attn=env.get("BENCH_ATTN", "einsum"),
        text_ctx=int(env.get("BENCH_TEXT_CTX", TEXT_CTX)),
        secondary=env.get("BENCH_SECONDARY"),
    )


def _rel_err(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def verify_kernels(device, k: Knobs, scan=None, attn=None, scan_shape=SCAN_SHAPE) -> dict:
    """Refuse to report numbers if a hand-written kernel on the step's path
    disagrees with its plain version on this card. Returns the errors by
    name; on a disagreement prints the name and the error and raises
    ``SystemExit``.

    - The scan: ``scan = (kernel, plain)``, each called as
      ``selective_scan_tm`` (default: its ``impl="cuda"`` and
      ``impl="plain"``), at ``scan_shape`` with the JAX bench's draws from
      ``np.random.default_rng(7)``: the loss ``sum(y * cos(i))``, du and
      ddelta within ``SCAN_GATE``.
    - Under ``BENCH_ATTN=flash``: ``attn = (kernel, plain)``, each called
      as ``FlashAttnFn.apply(q, k, v, key_mask, sm_scale)`` (default: its
      ``"cuda"`` and ``"plain"`` impls), at the towers' shapes in the
      step's compute type: B the bench's batch, 12 heads, HD 64, T 197
      (the ViT, no mask) and the text context (a key mask of all keys, as
      the bench's tokens, none of them the pad id, give it). o, dq, dk and
      dv within ``ATTN_GATE`` of the compute type.

    The JAX bench keeps a marker on disk once its check passed, because
    its Pallas lowering takes minutes; this check takes seconds, so it runs
    every time. With ``device`` the CPU and no implementation given there
    is no kernel to check, and it returns at once."""
    if torch.device(device).type == "cpu" and scan is None and attn is None:
        return {}
    if scan is None:
        scan = (partial(selective_scan_tm, impl="cuda"), partial(selective_scan_tm, impl="plain"))
    errs = {}
    rng = np.random.default_rng(7)
    Bsz, G, L, DG, N = scan_shape

    def draw(scale, shape, fn=None):
        x = rng.normal(0, scale, shape)
        return torch.tensor(x if fn is None else fn(x), dtype=torch.float32, device=device)

    u, delta = draw(1, (Bsz, G, L, DG)), draw(0.5, (Bsz, G, L, DG))
    A = draw(0.5, (G * DG, N), lambda x: -np.exp(x))
    Bm, Cm = draw(1, (Bsz, G, L, N)), draw(1, (Bsz, G, L, N))
    D, bias = draw(1, (G * DG,)), draw(0.2, (G * DG,))
    got = {}
    for name, fn in zip(("kernel", "plain"), scan):
        u_, d_ = u.clone().requires_grad_(True), delta.clone().requires_grad_(True)
        y = fn(u_, d_, A, Bm, Cm, D, bias, delta_softplus=True)
        w = torch.cos(torch.arange(y.numel(), dtype=torch.float32, device=device)).view(y.shape)
        loss = torch.sum(y * w)
        got[name] = (loss.detach(), *torch.autograd.grad(loss, (u_, d_)))
    for name, a, b in zip(("scan loss", "scan du", "scan ddelta"), got["kernel"], got["plain"]):
        errs[name] = _rel_err(a, b)
        _refuse_above(name, errs[name], SCAN_GATE)

    if k.attn == "flash":
        if attn is None:
            attn = (lambda *a: FlashAttnFn.apply(*a, "cuda"),
                    lambda *a: FlashAttnFn.apply(*a, "plain"))
        dtype = get_policy(k.precision).compute_dtype
        for T, masked in ((VIT_TOKENS, False), (k.text_ctx, True)):
            q, kk, v, w = inputs((k.batch, HEADS, T, HEAD_DIM), dtype, device)
            mask = torch.ones((k.batch, T), dtype=torch.bool, device=device) if masked else None
            out = [_attn_fwd_bwd(fn, q, kk, v, w, mask) for fn in attn]
            for i, part in ((0, "o"), (2, "dq"), (3, "dk"), (4, "dv")):
                name = f"flash T {T} {part}"
                errs[name] = _rel_err(out[0][i].float(), out[1][i].float())
                _refuse_above(name, errs[name], ATTN_GATE[dtype])
    return errs


def _attn_fwd_bwd(fn, q, k, v, w, mask):
    """(o, loss, dq, dk, dv) of the loss ``sum(o * w)`` through ``fn``."""
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = fn(q, k, v, mask, q.shape[-1] ** -0.5)
    loss = torch.sum(o.float() * w)
    return (o.detach(), loss.detach(), *torch.autograd.grad(loss, (q, k, v)))


def _refuse_above(name: str, err: float, gate: float) -> None:
    if not (math.isfinite(err) and err <= gate):
        print(f"{name}: rel err {err:.3e} above {gate:.0e}", file=sys.stderr)
        raise SystemExit(f"the hand-written kernel diverges from its plain version on the "
                         f"device ({name}: rel err {err:.2e}) — refusing to report benchmark")


def bench_args(batch_size: int = 64, precision: str = "amp") -> Args:
    """The step's flags, as the JAX bench sets them."""
    return Args(batch_size=batch_size, epochs=1, precision=precision, warmup=1, lr=1e-4,
                grad_clip_norm=1.0)


def make_batch(batch_size: int, text_ctx: int, device="cpu") -> dict:
    """The one batch, drawn as the JAX bench draws it (its arrays bit for
    bit): uint8 images (B, 256, 256, 3), then int32 token ids uniform in
    [4, 30522), from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (batch_size, 256, 256, 3), dtype=np.uint8)
    tokens = rng.integers(4, 30522, (batch_size, text_ctx), dtype=np.int32)
    return {"image": torch.from_numpy(image).to(device),
            "tokens": torch.from_numpy(tokens).to(device)}


def build_train_step(batch_size=64, model_name="biomedclip", precision="amp", quant=None,
                     attn_remat=False, attn_impl="einsum", text_ctx=256, device="cuda"):
    """Build (step_fn, state, batch) for the stage-1 recipe on ``device``:
    ``step_fn(state, batch, SEED) -> (state, metrics)``.

    Shared by the bench and ``profile_step``, so the profiled step is the
    benchmarked step. The delayed int8 scales (``quant`` ``int8_delayed*``)
    are set from the JAX bench's init batch: two zero images and two
    all-pad rows of ``text_ctx`` tokens."""
    args = bench_args(batch_size, precision)
    policy = get_policy(args.precision)
    tcfg = get_transform_config(None, 224, is_train=True)
    model = build_clip(model_name, image_size=224, dtype=policy.compute_dtype,
                       grad_checkpointing=False, quant=quant, attn_remat=attn_remat,
                       attn_flash=resolve_attn_flash(attn_impl),
                       generator=torch.Generator().manual_seed(SEED)).to(device)
    init_quant_state(model, 224, policy, stage=1, takes_text=True, device=device,
                     context=text_ctx)
    policy.cast_params(model)
    schedule = create_schedule(args, SCHEDULE_STEPS)
    tx = build_optimizer(args, schedule)
    state = create_train_state(model, tx, policy)
    step_fn = make_clip_train_step(model, tx, policy, args, tcfg, schedule)
    return step_fn, state, make_batch(batch_size, text_ctx, device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(quant, k: Knobs, device, build=build_train_step) -> float:
    """The stage-1 step's images/sec/chip for one quant recipe: ``k.warmup``
    steps, then ``k.steps`` steps timed by the host's clock up to a
    synchronise and the loss read. Divided by the cards the step runs on,
    which is one: the state and the batch lie on ``device``. (The JAX bench
    divides by ``jax.local_device_count()``, though its step is jitted onto
    one device.)"""
    step_fn, state, batch = build(k.batch, k.model, k.precision, quant, attn_impl=k.attn,
                                  text_ctx=k.text_ctx, device=device)
    for _ in range(k.warmup):
        state, metrics = step_fn(state, batch, SEED)
    _sync(device)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(k.steps):
        state, metrics = step_fn(state, batch, SEED)
    _sync(device)
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise SystemExit(f"non-finite training loss {loss} — refusing to report benchmark")
    return k.batch * k.steps / dt


def choose_secondary(env_value, quant):
    """Pick the second recipe measured in the same bench process.

    BENCH_SECONDARY set -> honour it ("" disables). Unset -> the one JSON
    line carries both the quantized number and the bf16 number: an
    int8_delayed primary gets a bf16 secondary, and a bf16/unquantized
    primary gets the int8_delayed secondary."""
    if env_value is not None:
        return env_value
    return "bf16" if quant else "int8_delayed"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="auto", help="auto|cuda|cpu (auto: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    k = knobs()
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card_name(), file=sys.stderr)
    else:
        print("cpu: the plain paths; no kernel and no device number", file=sys.stderr)
    t0 = time.perf_counter()
    errs = verify_kernels(device, k)
    if errs:
        print(f"kernel check, {time.perf_counter() - t0:.1f} s, rel errs: {json.dumps(errs)}",
              file=sys.stderr)

    img_per_s = measure(k.quant, k, device)
    out = {
        "metric": METRIC,
        "value": round(img_per_s, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(img_per_s / A100_BASELINE_IMG_S, 3),
        "baseline_img_s": A100_BASELINE_IMG_S,
        "vs_baseline_conservative": round(img_per_s / A100_BASELINE_CONSERVATIVE_IMG_S, 3),
        "baseline_conservative_img_s": A100_BASELINE_CONSERVATIVE_IMG_S,
    }
    if k.quant:
        out["quant"] = k.quant
    if k.attn != "einsum":
        out["attn_impl"] = k.attn
    if k.text_ctx != 256:
        out["text_context"] = k.text_ctx  # 256: the reference's padding
    secondary = choose_secondary(k.secondary, k.quant)
    # only a recipe distinct from the primary runs
    if secondary and secondary != (k.quant or "bf16"):
        sec_rate = measure(None if secondary == "bf16" else secondary, k, device)
        out["secondary_quant"] = secondary
        out["secondary_value"] = round(sec_rate, 2)
        out["secondary_vs_baseline"] = round(sec_rate / A100_BASELINE_IMG_S, 3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
