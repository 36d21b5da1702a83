"""Loss-trajectory parity of the int8 quantized-training modes against fp32.

Counterpart of ``tools/quant_parity.py``, with its flags and JSON keys. It
trains one CLIP (``build_clip("biomedclip", image_size=32,
context_length=16, vocab_size=64)``, batch 8, fp32) from one
initialization on one synthetic batch stream under fp32 and each
``--quant`` mode (``int8``, ``int8_fast``, ``int8_fast_attn``,
``int8_delayed``, ``int8_delayed_attn``), and reports each mode's first and
final loss and its largest and final distance from the fp32 run. int8
training is not fp32 bit for bit; what this checks is that the trajectory
tracks fp32's.

``--full-width`` (the JAX tool's ``--full-tpu``) runs the full-width
comparison instead: the stage-1 contrastive step of
``profile_train.clip_train_setup`` (BiomedCLIP, batch 64, amp, the einsum
interior, as the JAX package's ``bench.py`` builds it) under amp
(``bf16_amp``), ``int8_fast`` and ``int8_fast_attn``, with fresh batches
drawn on the device each step, and ``bf16_amp_dataseed1``, amp on another
draw of the batches: the distance a harmless change of the data makes, the
yardstick of the int8 curves' distance from amp's.

    python -m mamba_clip_tpu_torch.quant_parity [--steps 40] [--json] [--full-width] [--device auto|cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .config import Args
from .data.preprocess_cfg import get_transform_config
from .models import build_clip
from .ops.qdot import delayed_holders, init_delayed_scales
from .optim import build_optimizer
from .pipeline import resolve_device
from .schedules import create_schedule
from .train import create_train_state, make_clip_train_step
from .utils.precision import get_policy

MODES = (None, "int8", "int8_fast", "int8_fast_attn", "int8_delayed", "int8_delayed_attn")


def run(quant, steps, seed=0, device="cuda", state_dict=None):
    """fp32 losses of ``steps`` steps of the small CLIP under ``quant``.
    Its parameters are drawn from ``seed``, or taken from ``state_dict``
    (e.g. the JAX package's init carried over by ``convert.py``); the
    delayed modes' scales come from the init batch (two zero images, two
    all-ones token rows) and are re-anchored on the first batch, as
    ``train_one_epoch`` does."""
    model = build_clip("biomedclip", image_size=32, context_length=16, vocab_size=64,
                       quant=quant, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device)
    if state_dict is None:
        init_delayed_scales(model, image=torch.zeros(2, 32, 32, 3, device=device),
                            text=torch.ones(2, 16, dtype=torch.int64, device=device))
    args = Args(batch_size=8, epochs=1, lr=1e-3, warmup=2, precision="fp32", quant=quant)
    policy = get_policy("fp32")
    tcfg = get_transform_config(None, 32, is_train=True)
    schedule = create_schedule(args, steps)
    tx = build_optimizer(args, schedule)
    state = create_train_state(model, tx, policy)
    fn = make_clip_train_step(model, tx, policy, args, tcfg, schedule)

    r = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        batch = {
            "image": torch.as_tensor(r.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8),
                                     device=device),
            "tokens": torch.as_tensor(r.integers(4, 64, (8, 16), dtype=np.int32),
                                      device=device),
        }
        if i == 0 and delayed_holders(model):
            # re-anchor the init batch's scales on real data, as
            # train_one_epoch does on its first batch
            state = fn.calibrate_quant(state, batch, seed)
        state, metrics = fn(state, batch, seed)
        losses.append(metrics["loss"].detach())
    return [float(x) for x in torch.stack(losses).cpu()]


def run_full_width(quant, steps, seed=0, data_seed=0, tag=None, device="cuda"):
    """The full-width contrastive step (batch 64, amp, einsum) under
    ``quant`` with a fresh batch a step, drawn on the device from (``seed``
    + 1000 + ``data_seed``, step): uint8 images at the staging size and
    token ids in [4, 30522) at context 256. ``data_seed`` moves only the
    batches. Returns the losses."""
    from .profile_train import clip_train_setup

    state, step_fn, _ = clip_train_setup(64, device=device, attn_impl="einsum", seed=seed,
                                         quant=quant)
    S = get_transform_config(None, 224, is_train=True).staging_size
    gen = torch.Generator(device=device)
    name = tag or (quant or "bf16_amp")
    losses = []
    for i in range(steps):
        s = np.random.SeedSequence([seed + 1000 + data_seed, i]).generate_state(1)[0]
        gen.manual_seed(int(s))
        batch = {
            "image": torch.randint(0, 256, (64, S, S, 3), generator=gen, device=device,
                                   dtype=torch.uint8),
            "tokens": torch.randint(4, 30522, (64, 256), generator=gen, device=device),
        }
        state, metrics = step_fn(state, batch, seed)
        losses.append(metrics["loss"].detach())  # read once, at the end
        print(f"  [{name}] step {i}", file=sys.stderr)
    return [float(x) for x in torch.stack(losses).cpu()]


def full_width(steps, device="cuda") -> dict:
    """``--full-width``'s four curves and the JSON object of the JAX tool's
    ``--full-tpu``."""
    curves = {
        "bf16_amp": run_full_width(None, steps, device=device),
        "int8_fast": run_full_width("int8_fast", steps, device=device),
        "int8_fast_attn": run_full_width("int8_fast_attn", steps, device=device),
        # the yardstick: the same recipe on another draw of the data
        "bf16_amp_dataseed1": run_full_width(None, steps, data_seed=1,
                                             tag="bf16_amp_dataseed1", device=device),
    }
    base = np.asarray(curves["bf16_amp"])
    out = {"steps": steps,
           "bf16_amp": {"first": round(float(base[0]), 4), "final": round(float(base[-1]), 4)}}
    for name in ("int8_fast", "int8_fast_attn", "bf16_amp_dataseed1"):
        c = np.asarray(curves[name])
        out[name] = {
            "first": round(float(c[0]), 4),
            "final": round(float(c[-1]), 4),
            "max_dev_vs_bf16": round(float(np.abs(c - base).max()), 4),
            "final_dev_vs_bf16": round(float(abs(c[-1] - base[-1])), 4),
        }
    return out


def tiny(steps, device="cuda", modes=MODES):
    """The small CLIP under fp32 and each of ``modes``: (the curves, the JAX
    tool's JSON object)."""
    curves = {(quant or "fp32"): run(quant, steps, device=device) for quant in modes}
    base = np.asarray(curves["fp32"])
    out = {"steps": steps}
    for name, c in curves.items():
        c = np.asarray(c)
        out[name] = {
            "first": round(float(c[0]), 4),
            "final": round(float(c[-1]), 4),
            "max_dev_vs_fp32": round(float(np.abs(c - base).max()), 4),
            "final_dev_vs_fp32": round(float(abs(c[-1] - base[-1])), 4),
        }
    return curves, out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--json", action="store_true")
    p.add_argument("--full-width", action="store_true",
                   help="full-width amp against int8_fast and int8_fast_attn on the card")
    p.add_argument("--device", default="auto", help="auto|cuda|cpu (auto: the card)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    if a.full_width:
        out = full_width(a.steps, device)
        print(json.dumps(out))
        return out

    curves, out = tiny(a.steps, device)
    if a.json:
        print(json.dumps(out))
    else:
        for name, c in curves.items():
            print(f"{name:14s} first={c[0]:.4f} final={c[-1]:.4f}")
        for name in MODES[1:]:
            print(f"{name:14s} max|Δloss| vs fp32 = {out[name]['max_dev_vs_fp32']:.4f}, "
                  f"final Δ = {out[name]['final_dev_vs_fp32']:.4f}")
    return out


if __name__ == "__main__":
    main()
