"""Numerics parity harness: the port's training arithmetic against PyTorch's
stock optimizer stack, step by step.

Counterpart of ``tools/parity_harness.py``, with its three modes, flags,
keys and PASS gates:

- default: the same tiny MLP (the stage-2 head's shape) trained on the same
  data from the same initialization by both stacks: the port's
  ``optim.AdamW`` (optax's arithmetic), ``schedules.cosine_lr`` and
  ``losses.cross_entropy_loss`` (class-weighted) on one side,
  ``torch.optim.AdamW`` + ``LambdaLR`` + ``F.cross_entropy`` on the other;
  the largest per-step loss deviation and the final parameter deviation.
  PASS: loss deviation < 1e-4 and w1 deviation < 1e-3.
- ``--stage2``: stage 2 end to end on a fixed imbalanced synthetic split
  (about 3% positives, 1024-wide features): the
  Linear(1024->512)->ReLU->Linear(512->2) head trained by both stacks for
  ``--epochs`` epochs; the loss curves and the held-out pAUC above 80% TPR
  (``eval.partial_auc``). PASS: loss deviation < 1e-3 and pAUC deviation
  < 1e-4.
- ``--quant-stage1``: stage 1 of a tiny two-tower CLIP (the towers' module
  classes, scaled down) trained from one initialization under fp32, amp and
  ``int8_delayed`` (and fp32 from the next seed's initialization), each
  tower's concatenated features then fed to the same stage-2 head training;
  the held-out pAUC of each. PASS: ``int8_delayed``'s pAUC deviation from
  fp32 within ``1.5 * yardstick + 0.002``, the yardstick the larger of
  amp's deviation and the seed's.

In fp32 the two stacks agree to about 1e-5: the update rules are the same,
the order of the sums is not.

    python -m mamba_clip_tpu_torch.parity_harness [--steps 50] [--stage2] [--quant-stage1] [--epochs 3] [--json] [--device auto|cuda|cpu]

It runs on the card unless ``--device cpu`` is given; both stacks run on
that device.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from .config import Args
from .data.preprocess_cfg import get_transform_config
from .eval import partial_auc
from .losses import cross_entropy_loss
from .models.clip import ClipModel
from .models.text_bert import TextBert
from .models.vit import VisionTransformer
from .ops.preprocess import eval_preprocess
from .ops.qdot import delayed_scales, init_delayed_scales
from .ops.quant import make_dot_general_cls
from .optim import AdamW, build_optimizer
from .pipeline import resolve_device
from .schedules import cosine_lr, create_schedule
from .train import create_train_state, make_clip_train_step
from .utils.precision import get_policy

_MLP = ("w1", "b1", "w2", "b2")


def _train_ours(init, batch_of, steps, *, lr, wd, warmup, cw, device):
    """The 2-layer MLP trained by the port's stack from ``init`` (``w1, b1,
    w2, b2`` numpy, ``x @ w1`` layout) over ``batch_of(i) -> (x, y)`` on
    ``device``. Returns (the losses, the trained parameters as numpy)."""
    params = {k: torch.as_tensor(v, device=device) for k, v in zip(_MLP, init)}
    tx = AdamW(lr=cosine_lr(lr, warmup, steps), b1=0.9, b2=0.999, eps=1e-8, wd=wd,
               clip_norm=None)
    opt_state = tx.init(params)
    weight = torch.as_tensor(cw, device=device) if cw is not None else None
    losses = []
    for i in range(steps):
        x, y = batch_of(i)
        p = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        h = torch.relu(x @ p["w1"] + p["b1"])
        loss = cross_entropy_loss(h @ p["w2"] + p["b2"], y, weight=weight)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = {k: params[k] + updates[k] for k in params}
        losses.append(loss.detach())
    return (torch.stack(losses).cpu().numpy().astype(np.float64),
            {k: t.cpu().numpy() for k, t in params.items()})


def _train_both(w1, b1, w2, b2, xs, ys, *, lr, wd, warmup, cw, device):
    """Train the 2-layer MLP on the same (steps, B, ...) batch stream in
    both stacks from the same init. Returns (ours_losses, torch_losses,
    our_params, torch_model)."""
    steps = xs.shape[0]
    xs_d = torch.as_tensor(xs, device=device)
    ys_d = torch.as_tensor(ys, device=device)
    ours, params = _train_ours((w1, b1, w2, b2), lambda i: (xs_d[i], ys_d[i]), steps,
                               lr=lr, wd=wd, warmup=warmup, cw=cw, device=device)

    d_in, hid = w1.shape
    ncls = w2.shape[1]
    tmodel = torch.nn.Sequential(
        torch.nn.Linear(d_in, hid), torch.nn.ReLU(), torch.nn.Linear(hid, ncls)).to(device)
    with torch.no_grad():
        tmodel[0].weight.copy_(torch.as_tensor(w1.T))
        tmodel[0].bias.copy_(torch.as_tensor(b1))
        tmodel[2].weight.copy_(torch.as_tensor(w2.T))
        tmodel[2].bias.copy_(torch.as_tensor(b2))
    decay = [tmodel[0].weight, tmodel[2].weight]
    nodecay = [tmodel[0].bias, tmodel[2].bias]
    opt = torch.optim.AdamW(
        [{"params": decay, "weight_decay": wd},
         {"params": nodecay, "weight_decay": 0.0}],
        lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    sched = cosine_lr(lr, warmup, steps)
    sch = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: float(sched(s)))  # lr = 1.0 x sched
    tw = torch.as_tensor(cw, device=device) if cw is not None else None

    torch_losses = []
    for i in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(tmodel(xs_d[i]), ys_d[i], weight=tw)
        loss.backward()
        opt.step()
        sch.step()
        torch_losses.append(loss.detach())
    theirs = torch.stack(torch_losses).cpu().numpy().astype(np.float64)
    return ours, theirs, params, tmodel


def run(steps: int = 50, lr: float = 1e-3, wd: float = 0.05, warmup: int = 5,
        weighted: bool = True, seed: int = 0, device="cuda"):
    """The default mode: the tiny MLP's trajectories in both stacks."""
    rng = np.random.default_rng(seed)
    D_IN, HID, NCLS, B = 64, 32, 2, 16
    w1 = rng.normal(0, 0.05, (D_IN, HID)).astype(np.float32)
    b1 = np.zeros(HID, np.float32)
    w2 = rng.normal(0, 0.05, (HID, NCLS)).astype(np.float32)
    b2 = np.zeros(NCLS, np.float32)
    xs = rng.normal(0, 1, (steps, B, D_IN)).astype(np.float32)
    ys = rng.integers(0, NCLS, (steps, B))
    cw = np.array([0.6, 3.2], np.float32) if weighted else None

    ours, theirs, params, tmodel = _train_both(
        w1, b1, w2, b2, xs, ys, lr=lr, wd=wd, warmup=warmup, cw=cw, device=device)
    dev = np.abs(ours - theirs)
    final_w = np.abs(params["w1"] - tmodel[0].weight.detach().cpu().numpy().T).max()
    return {
        "steps": steps,
        "max_loss_dev": float(dev.max()),
        "mean_loss_dev": float(dev.mean()),
        "final_w1_dev": float(final_w),
        "ours_final_loss": float(ours[-1]),
        "torch_final_loss": float(theirs[-1]),
    }


def run_stage2(epochs: int = 3, lr: float = 1e-3, wd: float = 0.05, warmup: int = 10,
               seed: int = 0, device="cuda"):
    """Stage 2 end to end: the same init and batch stream in both stacks;
    the loss curves and the held-out pAUC."""
    rng = np.random.default_rng(seed)
    N, D_IN, HID, NCLS, B = 2048, 1024, 512, 2, 64
    # ISIC-shaped: ~3% positives, shifted along a random direction so the
    # task has signal but is not separable
    y = (rng.random(N) < 0.03).astype(np.int64)
    direction = rng.normal(0, 1, (D_IN,)).astype(np.float32)
    direction /= np.linalg.norm(direction)
    feats = rng.normal(0, 1, (N, D_IN)).astype(np.float32)
    feats += np.outer(y * 1.5 + rng.normal(0, 0.3, N), direction).astype(np.float32)

    n_train = 1536
    idx = rng.permutation(N)
    tr, va = idx[:n_train], idx[n_train:]

    steps_per_epoch = n_train // B
    order = np.concatenate(
        [rng.permutation(n_train) for _ in range(epochs)]
    )[: epochs * steps_per_epoch * B].reshape(-1, B)
    xs = feats[tr][order]
    ys = y[tr][order]

    # class-weighted CE as --class-weighted-loss computes it (balanced weights)
    counts = np.bincount(y[tr], minlength=2)
    cw = (n_train / (2.0 * counts)).astype(np.float32)

    w1 = (rng.normal(0, 1, (D_IN, HID)) * (1.0 / math.sqrt(D_IN))).astype(np.float32)
    b1 = np.zeros(HID, np.float32)
    w2 = (rng.normal(0, 1, (HID, NCLS)) * (1.0 / math.sqrt(HID))).astype(np.float32)
    b2 = np.zeros(NCLS, np.float32)

    ours, theirs, params, tmodel = _train_both(
        w1, b1, w2, b2, xs, ys, lr=lr, wd=wd, warmup=warmup, cw=cw, device=device)

    h = np.maximum(feats[va] @ params["w1"] + params["b1"], 0)
    logits_ours = h @ params["w2"] + params["b2"]
    probs_ours = torch.softmax(torch.from_numpy(logits_ours), dim=-1)[:, 1].numpy()
    with torch.no_grad():
        probs_torch = torch.softmax(
            tmodel(torch.as_tensor(feats[va], device=device)), dim=-1)[:, 1].cpu().numpy()

    pauc_ours = partial_auc(y[va], probs_ours, min_tpr=0.8)
    pauc_torch = partial_auc(y[va], probs_torch, min_tpr=0.8)
    dev = np.abs(ours - theirs)
    return {
        "epochs": epochs,
        "steps": int(xs.shape[0]),
        "val_samples": int(len(va)),
        "val_positives": int(y[va].sum()),
        "max_loss_dev": float(dev.max()),
        "mean_loss_dev": float(dev.mean()),
        "pauc_ours": float(pauc_ours),
        "pauc_torch": float(pauc_torch),
        "pauc_dev": float(abs(pauc_ours - pauc_torch)),
        "ours_final_loss": float(ours[-1]),
        "torch_final_loss": float(theirs[-1]),
    }


# ---------------------------------------------------------------------------
# --quant-stage1: does stage 1 trained under int8_delayed reach the same
# downstream pAUC as amp and fp32?
# ---------------------------------------------------------------------------


def _tiny_clip(quant, dtype, generator=None):
    """A tiny two-tower CLIP: the full model's module classes, scaled down so
    that a few hundred steps are cheap."""
    dg = make_dot_general_cls(quant)
    visual = VisionTransformer(image_size=32, patch_size=8, width=64, depth=3, num_heads=4,
                               embed_dim=64, dtype=dtype, dot_general_cls=dg,
                               generator=generator)
    text = TextBert(vocab_size=64, context_length=16, width=64, depth=3, num_heads=4,
                    embed_dim=64, dtype=dtype, dot_general_cls=dg, generator=generator)
    return ClipModel(visual, text)


def init_params(init_seed: int):
    """The tiny CLIP's initial parameters drawn from ``init_seed`` (fp32, a
    state dict) and the ``int8_delayed`` scales that one forward of the
    quantized model on two zero images and two all-ones token rows sets, as
    the JAX package's init makes its ``quant`` collection."""
    params = _tiny_clip(None, torch.float32,
                        torch.Generator().manual_seed(init_seed)).state_dict()
    mq = _tiny_clip("int8_delayed", torch.float32, torch.Generator().manual_seed(init_seed))
    mq.load_state_dict(params, strict=False)
    init_delayed_scales(mq, image=torch.zeros(2, 32, 32, 3),
                        text=torch.ones(2, 16, dtype=torch.int64))
    return params, {k: v.clone() for k, v in delayed_scales(mq).items()}


def _synth_isic(rng, n):
    """Synthetic ISIC-shaped paired data with shared latent structure.

    Latents: lesion type z in {0..3} (blob color / type word) and severity
    s in [0, 1] (blob size / severity word). Both towers can recover
    (z, s), so contrastive alignment is learnable, and the malignancy label
    depends on both, so held-out pAUC measures how much latent structure the
    trained towers captured (stage 2 trains a head on frozen stage-1
    features)."""
    z = rng.integers(0, 4, n)
    s = rng.random(n).astype(np.float32)
    logit = 3.0 * (s - 0.55) + 1.1 * (z - 1.5)
    p = 1.0 / (1.0 + np.exp(-(logit - 2.2)))
    y = (rng.random(n) < p).astype(np.int64)

    # images: 40px staged (train crop / eval center resize to 32), noisy
    # background + center-jittered blob; color from z, size from s
    imgs = rng.integers(90, 150, (n, 40, 40, 3), dtype=np.uint8)
    colors = np.array(
        [[230, 80, 80], [80, 230, 80], [80, 80, 230], [230, 200, 60]], np.float32)
    yy, xx = np.mgrid[0:40, 0:40].astype(np.float32)
    cy = 20 + rng.integers(-3, 4, n)
    cx = 20 + rng.integers(-3, 4, n)
    rad = 4.0 + 10.0 * s
    for i in range(n):
        mask = (yy - cy[i]) ** 2 + (xx - cx[i]) ** 2 <= rad[i] ** 2
        shade = colors[z[i]] * (0.65 + 0.35 * s[i])
        imgs[i][mask] = np.clip(
            shade + rng.normal(0, 12, (int(mask.sum()), 3)), 0, 255).astype(np.uint8)

    # reports: ctx 16, vocab 64 -- [CLS] TYPE_WORD SEV_WORD filler... [SEP] pad
    toks = np.zeros((n, 16), np.int32)
    toks[:, 0] = 1
    toks[:, 1] = 3 + z
    toks[:, 2] = 10 + np.clip((s * 8).astype(np.int64), 0, 7)
    for i in range(n):
        nf = int(rng.integers(2, 6))
        toks[i, 3:3 + nf] = rng.integers(30, 64, nf)
        toks[i, 3 + nf] = 2
    return imgs, toks, y, z, s


def _train_stage1_mode(mode, params0, quant0, imgs, toks, order, steps, batch, lr, seed,
                       device):
    """Train the tiny CLIP from ``params0`` (and ``quant0``'s delayed
    scales) under one numerics mode. Returns (losses, trained parameters as
    an fp32 state dict on the CPU)."""
    precision = "fp32" if mode == "fp32" else "amp"
    quant = "int8_delayed" if mode == "int8_delayed" else None
    policy = get_policy(precision)
    model = _tiny_clip(quant, policy.compute_dtype)
    model.load_state_dict({**params0, **(quant0 if quant else {})})
    model = model.to(device)
    policy.cast_params(model)

    args = Args(batch_size=batch, epochs=1, lr=lr, warmup=20, precision=precision,
                quant=quant)
    # a gentler crop than the ISIC default keeps the 40px blob in frame; the
    # same for every mode, so it cancels in the comparison
    tcfg = get_transform_config({"scale": (0.6, 1.0)}, 32, is_train=True)
    schedule = create_schedule(args, steps)
    tx = build_optimizer(args, schedule)
    state = create_train_state(model, tx, policy)
    fn = make_clip_train_step(model, tx, policy, args, tcfg, schedule)

    imgs_d = torch.as_tensor(imgs, device=device)
    toks_d = torch.as_tensor(toks, device=device)
    order_d = torch.as_tensor(order, device=device)

    def batch_of(i):
        return {"image": imgs_d[order_d[i]], "tokens": toks_d[order_d[i]]}

    if quant:
        state = fn.calibrate_quant(state, batch_of(0), seed)
    losses = []
    for i in range(steps):
        # the same seed in every mode: the same augmentation stream
        state, metrics = fn(state, batch_of(i), seed)
        losses.append(metrics["loss"].detach())
    trained = {k: v.detach().float().cpu() for k, v in state.model.named_parameters()}
    return torch.stack(losses).float().cpu().numpy().astype(np.float64), trained


def _embed_pairs(params, imgs, toks, device, batch=256):
    """The fp32 features of each pair, image and text concatenated: the
    stage-2 feature the pipeline feeds the classifier head."""
    model = _tiny_clip(None, torch.float32)
    model.load_state_dict(params)
    model = model.to(device).eval()
    feats = []
    with torch.no_grad():
        for i in range(0, len(imgs), batch):
            x = eval_preprocess(torch.as_tensor(imgs[i:i + batch], device=device),
                                out_size=32, out_dtype=torch.float32)
            out = model(image=x, text=torch.as_tensor(toks[i:i + batch], device=device))
            feats.append(torch.cat([out["image_features"], out["text_features"]], dim=-1))
    return torch.cat(feats).cpu().numpy()


def _train_head(feats_tr, y_tr, feats_va, order, w1, b1, w2, b2, *, device, lr=1e-3,
                wd=0.05, warmup=10, cw=None):
    """The stage-2 head on frozen features, the port's stack only (the
    stacks' parity is run() and run_stage2()'s). Returns (losses, held-out
    probabilities)."""
    xs = torch.as_tensor(feats_tr, device=device)
    ys = torch.as_tensor(y_tr, device=device)
    order_d = torch.as_tensor(order, device=device)
    losses, p = _train_ours((w1, b1, w2, b2), lambda i: (xs[order_d[i]], ys[order_d[i]]),
                            order.shape[0], lr=lr, wd=wd, warmup=warmup, cw=cw, device=device)
    h = np.maximum(feats_va @ p["w1"] + p["b1"], 0)
    logits = h @ p["w2"] + p["b2"]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return losses, (e / e.sum(-1, keepdims=True))[:, 1]


def run_quant_stage1(steps: int = 600, batch: int = 32, n_train: int = 4096,
                     n_s2: int = 3072, lr: float = 5e-4, seed: int = 0,
                     head_epochs: int = 4, seed_jitter: bool = True, device="cuda",
                     init=init_params):
    """The two-stage experiment: stage 1 from one initialization under
    fp32, amp and ``int8_delayed``, each tower grafted into the same stage-2
    head training (one head init, one batch stream), and the held-out pAUC
    above 80% TPR of each. The yardsticks of ``int8_delayed``'s deviation:
    amp's own deviation from fp32, and fp32 from the next seed's
    initialization. ``init(init_seed) -> (params, delayed scales)``, state
    dicts of the tiny CLIP (:func:`init_params`, the port's own draw)."""
    rng = np.random.default_rng(seed)
    imgs1, toks1, _, _, _ = _synth_isic(rng, n_train)
    # the stage-2 pool: fresh draws, a fixed split
    rng2 = np.random.default_rng(seed + 1000)
    imgs2, toks2, y2, _, _ = _synth_isic(rng2, n_s2)
    n_tr2 = (2 * n_s2) // 3
    idx2 = rng2.permutation(n_s2)
    tr2, va2 = idx2[:n_tr2], idx2[n_tr2:]

    order = np.stack([
        np.random.default_rng((seed, 7, i)).permutation(n_train)[:batch]
        for i in range(steps)
    ])

    params0, quant0 = init(seed)
    runs = [("fp32", params0), ("amp", params0), ("int8_delayed", params0)]
    if seed_jitter:
        params1, _ = init(seed + 1)
        runs.append(("fp32_seed1", params1))

    # one stage-2 head init and batch stream for every mode
    hrng = np.random.default_rng(seed + 2000)
    D, HID = 128, 64
    w1 = (hrng.normal(0, 1, (D, HID)) / math.sqrt(D)).astype(np.float32)
    b1 = np.zeros(HID, np.float32)
    w2 = (hrng.normal(0, 1, (HID, 2)) / math.sqrt(HID)).astype(np.float32)
    b2 = np.zeros(2, np.float32)
    spe = n_tr2 // 64
    horder = np.concatenate(
        [hrng.permutation(n_tr2) for _ in range(head_epochs)]
    )[: head_epochs * spe * 64].reshape(-1, 64)
    counts = np.bincount(y2[tr2], minlength=2)
    cw = (n_tr2 / (2.0 * counts)).astype(np.float32)

    out = {"steps": steps, "batch": batch, "n_train": n_train,
           "n_stage2": n_s2, "val_samples": int(len(va2)),
           "val_positives": int(y2[va2].sum()),
           "train2_positives": int(y2[tr2].sum()), "modes": {}}
    for mode, p0 in runs:
        m = mode.split("_seed")[0]
        losses, trained = _train_stage1_mode(
            m, p0, quant0 if m == "int8_delayed" else None,
            imgs1, toks1, order, steps, batch, lr, seed, device)
        feats = _embed_pairs(trained, imgs2, toks2, device)
        hlosses, probs = _train_head(
            feats[tr2], y2[tr2], feats[va2], np.ascontiguousarray(horder), w1, b1, w2, b2,
            cw=cw, device=device)
        pauc = float(partial_auc(y2[va2], probs, min_tpr=0.8))
        out["modes"][mode] = {
            "stage1_final_loss": float(np.mean(losses[-20:])),
            "stage1_first_loss": float(losses[0]),
            "head_final_loss": float(np.mean(hlosses[-10:])),
            "pauc": pauc,
        }

    p_fp32 = out["modes"]["fp32"]["pauc"]
    out["pauc_fp32"] = p_fp32
    out["dev_amp"] = abs(out["modes"]["amp"]["pauc"] - p_fp32)
    out["dev_int8_delayed"] = abs(out["modes"]["int8_delayed"]["pauc"] - p_fp32)
    if seed_jitter:
        out["dev_seed"] = abs(out["modes"]["fp32_seed1"]["pauc"] - p_fp32)
    return out


def run_mode(argv=None):
    """Parse the flags, run the mode they name and apply its PASS gate.
    Returns (the result, whether it passed, the parsed flags)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--stage2", action="store_true")
    p.add_argument("--quant-stage1", action="store_true")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="auto", help="auto|cuda|cpu (auto: the card)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    if a.quant_stage1:
        r = run_quant_stage1(steps=max(a.steps, 200) if a.steps != 50 else 600, device=device)
        ok = quant_stage1_passes(r)
    elif a.stage2:
        r = run_stage2(epochs=a.epochs, device=device)
        ok = r["max_loss_dev"] < 1e-3 and r["pauc_dev"] < 1e-4
    else:
        r = run(steps=a.steps, device=device)
        ok = r["max_loss_dev"] < 1e-4 and r["final_w1_dev"] < 1e-3
    return r, ok, a


def quant_stage1_passes(r) -> bool:
    """``--quant-stage1``'s gate: ``int8_delayed``'s pAUC deviation within
    ``1.5 * yardstick + 0.002``."""
    yard = max(r["dev_amp"], r.get("dev_seed", 0.0))
    return r["dev_int8_delayed"] <= 1.5 * yard + 0.002


def main(argv=None) -> int:
    r, ok, a = run_mode(argv)
    if a.json:
        print(json.dumps(r))
    else:
        for k, v in r.items():
            print(f"{k}: {v}")
    print("PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
