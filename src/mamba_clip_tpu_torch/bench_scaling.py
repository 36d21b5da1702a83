"""Weak-scaling bench of the stage-1 train step over a ladder of mesh
shapes, with the collectives of a step counted.

Counterpart of ``tools/bench_scaling.py``: the full stage-1 step (the
on-device preprocess, both towers, the global-batch InfoNCE and AdamW with
clipping) at a fixed batch a batch shard (weak scaling: the global batch is
``batch_per_device`` x data x fsdp) on each (data, fsdp, model) rung of
:func:`mesh_ladder`: ms a step, img/s, the weak-scaling efficiency against
the one-device step, and the collectives one step issues by kind, count and
output bytes (``parallel/collectives.py::count_collectives``, where JAX's
tool reads XLA's compiled HLO).

Each rung runs as W processes, one rank each: NCCL ranks, one a card, on
the card (the default ``--platform gpu``); gloo ranks on the host's cores
with ``--platform cpu``, where the ranks share the cores, so the times are
not a card's and the work-normalised efficiency and the collectives are
what the run can show. The model is placed on the rung's mesh by
``create_train_state(..., mesh=)`` (``parallel/sharding.py``), and the
step is ``make_clip_train_step``'s; on the card it runs the flash kernels
(``attn_impl="flash"``).

Usage:
    python -m mamba_clip_tpu_torch.bench_scaling --devices 4 --model flagship \\
        --precision amp --batch-per-device 64 --json out.json
    python -m mamba_clip_tpu_torch.bench_scaling --platform cpu --devices 2 --steps 2
"""

from __future__ import annotations

import argparse
import json
import socket
import time
import traceback

import numpy as np


def mesh_ladder(n: int):
    """(data, fsdp, model) rungs to measure, all using <= n devices."""
    rungs = [(1, 1, 1)]
    d = 2
    while d <= n:
        rungs.append((d, 1, 1))
        d *= 2
    if n >= 4:
        rungs.append((n // 2, 2, 1))
        rungs.append((n // 4 if n >= 8 else 1, 2, 2))
    if n >= 8:
        rungs.append((1, n // 2, 2))
    # dedup, preserve order
    seen, out = set(), []
    for r in rungs:
        if r not in seen and r[0] * r[1] * r[2] <= n:
            seen.add(r)
            out.append(r)
    return out


def build_step(args_ns, dims, device):
    """(state, step_fn, this rank's rows of the global batch, global batch)
    on the rung ``dims`` of the process group's mesh."""
    import torch

    from .config import Args
    from .data.preprocess_cfg import get_transform_config
    from .models import build_clip
    from .models.clip import ClipModel
    from .models.text_bert import TextBert
    from .models.vit import VisionTransformer
    from .optim import build_optimizer
    from .parallel.mesh import MeshSpec, create_mesh
    from .schedules import create_schedule
    from .train import create_train_state, make_clip_train_step
    from .utils.precision import get_policy

    mesh = create_mesh(MeshSpec(*dims))
    B = args_ns.batch_per_device * dims[0] * dims[1]  # weak scaling
    img = args_ns.image_size
    args = Args(batch_size=B, epochs=1, precision=args_ns.precision, warmup=1, lr=1e-4,
                grad_clip_norm=1.0, local_loss=False)
    policy = get_policy(args.precision)
    tcfg = get_transform_config(None, img, is_train=True)
    flash = args_ns.platform == "gpu"
    gen = torch.Generator().manual_seed(0)
    if args_ns.model == "flagship":
        model = build_clip("biomedclip", image_size=img, dtype=policy.compute_dtype,
                           attn_flash=flash, generator=gen)
        ctx, vocab = 256, 30522
    else:
        visual = VisionTransformer(image_size=img, patch_size=16, width=args_ns.width,
                                   depth=args_ns.depth, num_heads=2, embed_dim=64,
                                   dtype=policy.compute_dtype, attn_flash=flash, generator=gen)
        text = TextBert(vocab_size=512, context_length=32, width=args_ns.width,
                        depth=args_ns.depth, num_heads=2, embed_dim=64,
                        dtype=policy.compute_dtype, attn_flash=flash, generator=gen)
        model = ClipModel(visual=visual, text=text)
        ctx, vocab = 32, 512
    model = model.to(device)
    policy.cast_params(model)
    schedule = create_schedule(args, 100)
    tx = build_optimizer(args, schedule)
    state = create_train_state(model, tx, policy, mesh=mesh)
    step_fn = make_clip_train_step(model, tx, policy, args, tcfg, schedule, mesh=mesh)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, img + 16, img + 16, 3), dtype=np.uint8)
    tokens = rng.integers(4, vocab, (B, ctx), dtype=np.int32)
    ax = mesh.axis()
    rows = slice(ax.rank * (B // ax.world), (ax.rank + 1) * (B // ax.world))
    batch = {"image": torch.from_numpy(images[rows]).to(device),
             "tokens": torch.from_numpy(tokens[rows]).to(device)}
    return state, step_fn, batch, B


def _rung(rank, world, port, args_ns, dims, q):
    """One rank of a rung: warm-up steps, timed steps (the collectives of the
    first counted), then (rank, reading, error) on ``q``."""
    try:
        import torch
        import torch.distributed as dist

        from .parallel.collectives import count_collectives

        if args_ns.platform == "gpu":
            torch.cuda.set_device(rank)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            device, backend = torch.device("cuda", rank), "nccl"
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
            device, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        state, step_fn, batch, B = build_step(args_ns, dims, device)
        for _ in range(args_ns.warmup):
            state, metrics = step_fn(state, batch, 0)
        float(metrics["loss"])
        sync()
        t0 = time.perf_counter()
        for i in range(args_ns.steps):
            if i == 0:
                with count_collectives() as colls:
                    state, metrics = step_fn(state, batch, 0)
            else:
                state, metrics = step_fn(state, batch, 0)
        loss = float(metrics["loss"])
        sync()
        dt = (time.perf_counter() - t0) / args_ns.steps
        dist.destroy_process_group()
        q.put((rank, {"step_s": dt, "loss": loss, "global_batch": B, "collectives": colls}, None))
    except Exception:
        q.put((rank, None, traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rung(args_ns, dims):
    """The rung ``dims`` on data x fsdp x model spawned ranks; their readings
    by rank (each rank joined with ``--timeout``)."""
    import multiprocessing as mp

    world = dims[0] * dims[1] * dims[2]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rung, args=(r, world, port, args_ns, dims, q))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + args_ns.timeout
    out, errs = {}, []
    try:
        for _ in range(world):
            rank, res, err = q.get(timeout=max(deadline - time.monotonic(), 1.0))
            if err:
                errs.append(f"rank {rank}:\n{err}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    if errs:
        raise RuntimeError(f"mesh {dims}: " + "\n".join(errs))
    return [out[r] for r in range(world)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="gpu = NCCL ranks, one a card, times are the cards'; cpu = gloo "
                         "ranks sharing the host's cores (a methodology run)")
    ap.add_argument("--batch-per-device", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--model", default="tiny", choices=("tiny", "flagship"))
    ap.add_argument("--precision", default="fp32",
                    help="fp32 on the CPU; amp on the card")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a rung's ranks may take together")
    ap.add_argument("--json", default=None, help="write results JSON here")
    args_ns = ap.parse_args(argv)

    device = "host CPU cores"
    if args_ns.platform == "gpu":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling: --platform gpu and no CUDA card (--platform cpu "
                             "runs gloo ranks on the host)")
        if torch.cuda.device_count() < args_ns.devices:
            raise SystemExit(f"bench_scaling: need {args_ns.devices} cards, have "
                             f"{torch.cuda.device_count()}")
        device = torch.cuda.get_device_name(0)

    rows = []
    for dims in mesh_ladder(args_ns.devices):
        n = dims[0] * dims[1] * dims[2]
        ranks = run_rung(args_ns, dims)
        r0 = ranks[0]
        dt, B, colls = r0["step_s"], r0["global_batch"], r0["collectives"]
        if not np.isfinite(r0["loss"]):
            raise RuntimeError(f"non-finite loss {r0['loss']} at mesh {dims}")
        rows.append({
            "mesh": {"data": dims[0], "fsdp": dims[1], "model": dims[2]},
            "devices": n, "global_batch": B, "step_ms": dt * 1e3,
            "img_per_s": B / dt, "loss": r0["loss"], "collectives": colls,
            "step_ms_ranks": [r["step_s"] * 1e3 for r in ranks],
        })
        cstr = ", ".join(
            f"{k}×{v['count']} ({v['bytes']/1e6:.2f} MB)"
            for k, v in sorted(colls.items())) or "none"
        print(f"mesh {dims}: {dt*1e3:8.1f} ms/step  {B/dt:8.1f} img/s "
              f"(global B={B})  collectives: {cstr}", flush=True)

    base = rows[0]["step_ms"]
    base_b = rows[0]["global_batch"]
    # weak_scaling_efficiency = t(1 device)/t(n devices) at a fixed batch a
    # device (1.0 when the devices truly run in parallel);
    # work_normalized_efficiency = the per-row time against the one-device
    # per-row time: where the ranks share the host's cores (--platform cpu)
    # the raw ratio falls towards 1/n by construction, and the work
    # normalisation isolates the collectives' and the sharding's overhead
    print("\nefficiency (weak scaling, fixed per-device batch):")
    for r in rows:
        r["weak_scaling_efficiency"] = base / r["step_ms"]
        r["work_normalized_efficiency"] = (base * r["global_batch"] / base_b) / r["step_ms"]
        d = r["mesh"]
        print(f"  {d['data']}x{d['fsdp']}x{d['model']}: "
              f"parallel-eff={r['weak_scaling_efficiency']:.3f}  "
              f"work-eff={r['work_normalized_efficiency']:.3f}  "
              f"({r['step_ms']:.1f} ms, B={r['global_batch']})")
    if args_ns.platform == "cpu":
        print("  (gloo ranks share the host's cores: work-eff is the meaningful column; "
              "parallel-eff needs one card a rank)")

    out = {
        "platform": args_ns.platform,
        "model": args_ns.model,
        "batch_per_device": args_ns.batch_per_device,
        "image_size": args_ns.image_size,
        "precision": args_ns.precision,
        "steps": args_ns.steps,
        "rows": rows,
        "device": device,
        "note": ("gloo ranks on the host's CPU cores: ratios and the collectives are the "
                 "result; the times are not a card's"
                 if args_ns.platform == "cpu" else "real device timings"),
    }
    if args_ns.json:
        with open(args_ns.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"\nwrote {args_ns.json}")
    return out


if __name__ == "__main__":
    main()
