"""One attention interior's forward and backward, timed alone: the einsum
interior, the flash path and ``scaled_dot_product_attention``.

Counterpart of ``tools/flash_sweep.py``. It times forward + backward of one
interior at the text tower's shapes (B 64, h 12, T 256, hd 64, bf16, no
mask): a ``sum(o * w)`` loss of the output and its gradients in q, k and v.
Each row makes 20 timed calls after a warm-up, timed with CUDA events on
the card (the host's clock on the CPU). The rows:

- ``einsum``: the plain interior (``ops/flash_attn.attention_plain``) under
  autograd, what ``--attn-impl einsum`` runs;
- ``flash``: ``ops/flash_attn.FlashAttnFn``, the forward with residuals and
  the dk/dv and dq kernels (on the CPU: the plain interior and the plain
  backward, as every port wrapper does for a CPU tensor);
- ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention``, the
  library's call, printed beside the kernel and used nowhere in the port.

The JAX tool also sets the stock Pallas kernel's ``BlockSizes``. The
port's tiles are compile-time constants of the sources (``TcCfg`` in
``csrc/flash_attn_fwd.cu``, ``BwdCfg`` in ``csrc/flash_attn_bwd.cu``), so
it times the one instance the sources build and labels its row with the
tiles it reads from them.

    python -m mamba_clip_tpu_torch.flash_sweep [--device auto|cuda|cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch
import torch.nn.functional as F

from .ops import cuda_build
from .ops.flash_attn import FlashAttnFn, attention_plain
from .pipeline import resolve_device

SHAPE = (64, 12, 256, 64)  # B, h, T, hd: the text tower's
ITERS = 20
PATHS = ("einsum", "flash", "sdpa")


def tile_label(hd: int = 64) -> str:
    """The tensor-core bodies' tiles at head dim ``hd``, read from the
    sources: query rows and keys a block of the forward, own rows and
    staged rows a block of the backward."""
    def cfg(source, struct):
        text = (cuda_build.CSRC / source).read_text()
        body = text[text.index(f"struct {struct} {{"):]
        warps = int(re.search(r"kWarps = (\d+);", body).group(1))
        small, large = re.search(r"kBlockN = HD <= 64 \? (\d+) : (\d+);", body).groups()
        return 16 * warps, int(small) if hd <= 64 else int(large)

    fm, fn = cfg("flash_attn_fwd.cu", "TcCfg")
    bm, bn = cfg("flash_attn_bwd.cu", "BwdCfg")
    return f"tiles fwd {fm}x{fn}, bwd {bm}x{bn}"


def inputs(shape=SHAPE, dtype=torch.bfloat16, device="cpu", seed: int = 0):
    """q, k, v ``[B, T, h, hd]`` in ``dtype`` and the loss weights ``w``
    ``[B, T, h*hd]`` fp32, drawn as the JAX tool draws them (its
    ``[B, h, T, hd]`` layout, then transposed)."""
    B, h, T, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v, w = (torch.from_numpy(rng.normal(0, 1, (B, h, T, hd))).transpose(1, 2)
                  for _ in range(4))
    q, k, v = (t.to(device=device, dtype=dtype).contiguous() for t in (q, k, v))
    return q, k, v, w.reshape(B, T, h * hd).to(device=device, dtype=torch.float32).contiguous()


def fwd_bwd(path: str, q, k, v, w, impl=None):
    """The loss ``sum(o * w)`` of one interior and its gradients: returns
    (o ``[B, T, h*hd]``, loss, dq, dk, dv). ``impl`` for the flash path:
    None picks by the device (the kernels for CUDA tensors, the plain
    versions for CPU tensors), ``"cuda"`` asks for the kernels and raises
    where they cannot run."""
    B, T, h, hd = q.shape
    sm = hd ** -0.5
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    if path == "einsum":
        o = attention_plain(q, k, v, None, sm_scale=sm)
    elif path == "flash":
        if impl is None:
            impl = "cuda" if q.device.type == "cuda" else "plain"
        o = FlashAttnFn.apply(q, k, v, None, sm, impl)
    elif path == "sdpa":
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), scale=sm)
        o = o.transpose(1, 2).reshape(B, T, h * hd)
    else:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    loss = torch.sum(o.float() * w)
    dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
    return o.detach(), loss.detach(), dq, dk, dv


def time_ms(fn, device, iters: int = ITERS) -> float:
    """ms a call of ``fn`` over ``iters`` calls after one warm-up call:
    CUDA events on the card, the host's clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def sweep(device="cuda", shape=SHAPE, dtype=torch.bfloat16, iters: int = ITERS) -> dict:
    """ms a forward + backward of each row at ``shape``, with the flash
    row's tile label; prints a line a row as the JAX tool does."""
    device = torch.device(device)
    q, k, v, w = inputs(shape, dtype, device)
    out = {"shape": {"B": shape[0], "h": shape[1], "T": shape[2], "hd": shape[3]},
           "dtype": str(dtype).replace("torch.", ""), "iters": iters,
           "flash_tiles": tile_label(shape[3])}
    for path in PATHS:
        ms = time_ms(lambda: fwd_bwd(path, q, k, v, w), device, iters)
        out[f"{path}_ms"] = ms
        flash = (f"flash {out['flash_tiles']}" if device.type == "cuda"
                 else "flash (the plain versions, cpu)")
        label = {"einsum": "einsum fwd+bwd", "flash": flash,
                 "sdpa": "sdpa fwd+bwd (library)"}[path]
        print(f"{label}: {ms:7.2f} ms")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="auto", help="auto|cuda|cpu (auto: the card)")
    args = ap.parse_args(argv)
    return sweep(resolve_device(args.device))


if __name__ == "__main__":
    main()
