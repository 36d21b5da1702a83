"""The sequence-parallel scan (``ops/sharded_scan.py``) and GPipe
(``parallel/pipeline.py``) of the port over four gloo ranks on the CPU.

Four processes are started once for the module (``multiprocessing``'s
spawn on a free local port, each joined with a timeout of its own) and run
every case in turn: S = 2 on the subgroup of ranks 0 and 1, S = 4 on all
four, S = 1 on rank 0 alone. While they run, the parent computes the
references, jitted on one CPU device (JAX is imported there only, so
that the spawned ranks start without it):

- the scan: JAX's ``selective_scan_tm(..., impl="xla")`` on the whole
  sequence (JAX's ``tests/test_sharded_scan.py``, the same shapes and
  tolerances): the forward at S = 2 and 4 within 2e-5, S = 1 equal to the
  port's local scan within 1e-6, the gradients of u, delta, A, B and C at S = 4
  within 5e-4 of ``jax.grad`` of the same loss, the replicated A's
  gradient equal on every rank; the forward's ``collective-permute`` count
  2 (ceil(log2 S) + 1), A and h a permute a round, of B·G·DG·N·4 bytes each;
- GPipe (JAX's ``tests/test_pipeline_parallel.py``): the (S, M) cases (2,
  4), (4, 4) and (4, 1) of the toy stage against the sequential stack
  within 1e-6, the gradients of S = 4, M = 4 against ``jax.grad`` of the
  sequential loss within 1e-5 (the input's summed over the ranks), and 8
  of the port's ``EncoderBlock`` split into 4 stages of 2, the weights
  carried from Flax by ``convert.py``, against Flax's sequential apply
  within 2e-5; ``split_into_stages`` and a batch that M does not divide
  raise JAX's ``ValueError``.
"""

import socket
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mamba_clip_tpu_torch.convert import state_dict_from_jax
from mamba_clip_tpu_torch.parallel.pipeline import (pipeline_apply, split_into_stages,
                                                    stack_stages)

torch.set_num_threads(1)

WORLD = 4
TIMEOUT = 240
BSZ, G, L, DG, N = 2, 2, 64, 8, 4
PIPE_CASES = [(2, 4), (4, 4), (4, 1)]
BLOCKS = dict(depth=8, stages=4, microbatches=2, batch=4, tokens=10, width=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, task, payload, q):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        q.put((rank, globals()[task](rank, world, payload), None))
    except Exception:  # the parent reports it
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start_ranks(task: str, payload, world: int = WORLD):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, task, payload, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, q, time.monotonic() + TIMEOUT


def _join_ranks(procs, q, deadline):
    out, errs = {}, []
    try:
        for _ in procs:
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
    assert not errs, "\n".join(errs)
    return [out[r] for r in range(len(procs))]


# ---------------------------------------------------------------------------
# inputs, made from numpy seeds
# ---------------------------------------------------------------------------


def _scan_inputs(seed):
    """u, delta, A, B, C, D, bias as JAX's test draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(0, 1, (BSZ, G, L, DG)).astype(f),
            rng.normal(0, 0.5, (BSZ, G, L, DG)).astype(f),
            (-np.exp(rng.normal(0, 0.5, (G * DG, N)))).astype(f),
            rng.normal(0, 1, (BSZ, G, L, N)).astype(f),
            rng.normal(0, 1, (BSZ, G, L, N)).astype(f),
            rng.normal(0, 1, (G * DG,)).astype(f),
            rng.normal(0, 0.2, (G * DG,)).astype(f))


def _grad_weight():
    return np.random.default_rng(2).normal(0, 1, (BSZ, G, L, DG)).astype(np.float32)


def _toy_params(seed, n_stages, d):
    rng = np.random.default_rng(seed)
    return [{"w": (0.3 * rng.standard_normal((d, d))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(d)).astype(np.float32)} for _ in range(n_stages)]


def _toy_x(seed, B, d):
    return np.random.default_rng(seed).standard_normal((B, d)).astype(np.float32)


def _pipe_weight(B, d):
    return np.sin(np.arange(B * d, dtype=np.float32)).reshape(B, d)


def _block_params():
    """Flax variables of ``depth`` EncoderBlocks and the input, from seeds."""
    import jax
    import jax.numpy as jnp

    from mamba_clip_tpu.models.vit import EncoderBlock as JaxBlock

    b = BLOCKS
    block = JaxBlock(num_heads=2, mlp_ratio=2.0, dtype=jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (b["batch"], b["tokens"], b["width"])).astype(np.float32)
    init = jax.jit(lambda k: block.init(k, jnp.zeros((1, b["tokens"], b["width"])), True))
    params = [jax.tree_util.tree_map(np.asarray, init(k)["params"])
              for k in jax.random.split(jax.random.PRNGKey(5), b["depth"])]
    return block, params, x


# ---------------------------------------------------------------------------
# the ranks' task
# ---------------------------------------------------------------------------


def _scan_slice(t, rank, S):
    n = t.shape[2] // S
    return t[:, :, rank * n:(rank + 1) * n].contiguous()


def _task(rank, world, payload):
    from mamba_clip_tpu_torch.models.vit import EncoderBlock
    from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_tm
    from mamba_clip_tpu_torch.ops.sharded_scan import sharded_selective_scan_tm
    from mamba_clip_tpu_torch.parallel.collectives import count_collectives

    pair = dist.new_group([0, 1])
    alone = [dist.new_group([r]) for r in range(world)]
    groups = {1: alone[0], 2: pair, 4: None}
    out = {}

    # the scan's forward at S = 1, 2, 4 with its permutes counted
    u, delta, A, B, C, D, bias = (torch.from_numpy(a) for a in payload["scan"])
    for S in (1, 2, 4):
        if rank >= S:
            continue
        with count_collectives() as stats:
            y = sharded_selective_scan_tm(
                _scan_slice(u, rank, S), _scan_slice(delta, rank, S), A,
                _scan_slice(B, rank, S), _scan_slice(C, rank, S), D, bias,
                delta_softplus=True, group=groups[S])
        out[f"fwd{S}"] = (y.numpy(), stats)
    if rank == 0:
        out["local"] = selective_scan_tm(u, delta, A, B, C, D, bias, True).numpy()

    # the scan's gradients at S = 4
    u, delta, A, B, C, D, bias = (torch.from_numpy(a) for a in payload["scan_grad"])
    leaves = [_scan_slice(u, rank, 4), _scan_slice(delta, rank, 4), A.clone(),
              _scan_slice(B, rank, 4), _scan_slice(C, rank, 4)]
    for t in leaves:
        t.requires_grad_(True)
    y = sharded_selective_scan_tm(leaves[0], leaves[1], leaves[2], leaves[3], leaves[4], D,
                                  bias, delta_softplus=True)
    (y * _scan_slice(torch.from_numpy(payload["w"]), rank, 4)).sum().backward()
    out["grads"] = [t.grad.numpy() for t in leaves]

    # GPipe of the toy stage
    def toy(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    for S, M in PIPE_CASES:
        if rank < S:
            stages = [{k: torch.from_numpy(v) for k, v in p.items()}
                      for p in payload["toy"][(S, M)]]
            y = pipeline_apply(toy, stack_stages(stages), torch.from_numpy(payload["toy_x"]),
                               group=groups[S], microbatches=M)
            out[f"pipe{S}_{M}"] = y.numpy()

    stacked = stack_stages([{k: torch.from_numpy(v) for k, v in p.items()}
                            for p in payload["toy_grad"]])
    for t in stacked.values():
        t.requires_grad_(True)
    x = torch.from_numpy(payload["toy_grad_x"]).requires_grad_(True)
    y = pipeline_apply(toy, stacked, x, microbatches=4)
    (y * torch.from_numpy(payload["pipe_w"])).sum().backward()
    out["pipe_grads"] = ({k: t.grad[rank].numpy() for k, t in stacked.items()}, x.grad.numpy())

    # the port's EncoderBlocks, stages of 2
    b = BLOCKS
    template = EncoderBlock(b["width"], 2, mlp_ratio=2.0).eval()
    k = b["depth"] // b["stages"]

    def blocks(p, h):
        for j in range(k):
            h = torch.func.functional_call(template, p[f"sub{j}"], (h,))
        return h

    sds = [{n: torch.as_tensor(v) for n, v in sd.items()} for sd in payload["blocks"]]
    with torch.no_grad():
        y = pipeline_apply(blocks, split_into_stages(sds, b["stages"]),
                           torch.from_numpy(payload["blocks_x"]),
                           microbatches=b["microbatches"])
    out["blocks"] = y.numpy()
    return out


# ---------------------------------------------------------------------------
# the parent: the spawn, and JAX's references meanwhile
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from mamba_clip_tpu.ops.selective_scan import selective_scan_tm as jax_scan

    scan_in, scan_grad_in, w = _scan_inputs(0), _scan_inputs(1), _grad_weight()
    toy = {(S, M): _toy_params(0, S, 8) for S, M in PIPE_CASES}
    toy_grad = _toy_params(2, 4, 6)
    jblock, jparams, bx = _block_params()
    payload = {
        "scan": scan_in, "scan_grad": scan_grad_in, "w": w, "toy": toy,
        "toy_x": _toy_x(1, 8, 8), "toy_grad": toy_grad, "toy_grad_x": _toy_x(3, 8, 6),
        "pipe_w": _pipe_weight(8, 6),
        "blocks": [{k: v.numpy() for k, v in state_dict_from_jax({"params": p}).items()}
                   for p in jparams],
        "blocks_x": bx}
    procs, q, deadline = _start_ranks("_task", payload)

    ref = {}
    scan = jax.jit(lambda *a: jax_scan(*a, delta_softplus=True, impl="xla"))
    ref["scan"] = np.asarray(scan(*scan_in))
    D, bias = scan_grad_in[5], scan_grad_in[6]

    def loss(u, delta, A, B, C):
        return jnp.sum(jax_scan(u, delta, A, B, C, D, bias, delta_softplus=True,
                                impl="xla") * w)

    ref["grads"] = [np.asarray(g) for g in
                    jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*scan_grad_in[:5])]

    def toy_seq(stages, x):
        for p in stages:
            x = jnp.tanh(x @ p["w"] + p["b"])
        return x

    ref["pipe"] = {c: np.asarray(toy_seq(toy[c], payload["toy_x"])) for c in PIPE_CASES}
    g_stages, g_x = jax.grad(lambda st, x: jnp.sum(toy_seq(st, x) * payload["pipe_w"]),
                             argnums=(0, 1))(toy_grad, payload["toy_grad_x"])
    ref["pipe_grads"] = ([{k: np.asarray(v) for k, v in g.items()} for g in g_stages],
                         np.asarray(g_x))
    h = jnp.asarray(bx)
    apply = jax.jit(lambda p, h: jblock.apply({"params": p}, h, True))
    for p in jparams:
        h = apply(p, h)
    ref["blocks"] = np.asarray(h)
    return _join_ranks(procs, q, deadline), ref


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_forward_matches_single_device(runs, S):
    ranks, ref = runs
    y = np.concatenate([ranks[r][f"fwd{S}"][0] for r in range(S)], axis=2)
    np.testing.assert_allclose(y, ref["scan"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S", [2, 4])
def test_carry_pass_permutes(runs, S):
    """A and h a permute each, in ceil(log2 S) rounds and the shift; the
    forward issues nothing else."""
    ranks, _ = runs
    n = 2 * (int(np.ceil(np.log2(S))) + 1)
    assert n == {2: 4, 4: 6}[S]
    for r in range(S):
        assert ranks[r][f"fwd{S}"][1] == {
            "collective-permute": {"count": n, "bytes": n * BSZ * G * DG * N * 4}}


def test_single_shard_degenerates_to_local(runs):
    """S = 1: the carry pass is the identity and permutes nothing."""
    ranks, _ = runs
    y, stats = ranks[0]["fwd1"]
    np.testing.assert_allclose(y, ranks[0]["local"], rtol=1e-6, atol=1e-6)
    assert stats == {}


def test_sharded_gradients_match_single_device(runs):
    ranks, ref = runs
    names = ("u", "delta", "A", "B", "C")
    for i, name in enumerate(names):
        if name == "A":  # replicated: every rank holds the whole gradient
            got = ranks[0]["grads"][i]
            for r in ranks[1:]:
                assert np.array_equal(r["grads"][i], got)
        else:
            got = np.concatenate([r["grads"][i] for r in ranks], axis=2)
        np.testing.assert_allclose(got, ref["grads"][i], rtol=5e-4, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("S,M", PIPE_CASES)
def test_pipeline_matches_sequential_fwd(runs, S, M):
    ranks, ref = runs
    for r in range(S):  # replicated on every stage
        np.testing.assert_allclose(ranks[r][f"pipe{S}_{M}"], ref["pipe"][(S, M)],
                                   atol=1e-6, rtol=1e-6)


def test_pipeline_gradients_match_sequential(runs):
    ranks, ref = runs
    want_stages, want_x = ref["pipe_grads"]
    for r, rank in enumerate(ranks):
        for k, g in rank["pipe_grads"][0].items():
            np.testing.assert_allclose(g, want_stages[r][k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"stage{r}.{k}")
    dx = sum(rank["pipe_grads"][1] for rank in ranks)  # a replicated input's
    np.testing.assert_allclose(dx, want_x, atol=1e-5, rtol=1e-5, err_msg="dx")


def test_pipeline_real_encoder_blocks(runs):
    ranks, ref = runs
    for rank in ranks:
        np.testing.assert_allclose(rank["blocks"], ref["blocks"], atol=2e-5, rtol=2e-5)


def test_split_into_stages_validates():
    with pytest.raises(ValueError, match="split"):
        split_into_stages([{"w": torch.zeros(2)}] * 6, 4)
    toy = stack_stages([{"w": torch.zeros(4, 4), "b": torch.zeros(4)}] * 2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda p, h: h, toy, torch.zeros(8, 4), microbatches=3)
