"""The data axis across processes (``parallel/``), two gloo ranks on the CPU.

Each world is two processes started with ``multiprocessing``'s spawn on a
free local port; each process is joined with a timeout of its own, so a
stuck rendezvous fails the test instead of hanging it. A rank runs one
task of this module (``_task_*``) on its rows of the global batch and
returns numpy results; the parent holds them against:

- JAX: ``clip_loss``/``siglip_loss`` with ``axis_name`` inside ``shard_map``
  over 2 of the 8 CPU devices, and ``make_clip_train_step(mesh=...)`` over a
  2-device mesh at the global batch, with ``--local-loss`` on and off;
- the port in one process over the global batch (2B rows): the losses, the
  contrastive steps (also under ``--accum-freq 2``, against one process
  whose micro-batch j is the ranks' j-th ones), a VSSM classifier step with BatchNorm's global
  statistics, DropPath, head dropout and random crops (one global draw,
  sliced), class-weighted cross-entropy, and ``evaluate`` over an uneven
  split (7 rows: rank 0 takes 4, rank 1 takes 3).

Tolerances: fp32 throughout; the ranks sum in another order than one
process (the features' gather, the gradients' all-reduce, BatchNorm's
sums), so losses agree within rel 1e-5 and parameters after two AdamW
steps within 5e-5 of each leaf's largest entry (against JAX 1e-3, the
envelope one process of the port already needs: see the step test); what
the ranks must share (parameters, running statistics, the loss metric) is
equal bit for bit across them.
"""

import os
import socket
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mamba_clip_tpu_torch.parallel import collectives as coll

torch.set_num_threads(1)

WORLD, B = 2, 4                # two ranks of four rows: a global batch of 8
IMAGE, STAGING = 32, 40
VIT = dict(image_size=32, patch_size=16, width=32, depth=1, num_heads=2, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=1, num_heads=2, embed_dim=16)
VSSM_CLS = dict(depths=(1, 1), dims=(16, 32), num_classes=3, drop_path_rate=0.3)
FIXED = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
TIMEOUT = 240


# ---------------------------------------------------------------------------
# the two-rank harness
# ---------------------------------------------------------------------------


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
    except BaseException:  # the parent reports it
        q.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(task: str, payload, world: int = WORLD):
    """``task(rank, world, payload)`` on ``world`` gloo ranks; its results
    by rank."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, task, payload, q))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
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
    assert not errs, "\n".join(errs)
    return [out[r] for r in range(world)]


def _axis(rank, world):
    return coll.DataAxis(rank=rank, world=world)


def _rows(x, rank):
    return x[rank * B:(rank + 1) * B]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _sd(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# the ranks' tasks
# ---------------------------------------------------------------------------


def _features(seed=0, n=WORLD * B, d=16):
    rs = np.random.RandomState(seed)
    img = rs.standard_normal((n, d)).astype(np.float32)
    txt = rs.standard_normal((n, d)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    return img, txt, np.float32(14.3), np.float32(-2.0)


def _loss_fns():
    from mamba_clip_tpu_torch import losses

    return {
        "clip": lambda i, t, s, b, ax: losses.clip_loss(i, t, s, axis_name=ax),
        "clip_local": lambda i, t, s, b, ax: losses.clip_loss(i, t, s, axis_name=ax,
                                                              local_loss=True),
        "siglip": lambda i, t, s, b, ax: losses.siglip_loss(i, t, s, b, axis_name=ax),
    }


def _loss_and_grads(fn, img, txt, scale, bias, ax):
    ts = [torch.tensor(a).requires_grad_() for a in (img, txt, scale, bias)]
    loss = fn(*ts, ax)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() if t.grad is not None
                                  else np.zeros_like(a)
                                  for t, a in zip(ts, (img, txt, scale, bias))]


def _task_collectives_and_losses(rank, world, payload):
    out = {}
    t = torch.arange(6, dtype=torch.float32) * (rank + 1)
    coll.all_reduce_(t)
    m = torch.tensor([float(rank), 5.0 - rank])
    coll.all_reduce_(m, op=dist.ReduceOp.MAX)
    g = coll.all_gather_(torch.full((2, 2), float(rank)), world)
    out["coll"] = (t.numpy(), m.numpy(), g.numpy())
    img, txt, scale, bias = _features()
    with coll.data_axis(_axis(rank, world)):
        for name, fn in _loss_fns().items():
            out[name] = _loss_and_grads(fn, _rows(img, rank), _rows(txt, rank), scale, bias,
                                        "data")
        # gather_rows, sum_across and draw_rows under the axis
        x = torch.arange(4.0).reshape(2, 2).add(10 * rank).requires_grad_()
        y = coll.gather_rows(x)
        (y * torch.arange(1.0, 9.0).reshape(4, 2)).sum().backward()
        s = coll.sum_across(torch.tensor([1.0 + rank], requires_grad=True))
        gen = torch.Generator().manual_seed(3)
        d = coll.draw_rows(B, lambda n: torch.rand((n, 2), generator=gen))
        out["prims"] = (y.detach().numpy(), x.grad.numpy(), s.detach().numpy(), d.numpy())
    return out


@pytest.fixture(scope="module")
def axis_results():
    return _run_ranks("_task_collectives_and_losses", None)


def test_collectives(axis_results):
    for rank in range(WORLD):
        t, m, g = axis_results[rank]["coll"]
        np.testing.assert_array_equal(t, np.arange(6) * 3.0)
        np.testing.assert_array_equal(m, [1.0, 5.0])
        np.testing.assert_array_equal(g, np.stack([np.zeros((2, 2)), np.ones((2, 2))]))


def test_gather_sum_and_draw_primitives(axis_results):
    w = np.arange(1.0, 9.0).reshape(4, 2)
    rs = torch.rand((WORLD * B, 2), generator=torch.Generator().manual_seed(3)).numpy()
    for rank in range(WORLD):
        y, gx, s, d = axis_results[rank]["prims"]
        np.testing.assert_array_equal(y, np.concatenate([np.arange(4.0).reshape(2, 2),
                                                         np.arange(4.0).reshape(2, 2) + 10]))
        # each rank's loss sums y * w; the gather's backward sums the ranks'
        np.testing.assert_array_equal(gx, WORLD * w[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(s, [3.0])
        np.testing.assert_array_equal(d, _rows(rs, rank))


def _jax_shard_map_losses():
    """JAX's axis_name losses inside shard_map over 2 CPU devices, and
    their gradients with respect to the global features."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from mamba_clip_tpu import losses as jl

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    fns = {
        "clip": lambda i, t, s, b: jl.clip_loss(i, t, s, axis_name="data"),
        "clip_local": lambda i, t, s, b: jl.clip_loss(i, t, s, axis_name="data",
                                                      local_loss=True),
        "siglip": lambda i, t, s, b: jl.siglip_loss(i, t, s, b, axis_name="data"),
    }
    spec = P("data")
    out = {}
    for name, f in fns.items():
        g = shard_map(lambda i, t, s, b, f=f: jax.lax.pmean(f(i, t, s, b), "data"), mesh=mesh,
                      in_specs=(spec, spec, P(), P()), out_specs=P(), check_vma=False)
        loss, grads = jax.jit(jax.value_and_grad(g, argnums=(0, 1, 2, 3)))(
            *(jnp.asarray(a) for a in _features()))
        out[name] = (float(loss), [np.asarray(x) for x in grads])
    return out


@pytest.mark.parametrize("name", ["clip", "clip_local", "siglip"])
def test_losses_match_jax_shard_map_and_one_rank(axis_results, name):
    """The ranks' mean loss is JAX's pmean and the one-rank global loss; a
    rank's feature gradient, over W (the gather's backward sums the W ranks'
    losses), is JAX's gradient of its rows; the ranks' mean scale and bias
    gradients are JAX's."""
    want_loss, want_g = _jax_shard_map_losses()[name]
    img, txt, scale, bias = _features()
    one_loss, one_g = _loss_and_grads(_loss_fns()[name], img, txt, scale, bias, None)
    losses = [axis_results[r][name][0] for r in range(WORLD)]
    grads = [axis_results[r][name][1] for r in range(WORLD)]
    assert abs(np.mean(losses) - want_loss) <= 1e-6 * abs(want_loss)
    assert abs(np.mean(losses) - one_loss) <= 1e-6 * abs(one_loss)
    if name == "clip":  # the full logits on every rank: one loss
        assert losses[0] == losses[1]
    for k in (0, 1):
        got = np.concatenate([grads[r][k] for r in range(WORLD)]) / WORLD
        assert _rel(got, want_g[k]) <= 1e-5
        assert _rel(got, one_g[k]) <= 1e-5
    for k in (2, 3):
        got = np.mean([grads[r][k] for r in range(WORLD)])
        np.testing.assert_allclose(got, want_g[k], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the contrastive step: two ranks, JAX's mesh and one rank
# ---------------------------------------------------------------------------


def _clip_args(local_loss, precision="fp32", accum=1):
    from mamba_clip_tpu_torch.config import Args

    return Args(batch_size=B, epochs=1, lr=1e-3, warmup=1, wd=0.05, eps=1e-6,
                grad_clip_norm=1.0, precision=precision, local_loss=local_loss,
                accum_freq=accum)


def _clip_batches(n=2):
    rs = np.random.RandomState(1)
    out = []
    for _ in range(n):
        ids = rs.randint(4, 128, (WORLD * B, 16)).astype(np.int64)
        ids[:, 0] = 2
        for i, m in enumerate(rs.randint(3, 17, WORLD * B)):
            ids[i, m:] = 0
        out.append({"image": rs.randint(0, 256, (WORLD * B, STAGING, STAGING, 3),
                                        dtype=np.uint8), "tokens": ids})
    return out


def _rank_major_micro(b, accum=2):
    """The global batch as one process with ``--accum-freq accum`` must see
    it to match the ranks: micro-batch j is every rank's j-th micro-batch,
    rank-major."""
    mb = B // accum
    order = [r * B + j * mb + i for j in range(accum) for r in range(WORLD) for i in range(mb)]
    return {k: v[order] for k, v in b.items()}


def _port_clip_run(state_dict, local_loss, batches, rank=None, mesh=None, accum=1):
    """Two steps of the port's contrastive step on the rows of ``rank``
    (all of them when None)."""
    from mamba_clip_tpu_torch import train as ttrain
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.models import clip as tclip
    from mamba_clip_tpu_torch.models import text_bert as tbert
    from mamba_clip_tpu_torch.models import vit as tvit
    from mamba_clip_tpu_torch.optim import build_optimizer
    from mamba_clip_tpu_torch.schedules import create_schedule
    from mamba_clip_tpu_torch.utils.precision import get_policy

    args = _clip_args(local_loss, accum=accum)
    model = tclip.ClipModel(tvit.VisionTransformer(**VIT, attn_flash=True),
                            tbert.TextBert(**BERT, attn_flash=True))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    sched = create_schedule(args, 10)
    tx = build_optimizer(args, sched)
    step = ttrain.make_clip_train_step(model, tx, get_policy("fp32"), args,
                                       get_transform_config(FIXED, IMAGE, is_train=True),
                                       sched, mesh=mesh)
    state = ttrain.create_train_state(model, tx)
    losses = []
    for b in batches:
        sl = slice(None) if rank is None else slice(rank * B, (rank + 1) * B)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[sl])) for k, v in b.items()}
        state, m = step(state, batch, 0)
        losses.append(float(m["loss"]))
    return losses, _sd(model)


def _task_clip_steps(rank, world, payload):
    from mamba_clip_tpu_torch.parallel.mesh import create_mesh

    state_dict, batches = payload
    mesh = create_mesh()
    assert mesh.shape == {"data": world, "fsdp": 1, "model": 1} and mesh.rank == rank
    out = {local: _port_clip_run(state_dict, local, batches, rank, mesh)
           for local in (False, True)}
    out["accum"] = _port_clip_run(state_dict, False, batches, rank, mesh, accum=2)
    return out


@pytest.fixture(scope="module")
def clip_case():
    """The Flax init of the small CLIP, JAX's two steps over a 2-device
    mesh (local loss off and on), the port's one-rank steps and its two
    ranks'."""
    import jax
    import jax.numpy as jnp

    from mamba_clip_tpu import train as jtrain
    from mamba_clip_tpu.config import Args as JArgs
    from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jtcfg
    from mamba_clip_tpu.models import clip as jclip
    from mamba_clip_tpu.models import text_bert as jbert
    from mamba_clip_tpu.models import vit as jvit
    from mamba_clip_tpu.optim import build_optimizer as jbuild
    from mamba_clip_tpu.parallel.mesh import MeshSpec, create_mesh, data_sharding, replicated
    from mamba_clip_tpu.schedules import create_schedule as jsched
    from mamba_clip_tpu.utils.precision import get_policy as jpolicy
    from mamba_clip_tpu_torch.convert import load_jax_variables
    from mamba_clip_tpu_torch.models import clip as tclip
    from mamba_clip_tpu_torch.models import text_bert as tbert
    from mamba_clip_tpu_torch.models import vit as tvit

    jm = jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT))
    variables = jax.jit(lambda k, a, b: jm.init(k, image=a, text=b))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 16), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = tclip.ClipModel(tvit.VisionTransformer(**VIT), tbert.TextBert(**BERT))
    sd = _sd(load_jax_variables(tmodel, variables))
    batches = _clip_batches()

    mesh = create_mesh(MeshSpec(data=WORLD), devices=jax.devices()[:WORLD])
    want = {}
    for local in (False, True):
        a = JArgs(**{**_clip_args(local).to_dict(), "batch_size": WORLD * B})
        sched = jsched(a, 10)
        tx = jbuild(a, sched)
        st = jax.device_put(jtrain.create_train_state(variables["params"], tx, {},
                                                      policy=jpolicy("fp32")),
                            replicated(mesh))
        fn = jax.jit(jtrain.make_clip_train_step(jm, tx, jpolicy("fp32"), a,
                                                 jtcfg(FIXED, IMAGE, is_train=True), sched,
                                                 mesh=mesh))
        losses = []
        with mesh:
            for b in batches:
                b = {"image": b["image"], "tokens": b["tokens"].astype(np.int32)}
                st, m = fn(st, jax.device_put(b, data_sharding(mesh)), jax.random.PRNGKey(0))
                losses.append(float(m["loss"]))
        load_jax_variables(tmodel, {"params": jax.tree_util.tree_map(np.asarray, st.params)})
        want[local] = (losses, _sd(tmodel))
    one = {local: _port_clip_run(sd, local, batches) for local in (False, True)}
    one["accum"] = _port_clip_run(sd, False, [_rank_major_micro(b) for b in batches],
                                  accum=2)
    ranks = _run_ranks("_task_clip_steps", (sd, batches))
    return want, one, ranks


def _param_rel(got, want) -> float:
    """The worst leaf's deviation relative to its largest entry, leaving out
    the key third of each fused qkv bias: its true gradient is 0 (a softmax
    does not see a shift of its scores) and it holds rounding noise, which
    AdamW turns into steps of random sign."""
    worst = 0.0
    for k, y in want.items():
        x = got[k]
        if k.endswith("attn.qkv.bias"):
            n = y.shape[0] // 3
            x, y = np.concatenate([x[:n], x[2 * n:]]), np.concatenate([y[:n], y[2 * n:]])
        worst = max(worst, _rel(x, y))
    return worst


@pytest.mark.parametrize("local", [False, True], ids=["global_loss", "local_loss"])
def test_two_rank_clip_steps_match_jax_mesh_and_one_rank(clip_case, local):
    """Two steps: the ranks agree bit for bit; the losses are JAX's and one
    process's within rel 1e-5; the parameters one process's within 5e-5
    (1.3e-5 measured) and JAX's within 1e-3: one process of the port is
    3.1e-4 from JAX's parameters already (AdamW's first steps normalize each
    gradient entry, so a rounding-level difference in a small entry moves
    its update by up to the lr)."""
    want, one, ranks = clip_case
    (r0_losses, r0_sd), (r1_losses, r1_sd) = ranks[0][local], ranks[1][local]
    assert r0_losses == r1_losses
    for k in r0_sd:  # one update on every rank
        np.testing.assert_array_equal(r0_sd[k], r1_sd[k], err_msg=k)
    for (ref_losses, ref_sd), tol in ((want[local], 1e-3), (one[local], 5e-5)):
        for got, exp in zip(r0_losses, ref_losses):
            assert abs(got - exp) <= 1e-5 * abs(exp)
        assert _param_rel(r0_sd, ref_sd) <= tol


def test_two_rank_accum_steps_are_one_process_over_the_rank_major_micro_batches(clip_case):
    """``--accum-freq 2`` over two ranks: each rank's j-th micro-batch is
    gathered into the global feature bank, so the two ranks compute what
    one process computes with micro-batch j the ranks' j-th ones,
    rank-major. Losses within rel 1e-5; parameters within 5e-4 (1.1e-4
    measured): the micro-batches' gradients sum in another order, and
    AdamW's first steps normalize each entry, so a small entry's rounding
    moves its update by up to the lr."""
    _, one, ranks = clip_case
    (r0_losses, r0_sd), (r1_losses, _) = ranks[0]["accum"], ranks[1]["accum"]
    assert r0_losses == r1_losses
    for got, exp in zip(r0_losses, one["accum"][0]):
        assert abs(got - exp) <= 1e-5 * abs(exp)
    assert _param_rel(r0_sd, one["accum"][1]) <= 5e-4


# ---------------------------------------------------------------------------
# the classifier step: global BatchNorm, weighted loss, sliced draws
# ---------------------------------------------------------------------------


def _cls_run(rank=None, mesh=None):
    from mamba_clip_tpu_torch import train as ttrain
    from mamba_clip_tpu_torch.config import Args
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.models.vssm import VSSM
    from mamba_clip_tpu_torch.optim import build_optimizer
    from mamba_clip_tpu_torch.schedules import create_schedule
    from mamba_clip_tpu_torch.utils.precision import get_policy

    args = Args(batch_size=B, epochs=1, lr=1e-3, warmup=1, eps=1e-6, grad_clip_norm=1.0,
                precision="fp32", class_weighted_loss=True)
    model = VSSM(**VSSM_CLS, scan_impl="plain", generator=torch.Generator().manual_seed(0))
    sched = create_schedule(args, 10)
    tx = build_optimizer(args, sched)
    # random crops and flips: every rank takes its rows of one global draw
    tcfg = get_transform_config({"scale": (0.5, 1.0), "hflip": 0.5}, IMAGE, is_train=True)
    step = ttrain.make_classifier_train_step(
        model, tx, get_policy("fp32"), args, tcfg, sched,
        class_weights=np.array([1.0, 3.0, 0.5], np.float32), num_classes=3,
        takes_text=False, mesh=mesh)
    state = ttrain.create_train_state(model, tx)
    rs = np.random.RandomState(2)
    losses = []
    for _ in range(2):
        images = rs.randint(0, 256, (WORLD * B, STAGING, STAGING, 3), dtype=np.uint8)
        target = rs.randint(0, 3, WORLD * B).astype(np.int64)
        sl = slice(None) if rank is None else slice(rank * B, (rank + 1) * B)
        state, m = step(state, {"image": torch.from_numpy(images[sl]),
                                "target": torch.from_numpy(target[sl])}, 5)
        losses.append(float(m["loss"]))
    return losses, _sd(model)


def _task_classifier(rank, world, payload):
    from mamba_clip_tpu_torch.parallel.mesh import create_mesh

    return _cls_run(rank, create_mesh())


def test_two_rank_classifier_step_is_the_global_batch():
    """Two VSSM classifier steps (BatchNorm in the conv branches, DropPath
    0.3, head dropout 0.1, random crops, class weights) on two ranks
    against one process over the 8 rows: the loss, the parameters and the
    running statistics."""
    ranks = _run_ranks("_task_classifier", None)
    one_losses, one_sd = _cls_run()
    (l0, sd0), (l1, sd1) = ranks
    assert l0 == l1
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
    for got, exp in zip(l0, one_losses):
        assert abs(got - exp) <= 1e-5 * abs(exp)
    stats = [k for k in one_sd if "running" in k]
    assert stats
    # a conv bias that feeds a BatchNorm has true gradient 0 (the norm
    # removes a shift), so it holds rounding noise that AdamW turns into
    # steps of random sign; every other leaf and statistic is checked
    noise = ("conv_branch.conv0.bias", "conv_branch.conv1.bias")
    worst = max((_rel(sd0[k], v), k) for k, v in one_sd.items() if not k.endswith(noise))
    assert worst[0] <= 5e-5, worst


# ---------------------------------------------------------------------------
# evaluate over an uneven split
# ---------------------------------------------------------------------------


class _Rows:
    """Seven labeled rows of uint8 images, 2 classes."""

    def __init__(self, n=7):
        rs = np.random.RandomState(9)
        self.images = rs.randint(0, 256, (n, STAGING, STAGING, 3), dtype=np.uint8)
        self.targets = np.array([0, 1, 0, 0, 1, 1, 0])[:n]

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i):
        return {"image": self.images[i], "target": np.int64(self.targets[i])}


def _eval_run(rank=0, world=1):
    from mamba_clip_tpu_torch.config import Args
    from mamba_clip_tpu_torch.data.loader import BatchLoader
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.eval import evaluate
    from mamba_clip_tpu_torch.models.vssm import VSSM
    from mamba_clip_tpu_torch.utils.precision import get_policy

    model = VSSM(**{**VSSM_CLS, "num_classes": 2}, scan_impl="plain",
                 generator=torch.Generator().manual_seed(1))
    loader = BatchLoader(_Rows(), batch_size=2, rank=rank, world_size=world, workers=1,
                         shuffle=False, drop_last=False)
    data = {"val": types.SimpleNamespace(loader=loader)}
    run = types.SimpleNamespace(rank=rank, world_size=world, checkpoint_path=None)
    m = evaluate(model, None, data, 1, Args(epochs=1), get_policy("fp32"),
                 get_transform_config(None, IMAGE, is_train=False), run_state=run, stage=2,
                 takes_text=False, device="cpu",
                 class_weights=np.array([1.0, 2.0], np.float32))
    return m, loader.num_samples


def _task_eval(rank, world, payload):
    return _eval_run(rank, world)


def test_evaluate_at_world_two_equals_world_one():
    """7 rows over 2 ranks (4 and 3): the summed loss, the gathered
    probabilities in row order, so the same pAUC and sample count."""
    ranks = _run_ranks("_task_eval", None)
    want, _ = _eval_run()
    assert [n for _, n in ranks] == [4, 3]
    for m, _ in ranks:
        assert m["num_samples"] == want["num_samples"] == 7
        assert abs(m["val_loss"] - want["val_loss"]) <= 1e-6 * abs(want["val_loss"])
        assert m["partial_auc"] == want["partial_auc"]


# ---------------------------------------------------------------------------
# the pipeline: rank 0 writes
# ---------------------------------------------------------------------------


def _task_pipeline(rank, world, payload):
    from mamba_clip_tpu_torch import pipeline as tpipe
    from mamba_clip_tpu_torch.config import parse_args
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer
    from mamba_clip_tpu_torch.models import clip as tclip
    from mamba_clip_tpu_torch.models import text_bert as tbert
    from mamba_clip_tpu_torch.models import vit as tvit

    tpipe.build_clip = lambda **kw: tclip.ClipModel(tvit.VisionTransformer(**VIT),
                                                    tbert.TextBert(**BERT))
    tpipe.get_tokenizer = lambda name, **kw: HashTokenizer(16, 128)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    logs = os.path.join(payload, f"rank{rank}")
    argv = ["--model-stage-1", "tiny", "--batch-size", str(B), "--epochs", "1",
            "--train-num-samples", "16", "--val-num-samples", "8", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--logs", logs, "--workers", "1",
            "--force-image-size", str(IMAGE), "--save-most-recent", "--synthetic-data",
            "--device", "cpu", "--local-loss",
            "--copy-codebase", "--stage", "1"]
    m = tpipe.pipeline(parse_args(argv))
    files = sorted(os.path.relpath(os.path.join(d, f), logs)
                   for d, _, fs in os.walk(logs) for f in fs) if os.path.isdir(logs) else []
    return m, files


def test_pipeline_writes_on_rank_zero_only(tmp_path):
    """Stage 1 through ``pipeline()`` on two ranks (each given its own
    ``--logs``): rank 0 writes the run, rank 1 writes nothing; both get the
    same metrics."""
    (m0, f0), (m1, f1) = _run_ranks("_task_pipeline", str(tmp_path))
    assert f1 == []
    assert any(f.endswith("params.txt") for f in f0)
    assert any(f.endswith("results.jsonl") for f in f0)
    assert any("stage_1_epoch_latest" in f for f in f0)
    assert any("/code/mamba_clip_tpu_torch/" in f for f in f0)
    assert m0 == m1 and np.isfinite(m0["val_loss"])
