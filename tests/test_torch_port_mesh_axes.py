"""The fsdp and model axes (``parallel/mesh.py``, ``parallel/sharding.py``)
over four gloo ranks on the CPU.

Four processes are started once for the module (``multiprocessing``'s
spawn on a free local port, each joined with a timeout of its own) and run
every case in turn, each on a mesh of its own shape: the small CLIP of
JAX's ``test_fsdp_tp_train_step_matches_replicated`` (image 32, width 32,
depth 1, vocab 128, context 16; 16 rows global, fp32) at (data 2, fsdp 2),
(data 2, model 2) and (fsdp 4), and a small medmamba classifier (BatchNorm
in training mode, class-weighted cross-entropy) at (data 2, fsdp 2) and
(data 2, model 2). A rank takes the rows of its batch index d·F + f, runs
two steps and returns its gathered parameters. While the ranks run, the
parent runs the references:

- the port in one process over the 16 rows;
- JAX's jitted step on a ``MeshSpec`` of the same shape over 4 of the 8
  virtual CPU devices, its state placed by JAX's ``param_sharding``, the
  weights carried by ``convert.py``.

Tolerances, as the data axis's (``test_torch_port_data_axis.py``): the
losses within rel 1e-5; the parameters within 5e-5 of one process and
1e-3 of JAX, relative to each leaf's largest entry (the key third of a
fused qkv bias and the biases of the convolutions ahead of a BatchNorm
left out: their true gradient is 0); the ranks' gathered parameters bit
for bit alike; the grad norms one process's within rel 1e-4. No randomness
the frameworks draw differently: DropPath off, the crop fixed.

The CLIP runs with the arguments of JAX's test (AdamW's defaults, no
clipping; 1.9e-5 from one process measured at (data 2, model 2)). With the
data axis test's clipping at 1 and eps 1e-6 the same case measured 5.4e-5,
on two entries of the text tower's ``attn.out.bias`` whose clipped
gradients sit at about 2·eps, where AdamW's second step turns the model
axis's other summation order (the input gradients of the column-parallel
layers are sums over the model group) into steps of 1e-4·lr. The
classifier keeps that clipping, so the sharded norm clips.
"""

import socket
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD, GLOBAL = 4, 16
IMAGE, STAGING = 32, 40
VIT = dict(image_size=32, patch_size=16, width=32, depth=1, num_heads=2, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=1, num_heads=2, embed_dim=16)
VSSM_CLS = dict(depths=(1, 1), dims=(16, 32), num_classes=3, drop_path_rate=0.0)
FIXED = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
CLASS_WEIGHTS = np.array([1.0, 3.0, 0.5], np.float32)
CASES = [("clip", (2, 2, 1)), ("clip", (2, 1, 2)), ("clip", (1, 4, 1)),
         ("cls", (2, 2, 1)), ("cls", (2, 1, 2))]
TIMEOUT = 300


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


def _start_ranks(task: str, payload, world: int = WORLD, worker=None):
    """``worker`` (this module's ``_worker`` by default) on ``world`` gloo
    ranks running ``task`` of its module; join with :func:`_join_ranks`."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=worker or _worker, args=(r, world, port, task, payload, q))
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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _param_rel(got, want):
    """The worst leaf's deviation relative to its largest entry, and the
    leaf, leaving out the leaves whose true gradient is 0 and which hold
    rounding noise that AdamW turns into steps of random sign: the key third
    of a fused qkv bias and the biases of the convolutions ahead of a
    BatchNorm."""
    worst = (0.0, "")
    for k, y in want.items():
        x = got[k]
        if k.endswith("attn.qkv.bias"):
            n = y.shape[0] // 3
            x, y = np.concatenate([x[:n], x[2 * n:]]), np.concatenate([y[:n], y[2 * n:]])
        elif k.endswith(("conv_branch.conv0.bias", "conv_branch.conv1.bias")):
            continue
        worst = max(worst, (_rel(x, y), k))
    return worst


# ---------------------------------------------------------------------------
# the port's runs: one process, or one rank of a mesh
# ---------------------------------------------------------------------------


def _args(kind):
    """The CLIP: the arguments of JAX's test (AdamW's defaults, no
    clipping). The classifier: the data axis's classifier test's (eps 1e-6,
    clipping at 1), so that the clipping runs on a sharded norm."""
    from mamba_clip_tpu_torch.config import Args

    if kind == "clip":
        return Args(batch_size=GLOBAL, epochs=1, lr=1e-3, warmup=1, precision="fp32")
    return Args(batch_size=GLOBAL, epochs=1, lr=1e-3, warmup=1, eps=1e-6, grad_clip_norm=1.0,
                precision="fp32", class_weighted_loss=True)


def _batches(kind):
    rs = np.random.RandomState(1 if kind == "clip" else 2)
    out = []
    for _ in range(2):
        b = {"image": rs.randint(0, 256, (GLOBAL, STAGING, STAGING, 3), dtype=np.uint8)}
        if kind == "clip":
            ids = rs.randint(4, 128, (GLOBAL, 16)).astype(np.int64)
            ids[:, 0] = 2
            for i, m in enumerate(rs.randint(3, 17, GLOBAL)):
                ids[i, m:] = 0
            b["tokens"] = ids
        else:
            b["target"] = rs.randint(0, 3, GLOBAL).astype(np.int64)
        out.append(b)
    return out


def _port_model(kind, state_dict, quant=None):
    from mamba_clip_tpu_torch.models import clip as tclip
    from mamba_clip_tpu_torch.models import text_bert as tbert
    from mamba_clip_tpu_torch.models import vit as tvit
    from mamba_clip_tpu_torch.models.vssm import VSSM
    from mamba_clip_tpu_torch.ops.quant import make_dot_general_cls

    if kind == "clip":
        model = tclip.ClipModel(tvit.VisionTransformer(**VIT, attn_flash=True),
                                tbert.TextBert(**BERT, attn_flash=True))
    else:
        model = VSSM(**VSSM_CLS, scan_impl="plain",
                     dot_general_cls=make_dot_general_cls(quant))
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return model


def _port_run(kind, state_dict, batches, mesh=None):
    """Two steps on the rows of this rank's batch index (all of them without
    a mesh); the losses, the grad norms and the whole parameters and
    statistics after them."""
    from mamba_clip_tpu_torch import train as ttrain
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.optim import build_optimizer
    from mamba_clip_tpu_torch.parallel.sharding import full_params
    from mamba_clip_tpu_torch.schedules import create_schedule
    from mamba_clip_tpu_torch.utils.precision import get_policy

    args = _args(kind)
    model = _port_model(kind, state_dict)
    sched = create_schedule(args, 10)
    tx = build_optimizer(args, sched)
    pol, tcfg = get_policy("fp32"), get_transform_config(FIXED, IMAGE, is_train=True)
    state = ttrain.create_train_state(model, tx, pol, mesh=mesh)
    if kind == "clip":
        step = ttrain.make_clip_train_step(model, tx, pol, args, tcfg, sched, mesh=mesh)
    else:
        step = ttrain.make_classifier_train_step(
            model, tx, pol, args, tcfg, sched, class_weights=CLASS_WEIGHTS, num_classes=3,
            takes_text=False, mesh=mesh)
    rows = slice(None)
    if mesh is not None:
        ax = mesh.axis()
        per = GLOBAL // ax.world
        rows = slice(ax.rank * per, (ax.rank + 1) * per)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                                for k, v in b.items()}, 0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = {k: v.detach().numpy().copy() for k, v in full_params(model).items()}
    full.update({k: v.detach().numpy().copy() for k, v in model.named_buffers()})
    return {"losses": losses, "grad_norms": norms, "params": full}


def _task_cases(rank, world, payload):
    from mamba_clip_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    sds, batches = payload
    out = {}
    for kind, shape in CASES:
        mesh = create_mesh(MeshSpec(*shape))
        assert mesh.shape == dict(zip(("data", "fsdp", "model"), shape))
        out[(kind, shape)] = _port_run(kind, sds[kind], batches[kind], mesh)
    # --quant under a model axis: the int8 dots' column-slice scales are not
    # designed; under fsdp the dots see the gathered kernel and run
    from mamba_clip_tpu_torch import train as ttrain
    from mamba_clip_tpu_torch.config import Args
    from mamba_clip_tpu_torch.optim import build_optimizer

    mesh = create_mesh(MeshSpec(data=2, model=2))
    model = _port_model("cls", None, quant="int8_fast")
    try:
        ttrain.create_train_state(model, build_optimizer(Args(), None), mesh=mesh)
        out["quant_model_axis"] = None
    except NotImplementedError as e:
        out["quant_model_axis"] = str(e)
    mesh = create_mesh(MeshSpec(data=2, fsdp=2))
    model = _port_model("cls", None, quant="int8_fast")
    ttrain.create_train_state(model, build_optimizer(Args(), None), mesh=mesh)
    return out


# ---------------------------------------------------------------------------
# the references: JAX's sharded step and one port process
# ---------------------------------------------------------------------------


def _jax_init(kind):
    import jax
    import jax.numpy as jnp

    from mamba_clip_tpu.models import clip as jclip
    from mamba_clip_tpu.models import text_bert as jbert
    from mamba_clip_tpu.models import vit as jvit
    from mamba_clip_tpu.models.vssm import VSSM as JaxVSSM

    if kind == "clip":
        jm = jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT))
        init = jax.jit(lambda k, a, b: jm.init(k, image=a, text=b))
        variables = init(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)),
                         jnp.zeros((1, 16), jnp.int32))
    else:
        jm = JaxVSSM(scan_impl="xla", **VSSM_CLS)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)))
    return jm, jax.tree_util.tree_map(np.asarray, variables)


def _jax_run(kind, jm, variables, batches, shape):
    """JAX's two jitted steps over a (data, fsdp, model) mesh of 4 CPU
    devices, its state placed by ``param_sharding``; the losses and the
    parameters (and statistics) as the port's state dict."""
    import jax

    from mamba_clip_tpu import train as jtrain
    from mamba_clip_tpu.config import Args as JArgs
    from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jtcfg
    from mamba_clip_tpu.optim import build_optimizer as jbuild
    from mamba_clip_tpu.parallel.mesh import MeshSpec, create_mesh, data_sharding, param_sharding
    from mamba_clip_tpu.schedules import create_schedule as jsched
    from mamba_clip_tpu.utils.precision import get_policy as jpolicy
    from mamba_clip_tpu_torch.convert import load_jax_variables

    a = JArgs(**_args(kind).to_dict())
    sched = jsched(a, 10)
    tx = jbuild(a, sched)
    mesh = create_mesh(MeshSpec(*shape), devices=jax.devices()[:WORLD])
    st = jtrain.create_train_state(variables["params"], tx, variables.get("batch_stats", {}),
                                   policy=jpolicy("fp32"))
    st = jax.device_put(st, param_sharding(mesh, st))
    tcfg = jtcfg(FIXED, IMAGE, is_train=True)
    if kind == "clip":
        fn = jtrain.make_clip_train_step(jm, tx, jpolicy("fp32"), a, tcfg, sched, mesh=mesh)
    else:
        fn = jtrain.make_classifier_train_step(jm, tx, jpolicy("fp32"), a, tcfg, sched,
                                               class_weights=CLASS_WEIGHTS, num_classes=3,
                                               takes_text=False)
    fn = jax.jit(fn)
    losses = []
    with mesh:
        for b in batches:
            b = {k: v.astype(np.int32) if v.dtype == np.int64 else v for k, v in b.items()}
            st, m = fn(st, jax.device_put(b, data_sharding(mesh)), jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
    model = _port_model(kind, None)
    load_jax_variables(model, {"params": jax.tree_util.tree_map(np.asarray, st.params),
                               **({"batch_stats": jax.tree_util.tree_map(
                                   np.asarray, st.batch_stats)} if kind == "cls" else {})})
    return {"losses": losses, "params": {k: v.detach().numpy().copy()
                                         for k, v in model.state_dict().items()}}


@pytest.fixture(scope="module")
def mesh_case():
    """The ranks' runs of every case, one port process's and JAX's."""
    from mamba_clip_tpu_torch.convert import load_jax_variables

    with ThreadPoolExecutor(2) as pool:
        inits = dict(zip(("clip", "cls"), pool.map(_jax_init, ("clip", "cls"))))
    sds = {kind: {k: v.detach().numpy().copy() for k, v in load_jax_variables(
        _port_model(kind, None), variables).state_dict().items()}
        for kind, (_, variables) in inits.items()}
    batches = {kind: _batches(kind) for kind in ("clip", "cls")}
    procs, q, deadline = _start_ranks("_task_cases", (sds, batches))
    try:
        one = {kind: _port_run(kind, sds[kind], batches[kind]) for kind in ("clip", "cls")}
        # XLA compiles the five sharded steps side by side
        with ThreadPoolExecutor(len(CASES)) as pool:
            futs = {(kind, shape): pool.submit(_jax_run, kind, *inits[kind], batches[kind], shape)
                    for kind, shape in CASES}
            jax_runs = {case: f.result() for case, f in futs.items()}
    finally:
        ranks = _join_ranks(procs, q, deadline)
    return ranks, one, jax_runs


@pytest.mark.parametrize("kind,shape", CASES, ids=[f"{k}-{'x'.join(map(str, s))}"
                                                   for k, s in CASES])
def test_four_ranks_match_one_process_and_jax_mesh(mesh_case, kind, shape):
    """Two steps on four ranks: their gathered parameters bit for bit
    alike; the losses one process's and JAX's within rel 1e-5; the
    parameters (and BatchNorm's statistics) one process's within 5e-5 and
    JAX's within 1e-3."""
    ranks, one, jax_runs = mesh_case
    got = [r[(kind, shape)] for r in ranks]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        for k, v in got[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    mine = got[0]
    for ref, tol in ((one[kind], 5e-5), (jax_runs[(kind, shape)], 1e-3)):
        for a, b in zip(mine["losses"], ref["losses"]):
            assert abs(a - b) <= 1e-5 * abs(b), (mine["losses"], ref["losses"])
        params = {k: v for k, v in ref["params"].items() if not k.endswith("num_batches_tracked")}
        worst = _param_rel(mine["params"], params)
        assert worst[0] <= tol, worst
    for a, b in zip(mine["grad_norms"], one[kind]["grad_norms"]):
        assert abs(a - b) <= 1e-4 * abs(b)


def test_quant_under_a_model_axis_raises_naming_item_8(mesh_case):
    """``--quant`` with a model axis raises, naming ROADMAP item 8; under
    an fsdp axis the same model places (its dots see the gathered kernel)."""
    ranks, _, _ = mesh_case
    for r in ranks:
        assert r["quant_model_axis"] is not None
        assert "ROADMAP.md, Queue 1, item 8" in r["quant_model_axis"]
