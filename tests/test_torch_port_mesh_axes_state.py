"""The placements, checkpoints and CLI of the fsdp and model axes.

- ``param_sharding``: the port's rule against JAX's, leaf for leaf (same
  axis, JAX's dim mapped to the port's layout), on the small CLIP and
  medmamba at (2, 2, 1), (2, 1, 2), (1, 4, 1) and (2, 2, 2), and on
  full-width BiomedCLIP (built on the meta device; JAX's shapes from
  ``jax.eval_shape``) with the worked examples: the token table (30,522 ×
  768) shards dim 0 over fsdp 2 and stays whole at fsdp 4 (30,522 % 4 ≠ 0);
  the ViT's ``pos_embed`` (1, 197, 768) falls through to the model axis
  wherever it is above 1.
- Four gloo ranks, started once for the module: a checkpoint written at
  (data 2, fsdp 2) after a step (rank 0 writes) holds, loaded at world 1,
  the ranks' gathered parameters and moments bit for bit; loaded back at
  (fsdp 4) each rank holds its slice. Then the CLI's stage 1 (synthetic,
  two steps) with ``--mesh-fsdp 2`` and with ``--mesh-fsdp 1``: only rank
  0 writes, and the metrics agree within rel 1e-5.
"""

import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_port_mesh_axes import (BERT, IMAGE, STAGING, VIT, VSSM_CLS, _join_ranks,
                                       _start_ranks)

torch.set_num_threads(1)

SHAPES = [(2, 2, 1), (2, 1, 2), (1, 4, 1), (2, 2, 2)]


# ---------------------------------------------------------------------------
# param_sharding against JAX's
# ---------------------------------------------------------------------------


def _jax_placements(params_shapes, shape):
    """JAX's ``param_sharding`` over a mesh of ``shape``, as the port's
    keys and dims: None or (axis, port dim)."""
    import jax

    from mamba_clip_tpu.parallel.mesh import MeshSpec, create_mesh, param_sharding
    from mamba_clip_tpu_torch.convert import _key

    n = int(np.prod(shape))
    mesh = create_mesh(MeshSpec(*shape), devices=jax.devices()[:n])
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(param_sharding(mesh, params_shapes))[0]:
        keys = tuple(k.key for k in path)
        named = [(i, a) for i, a in enumerate(s.spec) if a is not None]
        where = None
        if named:
            (i, axis), = named
            if keys[-1] == "kernel":  # Flax [in, out] / HWIO -> port [out, in] / OIHW
                i = 1 - i if _leaf(params_shapes, keys).ndim == 2 else {0: 2, 1: 3, 2: 1, 3: 0}[i]
            where = (axis, i)
        out[_key("params", keys)] = where
    return out


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _port_placements(model, shape):
    from mamba_clip_tpu_torch.parallel.mesh import Mesh, param_sharding

    d, f, m = shape
    return param_sharding(Mesh(data=d, fsdp=f, model=m), model)


def _small_models():
    import jax
    import jax.numpy as jnp

    from mamba_clip_tpu.models import clip as jclip
    from mamba_clip_tpu.models import text_bert as jbert
    from mamba_clip_tpu.models import vit as jvit
    from mamba_clip_tpu.models.vssm import VSSM as JaxVSSM
    from mamba_clip_tpu_torch.models import clip as tclip
    from mamba_clip_tpu_torch.models import text_bert as tbert
    from mamba_clip_tpu_torch.models import vit as tvit
    from mamba_clip_tpu_torch.models.vssm import VSSM

    img = jnp.zeros((1, IMAGE, IMAGE, 3))
    jm = jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT))
    clip = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), image=img,
                                          text=jnp.zeros((1, 16), jnp.int32)))["params"]
    cls = jax.eval_shape(lambda: JaxVSSM(scan_impl="xla", **VSSM_CLS).init(
        jax.random.PRNGKey(0), img))["params"]
    return {"clip": (clip, tclip.ClipModel(tvit.VisionTransformer(**VIT),
                                            tbert.TextBert(**BERT))),
            "cls": (cls, VSSM(**VSSM_CLS))}


@pytest.fixture(scope="module")
def small_models():
    return _small_models()


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("kind", ["clip", "cls"])
def test_param_sharding_picks_jax_leaves(small_models, kind, shape):
    jshapes, model = small_models[kind]
    want = _jax_placements(jshapes, shape)
    got = _port_placements(model, shape)
    assert got == want
    assert any(v is not None for v in got.values())


@pytest.fixture(scope="module")
def biomedclip():
    import jax
    import jax.numpy as jnp

    from mamba_clip_tpu.models.clip import build_clip as jbuild
    from mamba_clip_tpu_torch.models import build_clip

    jm = jbuild("biomedclip", image_size=224)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            image=jnp.zeros((1, 224, 224, 3)),
                                            text=jnp.zeros((1, 256), jnp.int32)))["params"]
    with torch.device("meta"):
        model = build_clip("biomedclip", image_size=224)
    return shapes, model


@pytest.mark.parametrize("shape", [(1, 2, 1)] + SHAPES,
                         ids=["x".join(map(str, s)) for s in [(1, 2, 1)] + SHAPES])
def test_full_width_biomedclip_placements_match_jax(biomedclip, shape):
    jshapes, model = biomedclip
    got = _port_placements(model, shape)
    assert got == _jax_placements(jshapes, shape)
    table, pos = got["text.tok_emb.weight"], got["visual.pos_embed"]
    assert tuple(model.text.tok_emb.weight.shape) == (30522, 768)
    assert table == (("fsdp", 0) if shape[1] == 2 else ("model", 1) if shape[2] > 1 else None)
    assert pos == (("model", 2) if shape[2] > 1 else None)


# ---------------------------------------------------------------------------
# checkpoints and the CLI over four ranks
# ---------------------------------------------------------------------------


def _tiny_clip(quant=None):
    from mamba_clip_tpu_torch.models import clip as tclip
    from mamba_clip_tpu_torch.models import text_bert as tbert
    from mamba_clip_tpu_torch.models import vit as tvit
    from mamba_clip_tpu_torch.ops import quant as tquant

    kw = {} if quant is None else dict(dot_general_cls=tquant.make_dot_general_cls(quant))
    return tclip.ClipModel(tvit.VisionTransformer(**VIT, **kw), tbert.TextBert(**BERT, **kw))


def _clip_state(seed, mesh=None):
    from mamba_clip_tpu_torch import train as ttrain
    from mamba_clip_tpu_torch.config import Args
    from mamba_clip_tpu_torch.optim import build_optimizer
    from mamba_clip_tpu_torch.utils.precision import get_policy

    torch.manual_seed(seed)
    model = _tiny_clip()
    args = Args(batch_size=4, epochs=1, lr=1e-3, warmup=1, precision="fp32")
    tx = build_optimizer(args, None)
    return args, tx, ttrain.create_train_state(model, tx, get_policy("fp32"), mesh=mesh)


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


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _task_state(rank, world, tmp):
    from mamba_clip_tpu_torch import pipeline as tpipe
    from mamba_clip_tpu_torch import train as ttrain
    from mamba_clip_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from mamba_clip_tpu_torch.config import parse_args
    from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer
    from mamba_clip_tpu_torch.parallel.mesh import MeshSpec, barrier, create_mesh
    from mamba_clip_tpu_torch.parallel.sharding import full_moments, full_params, plan_of
    from mamba_clip_tpu_torch.utils.precision import get_policy

    out = {}
    # one step at (data 2, fsdp 2), saved by every rank, written by rank 0
    mesh = create_mesh(MeshSpec(data=2, fsdp=2))
    args, tx, state = _clip_state(0, mesh)
    step = ttrain.make_clip_train_step(state.model, tx, get_policy("fp32"), args,
                                       get_transform_config(None, IMAGE, is_train=True),
                                       mesh=mesh)
    rs = np.random.RandomState(3)
    ids = rs.randint(4, 128, (16, 16)).astype(np.int64)
    ids[:, 0] = 2
    images = rs.randint(0, 256, (16, STAGING, STAGING, 3), dtype=np.uint8)
    b = mesh.axis().rank
    state, _ = step(state, {"image": torch.from_numpy(images[4 * b:4 * b + 4]),
                            "tokens": torch.from_numpy(ids[4 * b:4 * b + 4])}, 0)
    ckpt_dir = os.path.join(tmp, "ckpt")
    path = save_checkpoint(ckpt_dir, state, 1, write=rank == 0)
    out["wrote"] = path is not None
    barrier()
    plan = plan_of(state.model)
    out["gathered"] = {"params": _np(full_params(state.model)),
                       "mu": _np(full_moments(state.opt_state.mu, plan)),
                       "nu": _np(full_moments(state.opt_state.nu, plan)),
                       "count": state.opt_state.count}
    # back at (fsdp 4): every rank keeps its slices
    mesh4 = create_mesh(MeshSpec(fsdp=4))
    _, _, state4 = _clip_state(1, mesh4)
    state4, epoch = load_checkpoint(os.path.join(ckpt_dir, "epoch_1"), state4)
    plan4 = plan_of(state4.model)
    out["resumed"] = {"params": _np(dict(state4.model.named_parameters())),
                      "mu": _np(state4.opt_state.mu), "nu": _np(state4.opt_state.nu),
                      "epoch": epoch, "step": state4.step, "placements": plan4.placements,
                      "fsdp_index": mesh4.sub_axis("fsdp").rank}
    # the CLI's stage 1 with --mesh-fsdp 2 and 1, each rank with its own logs
    tpipe.build_clip = lambda **kw: _tiny_clip(kw.get("quant"))
    tpipe.get_tokenizer = lambda name, **kw: HashTokenizer(16, 128)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    for fsdp in (2, 1):
        logs = os.path.join(tmp, f"fsdp{fsdp}", f"rank{rank}")
        torch.manual_seed(rank)  # the ranks start apart; rank 0's weights are taken
        argv = ["--model-stage-1", "tiny", "--batch-size", "4", "--epochs", "1",
                "--train-num-samples", "32", "--val-num-samples", "16", "--lr", "1e-3",
                "--warmup", "1", "--precision", "fp32", "--logs", logs, "--workers", "1",
                "--force-image-size", str(IMAGE), "--save-most-recent", "--synthetic-data",
                "--device", "cpu", "--seed", "0", "--mesh-fsdp", str(fsdp), "--stage", "1"]
        m = tpipe.pipeline(parse_args(argv))
        files = sorted(os.path.relpath(os.path.join(d, f), logs)
                       for d, _, fs in os.walk(logs) for f in fs) if os.path.isdir(logs) else []
        out[f"cli_fsdp{fsdp}"] = (m, files)
    # --quant int8_delayed under --mesh-model 2: the delayed scales set from
    # the init batch, calibrated at step 0 and committed over the model group
    logs = os.path.join(tmp, "quant_model2", f"rank{rank}")
    torch.manual_seed(rank)
    argv = ["--model-stage-1", "tiny", "--batch-size", "4", "--epochs", "1",
            "--train-num-samples", "32", "--val-num-samples", "16", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--logs", logs, "--workers", "1",
            "--force-image-size", str(IMAGE), "--synthetic-data", "--device", "cpu",
            "--seed", "0", "--mesh-model", "2", "--stage", "1", "--quant", "int8_delayed"]
    m = tpipe.pipeline(parse_args(argv))
    files = sorted(os.path.relpath(os.path.join(d, f), logs)
                   for d, _, fs in os.walk(logs) for f in fs) if os.path.isdir(logs) else []
    out["cli_quant_model2"] = (m, files)
    return out


@pytest.fixture(scope="module")
def state_case(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_state"))
    procs, q, deadline = _start_ranks("_task_state", tmp, worker=_worker)
    ranks = _join_ranks(procs, q, deadline)
    return ranks, tmp


def test_checkpoint_from_four_ranks_loads_at_world_one_bit_for_bit(state_case):
    """Rank 0 wrote; the file loaded by one process holds the ranks'
    gathered parameters and moments bit for bit, and the ranks gathered
    the same state."""
    from mamba_clip_tpu_torch.checkpoint import load_checkpoint

    ranks, tmp = state_case
    assert [r["wrote"] for r in ranks] == [True, False, False, False]
    want = ranks[0]["gathered"]
    for r in ranks[1:]:
        for part in ("params", "mu", "nu"):
            for k, v in want[part].items():
                np.testing.assert_array_equal(r["gathered"][part][k], v, err_msg=k)
    _, _, state = _clip_state(5)
    state, epoch = load_checkpoint(os.path.join(tmp, "ckpt", "epoch_1"), state)
    assert epoch == 1 and state.step == 1 and state.opt_state.count == want["count"] == 1
    got = {"params": _np(dict(state.model.named_parameters())),
           "mu": _np(state.opt_state.mu), "nu": _np(state.opt_state.nu)}
    for part in ("params", "mu", "nu"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part} {k}")


def test_checkpoint_loaded_at_fsdp_four_keeps_each_rank_slice(state_case):
    ranks, _ = state_case
    whole = ranks[0]["gathered"]
    sharded = 0
    for r in ranks:
        res = r["resumed"]
        assert res["epoch"] == 1 and res["step"] == 1
        f = res["fsdp_index"]
        for part in ("params", "mu", "nu"):
            for k, v in res[part].items():
                where, full = res["placements"][k], whole[part][k]
                if where is not None:
                    axis, dim = where
                    assert axis == "fsdp"
                    n = full.shape[dim] // 4
                    full = np.take(full, range(f * n, (f + 1) * n), axis=dim)
                    sharded += 1
                np.testing.assert_array_equal(v, full, err_msg=f"rank {f} {part} {k}")
    assert sharded > 0
    assert sorted(r["resumed"]["fsdp_index"] for r in ranks) == [0, 1, 2, 3]


def test_cli_mesh_fsdp_two_over_four_ranks_writes_on_rank_zero(state_case):
    """``--mesh-fsdp 2`` through ``pipeline()``: rank 0 writes the run (its
    checkpoints gathered from the shards), ranks 1-3 write nothing; every
    rank gets the same metrics, those of ``--mesh-fsdp 1`` within rel
    1e-5."""
    ranks, _ = state_case
    for fsdp in (2, 1):
        (m0, f0), rest = ranks[0][f"cli_fsdp{fsdp}"], [r[f"cli_fsdp{fsdp}"] for r in ranks[1:]]
        assert all(f == [] for _, f in rest)
        assert all(m == m0 for m, _ in rest)
        assert any(f.endswith("params.txt") for f in f0)
        assert any(f.endswith("results.jsonl") for f in f0)
        assert any("stage_1_epoch_latest" in f for f in f0)
    m2, m1 = ranks[0]["cli_fsdp2"][0], ranks[0]["cli_fsdp1"][0]
    assert m2["num_samples"] == m1["num_samples"] == 16
    assert np.isfinite(m2["val_loss"])
    assert abs(m2["val_loss"] - m1["val_loss"]) <= 1e-5 * abs(m1["val_loss"])



def test_cli_quant_under_mesh_model_two_over_four_ranks(state_case):
    """``--quant int8_delayed --mesh-model 2`` through ``pipeline()`` over
    four ranks (the int8 dots on column slices, the delayed scales from the
    init batch, the calibration and the commits over the model group):
    rank 0 writes the run, every rank gets the same finite metrics."""
    ranks, _ = state_case
    m0, f0 = ranks[0]["cli_quant_model2"]
    for r in ranks[1:]:
        m, f = r["cli_quant_model2"]
        assert m == m0 and f == []
    assert any(f.endswith("results.jsonl") for f in f0)
    assert m0["num_samples"] == 16 and np.isfinite(m0["val_loss"])
