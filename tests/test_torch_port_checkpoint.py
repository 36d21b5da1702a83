"""The port's checkpoints, on the CPU.

The format is the port's own (a directory holding ``state.pt``), so there
is no file to compare with the JAX package's Orbax checkpoints; what is
held against the JAX package is everything around the format: names,
natural ordering and latest-discovery on the same directory listing, the
step-checkpoint parser, and the sidecar errors message for message.

- round trips are bit for bit (``torch.equal``): parameters, buffers, both
  Adam moments, count, step, epoch and the fp16 loss scale;
- ``train_state_from_jax``: the JAX step takes 2 steps, its ``TrainState``
  is carried into the port, both take a third step: loss at rel 1e-5, the
  parameters after it at atol 1e-5 (fp32 on both sides; they differ in GEMM
  and reduction order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu import checkpoint as jckpt
from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import checkpoint as tckpt
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import state_dict_from_jax, train_state_from_jax
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models import ClipClassifier
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.models import vssm as tvssm
from mamba_clip_tpu_torch.optim import build_optimizer, freeze_submodule_mask
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.utils.precision import LossScaleState, get_policy

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH = 32, 40, 8


def _args(**kw):
    return Args(batch_size=BATCH, epochs=1, lr=1e-3, warmup=1, wd=0.05, grad_clip_norm=1.0,
                **kw)


def _vssm_clip(seed):
    """A CLIP whose image tower has BatchNorm buffers."""
    g = torch.Generator().manual_seed(seed)
    tower = tclip.VssmTower(tvssm.VSSM(depths=(1, 1), dims=(16, 32), num_classes=0,
                                       drop_path_rate=0.0, generator=g), embed_dim=16,
                            generator=g)
    return tclip.ClipModel(tower, tbert.TextBert(**BERT, generator=g))


def _state(model, precision="fp32", mask=None):
    args = _args(precision=precision)
    pol = get_policy(precision)
    sched = create_schedule(args, 10)
    tx = build_optimizer(args, sched, trainable_mask=mask)
    step = ttrain.make_clip_train_step(model, tx, pol, args,
                                       get_transform_config(AUG, IMAGE, is_train=True), sched)
    return ttrain.create_train_state(model, tx, pol), step


def _batch(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(4, 128, (BATCH, 16)).astype(np.int32)
    ids[:, 0] = 2
    ids[:, 11:] = 0
    return {"image": rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8),
            "tokens": ids}


def _tensors(state):
    out = dict(state.model.state_dict())
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    return out


def _trained(tmp_path, steps=2, **kw):
    state, step = _state(_vssm_clip(0), **kw)
    for i in range(steps):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in _batch(i).items()}, 0)
    return state, step


def test_round_trip_is_bit_for_bit_and_the_restored_state_continues_exactly(tmp_path):
    state, step = _trained(tmp_path)
    path = tckpt.save_checkpoint(str(tmp_path), state, 3, name="stage_1_epoch_3")
    assert path == str(tmp_path / "stage_1_epoch_3") and os.listdir(path) == ["state.pt"]
    assert sorted(os.listdir(tmp_path)) == ["stage_1_epoch_3"]  # no temporary directory left
    fresh, fresh_step = _state(_vssm_clip(9))
    saved = {k: v.clone() for k, v in _tensors(state).items()}
    assert any(not torch.equal(v, _tensors(fresh)[k]) for k, v in saved.items()
               if not k.startswith(("mu/", "nu/")))
    restored, epoch = tckpt.load_checkpoint(path, fresh)
    assert epoch == 3 and restored.step == state.step == 2
    assert restored.opt_state.count == state.opt_state.count == 2
    got = _tensors(restored)
    assert sorted(got) == sorted(saved) and any("running_mean" in k for k in got)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    # both take one more step on the same batch: still bit for bit
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    state, m1 = step(state, batch, 0)
    restored, m2 = fresh_step(restored, batch, 0)
    assert float(m1["loss"]) == float(m2["loss"])
    for k, v in _tensors(state).items():
        assert torch.equal(_tensors(restored)[k], v), k
    # a save over an existing name replaces it whole
    again = tckpt.save_checkpoint(str(tmp_path), state, 4, name="stage_1_epoch_3")
    assert tckpt.load_checkpoint(again, fresh)[1] == 4
    assert tckpt.save_checkpoint(str(tmp_path), state, 7).endswith("epoch_7")
    tckpt.wait_for_checkpoints()


def test_loss_scale_is_saved_and_a_checkpoint_without_one_starts_it_fresh(tmp_path):
    state, _ = _state(_vssm_clip(0), precision="fp16")
    state.loss_scale = LossScaleState(scale=512.0, growth_count=37)
    path = tckpt.save_checkpoint(str(tmp_path), state, 1)
    fresh, _ = _state(_vssm_clip(1), precision="fp16")
    restored, _ = tckpt.load_checkpoint(path, fresh)
    assert restored.loss_scale == LossScaleState(512.0, 37)
    # an fp32 run's checkpoint has no loss scale: the rest loads, the scale starts fresh
    plain, _ = _state(_vssm_clip(2))
    path = tckpt.save_checkpoint(str(tmp_path), plain, 2)
    restored, epoch = tckpt.load_checkpoint(path, fresh)
    assert epoch == 2 and restored.loss_scale == fresh.loss_scale
    assert torch.equal(restored.model.logit_scale, plain.model.logit_scale)


def test_allow_partial_restores_the_parameters_under_another_optimizer(tmp_path):
    state, _ = _trained(tmp_path)
    path = tckpt.save_checkpoint(str(tmp_path), state, 1)
    model = _vssm_clip(3)
    mask = freeze_submodule_mask(dict(model.named_parameters()), ["visual"])
    other, _ = _state(model, mask=mask)
    with pytest.raises(ValueError, match="optimizer state does not match"):
        tckpt.load_checkpoint(path, other)
    restored, epoch = tckpt.load_checkpoint(path, other, allow_partial=True)
    assert epoch == 1 and restored.opt_state is other.opt_state and restored.step == 2
    for k, p in state.model.named_parameters():
        assert torch.equal(dict(model.named_parameters())[k], p), k
    # another model altogether is refused, naming what is missing
    vit_clip = tclip.ClipModel(tvit.VisionTransformer(**VIT), tbert.TextBert(**BERT))
    with pytest.raises(ValueError, match="parameters do not match the model"):
        tckpt.load_checkpoint(path, _state(vit_clip)[0], allow_partial=True)


def test_load_params_only_feeds_stage_two(tmp_path):
    state, _ = _trained(tmp_path)
    path = tckpt.save_checkpoint(str(tmp_path), state, 1, name="stage_1_epoch_latest")
    head = ClipClassifier(_vssm_clip(4))
    fc1 = head.fc1.weight.detach().clone()
    assert tckpt.load_params_only(path, head.clip) is head.clip
    want = state.model.state_dict()
    for k, v in head.clip.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(head.fc1.weight, fc1)
    with pytest.raises(ValueError, match="do not match the model"):
        tckpt.load_params_only(path, head)


def test_step_checkpointer_keeps_a_ring_of_two_and_finalize_clears_it(tmp_path):
    state, _ = _state(_vssm_clip(0))
    d = str(tmp_path)
    ck = tckpt.StepCheckpointer(d, _args(), prefix="stage_1_")
    paths = [ck(state, 0, m, num_batches=10) for m in (2, 4, 6)]
    assert [os.path.basename(p) for p in paths] == [
        "stage_1_epoch_0_step_2", "stage_1_epoch_0_step_4", "stage_1_epoch_0_step_6"]
    assert sorted(os.listdir(d)) == [
        "stage_1_epoch_0_step_4", "stage_1_epoch_0_step_4.meta.json",
        "stage_1_epoch_0_step_6", "stage_1_epoch_0_step_6.meta.json"]
    assert json.load(open(paths[2] + ".meta.json")) == {"batch_size": BATCH, "num_batches": 10}
    assert tckpt.get_latest_checkpoint(d, prefix="stage_1_") == paths[2]
    restored, epoch = tckpt.load_checkpoint(paths[2], _state(_vssm_clip(1))[0])
    assert epoch == 0 and tckpt.parse_step_checkpoint(paths[2]) == (0, 6)
    # finalize leaves the numbered epoch checkpoints and another stage's step checkpoints
    tckpt.save_checkpoint(d, state, 1, name="stage_1_epoch_1")
    other = tckpt.StepCheckpointer(d, _args(), prefix="stage_2_")(state, 0, 2)
    ck.finalize()
    assert sorted(os.listdir(d)) == ["stage_1_epoch_1", os.path.basename(other),
                                    os.path.basename(other) + ".meta.json"]
    tckpt.delete_previous_checkpoint(d, 2, prefix="stage_1_")
    assert "stage_1_epoch_1" not in os.listdir(d)
    tckpt.StepCheckpointer(str(tmp_path / "absent")).finalize()  # nothing to clear


@pytest.mark.parametrize("sidecar,batch_size,num_batches", [
    ({"batch_size": 4, "num_batches": 10}, 8, 10),
    ({"batch_size": 8, "num_batches": 10}, 8, 12),
    ({"batch_size": 8, "num_batches": 10}, 8, 10),
    ({"batch_size": 8, "num_batches": 10}, 8, None),
    ({"batch_size": None, "num_batches": None}, 8, 3),
    (None, 8, 3),
])
def test_sidecar_errors_equal_jax_message_for_message(tmp_path, sidecar, batch_size,
                                                      num_batches):
    path = str(tmp_path / "stage_1_epoch_0_step_4")
    os.makedirs(path)
    if sidecar is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(sidecar, f)

    def outcome(fn):
        try:
            fn(path, batch_size, num_batches=num_batches)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jckpt.validate_step_resume)
    assert outcome(tckpt.validate_step_resume) == want
    assert (want is not None) == (sidecar in ({"batch_size": 4, "num_batches": 10},)
                                  or num_batches == 12)


def test_names_natural_order_and_discovery_equal_jax(tmp_path):
    names = ["stage_1_epoch_2", "stage_1_epoch_10", "stage_1_epoch_9_step_4",
             "stage_1_epoch_9_step_12", "stage_1_epoch_latest", "stage_2_epoch_11",
             "stage_1_epoch_9", "results.jsonl", "stage_1_epoch_10.tmp-123",
             "stage_1_epoch_9_step_12.meta.json", "Epoch_3", "epoch_1"]
    for n in names:
        assert tckpt.natural_key(n) == jckpt.natural_key(n)
        assert tckpt.parse_step_checkpoint(n) == jckpt.parse_step_checkpoint(n)
        assert tckpt.parse_step_checkpoint(f"/x/{n}/") == jckpt.parse_step_checkpoint(f"/x/{n}/")
    assert sorted(names, key=tckpt.natural_key) == sorted(names, key=jckpt.natural_key)
    assert tckpt.parse_step_checkpoint("stage_1_epoch_9_step_12") == (9, 12)
    d = tmp_path / "ck"
    assert tckpt.get_latest_checkpoint(str(d)) is None
    for upto in range(1, len(names) + 1):
        for n in names[:upto]:
            os.makedirs(d / n, exist_ok=True)
        for prefix in ("", "stage_1_", "stage_2_", "stage_3_"):
            assert (tckpt.get_latest_checkpoint(str(d), prefix=prefix)
                    == jckpt.get_latest_checkpoint(str(d), prefix=prefix)), (upto, prefix)
    assert tckpt.get_latest_checkpoint(str(d), prefix="stage_1_") == str(d / "stage_1_epoch_10")
    # remote discovery (--remote-sync) over a local fsspec path, and a missing one
    for prefix in ("", "stage_1_", "stage_2_", "stage_3_"):
        assert (tckpt.get_latest_checkpoint(str(d), remote=True, prefix=prefix)
                == jckpt.get_latest_checkpoint(str(d), remote=True, prefix=prefix)
                == tckpt.get_latest_checkpoint(str(d), prefix=prefix)), prefix
    assert tckpt.get_latest_checkpoint(f"file://{d}", remote=True, prefix="stage_1_") \
        == f"file://{d}/stage_1_epoch_10"
    assert tckpt.get_latest_checkpoint(str(tmp_path / "none"), remote=True) is None
    assert jckpt.get_latest_checkpoint(str(tmp_path / "none"), remote=True) is None


def test_train_state_from_jax_carries_the_moments_and_the_step():
    args = _args(precision="fp32", eps=1e-6)
    jm = jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT))
    variables = jax.jit(lambda k, a, b: jm.init(k, image=a, text=b))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 16), jnp.int32))
    jpol = jax_get_policy("fp32")
    jsched = jax_create_schedule(args, 10)
    jtx = jax_build_optimizer(args, jsched)
    jstate = jtrain.create_train_state(variables["params"], jtx, policy=jpol)
    jstep = jax.jit(jtrain.make_clip_train_step(
        jm, jtx, jpol, args, jax_tcfg(AUG, IMAGE, is_train=True), jsched))
    key = jax.random.PRNGKey(0)
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(i).items()}, key)

    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = tclip.ClipModel(tvit.VisionTransformer(**VIT, attn_flash=True),
                            tbert.TextBert(**BERT, attn_flash=True))
    tsched = create_schedule(args, 10)
    ttx = build_optimizer(args, tsched)
    tstate = train_state_from_jax(
        model, ttx, params=to_np(jstate.params), mu=to_np(adam.mu), nu=to_np(adam.nu),
        count=int(adam.count), step=int(jstate.step))
    assert tstate.step == 2 and tstate.opt_state.count == 2 and tstate.loss_scale is None
    want_mu = state_dict_from_jax({"params": to_np(adam.mu)})
    assert set(tstate.opt_state.mu) == set(dict(model.named_parameters())) == set(want_mu)
    k = "visual.blocks_0.mlp.fc1.weight" if "visual.blocks_0.mlp.fc1.weight" in want_mu \
        else sorted(n for n in want_mu if n.endswith("weight") and want_mu[n].ndim == 2)[0]
    assert torch.equal(tstate.opt_state.mu[k], want_mu[k]) and float(want_mu[k].abs().max()) > 0

    tstep = ttrain.make_clip_train_step(model, ttx, get_policy("fp32"), args,
                                        get_transform_config(AUG, IMAGE, is_train=True), tsched)
    batch = _batch(2)
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert tstate.step == int(jstate.step) == 3
    for name in ("loss", "grad_norm", "lr"):
        got, want = float(tmet[name]), float(jmet[name])
        assert abs(got - want) <= 1e-5 * abs(want), (name, got, want)
    want = state_dict_from_jax({"params": to_np(jstate.params)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    # a mask that freezes the text tower drops its moments; a missing trainable leaf raises
    frozen = build_optimizer(args, tsched, trainable_mask=freeze_submodule_mask(
        dict(model.named_parameters()), ["text"]))
    part = train_state_from_jax(model, frozen, params=to_np(jstate.params), mu=to_np(adam.mu),
                                nu=to_np(adam.nu), count=3, step=3,
                                loss_scale={"scale": 1024.0, "growth_count": 5})
    assert part.opt_state.mu and not any(n.startswith("text.") for n in part.opt_state.mu)
    assert part.loss_scale == LossScaleState(1024.0, 5)
    no_visual = {n: v for n, v in to_np(adam.mu).items() if n != "visual"}
    with pytest.raises(KeyError, match="lacks the trainable leaves"):
        train_state_from_jax(model, ttx, params=to_np(jstate.params), mu=no_visual,
                             nu=to_np(adam.nu), count=3, step=3)
