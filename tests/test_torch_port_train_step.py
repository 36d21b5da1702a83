"""The port's classifier train step against the JAX package's, on the CPU.

A small VSSM (depths (1, 1), dims (32, 64), 3 classes, image 32 from
40x40 uint8 staging) is initialized by Flax and carried into the port by
``convert.py``. DropPath is off (``drop_path_rate=0``: the two frameworks
draw different masks) and the crop is deterministic (``scale=(1, 1)``,
``ratio=(1, 1)``, ``hflip=0``, ``re_prob=0`` on square staging), so both
steps see the same images. JAX runs its scan with ``impl="xla"``, the port
its plain scan through ``SelectiveScanFn``. Both steps take the same
numpy batches, AdamW with clipping and weight decay under a cosine
schedule (eps 1e-6, see ``_Pair``).

Tolerances:
- fp32, the loss of each of 5 steps at rel 1e-5; the gradients of step 1
  per leaf at atol 1e-4 of the leaf's largest gradient (the
  scan-gradient tolerance), except the biases of the convolutions that
  feed a BatchNorm, whose gradient is 0 and is checked to be rounding
  noise (below 1e-6 of the largest gradient); BatchNorm's running statistics after 5 steps
  at atol 1e-5. Both sides compute in fp32; they differ in GEMM,
  convolution and reduction order.
- ``accum_freq=2``, class-weighted CE and balanced mixup (with JAX's lam
  injected): the loss of 3 steps at rel 1e-5, as above.
- ``amp`` (bf16 activations over fp32 parameters): the loss of 3 steps
  at rel 2e-3. bf16 keeps 8 bits; the two frameworks round at the same
  casts but sum in other orders, so activations differ by a few bf16 ulps
  (2^-8 each) that the mean over the batch averages down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.losses import cross_entropy_loss as jax_ce
from mamba_clip_tpu.models.vssm import VSSM as JaxVSSM
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models.vssm import VSSM
from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_bwd, selective_scan_fwd
from mamba_clip_tpu_torch.optim import build_optimizer
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.utils.precision import get_policy

MODEL = dict(depths=(1, 1), dims=(32, 64), num_classes=3, drop_path_rate=0.0)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH, SEED = 32, 40, 8, 0
CLASS_WEIGHTS = np.array([0.5, 2.0, 1.25], np.float32)


def _batches(n, mix=False):
    rs = np.random.RandomState(1)
    out = []
    for _ in range(n):
        b = {"image": rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8),
             "target": rs.randint(0, 3, (BATCH,)).astype(np.int32)}
        if mix:
            b["mix_image"] = rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8)
            b["mix_target"] = rs.randint(0, 3, (BATCH,)).astype(np.int32)
        out.append(b)
    return out


class _Pair:
    """The JAX step and the port's step from one Flax init."""

    def __init__(self, precision="fp32", class_weights=None, **arg_kw):
        # eps 1e-6: the biases of the convolutions ahead of a BatchNorm get
        # rounding-noise gradients (their true gradient is 0), which Adam
        # with eps 1e-8 turns into lr-sized steps of random sign on each
        # side; the loss cannot see those biases, but the running means do.
        self.args = Args(batch_size=BATCH, epochs=1, lr=2e-3, warmup=1, wd=0.05, eps=1e-6,
                         grad_clip_norm=1.0, precision=precision, **arg_kw)
        jpol, tpol = jax_get_policy(precision), get_policy(precision)
        self.jm = JaxVSSM(scan_impl="xla", dtype=jpol.compute_dtype, **MODEL)
        variables = jax.jit(self.jm.init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, IMAGE, IMAGE, 3)))
        self.variables = jax.tree_util.tree_map(np.asarray, variables)
        jtcfg = jax_tcfg(AUG, IMAGE, is_train=True)
        jsched = jax_create_schedule(self.args, 10)
        jtx = jax_build_optimizer(self.args, jsched)
        self.jstate = jtrain.create_train_state(
            variables["params"], jtx, variables["batch_stats"], policy=jpol)
        self.jstep = jax.jit(jtrain.make_classifier_train_step(
            self.jm, jtx, jpol, self.args, jtcfg, jsched, class_weights=class_weights,
            num_classes=3, takes_text=False))
        self.jtcfg, self.jpol = jtcfg, jpol

        model = VSSM(dtype=tpol.compute_dtype, **MODEL)
        load_jax_variables(model, self.variables)
        tsched = create_schedule(self.args, 10)
        ttx = build_optimizer(self.args, tsched)
        self.tstate = ttrain.create_train_state(model, ttx, policy=tpol)
        self.tstep = ttrain.make_classifier_train_step(
            model, ttx, tpol, self.args, get_transform_config(AUG, IMAGE, is_train=True),
            tsched, class_weights=class_weights, num_classes=3, takes_text=False)
        self.key = jax.random.PRNGKey(SEED)

    def step(self, batch):
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                     self.key)
        self.tstate, tm = self.tstep(
            self.tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, SEED)
        return {k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_five_fp32_steps_match_jax():
    pair = _Pair()
    batches = _batches(5)
    # step 1's gradients, from the JAX step's own loss at the initial state
    jimg = jtrain._preprocess_train(jnp.asarray(batches[0]["image"]),
                                    jax.random.split(jax.random.fold_in(pair.key, 0), 4)[0],
                                    pair.jtcfg, pair.jpol)

    def loss_fn(params):
        logits, _ = pair.jm.apply(
            {"params": params, "batch_stats": pair.variables["batch_stats"]}, jimg,
            deterministic=False, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(batches[0]["target"]))

    jgrads = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(
            pair.variables["params"]))})

    for i, batch in enumerate(batches):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= 1e-5, (i, got, want)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= 1e-4, (i, got, want)
        assert _rel(got["lr"], want["lr"]) <= 1e-6
        if i == 0:
            top = max(float(g.abs().max()) for g in jgrads.values())
            for name, p in pair.tstate.model.named_parameters():
                g, w = p.grad.numpy(), jgrads[name].numpy()
                if name.endswith(("conv0.bias", "conv1.bias")):
                    # feeds a train-mode BatchNorm, whose batch mean removes
                    # it: the gradient is 0 and both sides hold rounding noise
                    assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, name
                    continue
                scale = float(np.abs(w).max()) + 1e-12
                np.testing.assert_allclose(g / scale, w / scale, atol=1e-4, err_msg=name)
    assert pair.tstate.step == int(pair.jstate.step) == 5
    want_stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, pair.jstate.batch_stats)})
    buffers = dict(pair.tstate.model.named_buffers())
    assert want_stats
    for name, w in want_stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    assert selective_scan_fwd.launches == 0 and selective_scan_bwd.launches == 0


def _jax_lams(key, alpha, n):
    return [float(jax.random.beta(jax.random.split(jax.random.fold_in(key, s), 4)[2],
                                  alpha, 1.0)) for s in range(n)]


@pytest.mark.parametrize("case", ["accum_freq=2", "class_weighted", "balanced_mixup", "amp"])
def test_train_step_variants_match_jax(case, monkeypatch):
    kw, mix, bound = {}, False, 1e-5
    if case == "accum_freq=2":
        kw = dict(accum_freq=2)
    elif case == "class_weighted":
        kw = dict(class_weights=CLASS_WEIGHTS)
    elif case == "balanced_mixup":
        kw, mix = dict(balanced_mixup=0.4), True
    else:
        kw, bound = dict(precision="amp"), 2e-3
    pair = _Pair(**kw)
    if mix:  # JAX's lam of each step, in place of the port's own draw
        lams = iter(_jax_lams(pair.key, 0.4, 3))
        monkeypatch.setattr(ttrain, "draw_lam",
                            lambda gen, alpha: torch.tensor(next(lams), dtype=torch.float32))
    for i, batch in enumerate(_batches(3, mix=mix)):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= bound, \
            (case, i, got, want)


def test_train_step_draws_from_explicit_generators():
    """Two runs from the same seed give the same losses, with the random
    crop, flip, erasing and DropPath on; another seed gives others."""
    aug = {"re_prob": 0.5, "interpolation": "random"}

    def run(seed):
        torch_gen = torch.Generator().manual_seed(0)
        model = VSSM(depths=(1, 1), dims=(16, 32), num_classes=3, drop_path_rate=0.5,
                     generator=torch_gen)
        args = Args(batch_size=4, epochs=1, lr=1e-3, warmup=1, grad_clip_norm=1.0)
        pol = get_policy("fp32")
        tx = build_optimizer(args, None)
        step = ttrain.make_classifier_train_step(
            model, tx, pol, args, get_transform_config(aug, 24, is_train=True), None,
            num_classes=3, takes_text=False)
        state = ttrain.create_train_state(model, tx, pol)
        losses = []
        rs = np.random.RandomState(0)
        for _ in range(2):
            batch = {"image": torch.from_numpy(rs.randint(0, 256, (4, 30, 30, 3), dtype=np.uint8)),
                     "target": torch.from_numpy(rs.randint(0, 3, (4,)))}
            state, m = step(state, batch, seed)
            losses.append(float(m["loss"]))
        return losses

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c


def test_fp16_dynamic_scale_skips_a_non_finite_step(monkeypatch):
    """fp16: a finite step updates and counts toward growth; a step whose
    gradients are not finite leaves the parameters and the optimizer state
    as they were, halves the scale, and keeps the BatchNorm statistics its
    forward moved (as JAX's ``_finish_step`` does)."""
    model = VSSM(depths=(1, 1), dims=(16, 32), num_classes=3, drop_path_rate=0.0,
                 generator=torch.Generator().manual_seed(0))
    args = Args(batch_size=4, epochs=1, lr=1e-3, warmup=1, precision="fp16")
    pol = get_policy("fp16")
    tx = build_optimizer(args, None)
    step = ttrain.make_classifier_train_step(
        model, tx, pol, args, get_transform_config(AUG, 24, is_train=True), None,
        num_classes=3, takes_text=False)
    state = ttrain.create_train_state(model, tx, pol)
    assert (state.loss_scale.scale, state.loss_scale.growth_count) == (2.0**16, 0)
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.randint(0, 256, (4, 24, 24, 3), dtype=np.uint8)),
             "target": torch.from_numpy(rs.randint(0, 3, (4,)))}
    state, m = step(state, batch, 0)
    assert m["skipped_steps"] == 0 and state.loss_scale.growth_count == 1
    assert state.opt_state.count == 1

    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
    real = ttrain.cross_entropy_loss
    monkeypatch.setattr(ttrain, "cross_entropy_loss",
                        lambda *a, **kw: real(*a, **kw) * float("inf"))
    state, m = step(state, batch, 0)
    assert m["skipped_steps"] == 1 and m["loss_scale"] == 2.0**16
    assert (state.loss_scale.scale, state.loss_scale.growth_count) == (2.0**15, 0)
    assert state.step == 2 and state.opt_state.count == 1
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), params[k], rtol=0, atol=0, msg=k)
    assert any(not torch.equal(b, stats[k]) for k, b in model.named_buffers() if k in stats)
