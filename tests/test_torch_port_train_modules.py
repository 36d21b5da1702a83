"""The port's training modules against the JAX package's, on the CPU.

- ``ConvBranch`` in training mode against Flax ``BatchNorm`` with
  ``mutable=["batch_stats"]``: outputs and running statistics after two
  forwards, fp32, atol 1e-5 (both take fp32 batch statistics with the
  biased variance; they differ in convolution summation order).
- ``DropPath``: a per-sample mask from an explicit generator, 1/keep scale.
- Gradient checkpointing changes no gradient and no running statistic.
- ``cross_entropy_loss`` against JAX at 1e-6; the schedules at 1e-6 of
  the base rate (JAX evaluates them in fp32, the port in float64); two
  ``build_optimizer`` updates against optax at 1e-6 of each leaf's largest
  update (the port's bias corrections and rate are float64, optax's fp32).
- ``train_preprocess`` with JAX's draws injected: fp32, atol 1e-5.
- The loss-scale state machine and the train transform configuration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mamba_clip_tpu import losses as jl
from mamba_clip_tpu import optim as jo
from mamba_clip_tpu import schedules as js
from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data import preprocess_cfg as jcfg
from mamba_clip_tpu.models import vssm as jv
from mamba_clip_tpu.ops import preprocess as jp
from mamba_clip_tpu.utils import precision as jprec
from mamba_clip_tpu_torch import losses as tl
from mamba_clip_tpu_torch import optim as to
from mamba_clip_tpu_torch import schedules as ts
from mamba_clip_tpu_torch.convert import load_jax_variables
from mamba_clip_tpu_torch.data import preprocess_cfg as tcfg
from mamba_clip_tpu_torch.models import vssm as tv
from mamba_clip_tpu_torch.ops import preprocess as tp
from mamba_clip_tpu_torch.utils import precision as tprec

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)


def _fill(shapes, seed):
    """numpy values for a Flax variable tree of ShapeDtypeStructs."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            v = rs.uniform(0.5, 1.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*s.shape)
        elif name == "kernel":
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            v = 0.1 * rs.randn(*s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ---------------------------------------------------------------- BatchNorm


def test_conv_branch_train_mode_matches_flax_batch_stats():
    """Two train-mode forwards at a 7x7 stage with batch 2 (98 values per
    channel, where the unbiased variance would be 1% off)."""
    jm = jv.ConvBranch(8)
    rs = np.random.RandomState(0)
    xs = [(rs.randn(2, 7, 7, 8) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    variables = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(xs[0])), 1)
    port = load_jax_variables(tv.ConvBranch(8), variables).train()
    params, stats = variables["params"], variables["batch_stats"]
    for x in xs:
        want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for k in range(3):
        bn, js_ = getattr(port, f"bn{k}"), stats[f"BatchNorm_{k}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), js_["mean"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), js_["var"], atol=1e-5, rtol=0)


def test_conv_branch_eval_mode_keeps_running_stats():
    m = tv.ConvBranch(8, generator=torch.Generator().manual_seed(0)).eval()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    m(torch.randn(2, 5, 5, 8))
    for k, v in m.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


# ---------------------------------------------------------------- DropPath


def test_drop_path_mask_is_per_sample_scaled_and_reproducible():
    dp = tv.DropPath(0.25).train()
    x = torch.ones(64, 3, 4, 5)
    mask = dp.draw(64, torch.Generator().manual_seed(7), x.device)
    assert mask.shape == (64,) and mask.dtype == torch.bool
    torch.testing.assert_close(
        mask, dp.draw(64, torch.Generator().manual_seed(7), x.device), rtol=0, atol=0)
    y = dp(x, mask)
    for b in range(64):  # each sample is kept whole, scaled by 1/keep, or dropped
        want = 1.0 / 0.75 if mask[b] else 0.0
        assert torch.all(y[b] == want)
    assert 0 < int(mask.sum()) < 64
    with pytest.raises(ValueError, match="keep mask"):
        dp(x)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        dp.draw(64, None, x.device)
    assert dp.eval()(x) is x


def _small_vssm(use_checkpoint, seed=0, drop_path_rate=0.5):
    return tv.VSSM(depths=(2, 1), dims=(16, 32), num_classes=3,
                   drop_path_rate=drop_path_rate, use_checkpoint=use_checkpoint,
                   generator=torch.Generator().manual_seed(seed))


def _train_grads(model, x, seed):
    model.train()
    logits = model(x, generator=torch.Generator().manual_seed(seed))
    torch.sin(logits).sum().backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def test_checkpointing_changes_no_gradient_or_running_stat():
    """With DropPath on (rates up to 0.5), the checkpointed model applies
    the masks drawn outside the recompute, and updates BatchNorm's running
    statistics once per forward, not again in the recompute: gradients
    and statistics equal the plain model's."""
    x = torch.randn(8, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    plain, ckpt = _small_vssm(False), _small_vssm(True)
    ckpt.load_state_dict(plain.state_dict())
    g_plain = _train_grads(plain, x, 3)
    g_ckpt = _train_grads(ckpt, x, 3)
    assert g_plain.keys() == g_ckpt.keys()
    for k in g_plain:
        torch.testing.assert_close(g_ckpt[k], g_plain[k], rtol=1e-6, atol=1e-7, msg=k)
    sd_p, sd_c = plain.state_dict(), ckpt.state_dict()
    for k in sd_p:
        if "running" in k:
            torch.testing.assert_close(sd_c[k], sd_p[k], rtol=0, atol=0, msg=k)
    # a different seed drops other samples: the masks do act
    g_other = _train_grads(_small_vssm(False), x, 4)
    assert any(not torch.equal(g_other[k], g_plain[k]) for k in g_plain)


def test_build_classifier_grad_checkpointing_flag():
    import inspect

    from mamba_clip_tpu_torch.models import build_classifier

    m = build_classifier("medmamba", grad_checkpointing=True)
    assert all(getattr(m, f"layer{i}").use_checkpoint for i in range(4))
    default = inspect.signature(build_classifier).parameters["grad_checkpointing"].default
    assert default is False


# ---------------------------------------------------------------- losses


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(16, 5).astype(np.float32) * 3
    hard = rs.randint(0, 5, 16).astype(np.int32)
    soft = rs.dirichlet(np.ones(5), 16).astype(np.float32)
    w = rs.uniform(0.2, 3.0, 5).astype(np.float32)
    for target, weight in ((hard, None), (soft, None), (hard, w)):
        want = float(jl.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(target),
            None if weight is None else jnp.asarray(weight)))
        got = float(tl.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(target),
            None if weight is None else torch.from_numpy(weight)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


# ---------------------------------------------------------------- schedules

_SCHEDULES = [
    ("const", lambda m: m.const_lr(1e-3, 10)),
    ("const_restart", lambda m: m.const_lr(1e-3, 5, restart_interval=30)),
    ("cooldown", lambda m: m.const_lr_cooldown(1e-3, 10, 100, 40, 1.0, 1e-5)),
    ("cooldown_pow2_restart", lambda m: m.const_lr_cooldown(2e-3, 3, 100, 20, 2.0, 0.0, 45)),
    ("cosine", lambda m: m.cosine_lr(1e-3, 10, 100)),
    ("cosine_restart", lambda m: m.cosine_lr(5e-4, 4, 100, restart_interval=33)),
]


@pytest.mark.parametrize("name,make", _SCHEDULES, ids=[n for n, _ in _SCHEDULES])
def test_schedule_matches_jax_over_100_steps(name, make):
    jsched, tsched = make(js), make(ts)
    want = np.asarray(jax.vmap(jsched)(jnp.arange(100)))
    got = np.array([tsched(k) for k in range(100)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.max(want)))


def test_create_schedule_and_warmup_match_jax():
    for kw in (dict(lr_scheduler="cosine", warmup=0.1),
               dict(lr_scheduler="const", warmup=7),
               dict(lr_scheduler="const-cooldown", warmup=2, epochs=4, epochs_cooldown=1),
               dict(lr_scheduler="cosine", warmup=3, lr_restart_interval=25)):
        args = Args(lr=3e-4, **kw)
        want = np.asarray(jax.vmap(js.create_schedule(args, 80))(jnp.arange(80)))
        got = np.array([ts.create_schedule(args, 80)(k) for k in range(80)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * args.lr)
    assert ts.create_schedule(Args(skip_scheduler=True), 10) is None
    assert ts.resolve_warmup(0.25, 40) == js.resolve_warmup(0.25, 40) == 10
    with pytest.raises(ValueError, match="epochs-cooldown"):
        ts.create_schedule(Args(lr_scheduler="const-cooldown"), 10)


# ---------------------------------------------------------------- optimizer


def _opt_tree(seed):
    rs = np.random.RandomState(seed)
    f = np.float32
    return {
        "backbone": {"w": rs.randn(6, 4).astype(f), "b": rs.randn(4).astype(f)},
        "head": {"kernel": rs.randn(4, 3).astype(f), "bias": rs.randn(3).astype(f),
                 "conv": rs.randn(3, 3, 2, 2).astype(f)},
    }


def _flat(tree):
    return {f"{k}.{n}": torch.from_numpy(np.array(v)) for k, sub in tree.items()
            for n, v in sub.items()}


@pytest.mark.parametrize("frozen", [False, True])
def test_build_optimizer_matches_optax(frozen):
    """Two AdamW updates with clipping active (|g| of about 20 against a
    max norm of 1), decay on the ndim >= 2 leaves only, a cosine schedule,
    and optionally the ``backbone`` subtree frozen."""
    args = Args(lr=1e-2, wd=0.1, beta1=0.9, beta2=0.99, eps=1e-6, grad_clip_norm=1.0,
                warmup=1)
    params = _opt_tree(0)
    grads = [jax.tree_util.tree_map(lambda x: x * 5.0, _opt_tree(s)) for s in (1, 2)]
    jmask = jo.freeze_submodule_mask(params, ["backbone"]) if frozen else None
    jtx = jo.build_optimizer(args, js.create_schedule(args, 10), trainable_mask=jmask)
    tmask = to.freeze_submodule_mask(_flat(params), ["backbone"]) if frozen else None
    ttx = to.build_optimizer(args, ts.create_schedule(args, 10), trainable_mask=tmask)

    jstate, tstate = jtx.init(params), ttx.init(_flat(params))
    jparams, tparams = params, _flat(params)
    for g in grads:
        assert float(optax.global_norm(g)) > 10 * args.grad_clip_norm
        jup, jstate = jtx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = ttx.update(_flat(g), tstate, tparams)
        tparams = {k: p + tup[k] for k, p in tparams.items()}
        for k, u in _flat(jup).items():
            scale = float(u.abs().max()) + 1e-12
            np.testing.assert_allclose(tup[k].numpy() / scale, u.numpy() / scale,
                                       rtol=0, atol=1e-6, err_msg=k)
        if frozen:
            assert all(float(tup[k].abs().max()) == 0.0 for k in tup if k.startswith("backbone"))
    assert to.decay_mask(_flat(params)) == {k: v.ndim >= 2 for k, v in _flat(params).items()}


def test_masks_merge_like_jax():
    p = _flat(_opt_tree(0))
    a = to.freeze_submodule_mask(p, ["backbone"])
    b = {k: not k.endswith("bias") for k in p}
    assert to.merge_masks(a, b) == {k: a[k] and b[k] for k in p}
    assert to.merge_masks(None, b) == b and to.merge_masks(a, None) == a
    assert to.merge_masks(None, None) is None


# ---------------------------------------------------------------- preprocess


def _jax_draws(key, B, H, W, out, scale, ratio, hflip, re_prob):
    """The values ``train_preprocess`` draws per image, recomputed under
    jit from the same key splits and with the same jnp expressions as
    ``_crop_coords`` and ``_erase`` (so XLA rounds them alike)."""
    uni = jax.random.uniform

    def one(k):
        kc, kf, ke, ki = jax.random.split(k, 4)
        k1, k2, k3, k4 = jax.random.split(kc, 4)
        target_area = H * W * uni(k1, (), minval=scale[0], maxval=scale[1])
        aspect = jnp.exp(uni(k2, (), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])))
        w, h = jnp.sqrt(target_area * aspect), jnp.sqrt(target_area / aspect)
        ok = (w <= W) & (h <= H)
        side = jnp.minimum(H, W).astype(jnp.float32)
        w, h = jnp.where(ok, w, side), jnp.where(ok, h, side)
        box = jnp.stack([uni(k3, ()) * (H - h), uni(k4, ()) * (W - w), h, w])
        e1, e2, e3, e4, e5, e6 = jax.random.split(ke, 6)
        area = uni(e2, (), minval=0.02, maxval=1.0 / 3.0) * out * out
        easp = jnp.exp(uni(e3, (), minval=jnp.log(0.3), maxval=jnp.log(1 / 0.3)))
        eh, ew = jnp.sqrt(area / easp), jnp.sqrt(area * easp)
        erase = jnp.stack([uni(e4, ()) * (out - eh), uni(e5, ()) * (out - ew), eh, ew])
        return (box, uni(kf, ()) < hflip, jax.random.bernoulli(ki), erase,
                uni(e1, ()) < re_prob, jax.random.normal(e6, (out, out, 3), jnp.float32))

    box, flip, bil, erase, on, noise = (
        torch.from_numpy(np.array(x)) for x in jax.jit(jax.vmap(one))(jax.random.split(key, B)))
    return tp.TrainDraws(boxes=box, flip=flip, bilinear=bil, erase=erase, erase_on=on,
                         noise=noise)


@pytest.mark.parametrize("interp,re_prob", [("random", 0.6), ("bilinear", 0.0),
                                            ("bicubic", 0.0), ("nearest", 0.5)])
def test_train_preprocess_matches_jax_with_its_draws(interp, re_prob):
    B, H, W, out = 6, 40, 48, 32
    scale, ratio, hflip = (0.08, 1.0), (3 / 4, 4 / 3), 0.5
    rs = np.random.RandomState(5)
    imgs = rs.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jp.train_preprocess(
        jnp.asarray(imgs), key, out_size=out, scale=scale, ratio=ratio, hflip=hflip,
        re_prob=re_prob, out_dtype=jnp.float32, interpolation=interp))
    draws = _jax_draws(key, B, H, W, out, scale, ratio, hflip, re_prob)
    if interp != "random":
        draws.bilinear = None
    if re_prob == 0.0:
        draws.erase = draws.erase_on = draws.noise = None
    got = tp.apply_train_params(torch.from_numpy(imgs), draws, out_size=out,
                                out_dtype=torch.float32, interpolation=interp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_train_preprocess_draws_from_its_generator():
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (8, 40, 40, 3),
                                                             dtype=np.uint8))
    run = lambda s: tp.train_preprocess(  # noqa: E731
        imgs, torch.Generator().manual_seed(s), out_size=24, re_prob=0.5,
        interpolation="random", out_dtype=torch.float32)
    a, b, c = run(1), run(1), run(2)
    assert a.shape == (8, 24, 24, 3) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    d = tp.draw_train_params(256, 40, 50, torch.Generator().manual_seed(0), out_size=24)
    y0, x0, h, w = d.boxes.unbind(1)
    assert bool((y0 >= 0).all() and (y0 + h <= 40 + 1e-4).all())
    assert bool((x0 >= 0).all() and (x0 + w <= 50 + 1e-4).all())
    assert 0.35 < float(d.flip.float().mean()) < 0.65


def test_train_transform_config_matches_jax():
    for aug in (None, {"scale": (0.5, 1.0), "re_prob": 0.25, "hflip": 0.0,
                       "interpolation": "random"}):
        j = jcfg.get_transform_config(aug, 224, is_train=True)
        t = tcfg.get_transform_config(aug, 224, is_train=True)
        assert vars(j) == vars(t)


# ---------------------------------------------------------------- precision


def test_loss_scale_state_machine_matches_jax(monkeypatch):
    monkeypatch.setattr(jprec, "GROWTH_INTERVAL", 3)
    monkeypatch.setattr(tprec, "GROWTH_INTERVAL", 3)
    js_, ts_ = jprec.init_loss_scale(8.0), tprec.init_loss_scale(8.0)
    for finite in (True, True, True, False, True, False, False, False, False, True):
        js_ = jprec.update_loss_scale(js_, jnp.bool_(finite))
        ts_ = tprec.update_loss_scale(ts_, finite)
        assert (ts_.scale, ts_.growth_count) == (float(js_.scale), int(js_.growth_count))


def test_cast_to_param():
    pol = tprec.get_policy("pure_bf16")
    tree = {"a": torch.ones(2), "b": [torch.ones(1, dtype=torch.int32), 3.0]}
    out = pol.cast_to_param(tree)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int32 and out["b"][1] == 3.0


def test_average_meter_matches_jax():
    from mamba_clip_tpu.train import AverageMeter as JaxMeter
    from mamba_clip_tpu_torch.train import AverageMeter

    j, t = JaxMeter(), AverageMeter()
    for val, n in ((1.5, 2), (0.25, 1), (3.0, 5)):
        j.update(val, n)
        t.update(val, n)
        assert vars(j) == vars(t)
    t.reset()
    assert (t.val, t.avg, t.sum, t.count) == (0.0, 0.0, 0.0, 0)
