"""The port's contrastive train step against the JAX package's, on the CPU.

A small CLIP (ViT: image 32, patch 16, width 32, depth 2, 4 heads; BERT:
vocab 128, context 16, the same widths; embed 16) is initialized by Flax
and carried into the port by ``convert.py``. The crop is deterministic
(``scale=(1, 1)``, ``ratio=(1, 1)``, ``hflip=0``, ``re_prob=0`` on square
staging), so both steps see the same images; the tokens carry padding
inside and after the text. The port runs ``attn_flash=True`` (on the CPU:
``FlashAttnFn`` with the plain interior and the plain backward), JAX its
einsum interior. Both steps take the same numpy batches, AdamW with
clipping and weight decay under a cosine schedule.

Tolerances:
- fp32, 5 steps: the loss of each at rel 1e-5, the grad norm at rel 1e-4,
  ``logit_scale`` at rel 1e-6; the gradients of step 1 per leaf at atol
  1e-4 of the leaf's largest gradient, except the key bias inside every
  fused qkv bias, whose gradient is 0 (a softmax does not see a shift of
  its scores) and is checked to be rounding noise. Both sides compute in
  fp32; they differ in GEMM and reduction order.
- ``accum_freq=2``, ``siglip``, balanced mixup (JAX's lam injected), a
  ``lock_mask`` run, and the VSSM-towered CLIP: the loss of 3 steps at rel
  1e-5 and the grad norm at rel 1e-4, as above (the VSSM at 1e-4 and 1e-3:
  the scan's tolerance).
- ``amp`` (bf16 activations over fp32 parameters): the loss of 3 steps at
  rel 1e-2 at lr 1e-4 (2.5e-3 and 5.7e-3 measured at steps 1 and 2). bf16
  keeps 8 bits; the two frameworks round at the same casts but sum in
  other orders, so the unit features differ by a few bf16 ulps, and the
  contrastive logits multiply that by the logit scale (14.3) before the
  softmax over 8 pairs.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.losses import clip_loss as jax_clip_loss
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.models import vssm as jvssm
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import load_jax_variables, mask_from_jax, state_dict_from_jax
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.models import vssm as tvssm
from mamba_clip_tpu_torch.ops import flash_attn as tfa
from mamba_clip_tpu_torch.optim import build_optimizer
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.utils.precision import get_policy

VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
VSSM = dict(depths=(1, 1), dims=(16, 32), num_classes=0, drop_path_rate=0.0)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH, SEED = 32, 40, 8, 0
LOCK = dict(lock_image=True, lock_image_unlocked_groups=1, lock_text=True,
            lock_text_unlocked_layers=1, lock_text_freeze_layer_norm=False)


def _tokens(rs):
    ids = rs.randint(4, 128, (BATCH, 16)).astype(np.int32)
    ids[:, 0] = 2
    for i, n in enumerate(rs.randint(3, 17, BATCH)):
        ids[i, n:] = 0       # padding after the text
    ids[1, 2] = 0            # a pad key inside the text
    return ids


def _batches(n, mix=False):
    rs = np.random.RandomState(1)
    out = []
    for _ in range(n):
        b = {"image": rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8),
             "tokens": _tokens(rs)}
        if mix:
            b["mix_image"] = rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8)
            b["mix_tokens"] = _tokens(rs)
        out.append(b)
    return out


class _Pair:
    """The JAX step and the port's step from one Flax init."""

    def __init__(self, precision="fp32", vssm=False, lock=None, siglip=False, lr=1e-3,
                 **arg_kw):
        # eps 1e-6: a leaf whose true gradient is 0 (the key bias) holds
        # rounding noise, which Adam with eps 1e-8 turns into lr-sized steps
        # of random sign on each side
        self.args = Args(batch_size=BATCH, epochs=1, lr=lr, warmup=1, wd=0.05, eps=1e-6,
                         grad_clip_norm=1.0, precision=precision, siglip=siglip, **arg_kw)
        jpol, tpol = jax_get_policy(precision), get_policy(precision)
        jdt, tdt = jpol.compute_dtype, tpol.compute_dtype
        if vssm:
            jv = jclip.VssmTower(vssm=jvssm.VSSM(**VSSM, scan_impl="xla", dtype=jdt),
                                 embed_dim=16)
            tv = tclip.VssmTower(tvssm.VSSM(**VSSM, dtype=tdt), embed_dim=16)
        else:
            jv = jvit.VisionTransformer(**VIT, dtype=jdt)
            tv = tvit.VisionTransformer(**VIT, dtype=tdt, attn_flash=True)
        self.jm = jclip.ClipModel(visual=jv, text=jbert.TextBert(**BERT, dtype=jdt),
                                  siglip=siglip)
        model = tclip.ClipModel(tv, tbert.TextBert(**BERT, dtype=tdt, attn_flash=True),
                                siglip=siglip)
        variables = jax.jit(lambda k, a, b: self.jm.init(k, image=a, text=b))(
            jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 16), jnp.int32))
        self.variables = jax.tree_util.tree_map(np.asarray, variables)
        load_jax_variables(model, self.variables)

        jmask = tmask = None
        if lock:
            jmask = jclip.lock_mask(variables["params"], **lock)
            tmask = tclip.lock_mask(dict(model.named_parameters()), **lock)
            assert tmask == mask_from_jax(jmask)
        self.tmask = tmask
        jtcfg = jax_tcfg(AUG, IMAGE, is_train=True)
        jsched = jax_create_schedule(self.args, 10)
        jtx = jax_build_optimizer(self.args, jsched, trainable_mask=jmask)
        self.jstate = jtrain.create_train_state(
            variables["params"], jtx, variables.get("batch_stats"), policy=jpol)
        self.jstep = jax.jit(jtrain.make_clip_train_step(
            self.jm, jtx, jpol, self.args, jtcfg, jsched))
        self.jtcfg, self.jpol = jtcfg, jpol

        tsched = create_schedule(self.args, 10)
        ttx = build_optimizer(self.args, tsched, trainable_mask=tmask)
        self.tstate = ttrain.create_train_state(model, ttx, policy=tpol)
        self.tstep = ttrain.make_clip_train_step(
            model, ttx, tpol, self.args, get_transform_config(AUG, IMAGE, is_train=True), tsched)
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
    def loss_fn(params, image_u8, tokens):
        jimg = jtrain._preprocess_train(
            image_u8, jax.random.split(jax.random.fold_in(pair.key, 0), 4)[0],
            pair.jtcfg, pair.jpol)
        out = pair.jm.apply({"params": params}, image=jimg, text=tokens, deterministic=False)
        return jax_clip_loss(out["image_features"], out["text_features"], out["logit_scale"])

    jgrads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(
            pair.variables["params"], jnp.asarray(batches[0]["image"]),
            jnp.asarray(batches[0]["tokens"])))})

    for i, batch in enumerate(batches):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= 1e-5, (i, got, want)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= 1e-4, (i, got, want)
        assert _rel(got["logit_scale"], want["logit_scale"]) <= 1e-6, (i, got, want)
        assert _rel(got["lr"], want["lr"]) <= 1e-6
        assert sorted(got) == sorted(want)
        if i == 0:
            top = max(float(g.abs().max()) for g in jgrads.values())
            for name, p in pair.tstate.model.named_parameters():
                g, w = p.grad.numpy(), jgrads[name].numpy()
                if name.endswith("attn.qkv.bias"):
                    # the key third: a shift of every score of a row, which the
                    # softmax does not see; both sides hold rounding noise
                    third = g.shape[0] // 3
                    assert max(np.abs(g[third:2 * third]).max(),
                               np.abs(w[third:2 * third]).max()) <= 1e-6 * top, name
                    key = np.s_[third:2 * third]
                    g, w = np.delete(g, key), np.delete(w, key)
                scale = float(np.abs(w).max()) + 1e-12
                np.testing.assert_allclose(g / scale, w / scale, atol=1e-4, err_msg=name)
    assert pair.tstate.step == int(pair.jstate.step) == 5
    want_params = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, pair.jstate.params)})
    for name, p in pair.tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(), atol=2e-5,
                                   rtol=0, err_msg=name)
    assert tfa.flash_attn_fwd.launches == 0 and tfa.flash_attn_bwd_dkv.launches == 0


def _jax_lams(key, alpha, n):
    return [float(jax.random.beta(jax.random.split(jax.random.fold_in(key, s), 4)[2],
                                  alpha, 1.0)) for s in range(n)]


@pytest.mark.parametrize("case", ["accum_freq=2+debug", "siglip", "balanced_mixup",
                                  "lock_mask", "amp"])
def test_clip_step_variants_match_jax(case, monkeypatch):
    kw, mix, bound = {}, False, 1e-5
    if case == "accum_freq=2+debug":
        kw = dict(accum_freq=2, debug=True)
    elif case == "siglip":
        kw = dict(siglip=True)
    elif case == "balanced_mixup":
        kw, mix = dict(balanced_mixup=0.4), True
    elif case == "lock_mask":
        kw = dict(lock=LOCK)
    else:
        kw, bound = dict(precision="amp", lr=1e-4), 1e-2
    pair = _Pair(**kw)
    if mix:  # JAX's lam of each step, in place of the port's own draw
        lams = iter(_jax_lams(pair.key, 0.4, 3))
        monkeypatch.setattr(ttrain, "draw_lam",
                            lambda gen, alpha: torch.tensor(next(lams), dtype=torch.float32))
    before = {k: p.detach().clone() for k, p in pair.tstate.model.named_parameters()}
    for i, batch in enumerate(_batches(3, mix=mix)):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= bound, \
            (case, i, got, want)
        # summed, not averaged, micro-batch gradients: an average would halve the norm
        assert _rel(got["grad_norm"], want["grad_norm"]) <= max(10 * bound, 1e-4), \
            (case, i, got, want)
        assert _rel(got["logit_scale"], want["logit_scale"]) <= max(bound, 1e-6)
        assert sorted(got) == sorted(want)
        if "debug" in case:
            for key in ("gnorm/visual", "pnorm/text", "gnorm/logit_scale"):
                assert _rel(got[key], want[key]) <= 1e-4, (key, got, want)
    if case == "lock_mask":
        # frozen leaves are bit-unchanged (no update, no decay); the others moved
        frozen = [k for k, t in pair.tmask.items() if not t]
        assert frozen and len(frozen) < len(before)
        for k, p in pair.tstate.model.named_parameters():
            assert torch.equal(p.detach(), before[k]) == (k in frozen), k
        assert set(pair.tstate.opt_state.mu) == set(before) - set(frozen)


def test_vssm_towered_clip_matches_jax_and_freezes_bn_stats():
    """The VSSM image tower: BatchNorm in training mode. ``accum_freq=2``
    moves the running statistics in the graded pass only (the bank pass
    discards them), as JAX's do. With ``--lock-image
    --lock-image-freeze-bn-stats`` the visual running statistics are put
    back after the step."""
    pair = _Pair(vssm=True, accum_freq=2)
    stats0 = {k: b.clone() for k, b in pair.tstate.model.named_buffers() if "running" in k}
    assert stats0
    for i, batch in enumerate(_batches(3)):
        got, want = pair.step(batch)
        assert _rel(got["loss"], want["loss"]) <= 1e-4, (i, got, want)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= 1e-3, (i, got, want)
    want_stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, pair.jstate.batch_stats)})
    buffers = dict(pair.tstate.model.named_buffers())
    for k, w in want_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=k)
    assert not any(torch.equal(buffers[k], b) for k, b in stats0.items())

    model = pair.tstate.model
    moved = {k: b.clone() for k, b in buffers.items() if "running" in k}
    args = Args(batch_size=BATCH, epochs=1, lock_image=True, lock_image_freeze_bn_stats=True)
    tx = build_optimizer(args, None)
    step = ttrain.make_clip_train_step(model, tx, get_policy("fp32"), args,
                                       get_transform_config(AUG, IMAGE, is_train=True))
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    step(ttrain.create_train_state(model, tx), batch, SEED)
    assert all(torch.equal(buffers[k], b) for k, b in moved.items())


def test_accum_bank_pass_draws_the_graded_pass_dropout_stream(monkeypatch):
    """With patch dropout on, the no-grad bank pass must see the masks of
    the graded pass (JAX passes one ``rngs`` to both): then the rows a
    micro-batch substitutes into the bank equal the rows cached for it."""
    g = torch.Generator().manual_seed(0)
    model = tclip.ClipModel(
        tvit.VisionTransformer(**dict(VIT, image_size=64, patch_dropout=0.5), generator=g),
        tbert.TextBert(**BERT, generator=g))
    args = SimpleNamespace(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0, accum_freq=2,
                           grad_clip_norm=None, balanced_mixup=0.0, siglip=False)
    pol = get_policy("fp32")
    tx = build_optimizer(args, None)
    step = ttrain.make_clip_train_step(
        model, tx, pol, args, get_transform_config(AUG, 64, is_train=True))
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.randint(0, 256, (4, 72, 72, 3), dtype=np.uint8)),
             "tokens": torch.from_numpy(_tokens(rs)[:4])}
    banks = []
    real = ttrain.clip_loss
    monkeypatch.setattr(ttrain, "clip_loss",
                        lambda i, t, s: banks.append(i.detach()) or real(i, t, s))
    _, m = step(ttrain.create_train_state(model, tx, pol), batch, 3)
    # bank 0 holds micro-batch 0's graded rows and micro-batch 1's cached rows, bank 1 the
    # reverse: equal banks mean each graded forward reproduced its cached features
    assert len(banks) == 2 and torch.equal(banks[0], banks[1])
    assert not torch.equal(banks[0][:2], banks[0][2:]) and np.isfinite(float(m["loss"]))


def test_fp16_dynamic_scale_skips_a_non_finite_step_and_keeps_the_clamp(monkeypatch):
    """fp16: a finite step updates, clamps the logit scale and counts toward
    growth; a step whose gradients are not finite leaves the parameters and
    the optimizer state as they were and halves the scale."""
    g = torch.Generator().manual_seed(0)
    model = tclip.ClipModel(tvit.VisionTransformer(**VIT, dtype=torch.float16, generator=g),
                            tbert.TextBert(**BERT, dtype=torch.float16, generator=g))
    with torch.no_grad():
        model.logit_scale.fill_(4.7)  # above ln 100: the kept step must clamp it
    args = Args(batch_size=BATCH, epochs=1, lr=1e-3, warmup=1, precision="fp16")
    pol = get_policy("fp16")
    tx = build_optimizer(args, None)
    step = ttrain.make_clip_train_step(model, tx, pol, args,
                                       get_transform_config(AUG, IMAGE, is_train=True))
    state = ttrain.create_train_state(model, tx, pol)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    # the initial scale 2^16 overflows fp16 here: every skipped step halves it
    for n in range(12):
        scale = state.loss_scale.scale
        state, m = step(state, batch, 0)
        if m["skipped_steps"] == 0:
            break
        assert state.loss_scale.scale == scale / 2 and state.opt_state.count == 0
        assert float(model.logit_scale) == np.float32(4.7)  # a skipped step clamps nothing
    assert m["skipped_steps"] == 0 and state.loss_scale.growth_count == 1
    assert state.opt_state.count == 1 and state.step == n + 1
    assert float(m["logit_scale"]) == pytest.approx(float(np.exp(np.float32(4.7))), rel=1e-6)
    assert float(model.logit_scale.detach()) == np.float32(tclip.LOGIT_SCALE_MAX)
    scale = state.loss_scale.scale

    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    real = ttrain.clip_loss
    monkeypatch.setattr(ttrain, "clip_loss", lambda *a, **kw: real(*a, **kw) * float("inf"))
    state, m = step(state, batch, 0)
    assert m["skipped_steps"] == 1 and m["loss_scale"] == scale
    assert (state.loss_scale.scale, state.loss_scale.growth_count) == (scale / 2, 0)
    assert state.step == n + 2 and state.opt_state.count == 1
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


def test_clip_step_refuses_the_mesh_and_calibrate_quant():
    model = tclip.ClipModel(torch.nn.Identity(), torch.nn.Identity())
    args = Args(batch_size=BATCH, epochs=1)
    pol = get_policy("fp32")
    tcfg = get_transform_config(AUG, IMAGE, is_train=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        ttrain.make_clip_train_step(model, None, pol, args, tcfg, mesh=object())
    step = ttrain.make_clip_train_step(model, None, pol, args, tcfg)
    with pytest.raises(NotImplementedError, match="item 6"):
        step.calibrate_quant(None, None, 0)
    args = Args(batch_size=BATCH, epochs=1, accum_freq=3)
    g = torch.Generator().manual_seed(0)
    model = tclip.ClipModel(tvit.VisionTransformer(**VIT, generator=g),
                            tbert.TextBert(**BERT, generator=g))
    tx = build_optimizer(args, None)
    step = ttrain.make_clip_train_step(model, tx, pol, args, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    with pytest.raises(ValueError, match="--accum-freq 3 must divide"):
        step(ttrain.create_train_state(model, tx, pol), batch, 0)
