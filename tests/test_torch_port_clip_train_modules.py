"""The modules of the port's contrastive train step against the JAX package.

``clip_loss`` and ``siglip_loss`` (value and gradients), ``lock_mask`` (leaf
by leaf, through ``convert.mask_from_jax``), ``clamp_logit_scale``, the
ViT's patch dropout (JAX's mask injected into both sides), and the remat
modes (``grad_checkpointing``, ``attn_remat``), at the small sizes of
``test_torch_port_towers.py`` (width 32, depth 2, 4 heads, image 32,
context 16, vocab 128), whose numpy-seeded inputs and parameter values
they share.

Tolerances, all fp32:
- losses: the value at rtol 1e-6, the gradients at atol 1e-6 of gradients
  of order 0.1 (one matmul and a log-softmax, summed in another order);
- patch dropout through the ViT: features at atol 1e-5 and parameter
  gradients at 1e-4 of each leaf's largest entry, the towers' tolerances;
- remat: recomputing a block or an interior repeats the same operations on
  the same values, so every gradient must be bit-identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu import losses as jlosses
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.models import vssm as jvssm
from mamba_clip_tpu_torch import losses as tlosses
from mamba_clip_tpu_torch.convert import load_jax_variables, mask_from_jax, state_dict_from_jax
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.models import vssm as tvssm
from test_torch_port_towers import _image as image
from test_torch_port_towers import _tokens as tokens
from test_torch_port_towers import _variables as variables_of

VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
VSSM = dict(depths=(1, 1), dims=(16, 32), num_classes=0)


def _features(seed, n=6, d=16):
    rs = np.random.RandomState(seed)
    f = rs.randn(2, n, d).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    return f[0], f[1], np.float32(np.exp(2.3)), np.float32(-9.5)


# --- losses ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["clip", "clip_bias", "clip_bf16_features", "siglip"])
def test_contrastive_losses_match_jax(case):
    img, txt, scale, bias = _features(seed=3)
    ti, tt, ts, tb = (torch.tensor(a, requires_grad=True) for a in (img, txt, scale, bias))
    if case == "siglip":
        j_fn = lambda i, t, s, b: jlosses.siglip_loss(i, t, s, b)  # noqa: E731
        got = tlosses.siglip_loss(ti, tt, ts, tb)
    elif case == "clip_bias":
        j_fn = lambda i, t, s, b: jlosses.clip_loss(i, t, s, logit_bias=b)  # noqa: E731
        got = tlosses.clip_loss(ti, tt, ts, logit_bias=tb)
    elif case == "clip_bf16_features":  # fp32 logits whatever the compute type
        j_fn = lambda i, t, s, b: jlosses.clip_loss(  # noqa: E731
            i.astype(jnp.bfloat16), t.astype(jnp.bfloat16), s) + 0.0 * b
        got = tlosses.clip_loss(ti.bfloat16(), tt.bfloat16(), ts) + 0.0 * tb
    else:
        j_fn = lambda i, t, s, b: jlosses.clip_loss(i, t, s) + 0.0 * b  # noqa: E731
        got = tlosses.clip_loss(ti, tt, ts) + 0.0 * tb
    want, grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (img, txt, scale, bias)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    got.backward()
    atol = 1e-6 if case != "clip_bf16_features" else 1e-3  # bf16 features: 2^-8 of the grads
    for leaf, g, w in zip(("img", "txt", "scale", "bias"), (ti, tt, ts, tb), grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w, np.float32), atol=atol,
                                   rtol=1e-5, err_msg=leaf)


def test_losses_refuse_the_mesh_branches():
    img, txt, scale, bias = (torch.tensor(a) for a in _features(seed=4))
    with pytest.raises(NotImplementedError, match="item 7"):
        tlosses.clip_loss(img, txt, scale, axis_name="data", local_loss=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        tlosses.siglip_loss(img, txt, scale, bias, axis_name="data")


# --- lock_mask ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _clip_params(layout):
    """(the Flax params tree, the port's name -> parameter mapping)."""
    if layout == "vit":
        jv, tv = jvit.VisionTransformer(**VIT), tvit.VisionTransformer(**VIT)
        x = image()
    else:  # a bare VSSM as the visual tower: stem, layer<N> stages, no final norm
        jv, tv = jvssm.VSSM(**VSSM, scan_impl="xla"), tvssm.VSSM(**VSSM)
        x = image(size=16)
    jm = jclip.ClipModel(visual=jv, text=jbert.TextBert(**BERT))
    shapes = jax.eval_shape(lambda a, b: jm.init(jax.random.PRNGKey(0), image=a, text=b),
                            jnp.asarray(x), jnp.asarray(tokens()))
    port = tclip.ClipModel(tv, tbert.TextBert(**BERT))
    return shapes["params"], dict(port.named_parameters())


FLAGS = [
    dict(),
    dict(lock_image=True),
    dict(lock_image=True, lock_image_unlocked_groups=1),
    dict(lock_image=True, lock_image_unlocked_groups=2),
    dict(lock_image=True, lock_image_unlocked_groups=99),
    dict(lock_text=True),
    dict(lock_text=True, lock_text_freeze_layer_norm=False),
    dict(lock_text=True, lock_text_unlocked_layers=1),
    dict(lock_text=True, lock_text_unlocked_layers=2, lock_text_freeze_layer_norm=False),
    dict(lock_text=True, lock_text_unlocked_layers=-3),
    dict(lock_image=True, lock_image_unlocked_groups=1, lock_text=True,
         lock_text_unlocked_layers=1, lock_text_freeze_layer_norm=False),
]


@pytest.mark.parametrize("layout", ["vit", "vssm"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(
    f"{k.replace('lock_', '')}={v}" for k, v in f.items()) or "none")
def test_lock_mask_matches_jax_leaf_by_leaf(layout, flags):
    jparams, tparams = _clip_params(layout)
    want = mask_from_jax(jclip.lock_mask(jparams, **flags))
    got = tclip.lock_mask(tparams, **flags)
    assert set(got) == set(want) == set(tparams)
    assert got == want
    if not flags:
        assert all(got.values())
    if flags.get("lock_image") or flags.get("lock_text"):
        assert not all(got.values()) or 99 in flags.values()
        assert got["logit_scale"] and got["text.proj_fc1.weight"]
    if flags == dict(lock_text=True, lock_text_freeze_layer_norm=False):
        assert got["text.block0.ln_attn.weight"] and got["text.ln_emb.bias"]
        assert not got["text.block0.attn.qkv.weight"] and not got["text.pos_emb"]


def test_lock_mask_refuses_an_unknown_module():
    jparams, tparams = _clip_params("vit")
    jbad = {**jparams, "visual": {**jparams["visual"], "adapter": {"kernel": np.zeros((2, 2))}}}
    tbad = {**tparams, "visual.adapter.weight": torch.zeros(2, 2)}
    with pytest.raises(ValueError) as t_err:
        tclip.lock_mask(tbad, lock_image=True)
    with pytest.raises(ValueError) as j_err:
        jclip.lock_mask(jbad, lock_image=True)
    assert str(t_err.value) == str(j_err.value) and "adapter" in str(t_err.value)
    assert all(tclip.lock_mask(tbad, lock_text=True)[k] for k in tbad if k.startswith("visual."))
    # the VSSM behind VssmTower nests its stages one level down: both sides refuse
    port = tclip.ClipModel(tclip.VssmTower(tvssm.VSSM(**VSSM), embed_dim=16),
                           tbert.TextBert(**BERT))
    jm = jclip.ClipModel(visual=jclip.VssmTower(vssm=jvssm.VSSM(**VSSM, scan_impl="xla"),
                                                embed_dim=16), text=jbert.TextBert(**BERT))
    shapes = jax.eval_shape(lambda a, b: jm.init(jax.random.PRNGKey(0), image=a, text=b),
                            jnp.asarray(image(size=16)), jnp.asarray(tokens()))
    with pytest.raises(ValueError, match="vssm") as t_err:
        tclip.lock_mask(dict(port.named_parameters()), lock_image=True)
    with pytest.raises(ValueError) as j_err:
        jclip.lock_mask(shapes["params"], lock_image=True)
    assert str(t_err.value) == str(j_err.value)


def test_clamp_logit_scale_matches_jax():
    for value in (-0.5, 2.0, 7.0):
        port = tclip.ClipModel(torch.nn.Identity(), torch.nn.Identity(), siglip=True)
        with torch.no_grad():
            port.logit_scale.fill_(value)
        before = port.logit_bias.detach().clone()
        tclip.clamp_logit_scale(dict(port.named_parameters()))
        want = jclip.clamp_logit_scale({"params": {"logit_scale": jnp.float32(value),
                                                   "logit_bias": jnp.float32(-10.0)}})
        assert float(port.logit_scale.detach()) == float(want["params"]["logit_scale"])
        assert torch.equal(port.logit_bias.detach(), before)
    assert float(want["params"]["logit_scale"]) == np.float32(tclip.LOGIT_SCALE_MAX)


# --- patch dropout --------------------------------------------------------

def test_patch_dropout_matches_flax_with_its_mask_injected(monkeypatch):
    kw = dict(VIT, image_size=64, patch_dropout=0.4)  # 16 patches + CLS
    x = image(size=64)
    jm = jvit.VisionTransformer(**kw)
    variables = variables_of(jm, jnp.asarray(x))
    keep = np.random.RandomState(7).rand(2, 16, 1) < 0.6
    assert 0 < keep.sum() < keep.size
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    monkeypatch.setattr(tvit, "keep_mask", lambda shape, rate, gen, dev: torch.from_numpy(keep))
    w = np.random.RandomState(8).randn(2, 16).astype(np.float32)

    def j_loss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(j_loss, has_aux=True)(variables["params"])
    port = load_jax_variables(tvit.VisionTransformer(**kw), variables).train()
    got = port(torch.from_numpy(x), generator=torch.Generator())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (got * torch.from_numpy(w)).sum().backward()
    for name, g in state_dict_from_jax({"params": jax.tree_util.tree_map(
            np.asarray, jgrads)}).items():
        scale = float(g.abs().max()) + 1e-12
        np.testing.assert_allclose(dict(port.named_parameters())[name].grad.numpy() / scale,
                                   g.numpy() / scale, atol=1e-4, err_msg=name)
    # eval mode, and a dropped patch: CLS is never touched, kept patches scale by 1/keep
    port.eval()
    with torch.no_grad():
        assert not torch.equal(port(torch.from_numpy(x)), got)


def test_patch_dropout_draws_from_the_explicit_generator():
    port = tvit.VisionTransformer(**dict(VIT, image_size=64, patch_dropout=0.5)).train()
    x = torch.from_numpy(image(size=64))
    with pytest.raises(ValueError, match="generator"):
        port(x)
    with torch.no_grad():
        a = port(x, generator=torch.Generator().manual_seed(1))
        b = port(x, generator=torch.Generator().manual_seed(1))
        c = port(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- remat ----------------------------------------------------------------

def _grads(model, inputs, **kw):
    model.zero_grad()
    out = model(*inputs, **kw)
    (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("tower", ["vit", "bert"])
@pytest.mark.parametrize("mode", ["grad_checkpointing", "attn_remat", "both",
                                  "grad_checkpointing+flash", "attn_remat+flash"])
def test_remat_modes_change_no_gradient(tower, mode):
    flash = mode.endswith("+flash")
    flags = dict(grad_checkpointing=mode.startswith(("grad", "both")),
                 attn_remat=mode.startswith(("attn", "both")))
    if tower == "vit":
        make = lambda **kw: tvit.VisionTransformer(  # noqa: E731
            **dict(VIT, image_size=64, patch_dropout=0.3), attn_flash=flash, **kw)
        inputs = (torch.from_numpy(image(size=64)),)
        call = lambda: dict(generator=torch.Generator().manual_seed(5))  # noqa: E731
    else:
        make = lambda **kw: tbert.TextBert(**BERT, attn_flash=flash, **kw)  # noqa: E731
        inputs = (torch.from_numpy(tokens()),)
        call = dict
    plain = make(generator=torch.Generator().manual_seed(0)).train()
    remat = make(generator=torch.Generator().manual_seed(0), **flags).train()
    remat.load_state_dict(plain.state_dict())
    out_p, g_p = _grads(plain, inputs, **call())
    out_r, g_r = _grads(remat, inputs, **call())
    assert torch.equal(out_p, out_r)
    assert all(float(g.abs().max()) > 0 for k, g in g_p.items() if "attn.qkv.weight" in k)
    for k in g_p:
        assert torch.equal(g_p[k], g_r[k]), k
    # the recompute really runs: with checkpointing a block's forward runs twice
    if flags["grad_checkpointing"]:
        runs = []
        remat.block0.register_forward_pre_hook(lambda *a: runs.append(None))
        _grads(remat, inputs, **call())
        assert len(runs) == 2
