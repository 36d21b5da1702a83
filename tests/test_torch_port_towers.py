"""The port's CLIP towers against the Flax modules, weights via convert.py.

``VisionTransformer`` (image 32, patch 16, width 32, depth 2, 4 heads),
``TextBert`` (vocab 128, context 16, width 32, depth 2, 4 heads, with pad
tokens inside and after the text), ``VssmTower`` over a small VSSM and
``ClipModel`` over them, eval path. Variables are shaped by
``jax.eval_shape`` of the Flax init and filled from a numpy seed
(LayerNorm scales, embeddings and the logit scale and bias away from their
inits, so that every mapping of the bridge is exercised), then given to
both sides.

Tolerances. fp32: atol 1e-5 on features of order 1 (both sides compute
in fp32; GEMM summation order and Flax's one-pass LayerNorm variance
differ by a few ulps a layer). bf16 compute (``amp``): atol 5e-2, about
three bf16 ulps (1.6e-2 each) at the features' size of 2 to 3.5 (the
worst case measured is 2.2e-2): the two frameworks round the bf16 GEMM
outputs, the GELU and the residual sums at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.models import vssm as jvssm
from mamba_clip_tpu_torch.convert import load_jax_variables
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.models import vssm as tvssm

ATOL = 1e-5
ATOL_BF16 = 5e-2
VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
DTYPES = {"fp32": (jnp.float32, torch.float32, ATOL), "bf16": (jnp.bfloat16, torch.bfloat16,
                                                               ATOL_BF16)}


def _fill(shapes, seed):
    """numpy values for a Flax variable tree of ShapeDtypeStructs."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("embedding", "cls_token", "pos_embed", "pos_emb", "type_emb"):
            v = 0.5 * rs.randn(*shape)
        elif name in ("x_proj_weight", "dt_projs_weight"):
            v = rs.randn(*shape) / np.sqrt(shape[-1])
        elif name == "dt_projs_bias":
            dt = rs.uniform(1e-3, 0.1, shape)
            v = dt + np.log(-np.expm1(-dt))
        elif name == "A_logs":
            v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rs.randn(*shape)
        elif name in ("scale", "Ds"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == "var":
            v = rs.uniform(0.5, 1.5, shape)
        elif name == "logit_scale":
            v = np.log(1 / 0.07) + 0.1 * rs.randn()
        elif name == "logit_bias":
            v = -10.0 + rs.randn()
        else:  # bias, mean
            v = 0.1 * rs.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _variables(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)
    return _fill(shapes, seed)


def _image(seed=1, size=32):
    return np.random.RandomState(seed).randn(2, size, size, 3).astype(np.float32)


def _tokens(seed=2):
    ids = np.random.RandomState(seed).randint(4, 128, (2, 16)).astype(np.int32)
    ids[:, 0] = 2        # CLS
    ids[0, 9] = 3        # SEP, then padding
    ids[0, 10:] = 0
    ids[1, 5] = 0        # a pad key inside the text: the key mask is not a prefix
    return ids


def _port(module, variables):
    load_jax_variables(module, variables)
    return module.eval()


@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vit_matches_flax(dtype, gelu_approx):
    jdt, tdt, atol = DTYPES[dtype]
    jm = jvit.VisionTransformer(**VIT, dtype=jdt, gelu_approx=gelu_approx)
    x = _image()
    variables = _variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    port = _port(tvit.VisionTransformer(**VIT, dtype=tdt, gelu_approx=gelu_approx), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("proj_type", ["mlp", "linear", "none"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_text_bert_matches_flax(dtype, proj_type):
    jdt, tdt, atol = DTYPES[dtype]
    gelu_approx = dtype == "bf16"
    jm = jbert.TextBert(**BERT, dtype=jdt, proj_type=proj_type, gelu_approx=gelu_approx)
    ids = _tokens()
    variables = _variables(jm, jnp.asarray(ids))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(ids)))
    port = _port(tbert.TextBert(**BERT, dtype=tdt, proj_type=proj_type,
                                gelu_approx=gelu_approx), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    assert got.shape == want.shape == (2, 16 if proj_type != "none" else 32)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_flash_towers_match_flax_flash_with_oracle(monkeypatch):
    """The Flax towers with ``attn_flash`` (their flash interior run with
    the ``mha_reference`` oracle, as tests/test_flash_attn.py runs it) and
    the port's with ``attn_flash`` (on the CPU: the plain interior)."""
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

    import mamba_clip_tpu.ops.flash_attn as jfa

    def oracle(q, k, v, ab, segment_ids, *, causal, sm_scale):
        return mha_reference(q * sm_scale, k, v, ab, segment_ids, causal=causal, sm_scale=1.0)

    orig = jfa.flash_attention_interior
    monkeypatch.setattr(jfa, "flash_attention_interior", lambda q, k, v, m, *, sm_scale: orig(
        q, k, v, m, sm_scale=sm_scale, kernel_fn=oracle))
    for jm, port_cls, kw, x in (
            (jvit.VisionTransformer(**VIT, attn_flash=True), tvit.VisionTransformer, VIT,
             _image()),
            (jbert.TextBert(**BERT, attn_flash=True), tbert.TextBert, BERT, _tokens())):
        variables = _variables(jm, jnp.asarray(x))
        want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
        port = _port(port_cls(**kw, attn_flash=True), variables)
        assert all(b.attn.flash_interior for n, b in port.named_children()
                   if n.startswith("block"))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _clip_pair(siglip):
    jm = jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT),
                         siglip=siglip)
    port = tclip.ClipModel(tvit.VisionTransformer(**VIT), tbert.TextBert(**BERT), siglip=siglip)
    return jm, port


@pytest.mark.parametrize("siglip", [False, True])
def test_clip_model_matches_flax(siglip):
    jm, port = _clip_pair(siglip)
    x, ids = _image(), _tokens()
    variables = _variables(jm, image=jnp.asarray(x), text=jnp.asarray(ids))
    want = jax.jit(jm.apply)(variables, image=jnp.asarray(x), text=jnp.asarray(ids))
    want_logits = jax.jit(lambda v, a, b: jm.apply(v, a, b, method=jm.get_logits))(
        variables, jnp.asarray(x), jnp.asarray(ids))
    _port(port, variables)
    with torch.no_grad():
        got = port(image=torch.from_numpy(x), text=torch.from_numpy(ids))
        got_logits = port.get_logits(torch.from_numpy(x), torch.from_numpy(ids))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), atol=ATOL,
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(np.linalg.norm(got["image_features"].numpy(), axis=-1), 1.0,
                               atol=1e-6)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-5)


def test_vssm_tower_matches_flax():
    kw = dict(depths=(1, 1), dims=(16, 32), num_classes=0)
    jm = jclip.VssmTower(vssm=jvssm.VSSM(**kw, scan_impl="xla"), embed_dim=8)
    x = _image(size=16)
    variables = _variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    port = _port(tclip.VssmTower(tvssm.VSSM(**kw), embed_dim=8), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)  # test_torch_port_vssm's tolerance


def test_l2_normalize_and_constants_match():
    x = np.random.RandomState(3).randn(4, 7).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(tclip.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.l2_normalize(jnp.asarray(x))), atol=1e-7)
    assert tclip.LOGIT_SCALE_MAX == jclip.LOGIT_SCALE_MAX


@pytest.mark.parametrize("gelu", ["auto", "exact", "erf", "tanh"])
def test_resolve_gelu_approx_matches(gelu):
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16)):
        assert tclip.resolve_gelu_approx(gelu, tdt) == jclip.resolve_gelu_approx(gelu, jdt)


def test_gelu_forms_and_build_clip_defaults():
    with pytest.raises(ValueError) as t_err:
        tclip.resolve_gelu_approx("bogus", torch.float32)
    with pytest.raises(ValueError) as j_err:
        jclip.resolve_gelu_approx("bogus", jnp.float32)
    assert str(t_err.value) == str(j_err.value)
    x = torch.linspace(-4, 4, 101)
    assert not torch.equal(tvit.gelu(x, True), tvit.gelu(x, False))
    np.testing.assert_allclose(tvit.gelu(x, True).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True)),
                               atol=1e-6)
    np.testing.assert_allclose(tvit.gelu(x, False).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False)),
                               atol=1e-6)
    # "auto" through build_clip (the VSSM-towered CLIP: its full-width text
    # tower builds in about a second)
    small = dict(image_size=32, context_length=16, vocab_size=128)
    assert tclip.build_clip("medmamba", dtype=torch.bfloat16, **small).text.block0.gelu_approx
    assert not tclip.build_clip("medmamba", **small).text.block0.gelu_approx


@pytest.mark.parametrize("quant", ["int8_delayed_attn", "int8_fast_attn"])
def test_build_clip_refuses_flash_with_int8_attention(quant):
    small = dict(image_size=32, context_length=16, vocab_size=128)
    with pytest.raises(ValueError, match="flash") as t_err:
        tclip.build_clip("biomedclip", quant=quant, attn_flash=True, **small)
    with pytest.raises(ValueError) as j_err:
        jclip.build_clip("biomedclip", quant=quant, attn_flash=True, **small)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(NotImplementedError, match="Quantized modes"):
        tclip.build_clip("biomedclip", quant=quant, **small)


@pytest.mark.parametrize("kw", [dict(attn_int8=True), dict(attn_int8_delayed=True)])
def test_training_and_quant_modes_raise(kw):
    """The int8 interiors raise; the training modes (patch dropout, gradient
    checkpointing, ``attn_remat``) are ported and tested in
    test_torch_port_clip_train_modules.py."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tvit.VisionTransformer(**VIT, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbert.TextBert(**BERT, **kw)


def test_bridge_refuses_left_over_and_missing_leaves():
    jm, port = _clip_pair(siglip=False)
    variables = _variables(jm, image=jnp.asarray(_image()), text=jnp.asarray(_tokens()))
    params = dict(variables["params"])
    text = dict(params["text"])
    type_emb = text.pop("type_emb")
    with pytest.raises(KeyError, match=r"missing \['text.type_emb'\]"):
        load_jax_variables(port, {"params": {**params, "text": text}})
    with pytest.raises(KeyError, match=r"unexpected \['logit_bias'\]"):
        load_jax_variables(port, {"params": {**params, "logit_bias": np.float32(-10.0)}})
    text["type_emb"] = type_emb
    text["tok_emb"] = {"embedding": text["tok_emb"]["embedding"], "table": type_emb}
    with pytest.raises(KeyError, match="unmapped params leaf params/text/tok_emb/table"):
        load_jax_variables(port, {"params": {**params, "text": text}})
