"""The port's CLIP serving slice against the JAX package.

JAX ``make_serving_fns("biomedclip", is_clip=True, precision="fp32",
image_size=32, context_length=16, vocab_size=128)`` -- the full-width
BiomedCLIP towers (ViT-B/16 and the 12-layer BERT, width 768) at a small
image and context -- against the port's on ``device="cpu"``, with the JAX
weights carried over by convert.py. Tolerance: embeddings within atol
1e-5 (unit vectors of 512 entries; fp32 on both sides, 12 blocks of the
per-layer differences test_torch_port_towers.py bounds at 1e-5).

The VSSM-towered CLIP (``medmamba``, ``is_clip=True``) the same way, its
``image_embed`` at atol 1e-4, the tolerance test_torch_port_serving.py
puts on medmamba (its text tower is BiomedCLIP's, held above).

The JAX entry points are JAX's own ``make_serving_fns``; only its
``model.init`` is replaced while it runs, by ``jax.eval_shape`` of the
init and values from a numpy seed (the eager init draws ~170 M random
numbers with threefry, about 15 s on the CPU; the towers' inits are
tested in test_torch_port_towers.py by shape). LayerNorm scales and
BatchNorm variances are drawn around 1, so every mapping of the bridge
carries a value that shows.

The port's BiomedCLIP is built as it is served, with ``attn_impl="flash"``:
on the CPU it gives the einsum answer and launches no kernel. Also:
``text_embed`` through ``MicroBatcher``, and the port's ``HashTokenizer``
against JAX's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mamba_clip_tpu.data import tokenizer as jtok
from mamba_clip_tpu.serving import make_serving_fns as jax_make_serving_fns
from mamba_clip_tpu_torch.convert import load_jax_variables
from mamba_clip_tpu_torch.data import tokenizer as ttok
from mamba_clip_tpu_torch.ops.flash_attn import flash_attn_fwd
from mamba_clip_tpu_torch.ops.selective_scan import selective_scan_fwd
from mamba_clip_tpu_torch.serve import MicroBatcher
from mamba_clip_tpu_torch.serving import make_serving_fns

ATOL = 1e-5
SMALL = dict(precision="fp32", image_size=32, context_length=16, vocab_size=128)
REPORTS = [
    "Dermoscopy of a pigmented lesion on the upper back of a 45 year old male.",
    "Lesion: left forearm, diameter 6.2 mm; border irregular, two colours, "
    "asymmetric. History of melanoma in the family.",
    "Benign-appearing nevus.",
    "Female, 71. Scalp. Ulcerated nodule, 11 mm, rapid growth over 3 months; "
    "atypical network, blue-white veil, regression structures, dotted vessels.",
]


def _shaped_init(seed):
    """A stand-in for ``flax.linen.Module.init``: the variables' shapes from
    ``jax.eval_shape`` of the real init, values from a numpy seed."""
    orig = nn.Module.init
    rs = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 1 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel" else 0.1
        return (std * rs.standard_normal(s.shape, np.float32)).astype(np.float32)

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda: orig(self, rngs, *args, **kw))
        return jax.tree_util.tree_map_with_path(leaf, shapes)

    return init


def _pair(model_name, seed, attn_impl="einsum", **kw):
    """(jax fns, jax variables, port model, port fns, meta, jax meta)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _shaped_init(seed))
        _, jvars, jfns, jmeta = jax_make_serving_fns(model_name, is_clip=True, **SMALL, **kw)
    model, fns, meta = make_serving_fns(model_name, is_clip=True, device="cpu",
                                        attn_impl=attn_impl, **SMALL)
    load_jax_variables(model, jvars)
    return {k: jax.jit(f) for k, f in jfns.items()}, jvars, model, fns, meta, jmeta


@pytest.fixture(scope="module")
def clip_pair():
    """The served configuration, ``attn_impl="flash"``: on the CPU its
    interiors take the plain interior, so JAX's einsum default is its
    reference."""
    return _pair("biomedclip", seed=0, attn_impl="flash")


def _images(n, size, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), np.uint8)


def _tokens(context=16):
    return ttok.HashTokenizer(context_length=context, vocab_size=128)(REPORTS)


def test_clip_embeds_match_jax(clip_pair):
    jfns, jvars, model, fns, meta, jmeta = clip_pair
    assert meta == jmeta
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(jvars))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    imgs = _images(2, meta["staging_size"])
    tokens = _tokens()
    for name, x in (("image_embed", imgs), ("text_embed", tokens)):
        want = np.asarray(jfns[name](jvars, jnp.asarray(x)))
        got = fns[name](model, x)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.shape == (len(x), 512)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)
    assert flash_attn_fwd.launches == 0 and selective_scan_fwd.launches == 0


def test_flash_config_takes_the_plain_interior_on_cpu(clip_pair):
    _, _, model, fns, meta, _ = clip_pair
    attns = [m for n, m in model.named_modules() if n.endswith(".attn")]
    assert len(attns) == 24 and all(m.flash_interior for m in attns)
    imgs, tokens = _images(2, meta["staging_size"], seed=3), _tokens()
    flash = {name: fns[name](model, x) for name, x in (("image_embed", imgs),
                                                        ("text_embed", tokens))}
    try:  # the same weights through the einsum interior
        for m in attns:
            m.flash_interior = False
        for name, x in (("image_embed", imgs), ("text_embed", tokens)):
            assert torch.equal(flash[name], fns[name](model, x)), name
    finally:
        for m in attns:
            m.flash_interior = True
    assert flash_attn_fwd.launches == 0


def test_text_embed_through_microbatcher(clip_pair):
    _, _, model, fns, _, _ = clip_pair
    tokens = _tokens()
    direct = fns["text_embed"](model, tokens).numpy()
    results = [None] * len(tokens)
    with MicroBatcher(lambda x: fns["text_embed"](model, x), max_batch=16,
                      max_delay_ms=200.0) as mb:
        barrier = threading.Barrier(len(tokens))

        def client(i):
            barrier.wait(timeout=30)
            results[i] = mb(tokens[i:i + 1])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(tokens))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert mb.requests == len(tokens)
    for i in range(len(tokens)):
        assert results[i].shape == (1, 512)
        np.testing.assert_allclose(results[i][0], direct[i], atol=1e-5, rtol=0)


def test_vssm_towered_clip_matches_jax():
    jfns, jvars, model, fns, meta, jmeta = _pair("medmamba", seed=1, scan_impl="xla")
    assert meta == jmeta
    # the default attn_impl is JAX's: einsum
    assert not any(m.flash_interior for n, m in model.named_modules() if n.endswith(".attn"))
    imgs = _images(2, meta["staging_size"], seed=5)
    want = np.asarray(jfns["image_embed"](jvars, jnp.asarray(imgs)))
    np.testing.assert_allclose(fns["image_embed"](model, imgs).numpy(), want, atol=1e-4,
                               rtol=0)
    assert flash_attn_fwd.launches == 0 and selective_scan_fwd.launches == 0


@pytest.mark.parametrize("context", [16, 77, 256])
def test_hash_tokenizer_matches_jax(context):
    texts = REPORTS + ["", "ÄÖÜ ß — 3.5mm!", " ".join(REPORTS * 8)]
    want = jtok.HashTokenizer(context_length=context)(texts)
    got = ttok.HashTokenizer(context_length=context)(texts)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    one = ttok.HashTokenizer(context_length=context)
    assert [one.count_tokens(t) for t in texts] == [
        jtok.HashTokenizer().count_tokens(t) for t in texts]
    np.testing.assert_array_equal(one(texts[1]), want[1:2])


def test_tokenizer_overflow_and_factory(tmp_path):
    long = " ".join(REPORTS * 8)
    tok, jt = ttok.HashTokenizer(context_length=32), jtok.HashTokenizer(context_length=32)
    tok.on_overflow = jt.on_overflow = "error"
    with pytest.raises(ValueError) as t_err:
        tok([long])
    with pytest.raises(ValueError) as j_err:
        jt([long])
    assert str(t_err.value) == str(j_err.value)
    assert isinstance(ttok.get_tokenizer("hash", 64), ttok.HashTokenizer)
    assert ttok.get_tokenizer("hf-hub:microsoft/BiomedCLIP", 64).context_length == 64
    with pytest.raises(RuntimeError, match="not a local path"):
        ttok.get_tokenizer("hf-hub:microsoft/BiomedCLIP", require_real=True)
    # a local vocabulary would take the HF tokenizer, which is not ported
    assert isinstance(ttok.get_tokenizer(str(tmp_path)), ttok.HashTokenizer)
    with pytest.raises(RuntimeError, match="not ported"):
        ttok.get_tokenizer(str(tmp_path), require_real=True)
