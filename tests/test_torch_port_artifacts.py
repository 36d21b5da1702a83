"""The port's serving artifacts against the JAX package's.

``export_serving``/``load_serving`` and the int8 weight compression
(``compress_params``/``decompress_params``) of ``mamba_clip_tpu_torch/
serving.py`` against ``mamba_clip_tpu/serving.py`` on the same weights:

- full-width BiomedCLIP (ViT-B/16, the 12-layer BERT) at image 32, context
  16, vocab 128, fp32 -- the one full-width case -- and medmamba at image
  32 with random BatchNorm statistics;
- the JAX weights come from JAX's ``make_serving_fns`` with ``model.init``
  replaced by ``jax.eval_shape`` of it and values from a numpy seed (the
  eager init of the CLIP takes ~15 s), carried over by convert.py.

Gates: the compressed tensors map 1:1 onto JAX's, int8 values and scales
equal bit for bit (transposed for Dense kernels); the manifests' shared
keys equal; the loaded entry points equal the port's ``make_serving_fns``
bit for bit and JAX's entry points within 1e-5 (fp32, CPU; JAX's on its
variables, or on ``decompress_params(compress_params(variables))`` for a
compressed artifact); a shipped WordPiece vocabulary tokenizes as JAX's;
the refusals give JAX's messages.
"""

import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mamba_clip_tpu.data import tokenizer as jtok
from mamba_clip_tpu.serving import compress_params as jax_compress_params
from mamba_clip_tpu.serving import decompress_params as jax_decompress_params
from mamba_clip_tpu.serving import export_serving as jax_export_serving
from mamba_clip_tpu.serving import make_serving_fns as jax_make_serving_fns
from mamba_clip_tpu_torch import export_serving as export_cli
from mamba_clip_tpu_torch.checkpoint import save_checkpoint
from mamba_clip_tpu_torch.convert import _convert_value, _key, load_jax_variables
from mamba_clip_tpu_torch.serving import (
    _COMPRESS_KEY, compress_params, decompress_params, export_serving, load_serving,
    make_serving_fns)

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

ATOL = 1e-5
CLIP_KW = dict(is_clip=True, precision="fp32", image_size=32, context_length=16,
               vocab_size=128)
MM_KW = dict(precision="fp32", image_size=32, scan_impl="xla")
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "lesion", "patient",
         "a", "is", "mm", "##s", "of", "on", "torso", "male"]
TEXTS = ["the lesion is on the torso", "patient", "a male patient lesions of 4 mm"]
# the keys the port adds to JAX's manifest, and JAX's that the port has not
PORT_ONLY = {"is_clip", "scan_impl", "format", "params"}


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


def _flat(tree, path=()):
    """{path tuple: leaf} of a nested dict, a compressed leaf as one leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and _COMPRESS_KEY not in v:
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _export_pair(tmp, name, model_name, kw, seed, tokenizer=None):
    """JAX's variables, jitted entry points and export, and the port's
    model, entry points and exports (raw and compressed) of the same
    weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _shaped_init(seed))
        _, jvars, jfns, _ = jax_make_serving_fns(model_name, **kw)
        jvars = jax.tree_util.tree_map(np.asarray, jvars)
        jman = jax_export_serving(str(tmp / f"{name}_jax"), model_name, variables=jvars,
                                  tokenizer=tokenizer, **kw)
    port_kw = {k: v for k, v in kw.items() if k != "scan_impl"}
    model, fns, meta = make_serving_fns(model_name, device="cpu", attn_impl="flash", **port_kw)
    load_jax_variables(model, jvars)
    arts = {}
    for weights, compress in (("raw", False), ("int8_cols", True)):
        out = str(tmp / f"{name}_{weights}")
        man = export_serving(out, model_name, variables=model.state_dict(),
                             tokenizer=tokenizer, compress_weights=compress, **port_kw)
        arts[weights] = (out, man)
    return types.SimpleNamespace(
        jvars=jvars, jfns={k: jax.jit(f) for k, f in jfns.items()}, jman=jman,
        jdir=str(tmp / f"{name}_jax"), model=model, fns=fns, meta=meta, arts=arts)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("artifacts")
    (d / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    yield d
    shutil.rmtree(d, ignore_errors=True)  # about 2.5 GB of artifacts


@pytest.fixture(scope="module")
def clip(work):
    return _export_pair(work, "clip", "biomedclip", CLIP_KW, seed=0,
                        tokenizer=str(work / "vocab.txt"))


@pytest.fixture(scope="module")
def mm(work):
    """medmamba; the stand-in init draws the BatchNorm statistics too, so the
    artifact must carry them."""
    return _export_pair(work, "mm", "medmamba", MM_KW, seed=4)


def _inputs(meta, seed):
    rs = np.random.RandomState(seed)
    s = meta["staging_size"]
    return {"image": rs.randint(0, 256, (3, s, s, 3), np.uint8),
            "tokens": rs.randint(4, 128, (3, 16)).astype(np.int32)}


def _calls(names, meta, seed):
    x = _inputs(meta, seed)
    return [(n, x["tokens"] if n == "text_embed" else x["image"]) for n in names]


@pytest.mark.parametrize("which", ["clip", "mm"])
def test_compress_params_equals_jax(request, which):
    pair = request.getfixturevalue(which)
    want = {p: v for p, v in _flat(jax_compress_params(pair.jvars)["params"]).items()
            if isinstance(v, dict)}
    got = compress_params(pair.model.state_dict(), pair.model)
    keys = {k[: -len(f".{_COMPRESS_KEY}")] for k in got if k.endswith(f".{_COMPRESS_KEY}")}
    assert keys == {_key("params", p) for p in want}
    assert keys  # the Dense kernels (and the CLIP's token table) are there
    for path, d in want.items():
        k = f"{_key('params', path)}.{_COMPRESS_KEY}"
        q, scale = d[_COMPRESS_KEY], d["scale"]
        if path[-1] == "kernel":  # [K, N] per column -> [N, K] per row
            q, scale = q.T, scale.T
        assert got[k].dtype == torch.int8 and got[k + ".proto"].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), q)
        np.testing.assert_array_equal(got[k + ".scale"].numpy(), scale)
    # every other tensor stays as it is
    sd = pair.model.state_dict()
    for k, v in got.items():
        if _COMPRESS_KEY not in k:
            assert torch.equal(v, sd[k]), k
    # the round trip is JAX's, transposed
    back = decompress_params(got)
    jback = _flat(jax_decompress_params(jax_compress_params(pair.jvars))["params"])
    for path, v in jback.items():
        np.testing.assert_array_equal(back[_key("params", path)].numpy(),
                                      _convert_value(path, v))


class _Toy(torch.nn.Module):
    def __init__(self, k_in, n_out, vocab=64, width=32):
        super().__init__()
        self.layer = torch.nn.Linear(k_in, n_out)
        self.tok = torch.nn.Embedding(vocab, width)


def test_compression_roundtrip_lemma_and_threshold():
    """As tests/test_serving.py's lemma: dequantize -> requantize recovers
    the same int8 values and scales; the error is at most half a step;
    tables keep one scale a row; below 1 << 16 elements nothing is touched.
    And each piece equals JAX's on the same arrays."""
    r = np.random.default_rng(0)
    w = (r.normal(size=(256, 96)).astype(np.float32)
         * r.uniform(0.01, 3.0, size=(96,)).astype(np.float32))  # Flax [K, N]
    emb = (r.normal(size=(64, 32)).astype(np.float32)
           * r.uniform(0.01, 3.0, size=(64, 1)).astype(np.float32))
    toy = _Toy(256, 96)
    with torch.no_grad():
        toy.layer.weight.copy_(torch.from_numpy(w.T.copy()))
        toy.layer.bias.zero_()
        toy.tok.weight.copy_(torch.from_numpy(emb))
    comp = compress_params(toy.state_dict(), toy, min_elems=0)
    jcomp = jax_compress_params({"layer": {"kernel": w, "bias": np.zeros(96, np.float32)},
                                 "tok": {"embedding": emb}}, min_elems=0)
    k = f"layer.weight.{_COMPRESS_KEY}"
    assert comp[k].dtype == torch.int8 and comp[k + ".scale"].shape == (96, 1)
    np.testing.assert_array_equal(comp[k].numpy(), jcomp["layer"]["kernel"][_COMPRESS_KEY].T)
    np.testing.assert_array_equal(comp[k + ".scale"].numpy(), jcomp["layer"]["kernel"]["scale"].T)
    assert torch.equal(comp["layer.bias"], toy.layer.bias)

    deq = decompress_params(comp)["layer.weight"]
    assert deq.dtype == torch.float32
    err = (deq - toy.layer.weight.detach()).abs() / comp[k + ".scale"]
    assert float(err.max()) <= 0.5 + 1e-3
    toy.layer.weight.data.copy_(deq)
    again = compress_params(toy.state_dict(), toy, min_elems=0)
    assert torch.equal(again[k], comp[k])
    assert torch.equal(again[k + ".scale"], comp[k + ".scale"])

    e = f"tok.weight.{_COMPRESS_KEY}"
    assert comp[e + ".scale"].shape == (64, 1)  # one scale a token row
    np.testing.assert_array_equal(comp[e].numpy(), jcomp["tok"]["embedding"][_COMPRESS_KEY])
    demb = decompress_params(comp)["tok.weight"].detach()
    assert float(((demb - torch.from_numpy(emb)).abs() / comp[e + ".scale"]).max()) <= 0.5 + 1e-3

    # the default threshold, at its edge: 1 << 16 elements compress, one fewer does not
    assert set(compress_params(toy.state_dict(), toy)) == set(toy.state_dict())
    for n_out, hit in ((256, True), (255, False)):
        big = _Toy(256, n_out)
        got = any(_COMPRESS_KEY in key for key in compress_params(big.state_dict(), big))
        jgot = isinstance(jax_compress_params(
            {"k": {"kernel": np.ones((256, n_out), np.float32)}})["k"]["kernel"], dict)
        assert got == jgot == hit
    # the identity on a raw state dict
    assert decompress_params(toy.state_dict()).keys() == toy.state_dict().keys()


@pytest.mark.parametrize("which", ["clip", "mm"])
def test_manifest_equals_jax(request, which):
    pair = request.getfixturevalue(which)
    jman = pair.jman
    for weights, (out, man) in pair.arts.items():
        with open(os.path.join(out, "manifest.json")) as f:
            assert json.load(f) == man
        assert set(man) - set(jman) == PORT_ONLY and set(jman) <= set(man)
        shared = {k: v for k, v in man.items() if k not in PORT_ONLY | {"entry_points"}}
        assert shared == dict({k: jman[k] for k in shared}, weights=weights)
        assert man["entry_points"] == {
            name: {k: v for k, v in ep.items() if k != "file"}
            for name, ep in jman["entry_points"].items()}
        assert man["format"] == "torch" and man["params"] == "params.pt"
        assert man["is_clip"] == (which == "clip")
    # the CLIP's weights are nearly all large kernels: about 4x smaller, as
    # JAX's test holds; most of medmamba's lie below the threshold
    sizes = {w: os.path.getsize(os.path.join(out, "params.pt"))
             for w, (out, _) in pair.arts.items()}
    assert sizes["int8_cols"] < (0.35 if which == "clip" else 1.0) * sizes["raw"], sizes


@pytest.mark.parametrize("weights", ["raw", "int8_cols"])
@pytest.mark.parametrize("which", ["clip", "mm"])
def test_loaded_entry_points(request, which, weights):
    """Bit for bit the port's make_serving_fns on the stored weights (the
    decompressed ones for int8_cols); within 1e-5 of JAX's entry points on
    JAX's variables, or JAX's own round trip of them. A loaded CLIP runs the
    flash interior in every attention, the kernel's on the card."""
    pair = request.getfixturevalue(which)
    out, man = pair.arts[weights]
    served = load_serving(out, device="cpu")
    assert served["manifest"] == man
    module = next(iter(v for k, v in served.items() if k in man["entry_points"])).args[0]
    interiors = [m.flash_interior for m in module.modules() if hasattr(m, "flash_interior")]
    assert interiors == ([True] * 24 if which == "clip" else []), interiors
    names = sorted(man["entry_points"])
    assert set(served) == set(names) | {"manifest"} | (
        {"tokenize"} if "text_embed" in names else set())
    jvars = pair.jvars
    model = pair.model
    if weights == "int8_cols":
        jvars = jax_decompress_params(jax_compress_params(jvars))
        stored = torch.load(os.path.join(out, "params.pt"), weights_only=True)
        model, _, _ = make_serving_fns(
            man["model"], device="cpu", attn_impl="flash",
            **{k: man[k] for k in ("is_clip", "precision", "image_size", "context_length",
                                   "vocab_size", "num_classes")})
        model.load_state_dict(decompress_params(stored))
    for name, x in _calls(names, pair.meta, seed=1):
        got = served[name](x)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert torch.equal(got, pair.fns[name](model, x)), name
        want = np.asarray(pair.jfns[name](jvars, jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=name)


def test_compressed_clip_stays_close(clip):
    """JAX's bound on a compressed artifact (tests/test_serving.py): the
    embeddings' cosine to the raw artifact's above 0.999."""
    raw = load_serving(clip.arts["raw"][0], device="cpu")
    comp = load_serving(clip.arts["int8_cols"][0], device="cpu")
    for name, x in _calls(("image_embed", "text_embed"), clip.meta, seed=7):
        a, b = raw[name](x), comp[name](x)
        assert not torch.equal(a, b)
        cos = (a * b).sum(-1)
        assert bool((cos > 0.999).all()), (name, cos)


def test_artifact_carries_batch_stats(mm):
    stored = torch.load(os.path.join(mm.arts["raw"][0], "params.pt"), weights_only=True)
    stats = [k for k in stored if k.endswith(("running_mean", "running_var"))]
    assert stats
    sd = mm.model.state_dict()
    for k in stats:
        assert torch.equal(stored[k], sd[k])
    # the loaded module is in eval mode: it reads the statistics
    served = load_serving(mm.arts["raw"][0], device="cpu")
    x = _inputs(mm.meta, 2)["image"]
    assert torch.equal(served["classify"](x), mm.fns["classify"](mm.model, x))


def test_wordpiece_tokenizer_ships(clip):
    """The vocab ships as JAX ships it; the loaded ``tokenize`` gives JAX's
    ids; the hash tokenizer without one."""
    out, man = clip.arts["raw"]
    assert man["tokenizer"] == clip.jman["tokenizer"] == {
        "type": "wordpiece", "dir": "tokenizer", "context_length": 16}
    for fname in ("vocab.txt", "tokenizer_config.json"):
        with open(os.path.join(out, "tokenizer", fname), "rb") as f, \
                open(os.path.join(clip.jdir, "tokenizer", fname), "rb") as g:
            assert f.read() == g.read(), fname
    served = load_serving(out, device="cpu")
    jt = jtok.get_tokenizer(os.path.join(clip.jdir, "tokenizer"), context_length=16,
                            require_real=True)
    ids = served["tokenize"](TEXTS)
    np.testing.assert_array_equal(ids, jt(TEXTS))
    assert ids.shape == (3, 16) and ids.max() < len(WORDS)
    feats = served["text_embed"](ids)
    want = np.asarray(clip.jfns["text_embed"](clip.jvars, jnp.asarray(ids)))
    np.testing.assert_allclose(feats.numpy(), want, atol=ATOL, rtol=0)


def test_refusals_match_jax(tmp_path, mm):
    for quant in ("int8_delayed", "int8_delayed_attn"):
        with pytest.raises(ValueError) as want:
            jax_make_serving_fns("medmamba", quant=quant, **MM_KW)
        with pytest.raises(ValueError) as got:
            export_serving(str(tmp_path / "q"), "medmamba", quant=quant, precision="fp32")
        assert str(got.value) == str(want.value)
    for quant in ("int8", "int8_fwd"):  # the aqt modes export, as int8_serve does
        out = str(tmp_path / f"aqt_{quant}")
        man = export_serving(out, "medmamba", variables=mm.model.state_dict(), quant=quant,
                             **MM_KW)
        assert man["quant"] == quant
        loaded = load_serving(out, device="cpu")
        assert loaded["manifest"]["quant"] == quant
    # a data-sharded export and a sharded manifest load, one replica a device
    man = export_serving(str(tmp_path / "dp"), "medmamba", data_shards=8, precision="fp32")
    assert man["data_shards"] == 8 and man["entry_points"]["classify"]["input_shape"][0] == "8*b"
    assert load_serving(str(tmp_path / "dp"), devices=["cpu"] * 8)["manifest"] == man
    out, _ = mm.arts["raw"]
    shard = tmp_path / "shard"
    shutil.copytree(out, shard)
    man = json.loads((shard / "manifest.json").read_text())
    (shard / "manifest.json").write_text(json.dumps(dict(man, data_shards=2)))
    loaded = load_serving(str(shard), devices=["cpu"] * 2)
    x = _inputs(mm.meta, seed=3)["image"][:2]
    assert torch.equal(loaded["classify"](x), torch.cat(
        [load_serving(out, device="cpu")["classify"](x[i:i + 1]) for i in range(2)]))
    # a JAX artifact, a module that does not match
    with pytest.raises(ValueError, match="StableHLO artifact is read by the JAX"):
        load_serving(mm.jdir, device="cpu")
    sd = dict(mm.model.state_dict())
    sd.pop("head.weight")
    with pytest.raises(RuntimeError, match="head.weight"):
        export_serving(str(tmp_path / "bad"), "medmamba", variables=sd, precision="fp32")
    assert not os.path.exists(tmp_path / "q")


def test_export_cli_from_a_checkpoint(tmp_path, mm, capsys):
    """``python -m mamba_clip_tpu_torch.export_serving --checkpoint``: the
    weights of a checkpoint of the port, compressed, the platforms recorded."""
    state = types.SimpleNamespace(
        model=mm.model, step=0,
        opt_state=types.SimpleNamespace(count=0, mu={}, nu={}))
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), state, 1, name="stage_2_epoch_1")
    out = str(tmp_path / "cli")
    man = export_cli.main([
        "--out", out, "--model", "medmamba", "--checkpoint", ckpt, "--image-size", "32",
        "--precision", "fp32", "--compress-weights", "--platforms", "cuda", "cpu"])
    assert "exported ['classify'] for ['cuda', 'cpu'] to" in capsys.readouterr().out
    assert man["platforms"] == ["cuda", "cpu"] and man["weights"] == "int8_cols"
    served = load_serving(out, device="cpu")
    direct = load_serving(mm.arts["int8_cols"][0], device="cpu")
    x = _inputs(mm.meta, 3)["image"]
    assert torch.equal(served["classify"](x), direct["classify"](x))
