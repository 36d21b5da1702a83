"""The port's tools against the JAX package's (``tools/``), on the CPU.

- ``measure_report_tokens``: the statistics at 50 rows and 2 draws equal the
  JAX tool's, key for key (host numpy on both sides).
- ``parity_harness``: ``run(steps=10)`` and ``run_stage2(epochs=1)`` pass
  their gates, so do ``main`` and ``main --stage2 --epochs 1``; the port's
  stack ("ours") gives JAX's optax losses within 1e-5 on the same numpy
  init and data, in both modes; ``run_quant_stage1`` at the JAX test's mini
  scale (12 steps, 256 + 384 samples, one head epoch) from JAX's initial
  parameters carried over by ``convert.py``, under the JAX test's gates;
  the tiny CLIP's stage-2 features from those parameters within 1e-5 of
  JAX's ``_embed_pairs``.
- ``quant_parity.run``: fp32 and ``int8_fast`` at 3 steps from JAX's
  initial parameters, at a fixed crop (scale and ratio 1, no flip or
  erasing) on both sides: the losses within rel 1e-5 (fp32) and within the
  quant tests' 2e-3 (``int8_fast``: a flipped int8 rounding's envelope,
  ``tests/test_torch_port_quant_modes.py``) of JAX's ``run``. Small towers
  (ViT and BERT of width 32, depth 2) stand in for the full-width ones on
  both sides.
- ``flash_sweep`` at B 2, h 2, T 16, hd 8: the einsum and the plain flash
  paths give the same loss and gradients within 1e-5 in fp32; asking for the
  flash kernel on the CPU raises; the tile label is read from the sources.
- ``benchmark_e2e``: ``build_dataset`` writes the HDF5 layout byte for
  byte as JAX's (the CSV and every JPEG blob) and the JPEG layout with the
  same JPEGs, which ``get_metadata`` and ``IsicChallengeDataset`` read row
  for row; ``--layout hdf5`` without h5py raises, naming it and ``--layout
  jpeg``; the log parser reads the two epochs' rates out of a real CLI run
  (small towers, ``--cache-staging``, the JPEG layout).
- Each tool's entry takes the card by default and fails, naming
  ``--device cpu``, where there is none.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.ops import quant as jquant
from mamba_clip_tpu_torch import (benchmark_e2e, flash_sweep, measure_report_tokens,
                                  parity_harness, quant_parity)
from mamba_clip_tpu_torch.convert import state_dict_from_jax
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.ops import quant as tquant

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import measure_report_tokens as jax_report_tokens  # noqa: E402  (tools/)
import parity_harness as jax_parity  # noqa: E402
import quant_parity as jax_quant_parity  # noqa: E402

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
SMALL_VIT = dict(patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
SMALL_BERT = dict(width=32, depth=2, num_heads=4, embed_dim=16)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_report_tokens_equal_jax(tmp_path, monkeypatch):
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["measure_report_tokens.py", "--rows", "50", "--draws",
                                      "2", "--out", str(out)])
    jax_report_tokens.main()
    want = json.loads(out.read_text())
    got = measure_report_tokens.main(["--rows", "50", "--draws", "2"])
    assert got == want
    assert not list(tmp_path.glob("*.json"))[1:]  # the port wrote no file of its own


def _mlp_stream(steps, seed=0):
    """``run``'s init and batches, drawn as both tools draw them."""
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, 0.05, (64, 32)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (32, 2)).astype(np.float32)
    xs = rng.normal(0, 1, (steps, 16, 64)).astype(np.float32)
    ys = rng.integers(0, 2, (steps, 16))
    return (w1, np.zeros(32, np.float32), w2, np.zeros(2, np.float32)), xs, ys


def test_parity_harness_modes_pass_and_track_jax():
    r = parity_harness.run(steps=10, device="cpu")
    assert r["max_loss_dev"] < 1e-4 and r["final_w1_dev"] < 1e-3
    s = parity_harness.run_stage2(epochs=1, device="cpu")
    assert s["max_loss_dev"] < 1e-3 and s["pauc_dev"] < 1e-4
    assert 0.0 <= s["pauc_ours"] <= 0.2
    assert parity_harness.main(["--device", "cpu"]) == 0
    assert parity_harness.main(["--stage2", "--epochs", "1", "--device", "cpu"]) == 0

    # the port's stack against JAX's optax stack on the same init and data
    init, xs, ys = _mlp_stream(10)
    kw = dict(lr=1e-3, wd=0.05, warmup=5, cw=np.array([0.6, 3.2], np.float32))
    jours, _, jparams, _ = jax_parity._train_both(*init, xs, ys, **kw)
    ours, _, params, _ = parity_harness._train_both(*init, xs, ys, device="cpu", **kw)
    np.testing.assert_allclose(ours, jours, rtol=0, atol=1e-5)
    np.testing.assert_allclose(params["w1"], np.asarray(jparams["w1"]), rtol=0, atol=1e-5)
    want = jax_parity.run_stage2(epochs=1)
    assert abs(s["ours_final_loss"] - want["ours_final_loss"]) <= 1e-5
    assert abs(s["pauc_ours"] - want["pauc_ours"]) <= 1e-4


@pytest.fixture(scope="module")
def jax_tiny_init():
    """JAX's ``_tiny_clip`` initialization at seed 0 (its Flax parameters,
    and as the port's state dicts: the parameters, the ``int8_delayed``
    scales)."""
    args = dict(image=jnp.zeros((2, 32, 32, 3)), text=jnp.ones((2, 16), jnp.int32))
    v = jax_parity._tiny_clip(None, jnp.float32).init({"params": jax.random.PRNGKey(0)}, **args)
    vq = jax_parity._tiny_clip("int8_delayed", jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, **args)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return (params, state_dict_from_jax({"params": params}),
            state_dict_from_jax({"quant": jax.tree_util.tree_map(np.asarray, vq["quant"])}))


def test_quant_stage1_runs_from_jax_init(jax_tiny_init):
    rng = np.random.default_rng(3)
    imgs, toks, _, _, _ = parity_harness._synth_isic(rng, 40)
    jimgs, jtoks, _, _, _ = jax_parity._synth_isic(np.random.default_rng(3), 40)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(toks, jtoks)
    jparams, params, _ = jax_tiny_init
    np.testing.assert_allclose(parity_harness._embed_pairs(params, imgs, toks, "cpu"),
                               jax_parity._embed_pairs(jparams, imgs, toks), rtol=0, atol=1e-5)

    r = parity_harness.run_quant_stage1(
        steps=12, n_train=256, n_s2=384, head_epochs=1, seed_jitter=False, device="cpu",
        init=lambda s: jax_tiny_init[1:])
    assert set(r["modes"]) == {"fp32", "amp", "int8_delayed"}
    for mode, rec in r["modes"].items():
        assert np.isfinite(rec["stage1_first_loss"]) and np.isfinite(rec["pauc"]), mode
        assert rec["stage1_final_loss"] < rec["stage1_first_loss"], mode
        assert 0.0 <= rec["pauc"] <= 0.2, mode
    assert r["dev_amp"] >= 0.0 and r["dev_int8_delayed"] >= 0.0


def _jax_small(model_name="biomedclip", image_size=32, context_length=16, vocab_size=64,
               quant=None, **kw):
    q = dict(dot_general_cls=jquant.make_dot_general_cls(quant),
             attn_int8=jquant.attn_int8(quant), attn_int8_delayed=jquant.attn_int8_delayed(quant))
    return jclip.ClipModel(
        visual=jvit.VisionTransformer(image_size=image_size, **SMALL_VIT, **q),
        text=jbert.TextBert(vocab_size=vocab_size, context_length=context_length,
                            **SMALL_BERT, **q))


def _port_small(model_name="biomedclip", image_size=32, context_length=16, vocab_size=64,
                quant=None, generator=None, **kw):
    q = dict(dot_general_cls=tquant.make_dot_general_cls(quant),
             attn_int8=tquant.attn_int8(quant), attn_int8_delayed=tquant.attn_int8_delayed(quant),
             generator=generator)
    return tclip.ClipModel(
        tvit.VisionTransformer(image_size=image_size, **SMALL_VIT, **q),
        tbert.TextBert(vocab_size=vocab_size, context_length=context_length, **SMALL_BERT, **q))


def _fixed_crop(get_transform_config):
    def wrapped(aug_cfg, image_size=224, is_train=False, **kw):
        return get_transform_config(AUG if is_train else aug_cfg, image_size, is_train, **kw)
    return wrapped


@pytest.mark.parametrize("quant,rel", [(None, 1e-5), ("int8_fast", 2e-3)])
def test_quant_parity_run_tracks_jax(quant, rel, monkeypatch):
    import mamba_clip_tpu.data.preprocess_cfg as jcfg
    import mamba_clip_tpu.models as jmodels

    monkeypatch.setattr(jmodels, "build_clip", _jax_small)
    monkeypatch.setattr(jcfg, "get_transform_config", _fixed_crop(jcfg.get_transform_config))
    monkeypatch.setattr(quant_parity, "build_clip", _port_small)
    monkeypatch.setattr(quant_parity, "get_transform_config",
                        _fixed_crop(quant_parity.get_transform_config))
    # the init JAX's run makes: the same module, key and inputs
    v = _jax_small(quant=quant).init({"params": jax.random.PRNGKey(0)},
                                     image=jnp.zeros((2, 32, 32, 3)),
                                     text=jnp.ones((2, 16), jnp.int32))
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, dict(v)))
    want = jax_quant_parity.run(quant, 3)
    got = quant_parity.run(quant, 3, device="cpu", state_dict=state)
    assert len(got) == 3 and all(np.isfinite(got))
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= rel, (quant, i, got, want)


def test_flash_sweep_paths_agree_on_the_cpu():
    q, k, v, w = flash_sweep.inputs((2, 2, 16, 8), torch.float32, "cpu")
    ref = flash_sweep.fwd_bwd("einsum", q, k, v, w)
    got = flash_sweep.fwd_bwd("flash", q, k, v, w)
    for name, g, p in zip(("o", "loss", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    sdpa = flash_sweep.fwd_bwd("sdpa", q, k, v, w)
    np.testing.assert_allclose(sdpa[1].numpy(), ref[1].numpy(), rtol=1e-5)
    with pytest.raises(ValueError):
        flash_sweep.fwd_bwd("flash", q, k, v, w, impl="cuda")
    q, k, v, w = flash_sweep.inputs((2, 2, 16, 64), torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_sweep.fwd_bwd("flash", q, k, v, w, impl="cuda")
    assert flash_sweep.tile_label(64) == "tiles fwd 64x64, bwd 64x64"
    assert flash_sweep.tile_label(128) == "tiles fwd 64x32, bwd 64x32"
    r = flash_sweep.sweep("cpu", shape=(2, 2, 16, 8), dtype=torch.float32, iters=1)
    assert all(r[f"{p}_ms"] > 0 for p in flash_sweep.PATHS)


@pytest.mark.parametrize("tool,argv", [
    (flash_sweep, []), (parity_harness, []), (quant_parity, []),
    (benchmark_e2e, ["--layout", "jpeg"])])
def test_each_tool_takes_the_card_by_default(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(argv)


def test_e2e_dataset_layouts_read_row_for_row(tmp_path):
    import h5py
    from benchmark_e2e import build_dataset as jax_build_dataset

    from mamba_clip_tpu_torch.config import Args
    from mamba_clip_tpu_torch.data.dataset import IsicChallengeDataset
    from mamba_clip_tpu_torch.data.metadata import get_metadata
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer

    roots = {name: str(tmp_path / name) for name in ("jax", "hdf5", "jpeg")}
    jax_build_dataset(roots["jax"], 20, 64)
    benchmark_e2e.build_dataset(roots["hdf5"], 20, 64, layout="hdf5")
    benchmark_e2e.build_dataset(roots["jpeg"], 20, 64, layout="jpeg")
    csv = {k: open(os.path.join(r, "train-metadata.csv"), "rb").read() for k, r in roots.items()}
    assert csv["hdf5"] == csv["jax"] == csv["jpeg"]
    with h5py.File(os.path.join(roots["jax"], "train-image.hdf5")) as fj, \
            h5py.File(os.path.join(roots["hdf5"], "train-image.hdf5")) as fp:
        assert sorted(fj) == sorted(fp)
        for key in fj:
            blob = bytes(fp[key][()])
            assert blob == bytes(fj[key][()])
            with open(os.path.join(roots["jpeg"], "train-image", "image", f"{key}.jpg"),
                      "rb") as f:
                assert f.read() == blob

    tok = HashTokenizer(16)
    splits = {}
    for layout, data in (("hdf5", os.path.join(roots["hdf5"], "train-image.hdf5")),
                         ("jpeg", os.path.join(roots["jpeg"], "train-image", "image"))):
        train, val, _ = get_metadata(Args(data_path=roots[layout]))
        splits[layout] = [list(t["isic_id"]) for t in (train, val)]
        ds = IsicChallengeDataset(data, train, tokenizer=tok, staging_size=32)
        splits[layout].append([ds[i] for i in range(len(ds))])
        ds.close()
    assert splits["hdf5"][:2] == splits["jpeg"][:2] and len(splits["jpeg"][0]) == 17
    for a, b in zip(splits["hdf5"][2], splits["jpeg"][2]):
        assert a["image"].shape == (32, 32, 3) and a["image"].dtype == np.uint8
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_e2e_hdf5_without_h5py_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py.*--layout jpeg"):
        benchmark_e2e.build_dataset(str(tmp_path / "d"), 4, 32, layout="hdf5")
    assert not (tmp_path / "d").exists()


def test_e2e_log_parser_reads_a_port_cli_run(tmp_path, monkeypatch):
    import logging

    from mamba_clip_tpu_torch import pipeline as tpipe
    from mamba_clip_tpu_torch.cli.main import main as cli_main
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer

    monkeypatch.setattr(tpipe, "build_clip", lambda generator=None, **kw: tclip.ClipModel(
        tvit.VisionTransformer(image_size=32, patch_size=16, width=32, depth=1, num_heads=2,
                               embed_dim=16, generator=generator),
        tbert.TextBert(vocab_size=512, context_length=32, width=32, depth=1, num_heads=2,
                       embed_dim=16, generator=generator)))
    monkeypatch.setattr(tpipe, "get_tokenizer",
                        lambda name, context_length=32, **kw: HashTokenizer(32, 512))
    data = str(tmp_path / "data")
    benchmark_e2e.build_dataset(data, 40, 48, layout="jpeg")
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab()
    logging.getLogger("mamba_clip_tpu_torch").addHandler(grab)
    try:
        cli_main(["--data-path", data, "--cache-staging", str(tmp_path / "staging"),
                  "--batch-size", "8", "--epochs", "2", "--warmup", "2", "--lr", "1e-4",
                  "--precision", "fp32", "--stage", "1", "--logs", str(tmp_path / "logs"),
                  "--workers", "1", "--log-every-n-steps", "1", "--force-image-size", "32",
                  "--model-stage-1", "tiny", "--device", "cpu"])
    finally:
        logging.getLogger("mamba_clip_tpu_torch").removeHandler(grab)
    rates = benchmark_e2e.parse_rates("\n".join(lines))
    assert len(rates[0]) == len(rates[1]) == 4  # 33 train rows, batch 8
    for epoch in (0, 1):
        rate = benchmark_e2e.steady(rates[epoch])
        assert np.isfinite(rate) and rate > 0, (epoch, rates)
    assert benchmark_e2e.steady([1.0, 2.0, 9.0, 4.0, 5.0]) == 5.0  # the first two dropped
