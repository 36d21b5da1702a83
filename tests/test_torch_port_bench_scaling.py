"""The port's scaling bench (``bench_scaling.py``) against JAX's
``tools/bench_scaling.py``, on the CPU.

- ``mesh_ladder(n)`` equals the JAX tool's for n = 1 ... 16 (the tool is
  loaded from its path and only read: its functions import JAX inside);
- one run of ``main`` over gloo ranks (``--platform cpu --devices 2``, the
  tiny CLIP, 1 warm-up and 1 timed step) writes the JAX tool's JSON keys
  (``tools/bench_scaling.py:243-250``, ``:267-282``), and its (2, 1, 1)
  rung's collectives are exactly the step's, each named below with its
  bytes: the gradients' all-reduce (one flat fp32 call over every
  trainable parameter), the loss's mean over the ranks, and the backward of
  the two gathered feature matrices (an all-reduce each), beside the
  forward's two all-gathers of the features. The (1, 1, 1) rung issues none.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_clip_tpu_torch import bench_scaling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the JAX tool's keys: its result (:267-282) and a rung's row (:243-250, :253-265)
JAX_KEYS = {"platform", "model", "batch_per_device", "image_size", "precision", "steps",
            "rows", "note"}
JAX_ROW_KEYS = {"mesh", "devices", "global_batch", "step_ms", "img_per_s", "loss",
                "collectives", "weak_scaling_efficiency", "work_normalized_efficiency"}
# what the port adds: the device's name, and every rank's ms a step
PORT_KEYS, PORT_ROW_KEYS = {"device"}, {"step_ms_ranks"}
WORLD, BATCH, EMBED = 2, 4, 64   # --devices 2, the default --batch-per-device, the towers' embed


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bench_scaling",
                                                  ROOT / "tools" / "bench_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_ladder_matches_jax(n):
    assert bench_scaling.mesh_ladder(n) == _jax_tool().mesh_ladder(n)


def _trainable_fp32_bytes() -> int:
    """The tiny CLIP's trainable parameters, in fp32 (``--precision fp32``)."""
    from mamba_clip_tpu_torch.models.clip import ClipModel
    from mamba_clip_tpu_torch.models.text_bert import TextBert
    from mamba_clip_tpu_torch.models.vit import VisionTransformer

    model = ClipModel(
        visual=VisionTransformer(image_size=32, patch_size=16, width=64, depth=2, num_heads=2,
                                 embed_dim=EMBED),
        text=TextBert(vocab_size=512, context_length=32, width=64, depth=2, num_heads=2,
                      embed_dim=EMBED))
    return sum(p.numel() * 4 for p in model.parameters() if p.requires_grad)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench_scaling") / "out.json"
    out = bench_scaling.main(["--platform", "cpu", "--devices", str(WORLD), "--model", "tiny",
                              "--steps", "1", "--warmup", "1", "--timeout", "240",
                              "--json", str(path)])
    return out, json.loads(path.read_text())


def test_main_writes_jax_keys(run):
    out, written = run
    assert written == json.loads(json.dumps(out))
    assert set(written) == JAX_KEYS | PORT_KEYS
    assert written["platform"] == "cpu" and written["model"] == "tiny"
    assert [tuple(r["mesh"].values()) for r in written["rows"]] == [(1, 1, 1), (2, 1, 1)]
    for r in written["rows"]:
        assert set(r) == JAX_ROW_KEYS | PORT_ROW_KEYS
        assert np.isfinite(r["loss"]) and r["step_ms"] > 0
        assert r["global_batch"] == BATCH * r["devices"]
    assert written["rows"][0]["weak_scaling_efficiency"] == 1.0


def test_data_rung_collectives(run):
    rows = run[0]["rows"]
    assert rows[0]["collectives"] == {}
    features = WORLD * BATCH * EMBED * 4          # one gathered feature matrix, fp32
    all_reduce = {
        "gradients (one flat fp32 call)": _trainable_fp32_bytes(),
        "the loss's mean over the ranks": 4,
        "the image features' gather, backward": features,
        "the text features' gather, backward": features,
    }
    assert rows[1]["collectives"] == {
        "all-reduce": {"count": len(all_reduce), "bytes": sum(all_reduce.values())},
        "all-gather": {"count": 2, "bytes": 2 * features},
    }
