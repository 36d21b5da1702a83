"""The port's CLI, ``python -m mamba_clip_tpu_torch.cli.main``, driven on the
CPU (``--device cpu``) at a tiny width, beside the JAX package's
``pipeline``.

``build_clip`` and ``get_tokenizer`` are replaced in each package's
pipeline module by a tiny CLIP (ViT: image 32, patch 16, width 32, depth 1;
BERT: vocab 512, context 32; embed 16) and the hash tokenizer at that
context, as ``tests/test_e2e.py`` does on the JAX side. The two packages
draw different initial weights, so a run is not held number for number
(``tests/test_torch_port_pipeline.py`` holds its pieces); held here:

- stage 1, then stage 2 finding it without ``--name``, then ``--resume
  latest`` of the finished stage-2 run, which evaluates the restored state
  and trains nothing; ``params.txt`` byte for byte with JAX's ``Args``;
  ``results.jsonl`` rows with the JAX package's keys;
- the schedule horizon under ``--accum-freq`` (``tests/test_e2e.py``);
- the error probes (a missing ``--data-path`` file among them), type and
  message equal to JAX's ``pipeline``;
- each flag whose feature is not ported fails first, naming its item;
- no card and ``--device auto``/``cuda``: an error, not a fall-back;
- ``--is-test`` on ``--synthetic-data``: the outcome of JAX's ``pipeline``.
"""

import contextlib
import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from mamba_clip_tpu import config as jcfg
from mamba_clip_tpu import pipeline as jpipe
from mamba_clip_tpu.config import RunState as JRunState
from mamba_clip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from mamba_clip_tpu_torch import pipeline as tpipe
from mamba_clip_tpu_torch.cli.main import main
from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

STAGE1_KEYS = {"val_loss", "epoch", "num_samples"}
STAGE2_KEYS = STAGE1_KEYS | {"partial_auc"}


@pytest.fixture()
def tiny(monkeypatch):
    from mamba_clip_tpu.models.clip import ClipModel as JClip
    from mamba_clip_tpu.models.text_bert import TextBert as JBert
    from mamba_clip_tpu.models.vit import VisionTransformer as JViT
    from mamba_clip_tpu_torch.models.clip import ClipModel
    from mamba_clip_tpu_torch.models.text_bert import TextBert
    from mamba_clip_tpu_torch.models.vit import VisionTransformer

    vit = dict(image_size=32, patch_size=16, width=32, depth=1, num_heads=2, embed_dim=16)
    bert = dict(vocab_size=512, context_length=32, width=32, depth=1, num_heads=2, embed_dim=16)

    def port_small(generator=None, attn_flash=False, **kw):
        return ClipModel(VisionTransformer(**vit, attn_flash=attn_flash, generator=generator),
                         TextBert(**bert, attn_flash=attn_flash, generator=generator))

    def jax_small(**kw):
        return JClip(visual=JViT(**vit, name="visual"), text=JBert(**bert, name="text"))

    monkeypatch.setattr(tpipe, "build_clip", port_small)
    monkeypatch.setattr(tpipe, "get_tokenizer",
                        lambda name, context_length=32, **kw: HashTokenizer(32, 512))
    monkeypatch.setattr(jpipe, "build_clip", jax_small)
    monkeypatch.setattr(jpipe, "get_tokenizer",
                        lambda name, context_length=32, **kw: JaxHashTokenizer(32, 512))


def _argv(logs, *extra, device="cpu", synthetic=True):
    argv = ["--model-stage-1", "tiny", "--batch-size", "8", "--epochs", "1",
            "--train-num-samples", "32", "--val-num-samples", "16", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--logs", str(logs), "--workers", "1",
            "--log-every-n-steps", "10", "--force-image-size", "32", "--save-most-recent",
            "--num-classes", "2"]
    if synthetic:
        argv.append("--synthetic-data")
    if device is not None:
        argv += ["--device", device]
    return argv + list(extra)


@contextlib.contextmanager
def _log_lines(root="mamba_clip_tpu_torch"):
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = Grab()
    logging.getLogger(root).addHandler(h)
    try:
        yield lines
    finally:
        logging.getLogger(root).removeHandler(h)


def _rows(run_dir):
    with open(os.path.join(run_dir, "checkpoints", "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _params(run_dir, name):
    return torch.load(os.path.join(run_dir, "checkpoints", name, "state.pt"),
                      weights_only=True)["params"]


def test_two_stages_then_a_resume_through_the_cli(tiny, tmp_path, monkeypatch):
    # names are minted to the second; these runs take less than one
    stamps = iter(["2026_01_01-00_00_01", "2026_01_01-00_00_02"])
    monkeypatch.setattr(time, "strftime", lambda fmt: next(stamps))
    argv1 = _argv(tmp_path, "--stage", "1", "--attn-impl", "flash")
    m1 = main(argv1)
    (s1,) = os.listdir(tmp_path)
    assert s1 == "2026_01_01-00_00_01-model_tiny-lr_0.001-b_8-j_1-p_fp32"
    run1 = os.path.join(tmp_path, s1)
    assert sorted(os.listdir(os.path.join(run1, "checkpoints"))) == [
        "results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]
    assert _rows(run1) == [m1] and set(m1) == STAGE1_KEYS and np.isfinite(m1["val_loss"])
    # params.txt: the flags as the pipeline resolved them, JAX's bytes
    jax_txt = tmp_path.parent / f"{tmp_path.name}-jax-params.txt"
    jcfg.parse_args(argv1).replace(model="tiny").dump(str(jax_txt))
    assert open(os.path.join(run1, "params.txt"), "rb").read() == jax_txt.read_bytes()

    # stage 2 finds the stage-1 run by itself
    with _log_lines() as lines:
        m2 = main(_argv(tmp_path, "--stage", "2"))
    want = os.path.join(str(tmp_path), s1, "checkpoints", "stage_1_epoch_latest")
    assert f"Loaded stage-1 weights from {want}" in lines
    (s2,) = set(os.listdir(tmp_path)) - {s1}
    run2 = os.path.join(tmp_path, s2)
    assert set(m2) == STAGE2_KEYS and 0.0 <= m2["partial_auc"] <= 0.2
    p1, p2 = _params(run1, "stage_1_epoch_latest"), _params(run2, "stage_2_epoch_latest")
    assert all(torch.equal(p2[f"clip.{k}"], v) for k, v in p1.items())

    # the finished stage-2 run resumed: it evaluates the restored state and trains nothing
    trained = []
    monkeypatch.setattr(tpipe, "train_one_epoch", lambda *a, **k: trained.append(1))
    with _log_lines() as lines:
        m3 = main(_argv(tmp_path, "--stage", "2", "--name", s2, "--resume", "latest"))
    assert trained == [] and m3 == m2
    assert f"Resuming from latest checkpoint: {os.path.join(run2, 'checkpoints', 'stage_2_epoch_1')}" \
        in lines
    assert _rows(run2) == [m2, m3]


def test_accum_freq_keeps_the_schedule_horizon(tiny, tmp_path, monkeypatch):
    seen = {}
    orig = tpipe.create_schedule

    def spy(args, total_steps):
        seen["total"] = total_steps
        return orig(args, total_steps)

    monkeypatch.setattr(tpipe, "create_schedule", spy)
    m = main(_argv(tmp_path, "--stage", "1", "--accum-freq", "2", "--name", "accum"))
    assert np.isfinite(m["val_loss"])
    # 32 samples / batch 8 = 4 optimizer steps, not divided by --accum-freq
    assert seen["total"] == 4


PROBES = {
    "precision_bogus": ("--stage", "1", "--precision", "bogus"),
    "reused_name": ("--stage", "1", "--name", "taken"),
    "stage2_nothing_to_start_from": ("--stage", "2", "--resume", "latest", "--name", "orphan"),
    "missing_data_path": ("--stage", "1", "--data-path", "/nowhere/"),
}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_error_probes_say_what_jax_says(tiny, tmp_path, probe):
    os.makedirs(tmp_path / "taken" / "checkpoints")
    argv = _argv(tmp_path, *PROBES[probe], synthetic="--data-path" not in PROBES[probe])
    with pytest.raises(Exception) as j_err:
        jpipe.pipeline(jcfg.parse_args(argv))
    with pytest.raises(Exception) as t_err:
        main(argv)
    assert type(t_err.value) is type(j_err.value)
    assert str(t_err.value) == str(j_err.value)
    assert {"precision_bogus": "unknown precision 'bogus'",
            "reused_name": "Experiment taken already exists",
            "stage2_nothing_to_start_from": "stage 2 has nothing to start from",
            "missing_data_path": "No such file or directory: '/nowhere/train-metadata.csv'",
            }[probe] in str(t_err.value)


def test_resume_latest_in_an_empty_logs_dir_starts_fresh(tiny, tmp_path):
    with _log_lines("mamba_clip_tpu") as want:
        jpipe.setup_train(jcfg.Args(resume="latest"),
                          JRunState(checkpoint_path=str(tmp_path / "none")))
    with _log_lines() as lines:
        m = main(_argv(tmp_path, "--stage", "1", "--resume", "latest", "--name", "fresh"))
    assert want == ["No latest checkpoint found; starting fresh."]
    assert want[0] in lines and np.isfinite(m["val_loss"])
    assert _rows(os.path.join(tmp_path, "fresh")) == [m]


UNPORTED = {
    "quant": (["--quant", "int8"], 7),
    "precision_bf16": (["--precision", "bf16"], 11),
    "precision_pure_bf16": (["--precision", "pure_bf16"], 11),
    "precision_pure_fp16": (["--precision", "pure_fp16"], 11),
    "mesh_fsdp": (["--mesh-fsdp", "2"], 8),
    "mesh_model": (["--mesh-model", "2"], 8),
    "local_loss": (["--local-loss"], 8),
    "remote_sync": (["--remote-sync", "/nowhere"], 9),
    "report_to_wandb": (["--report-to", "tensorboard,wandb"], 9),
    "hyperparameter_tuning": (["--hyperparameter-tuning"], 9),
}


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_an_unported_flag_fails_first_naming_its_item(tmp_path, flag):
    extra, item = UNPORTED[flag]
    argv = _argv(tmp_path, "--stage", "1", *extra)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue 1, item {item} "):
        main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("device", ["auto", "cuda", None])
def test_no_card_is_an_error_not_a_fall_back(tiny, tmp_path, monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        main(_argv(tmp_path, "--stage", "1", device=device))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("stage", ["1", "2"])
def test_is_test_on_synthetic_data_does_what_jax_does(tiny, tmp_path, stage):
    def outcome(run, logs):
        try:
            return "returned", run(_argv(logs, "--stage", stage, "--is-test", "--name", "t"))
        except Exception as e:  # the outcome compared, whatever it is
            return type(e), str(e).replace(str(logs), "<logs>")

    want = outcome(lambda a: jpipe.pipeline(jcfg.parse_args(a)), tmp_path / "jax")
    got = outcome(main, tmp_path / "port")
    assert got == want
