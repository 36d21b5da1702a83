"""The port's epoch loop (``train_one_epoch``, ``pipeline.step``) on the
CPU, against the JAX package's ``train_one_epoch`` and against itself.

A small CLIP (ViT: image 32, patch 16, width 32, depth 2, 4 heads; BERT:
vocab 128, context 16; embed 16) initialized by Flax and carried over by
``convert.py``; the data is ``SyntheticIsicDataset`` (32 samples, batch 8:
4 batches) through each package's own ``get_data``, which give the same
batches (``tests/test_torch_port_data.py``); the crop is deterministic.

Tolerances:
- 4 batches of ``train_one_epoch`` against JAX's at lr 2e-4: every
  parameter at atol 1e-5 after the epoch (fp32; GEMM and reduction order
  differ; at lr 1e-3 one entry of 24,576 in the patch embedding was 1.6e-5
  off), and the log lines carry the same fields in the same order;
- a run interrupted after batch 3 and resumed from its step checkpoint
  (written after batch 2) against the uninterrupted run: parameters,
  buffers, moments, count and step **bit for bit** (``torch.equal``): the
  loader's order, the step's generators and the CPU kernels are
  deterministic.
"""

import json
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data import loader as jloader
from mamba_clip_tpu.data import tokenizer as jtok
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import checkpoint as tckpt
from mamba_clip_tpu_torch import pipeline as tpipe
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from mamba_clip_tpu_torch.data import loader as tloader
from mamba_clip_tpu_torch.data import tokenizer as ttok
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models import ClipClassifier
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.optim import build_optimizer, freeze_submodule_mask
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.utils.precision import get_policy

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH, SEED = 32, 40, 8, 0


def _args(**kw):
    base = dict(synthetic_data=True, stage=1, seed=3, batch_size=BATCH, epochs=1, workers=2,
                train_num_samples=32, val_num_samples=12, lr=1e-3, warmup=1, wd=0.05, eps=1e-6,
                grad_clip_norm=1.0, precision="fp32", log_every_n_steps=2)
    return Args(**{**base, **kw})


def _port_clip(seed=0):
    g = torch.Generator().manual_seed(seed)
    return tclip.ClipModel(tvit.VisionTransformer(**VIT, attn_flash=True, generator=g),
                           tbert.TextBert(**BERT, attn_flash=True, generator=g))


def _port_data(args):
    data = tloader.get_data(args, tokenizer=ttok.HashTokenizer(16, vocab_size=128),
                            staging_size=STAGING)
    data["tcfg_val"] = get_transform_config(None, IMAGE, is_train=False)
    return data


def _port_setup(args, model, total_steps=10, stage=1, mask=None, class_weights=None):
    pol = get_policy(args.precision)
    sched = create_schedule(args, total_steps)
    tx = build_optimizer(args, sched, trainable_mask=mask)
    tcfg = get_transform_config(AUG, IMAGE, is_train=True)
    if stage == 1:
        step = ttrain.make_clip_train_step(model, tx, pol, args, tcfg, sched)
    else:
        step = ttrain.make_classifier_train_step(model, tx, pol, args, tcfg, sched,
                                                 class_weights=class_weights)
    return {"state": ttrain.create_train_state(model, tx, pol), "step_fn": step, "policy": pol,
            "start_epoch": 0}


def _tensors(state):
    out = dict(state.model.state_dict())
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    return out


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _fields(line):
    """A train log line with every number replaced, so only its fields remain."""
    return re.sub(r"[-+]?\d[\d.]*(e[-+]?\d+)?", "N", line)


def test_train_one_epoch_matches_jax_over_four_batches():
    # lr 2e-4: Adam moves a leaf by up to lr a step whatever its gradient, so where a
    # gradient is rounding noise the two sides part by a fraction of 4 * lr; the
    # parameters move by up to 8e-4 over the epoch, 80 times the tolerance
    args = _args(lr=2e-4)
    jm = jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT))
    variables = jax.jit(lambda k, a, b: jm.init(k, image=a, text=b))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 16), jnp.int32))
    jpol = jax_get_policy("fp32")
    jsched = jax_create_schedule(args, 10)
    jtx = jax_build_optimizer(args, jsched)
    jstate = jtrain.create_train_state(variables["params"], jtx, policy=jpol)
    jstep = jax.jit(jtrain.make_clip_train_step(
        jm, jtx, jpol, args, jax_tcfg(AUG, IMAGE, is_train=True), jsched))
    jdata = jloader.get_data(args, tokenizer=jtok.HashTokenizer(16, vocab_size=128),
                             staging_size=STAGING)
    model = load_jax_variables(_port_clip(), jax.tree_util.tree_map(np.asarray, variables))
    params = _port_setup(args, model)
    tdata = _port_data(args)

    jlog, tlog = _Lines(), _Lines()
    logging.getLogger("mamba_clip_tpu").addHandler(jlog)
    logging.getLogger("mamba_clip_tpu_torch").addHandler(tlog)
    try:
        jstate = jtrain.train_one_epoch(jstep, jstate, jdata, 0, args, jax.random.PRNGKey(SEED))
        meters = {}
        tstate = ttrain.train_one_epoch(params["step_fn"], params["state"], tdata, 0, args, SEED,
                                        device="cpu", meters=meters)
    finally:
        logging.getLogger("mamba_clip_tpu").removeHandler(jlog)
        logging.getLogger("mamba_clip_tpu_torch").removeHandler(tlog)

    assert tstate.step == int(jstate.step) == 4 and tstate.opt_state.count == 4
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    jtrain_lines = [l for l in jlog.lines if l.startswith("Train Epoch")]
    ttrain_lines = [l for l in tlog.lines if l.startswith("Train Epoch")]
    # logged at batches 0, 2 and the last one
    assert len(jtrain_lines) == len(ttrain_lines) == 3
    assert [_fields(l) for l in ttrain_lines] == [_fields(l) for l in jtrain_lines]
    assert "[32/32 (100%)]" in ttrain_lines[-1] and "data:" in ttrain_lines[0]
    loss = lambda l: float(re.search(r" loss: (\S+)", l).group(1))  # noqa: E731
    for a, b in zip(ttrain_lines, jtrain_lines):
        assert abs(loss(a) - loss(b)) <= 1e-4 * abs(loss(b))
    assert meters["batches"] == 4 and meters["data_time_count"] == 4
    assert meters["batch_time_avg"] > 0 and set(meters["last_metrics"]) >= {"loss", "lr"}


def test_interrupted_then_resumed_equals_uninterrupted_bit_for_bit(tmp_path):
    args = _args(checkpoint_steps=2)
    init = _port_clip(1).state_dict()

    def fresh(seed):
        model = _port_clip(seed)
        return model, _port_setup(args, model)

    # the uninterrupted run, through pipeline.step
    model_a, params_a = fresh(2)
    model_a.load_state_dict(init)
    run_a = tpipe.RunState(checkpoint_path=str(tmp_path / "a"))
    metrics_a, state_a = tpipe.step(args, run_a, model_a, _port_data(args), params_a, "cpu",
                                    SEED, save_prefix="stage_1_", stage=1)
    assert sorted(os.listdir(run_a.checkpoint_path)) == [
        "results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]  # finalize cleared the rest
    assert metrics_a["num_samples"] == 12 and np.isfinite(metrics_a["val_loss"])
    assert json.loads(open(tmp_path / "a" / "results.jsonl").read()) == metrics_a
    assert run_a.meters[0]["batches"] == 4

    # the same run, killed inside batch 3 (0-based) after the checkpoint of batch 2
    model_b, params_b = fresh(3)
    model_b.load_state_dict(init)
    calls = []

    def dying(state, batch, seed):
        if len(calls) == 3:
            raise KeyboardInterrupt("preempted")
        calls.append(state.step)
        return params_b["step_fn"](state, batch, seed)

    run_b = tpipe.RunState(checkpoint_path=str(tmp_path / "b"))
    with pytest.raises(KeyboardInterrupt):
        tpipe.step(args, run_b, model_b, _port_data(args), {**params_b, "step_fn": dying}, "cpu",
                   SEED, save_prefix="stage_1_", stage=1)
    assert sorted(os.listdir(run_b.checkpoint_path)) == [
        "stage_1_epoch_0_step_2", "stage_1_epoch_0_step_2.meta.json"]

    # a new process: fresh weights, resume from the latest checkpoint
    model_c, params_c = fresh(4)
    latest = tckpt.get_latest_checkpoint(run_b.checkpoint_path, prefix="stage_1_")
    state_c, start_epoch = tckpt.load_checkpoint(latest, params_c["state"])
    start_batch = tckpt.parse_step_checkpoint(latest)[1]
    data_c = _port_data(args)
    tckpt.validate_step_resume(latest, args.batch_size, num_batches=data_c["train"].num_batches)
    assert (start_epoch, start_batch, state_c.step) == (0, 2, 2)
    metrics_c, state_c = tpipe.step(
        args, run_b, model_c, data_c,
        {**params_c, "state": state_c, "start_epoch": start_epoch, "start_batch": start_batch},
        "cpu", SEED, save_prefix="stage_1_", stage=1)
    assert (state_c.step, state_c.opt_state.count) == (state_a.step, state_a.opt_state.count) \
        == (4, 4)
    got, want = _tensors(state_c), _tensors(state_a)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert metrics_c == metrics_a
    assert sorted(os.listdir(run_b.checkpoint_path)) == [
        "results.jsonl", "stage_1_epoch_1", "stage_1_epoch_latest"]
    # the stage-latest checkpoint is what stage 2 starts from
    head = ClipClassifier(_port_clip(5))
    tckpt.load_params_only(os.path.join(run_b.checkpoint_path, "stage_1_epoch_latest"), head.clip)
    assert all(torch.equal(v, model_a.state_dict()[k]) for k, v in head.clip.state_dict().items())


def test_step_runs_stage_two_epochs_with_best_metric_and_checkpoint_rotation(tmp_path):
    args = _args(stage=2, epochs=3, class_weighted_loss=True, save_frequency=1,
                 delete_previous_checkpoint=True, save_most_recent=True, return_best=True,
                 eval_loss="val_loss", hopt_direction="minimize", train_num_samples=16)
    model = ClipClassifier(_port_clip(0), generator=torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    data = _port_data(args)
    cw = data["train"].class_weights
    params = _port_setup(args, model, total_steps=6, stage=2, class_weights=cw,
                         mask=freeze_submodule_mask(named, ["clip"]))
    clip0 = {k: p.detach().clone() for k, p in named.items() if k.startswith("clip.")}
    run = tpipe.RunState(checkpoint_path=str(tmp_path / "ck"))
    metrics, state = tpipe.step(args, run, model, data, params, "cpu", SEED,
                                save_prefix="stage_2_", stage=2, takes_text=True,
                                class_weights=cw)
    assert state.step == 6 and sorted(run.meters) == [0, 1, 2]
    rows = [json.loads(l) for l in open(tmp_path / "ck" / "results.jsonl")]
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert all(0.0 <= r["partial_auc"] <= 0.2 and r["num_samples"] == 12 for r in rows)
    assert metrics == min(rows, key=lambda r: r["val_loss"])  # --return-best
    # --delete-previous-checkpoint keeps the last numbered epoch only
    assert sorted(os.listdir(run.checkpoint_path)) == [
        "results.jsonl", "stage_2_epoch_3", "stage_2_epoch_latest"]
    assert all(torch.equal(named[k].detach(), v) for k, v in clip0.items())
    # a finished run resumed: nothing to train, it still evaluates
    again, _ = tpipe.step(args, run, model, data, {**params, "state": state, "start_epoch": 3},
                          "cpu", SEED, save_prefix="stage_2_", stage=2, class_weights=cw)
    assert again == rows[-1]


def test_loop_guards_its_resume_offset_calls_the_checkpoint_hook_and_traces(tmp_path):
    args = _args(train_num_samples=40, checkpoint_steps=2)
    model = _port_clip(0)
    params = _port_setup(args, model)
    data = _port_data(args)
    # the JAX package's message, word for word
    jdata = jloader.get_data(args, tokenizer=jtok.HashTokenizer(16, vocab_size=128),
                             staging_size=STAGING)
    with pytest.raises(ValueError) as jerr:
        jtrain.train_one_epoch(None, None, jdata, 0, args, None, start_batch=5)
    with pytest.raises(ValueError) as terr:
        ttrain.train_one_epoch(None, None, data, 0, args, SEED, start_batch=5, device="cpu")
    assert str(terr.value) == str(jerr.value) and "only 5 batches" in str(terr.value)

    hook = []
    state = ttrain.train_one_epoch(
        params["step_fn"], params["state"], data, 0, args, SEED, device="cpu",
        trace_dir=str(tmp_path / "trace"),
        step_ckpt_cb=lambda st, ep, done, num_batches: hook.append((st.step, ep, done,
                                                                    num_batches)))
    # every 2 steps, never on the last batch (5 batches: after 2 and 4)
    assert hook == [(2, 0, 2, 5), (4, 0, 4, 5)] and state.step == 5
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert trace["traceEvents"]  # steps 3 and 4 of the 5 were captured
    assert data["train"].loader.start_batch == 0
