"""``ClipClassifier``, ``partial_auc`` and ``evaluate`` of the port against
the JAX package, on the CPU.

A small CLIP (ViT: image 32, patch 16, width 32, depth 2, 4 heads; BERT:
vocab 128, context 16, the same widths; embed 16) is initialized by Flax
and carried into the port by ``convert.py``.

Tolerances:
- ``ClipClassifier`` logits in the four feature modes: atol 1e-5 (fp32 on
  both sides; GEMM and reduction order differ).
- a 3-step stage-2 loss trajectory (class-weighted CE, frozen CLIP, AdamW
  with weight decay): rel 1e-5 a step, the head's parameters at atol 1e-5,
  every ``clip.*`` parameter bit-unchanged.
- ``partial_auc`` against the JAX package's (scikit-learn's ROC curve):
  1e-12 absolute, on random scores, tied scores, a curve point exactly at
  the max-FPR boundary, a single positive, and hypothesis-made cases.
- ``evaluate`` metrics of both stages on the same split and weights: 1e-5.

What a stage-2 step can see of the frozen CLIP's training mode: the towers
here have no dropout layers, so it is ``patch_dropout`` (when the CLIP was
built with it; the stage-2 pipeline builds it with 0) and, for the
``medmamba`` CLIP, DropPath and the VSSM's BatchNorm, which normalizes with
batch statistics and moves its running statistics though no parameter of
the CLIP moves. The last test shows both.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mamba_clip_tpu import eval as jeval
from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args
from mamba_clip_tpu.data import loader as jloader
from mamba_clip_tpu.data import tokenizer as jtok
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import heads as jheads
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.optim import freeze_submodule_mask as jax_freeze_mask
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import eval as teval
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from mamba_clip_tpu_torch.data import loader as tloader
from mamba_clip_tpu_torch.data import tokenizer as ttok
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models import ClipClassifier
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.models import vssm as tvssm
from mamba_clip_tpu_torch.ops import flash_attn as tfa
from mamba_clip_tpu_torch.optim import build_optimizer, freeze_submodule_mask
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.utils.logging import ResultsWriter
from mamba_clip_tpu_torch.utils.precision import get_policy

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH = 32, 40, 8
MODES = {"concat": {}, "visual_only": {"use_visual_only": True},
         "text_only": {"use_text_only": True}, "inner_prod": {"use_inner_prod": True},
         "concat_feature_dim_20": {"feature_dim": 20}}


def _jax_clip():
    return jclip.ClipModel(visual=jvit.VisionTransformer(**VIT), text=jbert.TextBert(**BERT))


def _port_clip(**vit_kw):
    return tclip.ClipModel(tvit.VisionTransformer(**VIT, attn_flash=True, **vit_kw),
                           tbert.TextBert(**BERT, attn_flash=True))


def _classifier_pair(seed=0, **mode):
    jm = jheads.ClipClassifier(clip=_jax_clip(), **mode)
    variables = jax.jit(lambda k, a, b: jm.init(k, a, b))(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 16), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = ClipClassifier(_port_clip(), **mode)
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _tokens(rs, n=BATCH):
    ids = rs.randint(4, 128, (n, 16)).astype(np.int32)
    ids[:, 0] = 2
    for i, k in enumerate(rs.randint(3, 17, n)):
        ids[i, k:] = 0
    return ids


@pytest.mark.parametrize("mode", sorted(MODES))
def test_clip_classifier_logits_match_jax_in_every_feature_mode(mode):
    jm, variables, tm = _classifier_pair(**MODES[mode])
    rs = np.random.RandomState(0)
    img = rs.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
    tok = _tokens(rs)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(img), jnp.asarray(tok)))
    tm.eval()
    got = tm(torch.from_numpy(img), torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    hidden = {"concat": 16, "concat_feature_dim_20": 10}.get(mode, 16)
    in_dim = 32 if mode.startswith("concat") else 16
    assert tuple(tm.fc1.weight.shape) == (hidden, in_dim)
    assert tuple(variables["params"]["fc1"]["kernel"].shape) == (in_dim, hidden)
    assert not got.requires_grad or not any(  # the frozen CLIP is outside the graph
        p.grad is not None for p in tm.clip.parameters())
    pred, probs = tm.classify(torch.from_numpy(img), torch.from_numpy(tok))
    assert torch.equal(pred, probs.argmax(-1)) and torch.allclose(probs.sum(-1), torch.ones(BATCH))


def test_three_stage2_steps_match_jax_and_leave_the_clip_unchanged():
    jm, variables, tm = _classifier_pair()
    args = Args(batch_size=BATCH, epochs=1, lr=1e-3, warmup=1, wd=0.05, grad_clip_norm=1.0,
                precision="fp32", class_weighted_loss=True)
    cw = np.array([0.6, 3.0])
    jpol, tpol = jax_get_policy("fp32"), get_policy("fp32")
    jsched, tsched = jax_create_schedule(args, 10), create_schedule(args, 10)
    jtx = jax_build_optimizer(args, jsched,
                              trainable_mask=jax_freeze_mask(variables["params"], ["clip"]))
    named = dict(tm.named_parameters())
    tmask = freeze_submodule_mask(named, ["clip"])
    assert sorted(k for k, t in tmask.items() if t) == [
        "fc1.bias", "fc1.weight", "fc2.bias", "fc2.weight"]
    ttx = build_optimizer(args, tsched, trainable_mask=tmask)
    jstate = jtrain.create_train_state(variables["params"], jtx, policy=jpol)
    jstep = jax.jit(jtrain.make_classifier_train_step(
        jm, jtx, jpol, args, jax_tcfg(AUG, IMAGE, is_train=True), jsched, class_weights=cw))
    tstate = ttrain.create_train_state(tm, ttx, tpol)
    tstep = ttrain.make_classifier_train_step(
        tm, ttx, tpol, args, get_transform_config(AUG, IMAGE, is_train=True), tsched,
        class_weights=cw)
    clip0 = {k: p.detach().clone() for k, p in named.items() if k.startswith("clip.")}
    rs = np.random.RandomState(1)
    for i in range(3):
        batch = {"image": rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8),
                 "tokens": _tokens(rs), "target": rs.randint(0, 2, BATCH).astype(np.int32)}
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0))
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        for key in ("loss", "grad_norm"):
            got, want = float(tmet[key]), float(jmet[key])
            assert abs(got - want) <= 1e-5 * abs(want), (i, key, got, want)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    for k, p in named.items():
        if k.startswith("clip."):
            assert torch.equal(p.detach(), clip0[k]), k          # no update, no decay
            assert torch.equal(want[k], clip0[k]), k             # nor on the JAX side
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-5, rtol=0)
            assert float(p.grad.abs().max()) > 0
    assert set(tstate.opt_state.mu) == {k for k in named if not k.startswith("clip.")}
    assert all(float(named[k].grad.abs().max()) == 0 for k in clip0)
    assert tfa.flash_attn_fwd.launches == 0 and tfa.flash_attn_bwd_dkv.launches == 0


def _sk_cases():
    rs = np.random.RandomState(0)
    y = (rs.rand(400) < 0.1).astype(int)
    yield "random", y, rs.rand(400)
    yield "ties", y, np.round(rs.rand(400), 1)
    yield "all_tied", y, np.full(400, 0.5)
    # 10 positives scored so that the flipped curve has a point exactly at fpr = 0.2
    y2 = np.r_[np.ones(10, int), np.zeros(30, int)]
    s2 = np.r_[np.linspace(0.05, 0.95, 10), np.linspace(0.0, 1.0, 30)]
    yield "boundary", y2, s2
    y3 = np.zeros(64, int)
    y3[5] = 1
    yield "one_positive", y3, rs.rand(64)
    yield "perfect", y2, np.r_[np.ones(10), np.zeros(30)]
    yield "float_labels", y.astype(np.float32), rs.rand(400).astype(np.float32)


@pytest.mark.parametrize("case", [c[0] for c in _sk_cases()])
def test_partial_auc_matches_the_sklearn_based_one(case):
    _, y, s = next(c for c in _sk_cases() if c[0] == case)
    for min_tpr in (0.8, 0.5, 0.0):
        got, want = teval.partial_auc(y, s, min_tpr), jeval.partial_auc(y, s, min_tpr)
        assert abs(got - want) <= 1e-12, (case, min_tpr, got, want)
    assert 0.0 <= teval.partial_auc(y, s) <= 0.2 + 1e-12
    with pytest.raises(ValueError, match="Expected min_tpr"):
        teval.partial_auc(y, s, min_tpr=1.0)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.integers(0, 12)), min_size=4, max_size=60))
def test_partial_auc_matches_on_hypothesis_cases(rows):
    y = np.array([int(r[0]) for r in rows])
    s = np.array([r[1] / 12.0 for r in rows])  # a coarse grid: many ties
    if y.min() == y.max():
        y[0] = 1 - y[0]
    for min_tpr in (0.8, 0.3):
        assert abs(teval.partial_auc(y, s, min_tpr) - jeval.partial_auc(y, s, min_tpr)) <= 1e-12


def _eval_args(stage, **kw):
    return Args(synthetic_data=True, stage=stage, seed=3, batch_size=BATCH, epochs=2, workers=2,
                train_num_samples=16, val_num_samples=21, log_every_n_steps=2, **kw)


@pytest.mark.parametrize("stage", [1, 2])
def test_evaluate_matches_jax_on_the_same_split_and_weights(stage, tmp_path):
    args = _eval_args(stage)
    if stage == 1:
        jm = _jax_clip()
        variables = jax.jit(lambda k, a, b: jm.init(k, image=a, text=b))(
            jax.random.PRNGKey(1), jnp.zeros((1, IMAGE, IMAGE, 3)),
            jnp.zeros((1, 16), jnp.int32))
        variables = jax.tree_util.tree_map(np.asarray, variables)
        tm = load_jax_variables(_port_clip(), variables)
        cw = None
    else:
        jm, variables, tm = _classifier_pair(seed=1)
        cw = np.array([0.7, 2.5])
    jdata = jloader.get_data(args, tokenizer=jtok.HashTokenizer(16, vocab_size=128),
                             staging_size=STAGING)
    tdata = tloader.get_data(args, tokenizer=ttok.HashTokenizer(16, vocab_size=128),
                             staging_size=STAGING)
    want = jeval.evaluate(jm, variables, jdata, 2, args, jax_get_policy("fp32"),
                          jax_tcfg(None, IMAGE, is_train=False), stage=stage, class_weights=cw)
    writer = ResultsWriter(str(tmp_path / "results.jsonl"))
    tm.train()  # evaluate puts the model in eval mode itself
    got = teval.evaluate(tm, None, tdata, 2, args, get_policy("fp32"),
                         get_transform_config(None, IMAGE, is_train=False), stage=stage,
                         class_weights=cw, results_writer=writer, device="cpu")
    assert sorted(got) == sorted(want) and got["num_samples"] == want["num_samples"] == 21
    assert not tm.training
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got, want)
    if stage == 2:
        assert 0.0 <= got["partial_auc"] <= 0.2
    assert json.loads(open(tmp_path / "results.jsonl").read()) == got
    # --val-frequency gates by epoch; the last epoch always evaluates
    gated = _eval_args(stage, val_frequency=2)
    assert teval.evaluate(tm, None, tdata, 1, gated, get_policy("fp32"),
                          get_transform_config(None, IMAGE, is_train=False), stage=stage,
                          device="cpu") == {}
    assert teval.evaluate(tm, None, {}, 2, args, None, None, device="cpu") == {}


def test_evaluate_unlabeled_split_single_column_probs_and_world(monkeypatch):
    args = _eval_args(2)
    pol, tcfg = get_policy("fp32"), get_transform_config(None, IMAGE, is_train=False)
    _, _, tm = _classifier_pair(seed=2)
    tdata = tloader.get_data(args, tokenizer=ttok.HashTokenizer(16, vocab_size=128),
                             staging_size=STAGING)

    class NoTargets:  # the challenge's test split: no target column
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            return {k: v for k, v in self.ds[i].items() if k != "target"}

    loader = tdata["val"].loader
    unl = {"test": tloader.DataInfo(tloader.BatchLoader(
        NoTargets(loader.dataset), BATCH, shuffle=False, drop_last=False, workers=1))}
    got = teval.evaluate(tm, None, unl, 2, args, pol, tcfg, stage=2, device="cpu")
    assert got == {"epoch": 2, "num_samples": 21}  # no loss, no pAUC without labels

    # a model with one sigmoid output: [N, 1] probabilities become [1 - p, p]
    def one_column(model, batch):
        p = torch.sigmoid(batch["image"].float().mean((1, 2, 3)) - 127.0)[:, None]
        return torch.zeros(()), p

    got = teval.evaluate(tm, None, tdata, 2, args, pol, tcfg, stage=2, eval_step=one_column,
                         device="cpu")
    assert 0.0 <= got["partial_auc"] <= 0.2 and got["val_loss"] == 0.0

    # world > 1 combines the ranks' shards (two gloo ranks against world 1
    # in test_torch_port_data_axis.py); here a stand-in gather hands rank 0
    # its own shard twice: the sums double, the metrics stay
    class Two:
        world_size, rank, checkpoint_path = 2, 0, None

    base = teval.evaluate(tm, None, tdata, 2, args, pol, tcfg, device="cpu")
    monkeypatch.setattr(teval, "_gather", lambda x, world: np.stack([np.asarray(x)] * world))
    two = teval.evaluate(tm, None, tdata, 2, args, pol, tcfg, run_state=Two(), device="cpu")
    assert two["num_samples"] == 2 * base["num_samples"]
    assert two["val_loss"] == pytest.approx(base["val_loss"], rel=1e-12)
    assert two["partial_auc"] == base["partial_auc"]


def test_frozen_clip_still_runs_in_training_mode():
    """Training mode reaches the frozen CLIP: ``patch_dropout`` changes the
    features, and a VSSM tower's BatchNorm moves its running statistics
    while every ``clip.*`` parameter stays bit-identical and gets no
    gradient."""
    g = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32))
    tok = torch.from_numpy(_tokens(rs, 4))
    vit = tvit.VisionTransformer(**dict(VIT, image_size=64), patch_dropout=0.5, generator=g)
    model = ClipClassifier(tclip.ClipModel(vit, tbert.TextBert(**BERT, generator=g)),
                           generator=g)
    model.eval()
    calm = model(img, tok)
    model.train()
    a = model(img, tok, generator=torch.Generator().manual_seed(1))
    b = model(img, tok, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, calm)

    tower = tclip.VssmTower(tvssm.VSSM(depths=(1, 1), dims=(16, 32), num_classes=0,
                                       drop_path_rate=0.0, generator=g), embed_dim=16,
                            generator=g)
    model = ClipClassifier(tclip.ClipModel(tower, tbert.TextBert(**BERT, generator=g)),
                           generator=g)
    args = Args(batch_size=4, epochs=1, lr=1e-3, wd=0.05)
    named = dict(model.named_parameters())
    tx = build_optimizer(args, None, trainable_mask=freeze_submodule_mask(named, ["clip"]))
    step = ttrain.make_classifier_train_step(
        model, tx, get_policy("fp32"), args, get_transform_config(AUG, IMAGE, is_train=True))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = {"image": torch.from_numpy(rs.randint(0, 256, (4, STAGING, STAGING, 3), dtype=np.uint8)),
             "tokens": tok, "target": torch.tensor([0, 1, 0, 0], dtype=torch.int32)}
    _, m = step(ttrain.create_train_state(model, tx), batch, 0)
    assert np.isfinite(float(m["loss"]))
    after = model.state_dict()
    stats = [k for k in after if "running_" in k]
    assert stats and all(not torch.equal(after[k], before[k]) for k in stats)
    for k in named:
        assert torch.equal(after[k], before[k]) == k.startswith("clip."), k
