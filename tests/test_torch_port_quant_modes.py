"""The port's native int8 modes against the JAX package's, on the CPU.

A small CLIP (ViT: image 32, patch 16, width 32, depth 2, 4 heads; BERT:
vocab 128, context 16, the same widths; embed 16, the einsum interior) and
a small medmamba classifier (depths (1, 1), dims (32, 64)) take parameter
values from a numpy seed over ``jax.eval_shape`` of the init; the delayed
modes' ``quant`` collection comes from one JAX forward on a seeded batch
(as ``model.init`` makes it) and both go into the port through
``convert.py``. For each of ``int8_fast``, ``int8_fast_attn``,
``int8_delayed``, ``int8_delayed_attn`` and ``int8_serve``:

- a forward against JAX: unit features within 1e-5, fp32;
- three contrastive steps (fp32, deterministic crop, AdamW with clipping)
  against JAX's jitted steps: the loss of each within rel 2e-3, the grad
  norm within rel 2e-2, the delayed state after each step within rel 2e-2
  leaf for leaf, and an eval forward after them writes no scale.

The int8 envelope. Both packages make the same int8 operands from the same
values and sum them exactly (``tests/test_torch_port_qdot.py``), so the
int8 dots add no difference of their own; what differs is the fp32
arithmetic around them (GEMM and reduction orders, about one ulp). An
element that sits within an ulp of a rounding boundary of ``round()``
rounds to the neighbouring int8 value on one side only
(``tests/test_quant.py:243-251``, which measured the same effect as a 0.2%
loss delta at full width): one term of one dot moves by one quantization
step, 1/127 of its tensor's (or its row's) absmax, and the trajectories
part from there. So the loss is held at rel 2e-3, JAX's figure; a delayed
absmax moves by at most about a step of its producer, 1/127 = 7.9e-3, held
at 2e-2 with the grad norm (whose largest term a flip in a cotangent's
quantization moves). Measured here: before the first flip every quantity
agrees within 1e-6; after it the loss within 6.1e-4, the grad norm within
9.6e-3 and the delayed state within 3.9e-3. Under amp the bf16 roundings
of the two frameworks differ far more often, so the trajectories are
compared in fp32 and the rounding point under bf16 is checked bit for bit
at the Dense layer instead.

Also: the medmamba classifier step under ``int8_delayed`` (BatchNorm's
statistics and the delayed state, three steps) and its ``int8_serve``
forward; ``accum_freq`` 2 with ``grad_checkpointing`` under
``int8_delayed`` against JAX, and against the same step without the
checkpoints bit for bit (the recompute must quantize with the stored
scales, not the ones this step records); ``calibrate_quant`` against
JAX's, fired by ``train_one_epoch`` at step 0 only; the initial delayed
state from the init batch through ``prepare_params``; ``--quant`` through
``pipeline()`` at both stages; a checkpoint round trip of the delayed
state; the flash-with-``_attn`` refusal; a compressed ``int8_serve``
artifact's int8 values and scales bit for bit JAX's and its outputs bit
for bit the uncompressed module's.
"""

import contextlib
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args as JArgs
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.models.vssm import VSSM as JaxVSSM
from mamba_clip_tpu.ops import qdot as jq
from mamba_clip_tpu.ops import quant as jquant
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.serving import compress_params as jax_compress_params
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import checkpoint as tckpt
from mamba_clip_tpu_torch import pipeline as tpipe
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.config import Args, RunState
from mamba_clip_tpu_torch.convert import (flax_arrays, load_jax_variables, quant_to_jax,
                                          state_dict_from_jax)
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models import VSSM
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.models.vssm import _linear
from mamba_clip_tpu_torch.ops import qdot as tq
from mamba_clip_tpu_torch.ops import quant as tquant
from mamba_clip_tpu_torch.optim import build_optimizer
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.serving import (_COMPRESS_KEY, export_serving, load_serving,
                                          make_serving_fns)
from mamba_clip_tpu_torch.utils.precision import get_policy

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

MODES = ("int8_fast", "int8_fast_attn", "int8_delayed", "int8_delayed_attn", "int8_serve")
DELAYED = ("int8_delayed", "int8_delayed_attn")
VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
VSSM_KW = dict(depths=(1, 1), dims=(32, 64), num_classes=2, drop_path_rate=0.0)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH = 32, 40, 8
LOSS_REL, GNORM_REL, QUANT_REL, FEAT_ATOL = 2e-3, 2e-2, 2e-2, 1e-5
# the medmamba classifier: BatchNorm over 8 images in training mode and the
# scan carry a flip further (measured over three steps: loss 9.3e-3, grad
# norm 2.4e-3, delayed state 2.1e-2, statistics within the loss's)
MM_LOSS_REL, MM_QUANT_REL = 2e-2, 5e-2


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _tree_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_quant_close(model, jquant_tree, rel=QUANT_REL, what=""):
    want, got = _tree_leaves(jquant_tree), _tree_leaves(quant_to_jax(model))
    assert sorted(got) == sorted(want), what
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= rel, (what, k, err)


def _quant_kw(quant, jax_side):
    mod = jquant if jax_side else tquant
    return dict(dot_general_cls=mod.make_dot_general_cls(quant),
                attn_int8=mod.attn_int8(quant), attn_int8_delayed=mod.attn_int8_delayed(quant))


def _jax_clip(quant=None, grad_checkpointing=False):
    kw = dict(_quant_kw(quant, True), grad_checkpointing=grad_checkpointing)
    return jclip.ClipModel(visual=jvit.VisionTransformer(**VIT, **kw),
                           text=jbert.TextBert(**BERT, **kw))


def _port_clip(quant=None, grad_checkpointing=False):
    kw = dict(_quant_kw(quant, False), grad_checkpointing=grad_checkpointing)
    return tclip.ClipModel(tvit.VisionTransformer(**VIT, **kw),
                           tbert.TextBert(**BERT, **kw))


def _shaped_params(module, seed, *inputs):
    """Flax params with the init's shapes and values from a numpy seed (and
    the BatchNorm statistics, where the module has them)."""
    rs = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    shapes = {k: v for k, v in shapes.items() if k != "quant"}

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = 1 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel" else 0.1
        return (std * rs.standard_normal(s.shape, np.float32)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tokens(rs, n=BATCH):
    ids = rs.randint(4, 128, (n, 16)).astype(np.int32)
    ids[:, 0] = 2
    for i, k in enumerate(rs.randint(3, 17, n)):
        ids[i, k:] = 0
    return ids


def _batches(n, seed=1, text=True):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"image": rs.randint(0, 256, (BATCH, STAGING, STAGING, 3), dtype=np.uint8),
             "target": (np.arange(BATCH) % 2).astype(np.int32)}
        if text:
            b["tokens"] = _tokens(rs)
        out.append(b)
    return out


_INIT_RS = np.random.RandomState(5)
INIT_IMAGE = _INIT_RS.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
INIT_TOKENS = _tokens(_INIT_RS, 2)


@pytest.fixture(scope="module")
def clip_params():
    return _shaped_params(_jax_clip(), 0, INIT_IMAGE, INIT_TOKENS)["params"]


@pytest.fixture(scope="module")
def quant_states(clip_params):
    """The ``quant`` collection of each delayed mode: one JAX forward that
    makes it (what ``model.init`` does) on a seeded batch."""
    out = {}
    for quant in DELAYED:
        jm = _jax_clip(quant)
        _, mut = jax.jit(lambda p, a, b: jm.apply({"params": p}, image=a, text=b,
                                                  mutable=["quant"]))(
            clip_params, INIT_IMAGE, INIT_TOKENS)
        out[quant] = jax.tree_util.tree_map(np.asarray, mut["quant"])
    return out


def _variables(params, quant_states, quant):
    v = {"params": params}
    if quant in DELAYED:
        v["quant"] = quant_states[quant]
    return v


def _args(quant, **kw):
    return JArgs(batch_size=BATCH, epochs=1, lr=1e-3, warmup=1, wd=0.05, eps=1e-6,
                 grad_clip_norm=1.0, precision="fp32", quant=quant, **kw)


class _Pair:
    """The JAX contrastive step and the port's from the same variables."""

    def __init__(self, quant, variables, grad_checkpointing=False, **arg_kw):
        args = _args(quant, **arg_kw)
        pol, tpol = jax_get_policy("fp32"), get_policy("fp32")
        self.jm = _jax_clip(quant, grad_checkpointing)
        self.model = _port_clip(quant, grad_checkpointing)
        load_jax_variables(self.model, variables)
        jsched, tsched = jax_create_schedule(args, 10), create_schedule(args, 10)
        jtx = jax_build_optimizer(args, jsched)
        self.jstate = jtrain.create_train_state(variables["params"], jtx, {}, policy=pol,
                                                quant_stats=variables.get("quant"))
        self.jfn = jtrain.make_clip_train_step(self.jm, jtx, pol, args,
                                               jax_tcfg(AUG, IMAGE, is_train=True), jsched)
        self.jstep = jax.jit(self.jfn)
        ttx = build_optimizer(args, tsched)
        self.tstate = ttrain.create_train_state(self.model, ttx, policy=tpol)
        self.tstep = ttrain.make_clip_train_step(
            self.model, ttx, tpol, args, get_transform_config(AUG, IMAGE, is_train=True), tsched)
        self.key = jax.random.PRNGKey(0)

    def step(self, batch):
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                     self.key)
        self.tstate, tm = self.tstep(
            self.tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        return {k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}


@pytest.mark.parametrize("quant", MODES)
def test_forward_matches_jax(quant, clip_params, quant_states):
    variables = _variables(clip_params, quant_states, quant)
    jm = _jax_clip(quant)
    model = _port_clip(quant)
    load_jax_variables(model, variables)
    model.eval()
    img = np.random.RandomState(2).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    tok = _tokens(np.random.RandomState(3), 4)
    want = jax.jit(lambda v, a, b: jm.apply(v, image=a, text=b))(variables, img, tok)
    with torch.no_grad():
        got = model(image=torch.from_numpy(img), text=torch.from_numpy(tok))
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=FEAT_ATOL,
                                   rtol=0, err_msg=f"{quant} {key}")
    # the injection: a dot in every Dense the JAX package quantizes, none in
    # the fp32 projections
    injected = {n for n, m in model.named_modules() if tq.injected(m) is not None}
    dense = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    assert dense - injected == {"visual.proj", "text.proj_fc1", "text.proj_fc2"}


@pytest.mark.parametrize("quant", MODES)
def test_three_steps_match_jax(quant, clip_params, quant_states):
    pair = _Pair(quant, _variables(clip_params, quant_states, quant))
    for i, batch in enumerate(_batches(3)):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= LOSS_REL, \
            (quant, i, got, want)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= GNORM_REL, (quant, i, got, want)
        if quant in DELAYED:
            _assert_quant_close(pair.model, pair.jstate.quant_stats, what=f"{quant} step {i}")
        else:
            assert not tq.delayed_scales(pair.model) and not pair.jstate.quant_stats
    if quant in DELAYED:
        before = {k: v.clone() for k, v in tq.delayed_scales(pair.model).items()}
        assert any(not torch.equal(before[k], torch.from_numpy(
            np.asarray(v))) for k, v in state_dict_from_jax(
                {"quant": quant_states[quant]}).items())  # the steps moved them
        pair.model.eval()  # an eval forward reads the scales and writes none
        with torch.no_grad():
            pair.model(image=torch.zeros(2, IMAGE, IMAGE, 3),
                       text=torch.from_numpy(_tokens(np.random.RandomState(0), 2)))
        for k, v in tq.delayed_scales(pair.model).items():
            assert torch.equal(v, before[k]), k


def test_medmamba_classifier_under_int8_delayed_and_int8_serve():
    """Three CE steps under int8_delayed (BatchNorm in training mode moves
    its statistics beside the delayed state) against JAX's, then the
    int8_serve forward (softmax probabilities) on the stepped weights. The
    unquantized steps of this model agree within 1e-6 for five steps; the
    quantized ones within the envelope of the module docstring, widened by
    BatchNorm and the scan (``MM_LOSS_REL``, ``MM_QUANT_REL``)."""
    img = INIT_IMAGE
    jm = JaxVSSM(scan_impl="xla", dot_general_cls=jquant.make_dot_general_cls("int8_delayed"),
                 **VSSM_KW)
    v = _shaped_params(JaxVSSM(scan_impl="xla", **VSSM_KW), 4, img)
    _, mut = jax.jit(lambda vv, a: jm.apply(vv, a, mutable=["quant"]))(v, img)
    v = dict(v, quant=jax.tree_util.tree_map(np.asarray, mut["quant"]))
    model = VSSM(dot_general_cls=tquant.make_dot_general_cls("int8_delayed"), **VSSM_KW)
    load_jax_variables(model, v)
    args = _args("int8_delayed")
    pol, tpol = jax_get_policy("fp32"), get_policy("fp32")
    jsched, tsched = jax_create_schedule(args, 10), create_schedule(args, 10)
    jtx = jax_build_optimizer(args, jsched)
    jstate = jtrain.create_train_state(v["params"], jtx, v["batch_stats"], policy=pol,
                                       quant_stats=v["quant"])
    jstep = jax.jit(jtrain.make_classifier_train_step(
        jm, jtx, pol, args, jax_tcfg(AUG, IMAGE, is_train=True), jsched, takes_text=False))
    ttx = build_optimizer(args, tsched)
    tstate = ttrain.create_train_state(model, ttx, policy=tpol)
    tstep = ttrain.make_classifier_train_step(
        model, ttx, tpol, args, get_transform_config(AUG, IMAGE, is_train=True), tsched,
        takes_text=False)
    for i, batch in enumerate(_batches(3, seed=4, text=False)):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()},
                             jax.random.PRNGKey(0))
        tstate, tmet = tstep(tstate, {k: torch.from_numpy(x) for k, x in batch.items()}, 0)
        assert _rel(float(tmet["loss"]), float(jmet["loss"])) <= MM_LOSS_REL, (i, tmet, jmet)
        assert _rel(float(tmet["grad_norm"]), float(jmet["grad_norm"])) <= GNORM_REL, i
        _assert_quant_close(model, jstate.quant_stats, rel=MM_QUANT_REL, what=f"step {i}")
        stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
            np.asarray, jstate.batch_stats)})
        buffers = dict(model.named_buffers())
        for name, want in stats.items():
            # the batch statistics of activations that quantized dots made:
            # the loss's envelope, of the tensor's largest entry
            got = buffers[name].numpy()
            err = np.abs(got - want.numpy()).max() / np.abs(want.numpy()).max()
            assert err <= MM_LOSS_REL, (i, name, err)
    # int8_serve: the same module with the serving dot, eval mode
    js = JaxVSSM(scan_impl="xla", dot_general_cls=jquant.make_dot_general_cls("int8_serve"),
                 **VSSM_KW)
    served = VSSM(dot_general_cls=tquant.make_dot_general_cls("int8_serve"), **VSSM_KW)
    sv = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
          "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}
    load_jax_variables(served, sv)
    served.eval()
    want = jax.nn.softmax(jax.jit(lambda vv, a: js.apply(vv, a))(sv, img), axis=-1)
    with torch.no_grad():
        got = torch.softmax(served(torch.from_numpy(img)), dim=-1)
    # classify's bound against JAX (tests/test_torch_port_serving.py); a
    # flip in the per-tensor lhs quantization moved a probability by 3.8e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_accum_and_checkpointing_under_int8_delayed(clip_params, quant_states):
    """``accum_freq`` 2 with ``grad_checkpointing``: micro-batch 2 quantizes
    with micro-batch 1's absmax, the recomputed blocks with the stored
    scales. Against JAX (loss, grad norm, the state after the step), then
    against the same step without the checkpoints, bit for bit."""
    variables = _variables(clip_params, quant_states, "int8_delayed")
    batch = _batches(1, seed=6)[0]
    pair = _Pair("int8_delayed", variables, grad_checkpointing=True, accum_freq=2)
    got, want = pair.step(batch)
    assert _rel(got["loss"], want["loss"]) <= LOSS_REL, (got, want)
    assert _rel(got["grad_norm"], want["grad_norm"]) <= GNORM_REL, (got, want)
    _assert_quant_close(pair.model, pair.jstate.quant_stats, what="accum 2 + remat")
    plain = _Pair("int8_delayed", variables, grad_checkpointing=False, accum_freq=2)
    plain.tstate, _ = plain.tstep(plain.tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  0)
    for (name, p), q in zip(pair.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name
    a, b = tq.delayed_scales(pair.model), tq.delayed_scales(plain.model)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_calibrate_quant_matches_jax_and_fires_at_step_zero_only(clip_params, quant_states):
    variables = _variables(clip_params, quant_states, "int8_delayed_attn")
    pair = _Pair("int8_delayed_attn", variables)
    batch = _batches(1, seed=8)[0]
    jstate = jax.jit(pair.jfn.calibrate_quant)(
        pair.jstate, {k: jnp.asarray(v) for k, v in batch.items()}, pair.key)
    calls = []
    real = pair.tstep.calibrate_quant

    def spy(state, b, seed):
        calls.append(state.step)
        return real(state, b, seed)

    batches = [batch, _batches(1, seed=9)[0]]

    class Loader:
        num_batches, num_samples, start_batch = 2, 2 * BATCH, 0

        def __iter__(self):
            return iter(batches)

    data = {"train": SimpleNamespace(loader=Loader(), set_epoch=lambda e: None)}
    steps = []
    step_fn = pair.tstep

    def record(state, b, seed):
        if not steps:  # the state the first step sees: calibrated, not stepped
            _assert_quant_close(state.model, jstate.quant_stats, what="calibrated")
            assert state.step == 0
        steps.append(state.step)
        return step_fn(state, b, seed)

    record.calibrate_quant = spy
    args = SimpleNamespace(checkpoint_steps=0, log_every_n_steps=10)
    state = ttrain.train_one_epoch(record, pair.tstate, data, 0, args, 0, device="cpu")
    assert calls == [0] and steps == [0, 1]
    # a resumed run (step > 0) keeps its scales: no calibration
    ttrain.train_one_epoch(record, state, data, 1, args, 0, device="cpu")
    assert calls == [0] and steps == [0, 1, 2, 3]
    # the calibration moves the delayed scales and nothing else
    fresh = _port_clip("int8_delayed_attn")
    load_jax_variables(fresh, variables)
    st = ttrain.create_train_state(fresh, build_optimizer(_args("int8_delayed_attn"), None))
    real(st, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    want = state_dict_from_jax({"params": variables["params"]})
    for n, p in fresh.named_parameters():
        assert torch.equal(p.detach(), want[n]) and p.grad is None, n


def test_prepare_params_sets_the_delayed_state_from_the_init_batch():
    """Without ``init_params``, ``prepare_params`` sets the delayed state
    as JAX's ``model.init`` does: from two zero images at the train size and
    two all-pad token rows, the params it starts from."""
    model = _port_clip("int8_delayed_attn")
    data = {"train": SimpleNamespace(num_batches=2),
            "tcfg_train": get_transform_config(AUG, IMAGE, is_train=True)}
    tp = tpipe.prepare_params(Args(batch_size=BATCH, epochs=1, precision="fp32",
                                   quant="int8_delayed_attn"),
                              model, data, RunState(device="cpu"), stage=1, takes_text=True)
    params = {}
    for key, arr in flax_arrays(tp["state"].model).items():
        node = params
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    jm = _jax_clip("int8_delayed_attn")
    zeros = (np.zeros((2, IMAGE, IMAGE, 3), np.float32), np.zeros((2, 16), np.int32))
    # the apply that creates the collection, as model.init does, on the
    # port's parameters
    want = jax.jit(lambda p, a, b: jm.apply({"params": p}, image=a, text=b,
                                            mutable=["quant"])[1]["quant"])(params, *zeros)
    _assert_quant_close(tp["state"].model, want, what="init batch")


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


def test_pipeline_runs_both_stages_under_int8_delayed(tmp_path, monkeypatch):
    """``--quant`` reaches stage 1 and stage 2 through the CLI's ``main()``
    and ``pipeline()``: the
    small CLIP is built with the mode, calibrated on its first batch, and
    its checkpoints carry the delayed state; the aqt modes ``int8`` and
    ``int8_fwd`` run stage 1 too, with no delayed state to carry. JAX's
    stage 2 cannot run this mode: its ``prepare_params`` gets the grafted
    ``init_params`` and no ``init_quant_stats`` (JAX ``pipeline.py``
    :749-753, :302-303), so the classifier's apply finds no ``quant``
    collection and raises (ROADMAP Queue 3); the port's stage 2 sets the
    scales from the init batch and calibrates them."""
    built = []

    def small(quant=None, attn_flash=False, generator=None, **kw):
        built.append(quant)
        return _port_clip(quant)

    monkeypatch.setattr(tpipe, "build_clip", small)
    from mamba_clip_tpu_torch.data.tokenizer import HashTokenizer

    monkeypatch.setattr(tpipe, "get_tokenizer", lambda name, **kw: HashTokenizer(16, 128))
    from mamba_clip_tpu_torch.cli.main import main

    argv = ["--model-stage-1", "tiny", "--batch-size", str(BATCH), "--epochs", "1",
            "--train-num-samples", "16", "--val-num-samples", "8", "--lr", "1e-3",
            "--warmup", "1", "--precision", "fp32", "--logs", str(tmp_path), "--workers", "1",
            "--log-every-n-steps", "10", "--force-image-size", str(IMAGE),
            "--save-most-recent", "--num-classes", "2", "--synthetic-data", "--device", "cpu",
            "--quant", "int8_delayed"]
    with _log_lines() as lines:
        m1 = main(argv + ["--stage", "1"])
        m2 = main(argv + ["--stage", "2", "--name", "stage2"])
    assert built == ["int8_delayed", "int8_delayed"]
    assert np.isfinite(m1["val_loss"]) and np.isfinite(m2["val_loss"])
    assert not any("missing loss-scale" in ln for ln in lines)
    run = next(d for d in os.listdir(tmp_path) if d != "stage2")
    saved = torch.load(os.path.join(tmp_path, run, "checkpoints", "stage_1_epoch_latest",
                                    "state.pt"), weights_only=True)
    assert len(saved["quant_stats"]) == 2 * 2 * 4 + 2 * 2 * 4 + 2  # blocks x Denses + patch
    assert not any("amax" in k for k in saved["batch_stats"])
    for q in ("int8", "int8_fwd"):
        m = main(argv[:-1] + [q, "--stage", "1", "--name", f"aqt_{q}"])
        assert np.isfinite(m["val_loss"]) and built[-1] == q
        saved = torch.load(os.path.join(tmp_path, f"aqt_{q}", "checkpoints",
                                        "stage_1_epoch_latest", "state.pt"), weights_only=True)
        assert not saved.get("quant_stats")
    # JAX's stage 2: the state it builds holds no quant collection
    from flax.errors import ScopeCollectionNotFound
    from mamba_clip_tpu.models.heads import ClipClassifier as JClassifier

    jc = JClassifier(clip=_jax_clip("int8_delayed"), num_classes=2)
    img, tok = np.zeros((2, IMAGE, IMAGE, 3), np.float32), np.zeros((2, 16), np.int32)
    shapes = jax.eval_shape(lambda: jc.init(jax.random.PRNGKey(0), img, tok))
    with pytest.raises(ScopeCollectionNotFound, match='collection "quant"'):
        jax.eval_shape(lambda p: jc.apply({"params": p}, img, tok, deterministic=False,
                                          rngs={"dropout": jax.random.PRNGKey(0)}),
                       shapes["params"])


def test_checkpoint_round_trip_of_the_delayed_state(tmp_path, clip_params, quant_states):
    variables = _variables(clip_params, quant_states, "int8_delayed")
    args = _args("int8_delayed")
    model = _port_clip("int8_delayed")
    load_jax_variables(model, variables)
    tx = build_optimizer(args, None)
    state = ttrain.create_train_state(model, tx)
    with torch.no_grad():
        for v in tq.delayed_scales(model).values():
            v.add_(1.25)  # distinguishable from a fresh init
    bumped = {k: v.clone() for k, v in tq.delayed_scales(model).items()}
    path = tckpt.save_checkpoint(str(tmp_path), state, epoch=1, name="q")
    fresh = _port_clip("int8_delayed")
    load_jax_variables(fresh, variables)
    restored, epoch = tckpt.load_checkpoint(path, ttrain.create_train_state(fresh, tx))
    assert epoch == 1
    for k, v in tq.delayed_scales(fresh).items():
        assert torch.equal(v, bumped[k]), k
    # a checkpoint written without the state (another mode): the rest loads,
    # this run's scales stay, with JAX's warning
    plain = _port_clip(None)
    load_jax_variables(plain, {"params": clip_params})
    p2 = tckpt.save_checkpoint(str(tmp_path), ttrain.create_train_state(plain, tx), 2, name="p")
    fresh2 = _port_clip("int8_delayed")
    load_jax_variables(fresh2, variables)
    before = {k: v.clone() for k, v in tq.delayed_scales(fresh2).items()}
    with _log_lines() as lines:
        tckpt.load_checkpoint(p2, ttrain.create_train_state(fresh2, tx))
    assert any("is missing loss-scale and/or quant state; starting those fresh" in ln
               for ln in lines)
    assert all(torch.equal(v, before[k]) for k, v in tq.delayed_scales(fresh2).items())
    # the delayed state is not a batch statistic: the stage-2 load takes none
    tckpt.load_params_only(path, plain)


@pytest.mark.parametrize("quant", ["int8_fast_attn", "int8_delayed_attn"])
def test_flash_with_an_attn_mode_refuses_as_jax(quant):
    small = dict(image_size=32, context_length=16, vocab_size=128)
    with pytest.raises(ValueError) as want:
        jclip.build_clip("biomedclip", quant=quant, attn_flash=True, **small)
    with pytest.raises(ValueError) as got:
        tclip.build_clip("biomedclip", quant=quant, attn_flash=True, **small)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("quant", ["int8_fast", "int8_delayed", "int8_serve"])
def test_rounding_point_is_after_the_cast(quant):
    """A Dense under bf16 compute quantizes the weight cast to bf16, as
    Flax's Dense casts before its dot: the port's ``_linear`` equals JAX's
    ``nn.Dense(dtype=bf16, dot_general_cls=...)`` bit for bit, and
    quantizing the fp32 master weights instead would not."""
    rs = np.random.RandomState(11)
    x = rs.standard_normal((3, 5, 48)).astype(np.float32)
    kernel = (rs.standard_normal((48, 40)) * 0.1).astype(np.float32)
    bias = (rs.standard_normal(40) * 0.1).astype(np.float32)
    dense = fnn.Dense(40, dtype=jnp.bfloat16, dot_general_cls=jquant.make_dot_general_cls(quant))
    v = {"params": {"kernel": kernel, "bias": bias}}
    if quant == "int8_delayed":
        v["quant"] = {"Int8DelayedDotGeneral_0": {
            "amax_lhs": np.float32(0.9 * np.abs(x).max()),
            "amax_rhs": np.float32(np.abs(kernel).max())}}
    want = np.asarray(jax.jit(lambda vv, a: dense.apply(vv, a))(v, x).astype(jnp.float32))
    layer = tq.inject(torch.nn.Linear(48, 40), tquant.make_dot_general_cls(quant))
    load_jax_variables(layer, v)
    with torch.no_grad():
        got = _linear(torch.from_numpy(x), layer, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the fp32 weights quantize to other int8 values: the check above decides
    w32 = torch.from_numpy(kernel)
    w16 = w32.to(torch.bfloat16)
    assert not torch.equal(tq._quantize(w32, tq._absmax_scale(w32)),
                           tq._quantize(w16, tq._absmax_scale(w16)))


MM_SERVE = dict(image_size=IMAGE, staging_size=STAGING)


def _jax_serve_operand(w, dtype):
    """JAX's ``int8_serve_dot`` quantization of the port weight ``w`` [N, K]:
    the [K, N] kernel cast to ``dtype`` as the Dense casts it, its int8
    values and per-column scales, jitted as the steps run."""
    kernel = jnp.asarray(w.numpy().T).astype(dtype)
    sr = jax.jit(jq._absmax_scale_cols)(kernel)
    return np.asarray(jax.jit(jq._quantize)(kernel, sr)), np.asarray(sr)


@pytest.mark.parametrize("precision", ["amp", "fp32"])
def test_compressed_int8_serve_artifact_round_trips_bit_for_bit(tmp_path, precision):
    """A compressed ``int8_serve`` artifact of medmamba: each kernel that an
    int8_serve dot consumes is stored as that dot's own int8 values and
    per-output-channel scales, bit for bit JAX's ``int8_serve_dot``
    quantization of the kernel as the Dense casts it (JAX's per-column
    scales of a [K, N] kernel, the rows of the port's [N, K] weight).
    Dequantized on load and cast again, they requantize to the same int8
    values (JAX's lemma, tests/test_serving.py) and, under amp, to the same
    scales: ``classify`` from the artifact is then bit for bit
    ``make_serving_fns`` on the uncompressed weights (fp32: the scales come
    back within an ulp, the probabilities within 1e-6). JAX's own
    compression, of the fp32 kernel, requantizes to other int8 values
    under bf16 compute."""
    jdt = {"amp": jnp.bfloat16, "fp32": jnp.float32}[precision]
    model, fns, meta = make_serving_fns("medmamba", quant="int8_serve", device="cpu",
                                        precision=precision,
                                        generator=torch.Generator().manual_seed(0), **MM_SERVE)
    out = str(tmp_path / "art")
    man = export_serving(out, "medmamba", variables=model.state_dict(), quant="int8_serve",
                         compress_weights=True, precision=precision, **MM_SERVE)
    assert man["quant"] == "int8_serve" and man["weights"] == "int8_cols"
    stored = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    served_keys = [k[: -len(f".{_COMPRESS_KEY}")] for k in stored
                   if k.endswith(f".{_COMPRESS_KEY}")]
    assert len(served_keys) >= 4
    jax_moved = 0
    for key in served_keys:
        w = model.state_dict()[key]
        assert tq.injected(model.get_submodule(key.rsplit(".", 1)[0])) is not None, key
        qr, sr = _jax_serve_operand(w, jdt)
        np.testing.assert_array_equal(stored[f"{key}.{_COMPRESS_KEY}"].numpy(), qr.T,
                                      err_msg=key)
        np.testing.assert_array_equal(stored[f"{key}.{_COMPRESS_KEY}.scale"].numpy()[:, 0], sr,
                                      err_msg=key)
        # dequantized (the load), the dot quantizes to the stored values
        deq = torch.from_numpy(qr.T.astype(np.float32) * sr[:, None])
        q2, s2 = _jax_serve_operand(deq, jdt)
        np.testing.assert_array_equal(q2, qr, err_msg=key)
        np.testing.assert_allclose(s2, sr, rtol=0 if precision == "amp" else 1e-6)
        # JAX's compression of the fp32 kernel, dequantized and cast
        jc = jax_compress_params({"k": {"kernel": w.numpy().T}}, min_elems=0)["k"]["kernel"]
        jdeq = torch.from_numpy((jc["__int8_cols__"] * jc["scale"]).T.astype(np.float32))
        jax_moved += int(np.sum(_jax_serve_operand(jdeq, jdt)[0] != qr))
    assert (jax_moved > 0) == (precision == "amp"), jax_moved
    served = load_serving(out, device="cpu")
    x = np.random.RandomState(3).randint(0, 256, (5, STAGING, STAGING, 3), dtype=np.uint8)
    got, want = served["classify"](x), fns["classify"](model, x)
    if precision == "amp":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
