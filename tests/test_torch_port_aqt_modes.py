"""The aqt modes (``--quant int8``, ``--quant int8_fwd``) through the port's
train steps, pipeline and serving, against the JAX package on the CPU.

The models, batches and steps are those of ``test_torch_port_quant_modes.py``
(a small CLIP and a small medmamba classifier, parameter values from a
numpy seed over ``jax.eval_shape`` of the init, fp32, a deterministic
crop, AdamW with clipping), with the aqt dots in the towers' Dense layers.
The dots themselves are held against the aqt library bit for bit in
``test_torch_port_aqt.py``; what differs here is the fp32 arithmetic around
them, and with it, now and then, one int8 rounding. So the envelope is that
file's: the loss of each of three steps within rel 2e-3 (the classifier's,
with BatchNorm and the scan carrying a flip further, 2e-2), the grad norm
within rel 2e-2. ``int8`` also quantizes the backward, with a scale a row
or a column of the cotangent: there an ulp in one absmax moves the scale
of a whole column and flips every entry of it that sits near a rounding
boundary, so its grad norm is held at rel 5e-2 (measured: 3.8e-4 at the
first step, then 3.1e-2, then 4.9e-3; ``int8_fwd`` 8.2e-3 at most), and
at the first step, before the trajectories part, at 1e-3 for both.

Also: the small CLIP's eval forward within 1e-5 of JAX's; both stages
through ``pipeline()`` under ``--quant int8``; the full-width medmamba
classifier's ``make_serving_fns`` and an exported artifact under
``int8_fwd``. At full width an int8 flip travels through every later layer:
JAX's own jitted and eager ``classify`` part by 1.8e-2 in a probability on
the inputs below (unquantized, the port is within 4.5e-6 of the jitted
one), so the port is held at 5e-2 of the jitted one, and the artifact, bit
for bit, at the module it was exported from. Unlike ``int8_serve``, an aqt
artifact is not claimed to requantize exactly: it stores the fp32 weights
and the dot quantizes them on every call.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.models.vssm import VSSM as JaxVSSM
from mamba_clip_tpu.ops import quant as jquant
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.serving import make_serving_fns as jax_make_serving_fns
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import pipeline as tpipe
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models.vssm import VSSM
from mamba_clip_tpu_torch.ops import quant as tquant
from mamba_clip_tpu_torch.optim import build_optimizer
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.serving import export_serving, load_serving, make_serving_fns
from mamba_clip_tpu_torch.utils.precision import get_policy
from test_torch_port_artifacts import _shaped_init
from test_torch_port_quant_modes import (AUG, BATCH, GNORM_REL, IMAGE, INIT_IMAGE, INIT_TOKENS,
                                         LOSS_REL, MM_LOSS_REL, VSSM_KW, _args, _batches,
                                         _jax_clip, _Pair, _port_clip, _rel, _shaped_params,
                                         _tokens)

torch.set_num_threads(1)

AQT = ("int8", "int8_fwd")
GNORM = {"int8": 5e-2, "int8_fwd": GNORM_REL}
FIRST_GNORM_REL = 1e-3


@pytest.fixture(scope="module")
def clip_params():
    return _shaped_params(_jax_clip(), 0, INIT_IMAGE, INIT_TOKENS)["params"]


@pytest.mark.parametrize("quant", AQT)
def test_forward_matches_jax(quant, clip_params):
    """The small CLIP's eval forward: unit features within 1e-5 of JAX's."""
    jm, model = _jax_clip(quant), _port_clip(quant)
    load_jax_variables(model, {"params": clip_params})
    model.eval()
    img = np.random.RandomState(2).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    tok = _tokens(np.random.RandomState(3), 4)
    want = jax.jit(lambda v, a, b: jm.apply(v, image=a, text=b))({"params": clip_params},
                                                                 img, tok)
    with torch.no_grad():
        got = model(image=torch.from_numpy(img), text=torch.from_numpy(tok))
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   rtol=0, err_msg=f"{quant} {key}")


@pytest.mark.parametrize("quant", AQT)
def test_three_contrastive_steps_match_jax(quant, clip_params):
    pair = _Pair(quant, {"params": clip_params})
    assert any(type(m).__name__.startswith("AqtInt8") for m in pair.model.modules())
    for i, batch in enumerate(_batches(3)):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= LOSS_REL, \
            (quant, i, got, want)
        tol = FIRST_GNORM_REL if i == 0 else GNORM[quant]
        assert _rel(got["grad_norm"], want["grad_norm"]) <= tol, (quant, i, got, want)


@pytest.mark.parametrize("quant", AQT)
def test_three_medmamba_classifier_steps_match_jax(quant):
    """Three CE steps of the small medmamba classifier (BatchNorm in
    training mode) under the mode: the loss, the grad norm and the running
    statistics."""
    dg_j, dg_t = jquant.make_dot_general_cls(quant), tquant.make_dot_general_cls(quant)
    jm = JaxVSSM(scan_impl="xla", dot_general_cls=dg_j, **VSSM_KW)
    v = _shaped_params(JaxVSSM(scan_impl="xla", **VSSM_KW), 4, INIT_IMAGE)
    model = VSSM(dot_general_cls=dg_t, **VSSM_KW)
    load_jax_variables(model, v)
    args = _args(quant)
    pol, tpol = jax_get_policy("fp32"), get_policy("fp32")
    jsched, tsched = jax_create_schedule(args, 10), create_schedule(args, 10)
    jtx = jax_build_optimizer(args, jsched)
    jstate = jtrain.create_train_state(v["params"], jtx, v["batch_stats"], policy=pol)
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
        assert _rel(float(tmet["grad_norm"]), float(jmet["grad_norm"])) <= GNORM[quant], i
    stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, jstate.batch_stats)})
    buffers = dict(model.named_buffers())
    for name, want in stats.items():
        err = np.abs(buffers[name].numpy() - want.numpy()).max() / np.abs(want.numpy()).max()
        assert err <= MM_LOSS_REL, (name, err)


def test_pipeline_runs_both_stages_under_int8(tmp_path, monkeypatch):
    """``--quant int8`` through the CLI's ``main()``: stage 1 trains the
    small CLIP with the aqt dots, stage 2 finds it and trains the
    classifier over it; the checkpoints carry no quantization state."""
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
            "--quant", "int8"]
    m1 = main(argv + ["--stage", "1"])
    m2 = main(argv + ["--stage", "2", "--name", "stage2"])
    assert built == ["int8", "int8"]
    assert np.isfinite(m1["val_loss"]) and np.isfinite(m2["val_loss"])
    assert 0.0 <= m2["partial_auc"] <= 0.2
    for run, stage in ((next(d for d in os.listdir(tmp_path) if d != "stage2"), 1),
                       ("stage2", 2)):
        saved = torch.load(os.path.join(tmp_path, run, "checkpoints",
                                        f"stage_{stage}_epoch_latest", "state.pt"),
                           weights_only=True)
        assert not saved.get("quant_stats")


def test_serving_and_artifact_under_int8_fwd_match_jax(tmp_path):
    """Full-width medmamba at image 32, fp32: the port's ``classify`` under
    ``int8_fwd`` against JAX's jitted one on the same weights (the module
    docstring's bound), and the exported artifact, reloaded, bit for bit the
    module it came from."""
    kw = dict(quant="int8_fwd", precision="fp32", image_size=32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", _shaped_init(6))
        _, jvars, jfns, _ = jax_make_serving_fns("medmamba", scan_impl="xla", **kw)
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    model, fns, meta = make_serving_fns("medmamba", device="cpu", **kw)
    load_jax_variables(model, jvars)
    x = np.random.RandomState(7).randint(0, 256, (3, meta["staging_size"],
                                                  meta["staging_size"], 3), np.uint8)
    got = fns["classify"](model, x)
    want = np.asarray(jax.jit(jfns["classify"])(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)
    out = str(tmp_path / "art")
    man = export_serving(out, "medmamba", variables=model.state_dict(), **kw)
    assert man["quant"] == "int8_fwd" and man["weights"] == "raw"
    served = load_serving(out, device="cpu")
    assert torch.equal(served["classify"](x), got)
