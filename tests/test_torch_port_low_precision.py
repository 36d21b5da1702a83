"""Low-precision parameters (``--precision bf16|pure_bf16|pure_fp16``) in the
port against the JAX package, on the CPU.

Under these policies the parameters, and so the gradients and the Adam
moments, are bf16 or fp16, and each layer promotes a parameter to its
compute type at its use, as Flax's ``promote_dtype`` does. Held here, each
piece with its tolerance (the train steps in
``tests/test_torch_port_low_precision_steps.py``, the fp16 flash interior
in ``tests/test_torch_port_flash_fp16.py``):

- the AdamW update on bf16 and fp16 leaves (clipping active and not,
  weight decay on the 2-d leaf) bit for bit against optax 0.2.6 run op by
  op, whose code fixes the rounding points; bf16 also against the jitted
  update. (Jitted, XLA's CPU compiler rewrites fp16 and fp32 chains, e.g.
  ``(a / b) / c`` into ``a / (b * c)``, which moves an ulp; bf16 it leaves
  alone.) The fp32 gradients of the ``pure_fp16`` step (unscaled by an fp32
  scale) on fp16 leaves make fp32 moments, bit for bit. fp16 gradients at
  the default eps 1e-8, which rounds to 0 in fp16, give optax's inf and NaN
  entries, bit for bit;
- the scan wrapper with bf16 ``A``, ``D`` and ``delta_bias``, in both of its
  branches (the CUDA branch's casts with the plain loops in place of the
  kernels): y within 1e-5 relative of JAX's ``selective_scan_tm`` (its
  lax.scan reference) and each of the seven gradients in its operand's
  type, within one rounding of that type of the largest entry;
- the forwards of a tiny ViT + BERT CLIP, a tiny VSSM-towered CLIP and a
  ``ClipClassifier`` under ``pure_bf16`` against JAX's within 2^-5 of the
  largest entry: the two frameworks sum the bf16 GEMMs in other orders and
  round the activations at the same points, so a few bf16 ulps move, the
  envelope ``tests/test_torch_port_towers.py`` holds amp to (measured on
  these weights: 0.9-1.7e-2 under pure_bf16, 0.5-1.1e-2 under amp);
- ``--quant int8_fast`` under ``pure_bf16``: the int8 dots quantize the
  weights cast to the compute type, so a bf16 weight goes in as it is;
  three steps within the envelope of the unquantized steps;
- ``convert.py`` carries a JAX bf16 train state into the port and back bit
  for bit; a bf16 (and a pure_fp16) checkpoint resumes bit for bit;
- a bf16 ``export_serving`` artifact, raw and int8-compressed, loads and
  answers bit for bit as the model it was exported from, its int8 values
  JAX's ``compress_params`` of the same bf16 weights.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from mamba_clip_tpu import train as jtrain
from mamba_clip_tpu.config import Args as JArgs
from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_tcfg
from mamba_clip_tpu.models import clip as jclip
from mamba_clip_tpu.models import heads as jheads
from mamba_clip_tpu.models import text_bert as jbert
from mamba_clip_tpu.models import vit as jvit
from mamba_clip_tpu.models.vssm import VSSM as JaxVSSM
from mamba_clip_tpu.ops import quant as jquant
from mamba_clip_tpu.ops.selective_scan import selective_scan_tm as jax_scan_tm
from mamba_clip_tpu.optim import build_optimizer as jax_build_optimizer
from mamba_clip_tpu.schedules import create_schedule as jax_create_schedule
from mamba_clip_tpu.serving import compress_params as jax_compress_params
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch import checkpoint as tckpt
from mamba_clip_tpu_torch import train as ttrain
from mamba_clip_tpu_torch.convert import (flax_arrays, load_jax_variables, state_dict_from_jax,
                                          train_state_from_jax)
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config
from mamba_clip_tpu_torch.models import VSSM
from mamba_clip_tpu_torch.models import clip as tclip
from mamba_clip_tpu_torch.models import heads as theads
from mamba_clip_tpu_torch.models import text_bert as tbert
from mamba_clip_tpu_torch.models import vit as tvit
from mamba_clip_tpu_torch.ops import quant as tquant
from mamba_clip_tpu_torch.optim import build_optimizer
from mamba_clip_tpu_torch.schedules import create_schedule
from mamba_clip_tpu_torch.serving import export_serving, load_serving, make_serving_fns
from mamba_clip_tpu_torch.utils.precision import get_policy

# the module: the package exports the function ``selective_scan`` under its name
tscan = importlib.import_module("mamba_clip_tpu_torch.ops.selective_scan")

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=16, width=32, depth=2, num_heads=4, embed_dim=16)
BERT = dict(vocab_size=128, context_length=16, width=32, depth=2, num_heads=4, embed_dim=16)
VSSM_KW = dict(depths=(1, 1), dims=(32, 64), drop_path_rate=0.0)
AUG = {"scale": (1.0, 1.0), "ratio": (1.0, 1.0), "hflip": 0.0, "re_prob": 0.0}
IMAGE, STAGING, BATCH = 32, 40, 8
FWD_REL = 2.0**-5            # a pure_bf16 forward against JAX's, of the largest entry
LOSS_REL, GNORM_REL = 1e-2, 5e-2
TYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp16": (jnp.float16, torch.float16)}


def _tensor(a):
    """A numpy or JAX array as a tensor of its own type (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _max_rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

ADAM_CASES = {  # (leaf type, gradient type, clip norm, eps, jitted JAX too)
    "bf16": ("bf16", "bf16", None, 1e-8, True),
    "bf16_clipped": ("bf16", "bf16", 0.05, 1e-8, True),
    "bf16_clip_idle": ("bf16", "bf16", 100.0, 1e-8, True),
    "fp16": ("fp16", "fp16", None, 1e-4, False),
    "fp16_clipped": ("fp16", "fp16", 0.05, 1e-4, False),
    "fp16_fp32_grads": ("fp16", "fp32", None, 1e-8, False),
    # 1e-8 rounds to 0 in fp16 and (1 - b2) g^2 underflows for small |g|:
    # optax's own update is then inf or NaN there, and so is the port's
    "fp16_default_eps": ("fp16", "fp16", None, 1e-8, False),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adamw_update_is_optax_bit_for_bit(case):
    leaf, grad, clip, eps, jitted = ADAM_CASES[case]
    jdt = TYPES[leaf][0]
    gdt = jnp.float32 if grad == "fp32" else TYPES[grad][0]
    args = JArgs(lr=1e-3, beta1=0.9, beta2=0.999, eps=eps, wd=0.05, grad_clip_norm=clip)
    rs = np.random.default_rng(len(case))
    params = {"w": jnp.asarray(rs.normal(size=(48, 32)), jnp.float32).astype(jdt),
              "b": jnp.asarray(rs.normal(size=(32,)), jnp.float32).astype(jdt)}
    # a schedule in fp32, as JAX's and the port's take it
    jsched = lambda c: jnp.float32(1e-3) * (jnp.asarray(c, jnp.float32) + 1) / 3  # noqa: E731
    tsched = lambda c: float(np.float32(1e-3) * (np.float32(c) + 1) / np.float32(3))  # noqa: E731
    jtx, ttx = jax_build_optimizer(args, jsched), build_optimizer(args, tsched)
    update = jax.jit(jtx.update) if jitted else jtx.update
    runs = {"eager": (params, jtx.init(params))}
    if jitted:
        runs["jit"] = (params, jtx.init(params))
    tp = {k: _tensor(v) for k, v in params.items()}
    ts = ttx.init(tp)
    for step in range(3):
        g = {k: (jnp.asarray(rs.normal(size=v.shape), jnp.float32) * 0.01 * (step + 1))
             .astype(gdt) for k, v in params.items()}
        if case == "fp16_default_eps":  # entries whose squares vanish in fp16
            g["b"] = g["b"].at[:4].set(jnp.asarray([1e-3, 0.0, 0.5, 1e-5], gdt))
        tu, ts = ttx.update({k: _tensor(v) for k, v in g.items()}, ts, tp)
        with torch.no_grad():
            for k in tp:
                tp[k].add_(tu[k])
        for mode, (p, s) in runs.items():
            u, s = (update if mode == "jit" else jtx.update)(g, s, p)
            p = optax.apply_updates(p, u)
            runs[mode] = (p, s)
            adam = next(x for x in s if hasattr(x, "mu"))
            for k in p:
                assert tp[k].dtype == TYPES[leaf][1], (mode, k)
                assert np.array_equal(_f32(tp[k]), _f32(p[k]), equal_nan=True), \
                    (case, mode, step, k)
                for name in ("mu", "nu"):
                    mine, theirs = getattr(ts, name)[k], getattr(adam, name)[k]
                    assert str(mine.dtype) == f"torch.{jnp.dtype(theirs.dtype).name}", name
                    assert np.array_equal(_f32(mine), _f32(theirs), equal_nan=True), \
                        (case, mode, step, name)
    finite = all(np.isfinite(_f32(t)).all() for t in tp.values())
    assert finite == (case != "fp16_default_eps"), case


@pytest.mark.parametrize("leaf", ["bf16", "fp16"])
def test_logit_scale_clamp_of_a_low_precision_leaf_is_jax(leaf):
    """The train step's clamp to [0, ln 100] on a bf16 or fp16 log scale:
    every value of the type from -1 to 6 clamps to JAX's ``jnp.clip``."""
    jdt, tdt = TYPES[leaf]
    x = np.unique(np.asarray(jnp.linspace(-1.0, 6.0, 20001).astype(jdt)))
    want = np.asarray(jnp.clip(jnp.asarray(x), 0.0, jclip.LOGIT_SCALE_MAX), np.float32)
    got = torch.nn.Parameter(_tensor(x))
    tclip.clamp_logit_scale({"logit_scale": got})
    assert got.dtype == tdt and np.array_equal(_f32(got), want)


# ---------------------------------------------------------------------------
# the scan wrapper with low-precision parameters
# ---------------------------------------------------------------------------


def _plain_kernels(monkeypatch):
    """The scan wrapper's CUDA branch on the CPU: its casts and copies as
    they are, with the plain loops standing in for the two kernels."""
    def fwd(u, delta, A, B, C, D, bias, softplus, with_hck=False):
        return tscan._scan_tm_plain(u, delta, A, B, C, D, bias, softplus, return_hck=with_hck)

    monkeypatch.setattr(tscan, "selective_scan_fwd", fwd)
    monkeypatch.setattr(tscan, "selective_scan_bwd", tscan._scan_tm_plain_bwd)


@pytest.mark.parametrize("impl", ["plain", "cuda_branch"])
@pytest.mark.parametrize("act", ["bf16", "fp16"])
def test_scan_with_bf16_parameters_matches_jax(impl, act, monkeypatch):
    """The SS2D's scan under pure_bf16 (bf16 activations) and, for fp16
    activations, a bf16 ``A``/``D``/bias beside them: y within 1e-5
    relative, each gradient in its operand's type within one rounding of
    that type of the largest entry."""
    Bsz, G, L, DG, N = 2, 4, 20, 8, 16
    rs = np.random.RandomState(3)
    jact, tact = TYPES[act]
    u, delta, B, C = (rs.randn(*s).astype(np.float32) * sc for s, sc in (
        ((Bsz, G, L, DG), 1.0), ((Bsz, G, L, DG), 0.5), ((Bsz, G, L, N), 1.0),
        ((Bsz, G, L, N), 1.0)))
    a_logs = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (G * DG, 1)))
    D, bias = rs.randn(G * DG).astype(np.float32), rs.randn(G * DG).astype(np.float32) * 0.1
    w = rs.randn(Bsz, G, L, DG).astype(np.float32)
    acts = [jnp.asarray(x).astype(jact) for x in (u, delta, B, C)]
    params = [jnp.asarray(x).astype(jnp.bfloat16) for x in (a_logs, D, bias)]

    def jloss(u_, d_, B_, C_, al, D_, b_):
        y = jax_scan_tm(u_, d_, -jnp.exp(al), B_, C_, D=D_, delta_bias=b_,
                        delta_softplus=True, impl="xla")
        return jnp.sum(y * w), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(7)), has_aux=True))(
        *acts, *params)
    if impl == "cuda_branch":
        _plain_kernels(monkeypatch)
    leaves = [_tensor(x).requires_grad_() for x in acts + params]
    tu, td, tB, tC, tal, tD, tb = leaves
    ty = tscan.selective_scan_tm(tu, td, -torch.exp(tal), tB, tC, D=tD, delta_bias=tb,
                                 delta_softplus=True,
                                 impl="cuda" if impl == "cuda_branch" else "plain")
    tg = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), leaves)
    assert ty.dtype == torch.float32 and _max_rel(ty, jy) <= 1e-5
    for name, g, x, leaf in zip(("du", "ddelta", "dB", "dC", "dA_logs", "dD", "dbias"),
                                tg, jg, leaves):
        assert g.dtype == leaf.dtype, name
        tol = 2.0**-8 if g.dtype == torch.bfloat16 else 2.0**-11
        assert _max_rel(g, x) <= tol, (name, _max_rel(g, x))


# ---------------------------------------------------------------------------
# the models' forwards under pure_bf16
# ---------------------------------------------------------------------------


def _shaped_params(module, seed, *inputs):
    """Flax variables with the init's shapes and values from a numpy seed
    (fp32; BatchNorm's statistics where the module has them)."""
    rs = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    shapes = {k: v for k, v in shapes.items() if k != "quant"}

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "A_logs":
            return np.log(np.broadcast_to(np.arange(1, s.shape[-1] + 1, dtype=np.float32),
                                          s.shape)).copy()
        std = 1 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel" else 0.1
        return (std * rs.standard_normal(s.shape, np.float32)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tokens(rs, n=BATCH):
    ids = rs.randint(4, 128, (n, 16)).astype(np.int32)
    ids[:, 0] = 2
    for i, k in enumerate(rs.randint(3, 17, n)):
        ids[i, k:] = 0
    return ids


_INIT_RS = np.random.RandomState(5)
INIT_IMAGE = _INIT_RS.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
INIT_TOKENS = _tokens(_INIT_RS, 2)


def _jax_clip(cdt, tower="vit", quant=None):
    kw = {} if quant is None else dict(dot_general_cls=jquant.make_dot_general_cls(quant))
    visual = (jvit.VisionTransformer(**VIT, dtype=cdt, **kw) if tower == "vit" else
              jclip.VssmTower(vssm=JaxVSSM(num_classes=0, dtype=cdt, scan_impl="xla",
                                           **VSSM_KW), embed_dim=16))
    return jclip.ClipModel(visual=visual, text=jbert.TextBert(**BERT, dtype=cdt, **kw))


def _port_clip(cdt, tower="vit", quant=None):
    kw = {} if quant is None else dict(dot_general_cls=tquant.make_dot_general_cls(quant))
    visual = (tvit.VisionTransformer(**VIT, dtype=cdt, **kw) if tower == "vit" else
              tclip.VssmTower(VSSM(num_classes=0, dtype=cdt, **VSSM_KW), embed_dim=16))
    return tclip.ClipModel(visual, tbert.TextBert(**BERT, dtype=cdt, **kw))


def _low(variables, jdt):
    """The pipeline's cast of a variable tree: ``params`` only (BatchNorm's
    statistics stay fp32)."""
    return dict(variables, params=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt),
                                                         variables["params"]))


@pytest.fixture(scope="module")
def clip_vars():
    return {tower: _shaped_params(_jax_clip(jnp.float32, tower), i, INIT_IMAGE, INIT_TOKENS)
            for i, tower in enumerate(("vit", "vssm"))}


@pytest.mark.parametrize("what", ["vit_clip", "vssm_clip", "clip_classifier"])
def test_pure_bf16_forward_matches_jax(what, clip_vars):
    tower = "vssm" if what == "vssm_clip" else "vit"
    jm, model = _jax_clip(jnp.bfloat16, tower), _port_clip(torch.bfloat16, tower)
    variables = clip_vars[tower]
    if what == "clip_classifier":
        jm = jheads.ClipClassifier(clip=jm, num_classes=2)
        model = theads.ClipClassifier(model, num_classes=2)
        head = _shaped_params(jm, 7, INIT_IMAGE, INIT_TOKENS)["params"]
        variables = {"params": dict(head, clip=variables["params"])}
    variables = _low(variables, jnp.bfloat16)
    load_jax_variables(model, variables)
    get_policy("pure_bf16").cast_params(model).eval()
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers() if b.is_floating_point())
    rs = np.random.RandomState(2)
    img = rs.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    tok = _tokens(rs, 4)
    if what == "clip_classifier":
        want = {"logits": jax.jit(lambda v, a, b: jm.apply(v, a, b))(variables, img, tok)}
        with torch.no_grad():
            got = {"logits": model(torch.from_numpy(img), torch.from_numpy(tok))}
    else:
        want = jax.jit(lambda v, a, b: jm.apply(v, image=a, text=b))(variables, img, tok)
        with torch.no_grad():
            got = model(image=torch.from_numpy(img), text=torch.from_numpy(tok))
    for key, x in want.items():
        assert got[key].dtype == (torch.float32 if x.dtype == jnp.float32 else torch.bfloat16)
        assert _max_rel(got[key], x) <= FWD_REL, (what, key, _max_rel(got[key], x))


# ---------------------------------------------------------------------------
# the train steps' pieces, shared with test_torch_port_low_precision_steps.py
# ---------------------------------------------------------------------------


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


def _args(precision, eps=1e-6, quant=None):
    return JArgs(batch_size=BATCH, epochs=1, lr=1e-3, warmup=1, wd=0.05, eps=eps,
                 grad_clip_norm=1.0, precision=precision, quant=quant)


class _Pair:
    """The JAX contrastive step and the port's under one policy, from the
    same fp32 variables cast as each pipeline casts them."""

    def __init__(self, precision, variables, eps=1e-6, quant=None):
        args = _args(precision, eps, quant)
        pol, tpol = jax_get_policy(precision), get_policy(precision)
        self.jm = _jax_clip(pol.compute_dtype, quant=quant)
        self.model = _port_clip(tpol.compute_dtype, quant=quant)
        load_jax_variables(self.model, variables)
        params = variables["params"]
        if pol.param_dtype != jnp.float32:
            params = pol.cast_to_param(params)
            tpol.cast_params(self.model)
        jsched, tsched = jax_create_schedule(args, 10), create_schedule(args, 10)
        jtx = jax_build_optimizer(args, jsched)
        self.jstate = jtrain.create_train_state(params, jtx, {}, policy=pol)
        self.jstep = jax.jit(jtrain.make_clip_train_step(
            self.jm, jtx, pol, args, jax_tcfg(AUG, IMAGE, is_train=True), jsched))
        ttx = build_optimizer(args, tsched)
        self.tstate = ttrain.create_train_state(self.model, ttx, policy=tpol)
        self.tstep = ttrain.make_clip_train_step(
            self.model, ttx, tpol, args, get_transform_config(AUG, IMAGE, is_train=True), tsched)

    def step(self, batch):
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.PRNGKey(0))
        self.tstate, tm = self.tstep(
            self.tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        return {k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}

    def types(self):
        """({leaf: the port's parameter, mu and nu types}, JAX's)."""
        adam = next(x for x in jax.tree_util.tree_leaves(
            self.jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))
        trees = [state_dict_from_jax({"params": t})
                 for t in (self.jstate.params, adam.mu, adam.nu)]
        want = {k: tuple(t[k].dtype for t in trees) for k in trees[0]}
        named, opt = dict(self.model.named_parameters()), self.tstate.opt_state
        got = {k: (named[k].dtype, opt.mu[k].dtype, opt.nu[k].dtype) for k in named}
        return got, want


def test_int8_fast_under_pure_bf16_matches_jax(clip_vars):
    """The native int8 dots quantize the weights cast to the compute type
    (``_linear``), so a bf16 weight goes in as it is: three steps within
    the unquantized envelope."""
    pair = _Pair("pure_bf16", clip_vars["vit"], quant="int8_fast")
    for i, batch in enumerate(_batches(3, seed=2)):
        got, want = pair.step(batch)
        assert np.isfinite(got["loss"]) and _rel(got["loss"], want["loss"]) <= LOSS_REL, \
            (i, got, want)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= GNORM_REL, (i, got, want)
    mine, theirs = pair.types()
    assert mine == theirs


# ---------------------------------------------------------------------------
# conversion, checkpoints and serving artifacts
# ---------------------------------------------------------------------------


def test_convert_carries_a_jax_bf16_train_state_both_ways(clip_vars):
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                    clip_vars["vit"]["params"])
    rs = np.random.default_rng(11)
    mu, nu = (jax.tree_util.tree_map(
        lambda x: jnp.asarray(rs.normal(size=x.shape) * sc, jnp.bfloat16), params)
        for sc in (1e-3, 1e-6))
    args = _args("pure_bf16")
    model = get_policy("pure_bf16").cast_params(_port_clip(torch.bfloat16))
    state = train_state_from_jax(model, build_optimizer(args, None), params=params, mu=mu,
                                 nu=nu, count=3, step=3)
    want_p = state_dict_from_jax({"params": params})
    for name, t in dict(model.named_parameters()).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want_p[name]), name
    for tree, got in ((mu, state.opt_state.mu), (nu, state.opt_state.nu)):
        want = state_dict_from_jax({"params": tree})
        assert all(got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k])
                   for k in want)
    # and back: Flax layouts, bf16 bit for bit
    flat = {"/".join(p.key for p in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    back = flax_arrays(model)
    assert sorted(back) == sorted(flat)
    for k, x in flat.items():
        assert back[k].dtype == ml_dtypes.bfloat16 and back[k].shape == x.shape, k
        assert np.array_equal(back[k].view(np.int16), x.view(np.int16)), k
    # a file for load_torch_clip stays fp32, as tools/convert_weights.py writes it
    assert all(a.dtype == np.float32 for a in flax_arrays(model, np.float32).values())


@pytest.mark.parametrize("precision", ["pure_bf16", "pure_fp16"])
def test_low_precision_checkpoint_resumes_bit_for_bit(precision, clip_vars, tmp_path):
    """Two steps, a checkpoint after the first: a fresh state loaded from it
    takes the second step to the same parameters, moments, step and loss
    scale, bit for bit; the saved tensors keep their types (under
    pure_fp16 the moments are fp32 after a step, as JAX's are)."""
    args = _args(precision, eps=1e-4)
    tpol = get_policy(precision)
    tcfg = get_transform_config(AUG, IMAGE, is_train=True)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(2, seed=3)]

    def fresh():
        model = _port_clip(tpol.compute_dtype)
        load_jax_variables(model, clip_vars["vit"])
        tpol.cast_params(model)
        tx = build_optimizer(args, create_schedule(args, 10))
        return (ttrain.create_train_state(model, tx, policy=tpol),
                ttrain.make_clip_train_step(model, tx, tpol, args, tcfg,
                                            create_schedule(args, 10)))

    state, step = fresh()
    state, _ = step(state, batches[0], 0)
    path = tckpt.save_checkpoint(str(tmp_path), state, epoch=1)
    saved = torch.load(f"{path}/{tckpt.STATE_FILE}", weights_only=True)
    assert {t.dtype for t in saved["params"].values()} == {tpol.param_dtype}
    assert {t.dtype for t in saved["opt_state"]["mu"].values()} == {
        torch.float32 if tpol.dynamic_loss_scale else tpol.param_dtype}
    state, _ = step(state, batches[1], 0)
    resumed, resumed_step = fresh()
    resumed, epoch = tckpt.load_checkpoint(path, resumed)
    resumed, _ = resumed_step(resumed, batches[1], 0)
    assert epoch == 1 and resumed.step == state.step == 2
    assert resumed.loss_scale == state.loss_scale
    a, b = dict(state.model.named_parameters()), dict(resumed.model.named_parameters())
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    for name in ("mu", "nu"):
        x, y = getattr(state.opt_state, name), getattr(resumed.opt_state, name)
        assert all(x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]) for k in x)


SERVE_VIT = dict(image_size=32, patch_size=16, width=128, depth=1, num_heads=4, embed_dim=16)
SERVE_BERT = dict(vocab_size=2048, context_length=16, width=32, depth=1, num_heads=4,
                  embed_dim=16)


def test_bf16_artifact_round_trips(monkeypatch, tmp_path):
    """A pure_bf16 state exported raw and int8-compressed (its 2-d kernels
    and tables of 2^16 entries and more), loaded back: the raw artifact's
    answers bit for bit the exporting model's, the compressed one's bit
    for bit the same model given the decompressed weights, whose int8
    values and scales are JAX's ``compress_params`` of the bf16 weights."""
    from mamba_clip_tpu_torch import serving as tserving
    from mamba_clip_tpu_torch.convert import flax_leaf_names
    from mamba_clip_tpu_torch.serving import decompress_params

    def tiny(model_name=None, dtype=torch.float32, attn_flash=False, generator=None, **kw):
        return tclip.ClipModel(
            tvit.VisionTransformer(**SERVE_VIT, dtype=dtype, attn_flash=attn_flash,
                                   generator=generator),
            tbert.TextBert(**SERVE_BERT, dtype=dtype, attn_flash=attn_flash,
                           generator=generator))

    monkeypatch.setattr(tserving, "build_clip", tiny)
    kw = dict(precision="pure_bf16", image_size=32, context_length=16, vocab_size=2048)
    model, fns, meta = make_serving_fns("tiny", is_clip=True, device="cpu", attn_impl="flash",
                                        generator=torch.Generator().manual_seed(3), **kw)
    get_policy("pure_bf16").cast_params(model)
    sd = model.state_dict()
    rs = np.random.RandomState(4)
    image = rs.randint(0, 256, (3, meta["staging_size"], meta["staging_size"], 3),
                       dtype=np.uint8)
    tokens = _tokens(rs, 3)
    for compress in (False, True):
        out = tmp_path / f"art{int(compress)}"
        manifest = export_serving(str(out), "tiny", variables=sd, is_clip=True,
                                  compress_weights=compress, **kw)
        assert manifest["precision"] == "pure_bf16"
        stored = torch.load(out / "params.pt", weights_only=True)
        loaded = load_serving(str(out), device="cpu")
        ref = model
        if compress:
            packed = [k for k in stored if k.endswith(".__int8_cols__")]
            assert packed  # the table and the MLP kernels
            names = flax_leaf_names(model)
            for key in packed:
                base = key[:-len(".__int8_cols__")]
                w = sd[base]
                want = jax_compress_params(
                    {"k": {names[base]: np.asarray(
                        jnp.asarray(_f32(w.t() if names[base] == "kernel" else w),
                                    jnp.bfloat16))}})["k"][names[base]]
                q = stored[key].t() if names[base] == "kernel" else stored[key]
                assert np.array_equal(q.numpy(), np.asarray(want["__int8_cols__"])), key
            ref, _, _ = make_serving_fns("tiny", is_clip=True, device="cpu",
                                         attn_impl="flash", **kw)
            ref.load_state_dict(decompress_params(stored), assign=True)
            ref.eval()
        else:
            assert {t.dtype for k, t in stored.items() if k in dict(
                model.named_parameters())} == {torch.bfloat16}
        assert all(p.dtype == torch.bfloat16 for p in loaded["image_embed"].args[0].parameters())
        for name, x in (("image_embed", image), ("text_embed", tokens)):
            got, want = loaded[name](x), fns[name](ref, x)
            assert got.dtype == torch.float32 and torch.equal(got, want), (compress, name)
