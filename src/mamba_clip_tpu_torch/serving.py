"""Serving entry points, artifacts and weight compression, in PyTorch.

Counterpart of ``mamba_clip_tpu/serving.py``. The classifier zoo gets
``classify``: raw ``uint8 [B, staging, staging, 3]`` images (the host
JPEG-decode wire format) -> eval preprocess -> model -> fp32 class
probabilities. The CLIP models (``is_clip``, or a non-mamba name) get
``image_embed`` (uint8 images -> L2-normalized fp32 ``[B, embed_dim]``)
and ``text_embed`` (int32 ``[B, context]`` tokens -> the same). Everything
runs on the model's device.

Artifacts. JAX's export writes one StableHLO graph per entry point and the
variables as flax msgpack, which nothing but JAX reads. The port's
artifact directory, written by :func:`export_serving` and read back by
:func:`load_serving`, holds:

- ``params.pt``: the module's state dict (parameters and buffers,
  BatchNorm's running statistics included) written with ``torch.save``,
  read with ``torch.load(..., weights_only=True)``; with
  ``compress_weights`` the large 2-D kernels and embedding tables are
  stored as int8 with fp32 scales (:func:`compress_params`);
- ``manifest.json``: JAX's keys with JAX's values for the same arguments
  (``model``, ``quant``, ``precision``, ``image_size``, ``staging_size``,
  ``context_length``, ``vocab_size``, ``num_classes``, ``mean``, ``std``,
  ``entry_points`` with ``input_shape`` and ``input_dtype``,
  ``data_shards``, ``weights``, ``tokenizer``, ``platforms``). It differs
  from JAX's in this: an entry point has no ``file`` (there is no graph
  per entry point); ``platforms`` records the platforms asked for, or the
  platform of this process (``cuda`` or ``cpu``), and lowers nothing; and
  it adds what rebuilding the module needs and a graph would have
  captured: ``is_clip``, ``scan_impl``, ``format`` (always ``"torch"``)
  and ``params`` (the state dict's file name);
- ``tokenizer/``: a local WordPiece vocabulary shipped with the artifact,
  as JAX ships it.

:func:`load_serving` rebuilds the module from the manifest on the meta
device (no random init), loads the state dict into it with ``assign=True``
on the requested device, and returns JAX's dict: ``manifest``, one
``fn(x)`` per entry point and ``tokenize`` beside ``text_embed``. A loaded
CLIP module always runs the flash attention interior: its CUDA kernel on
the card, the plain interior on the CPU.

Quantized serving: ``quant="int8_serve"`` puts the per-channel int8 dot
(``ops/qdot.py``) into the towers' Dense layers; the manifest records it
and ``load_serving`` rebuilds the module with it. The training modes
``int8_delayed*`` are refused, with the JAX package's message.

Data-sharded artifacts (``data_shards`` S above 1): the weights file is the
same, and the manifest records ``data_shards`` S and each entry point's
batch dimension as ``"{S}*b"``, as JAX's does. ``load_serving`` puts one
replica of the module on each of S devices (``cuda:0`` ... ``cuda:{S-1}``
unless the caller names them); an entry point splits a batch of S·b rows
into S slices, issues each slice's forward on its replica in turn from
the calling thread (the launches are asynchronous, so the cards overlap
the host's work), and concatenates the results on the first device. The forward needs no
collective, as JAX's data-parallel graph needs none. A batch that S does
not divide raises ``ValueError``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from .convert import flax_leaf_names
from .data.preprocess_cfg import get_transform_config
from .models import build_classifier, build_clip
from .ops.flash_attn import resolve_attn_flash
from .ops.preprocess import eval_preprocess
from .ops import qdot
from .utils.precision import get_policy

_MANIFEST = "manifest.json"
_PARAMS = "params.pt"

# ---------------------------------------------------------------------------
# int8 weight compression for the params artifact (--compress-weights)
# ---------------------------------------------------------------------------
#
# A storage format only, as in the JAX package: load_serving dequantizes on
# load and the module runs in its own types. A tensor is compressed exactly
# when its Flax counterpart would be: a 2-D floating ``kernel`` or
# ``embedding`` (by convert.py's names) of at least 1 << 16 elements. A
# Flax Dense kernel [K, N] has one scale per column; its torch weight is
# [N, K], so here the scale is per row. An embedding table is [V, D] in
# both packages, one scale per row. Either way: one scale per row.
#
# A kernel that an int8_serve dot consumes is stored as that dot's own
# int8 operand and per-output-channel scales: quantized from the weight cast
# to the compute type (the dot's rounding point), with the dot's arithmetic.
# Under bf16 compute its dequantized values requantize, through the same
# cast, to the same int8 values and scales, so a compressed int8_serve
# artifact serves those dots bit for bit as the uncompressed module does;
# under fp32 the int8 values come back and the scales within an ulp. (The
# JAX package's serving.py:52-58 states the exactness; its compression of
# the fp32 kernel keeps it under fp32 compute only.) Every other tensor is
# compressed in fp32 and carries one int8 rounding.

_COMPRESS_KEY = "__int8_cols__"
_COMPRESS_MIN_ELEMS = 1 << 16


def _compress_2d(w: torch.Tensor):
    """Symmetric int8 with one fp32 scale per row, in JAX's fp32
    arithmetic: amax, max(amax, 1e-6) / 127, the division, round half to
    even, clip to +-127. Returns (int8 values, scales [rows, 1])."""
    w32 = w.detach().to("cpu", torch.float32)
    amax = w32.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _compress_served(w: torch.Tensor, dtype: torch.dtype):
    """The int8 operand and the per-output-channel scales [N, 1] that an
    int8_serve dot makes of the weight ``w`` [N, K] under ``dtype``."""
    rhs = w.detach().to("cpu", dtype).t()  # JAX's [K, N] kernel, cast as the Dense casts it
    sr = qdot._absmax_scale_cols(rhs)
    return qdot._quantize(rhs, sr).t().contiguous(), sr.reshape(-1, 1)


def serve_kernels(module: torch.nn.Module) -> set:
    """The state-dict keys of the weights that an int8_serve dot consumes."""
    return {f"{name}.weight" for name, m in module.named_modules()
            if isinstance(qdot.injected(m), qdot.Int8ServeDotGeneral)}


def compress_params(state_dict: Mapping[str, torch.Tensor], module: torch.nn.Module,
                    min_elems: int = _COMPRESS_MIN_ELEMS,
                    compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """``state_dict`` (of ``module``, whose module types name its tensors)
    with each large 2-D kernel and embedding table replaced by three flat
    entries: ``<key>.__int8_cols__`` (int8), ``<key>.__int8_cols__.scale``
    (fp32, one a row) and ``<key>.__int8_cols__.proto`` (empty, the
    original dtype), on the CPU. Every other tensor is kept as it is. With
    ``compute_dtype`` (the module's compute type), a kernel of an int8_serve
    dot is stored as that dot's own operand and scales under that type."""
    names = flax_leaf_names(module)
    served = serve_kernels(module) if compute_dtype is not None else set()
    out: Dict[str, torch.Tensor] = {}
    for key, t in state_dict.items():
        if (names.get(key) in ("kernel", "embedding") and t.ndim == 2
                and t.is_floating_point() and t.numel() >= min_elems):
            q, scale = (_compress_served(t, compute_dtype) if key in served
                        else _compress_2d(t))
            out[f"{key}.{_COMPRESS_KEY}"] = q
            out[f"{key}.{_COMPRESS_KEY}.scale"] = scale
            out[f"{key}.{_COMPRESS_KEY}.proto"] = torch.zeros((0,), dtype=t.dtype)
        else:
            out[key] = t
    return out


def decompress_params(stored: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`compress_params` (the identity on a raw state
    dict): ``q * scale`` in fp32, cast to the recorded dtype, on the
    device the entries lie on."""
    out: Dict[str, torch.Tensor] = {}
    suffix = f".{_COMPRESS_KEY}"
    for key, t in stored.items():
        if key.endswith(suffix):
            base = key[: -len(suffix)]
            scale = stored[f"{key}.scale"]
            out[base] = (t.to(torch.float32) * scale.to(torch.float32)).to(
                stored[f"{key}.proto"].dtype)
        elif not key.endswith((f"{suffix}.scale", f"{suffix}.proto")):
            out[key] = t
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _check_quant(quant: Optional[str]) -> None:
    if quant in ("int8_delayed", "int8_delayed_attn"):
        raise ValueError(
            f"--quant {quant} is a TRAINING mode (its scales live in "
            "mutable model state); export serving artifacts with "
            "--quant int8_serve (per-channel weight scales) instead — "
            "checkpoints trained under int8_delayed load fine either way"
        )


def _is_classifier(model_name: Optional[str], is_clip: bool) -> bool:
    """Mamba-family names default to the classifier zoo; ``is_clip`` builds
    the VSSM-towered CLIP instead, as the JAX package does."""
    return not is_clip and (
        model_name in (None, "vssm", "medmamba") or "mamba" in str(model_name))


def _build_model(model_name, *, is_clip, num_classes, quant, scan_impl, precision,
                 image_size, context_length, vocab_size, attn_impl, generator):
    """The serving module on the default device (the CPU, or the meta
    device under ``torch.device("meta")``), parameters drawn from
    ``generator``."""
    dtype = get_policy(precision).compute_dtype
    if _is_classifier(model_name, is_clip):
        return build_classifier(model_name, num_classes=num_classes, dtype=dtype,
                                quant=quant, scan_impl=scan_impl, generator=generator)
    return build_clip(
        model_name=model_name, image_size=image_size, context_length=context_length,
        vocab_size=vocab_size, dtype=dtype, quant=quant, scan_impl=scan_impl,
        attn_flash=resolve_attn_flash(attn_impl), generator=generator)


def _entry_points(model_name, is_clip, precision, image_size, dev):
    """``{entry point: fn(model, x)}``, each under ``inference_mode`` on
    ``dev``."""
    policy = get_policy(precision)
    tcfg = get_transform_config(None, image_size, is_train=False)

    def prep(image_u8):
        return eval_preprocess(
            torch.as_tensor(image_u8, device=dev), out_size=tcfg.image_size,
            mean=tcfg.mean, std=tcfg.std, out_dtype=policy.compute_dtype,
            interpolation=tcfg.interpolation or "bilinear",
        )

    if _is_classifier(model_name, is_clip):
        def classify(model, image_u8):
            with torch.inference_mode():
                return torch.softmax(model(prep(image_u8)).float(), dim=-1)

        return {"classify": classify}

    def image_embed(model, image_u8):
        with torch.inference_mode():
            return model.encode_image(prep(image_u8), normalize=True).float()

    def text_embed(model, tokens):
        with torch.inference_mode():
            return model.encode_text(
                torch.as_tensor(tokens, device=dev), normalize=True).float()

    return {"image_embed": image_embed, "text_embed": text_embed}


def make_serving_fns(
    model_name: str = "biomedclip",
    *,
    is_clip: bool = False,
    num_classes: int = 2,
    quant: Optional[str] = None,
    scan_impl: Optional[str] = None,
    precision: str = "amp",
    image_size: int = 224,
    staging_size: Optional[int] = None,
    context_length: int = 256,
    vocab_size: int = 30522,
    generator: Optional[torch.Generator] = None,
    device: str | torch.device = "cuda",
    attn_impl: Optional[str] = "einsum",
):
    """Build ``(model, {entry_point: fn(model, x)}, meta)`` for serving.

    The model is initialized on the CPU from ``generator`` (seed 0 when
    None), then moved to ``device`` in eval mode; load trained weights with
    ``convert.load_jax_variables`` or ``load_state_dict``. ``device`` is the
    card unless the caller asks for the CPU. ``attn_impl`` (``--attn-impl``,
    the CLIP models only): ``einsum`` runs the plain attention interior,
    ``flash`` the flash interior, whose CUDA kernel every attention of both
    towers launches on the card.
    """
    _check_quant(quant)
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = _build_model(
        model_name, is_clip=is_clip, num_classes=num_classes, quant=quant,
        scan_impl=scan_impl, precision=precision, image_size=image_size,
        context_length=context_length, vocab_size=vocab_size, attn_impl=attn_impl,
        generator=generator)
    model = model.to(dev).eval()
    fns = _entry_points(model_name, is_clip, precision, image_size, dev)
    return model, fns, _meta(model_name, quant, precision, image_size, staging_size,
                             context_length, vocab_size, num_classes)


def _meta(model_name, quant, precision, image_size, staging_size, context_length,
          vocab_size, num_classes):
    tcfg = get_transform_config(None, image_size, is_train=False)
    return {
        "model": model_name,
        "quant": quant,
        "precision": precision,
        "image_size": image_size,
        "staging_size": staging_size or tcfg.staging_size,
        "context_length": context_length,
        "vocab_size": vocab_size,
        "num_classes": num_classes,
        "mean": list(tcfg.mean),
        "std": list(tcfg.std),
    }


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


def _default_platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def export_serving(
    out_dir: str,
    model_name: str = "biomedclip",
    *,
    variables: Optional[Mapping[str, torch.Tensor]] = None,
    platforms: Optional[tuple] = None,
    data_shards: int = 1,
    tokenizer: Optional[str] = None,
    compress_weights: bool = False,
    is_clip: bool = False,
    num_classes: int = 2,
    quant: Optional[str] = None,
    scan_impl: Optional[str] = None,
    precision: str = "amp",
    image_size: int = 224,
    staging_size: Optional[int] = None,
    context_length: int = 256,
    vocab_size: int = 30522,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """Write a serving artifact (module docstring) to ``out_dir`` and return
    its manifest. The keywords after ``compress_weights`` are
    :func:`make_serving_fns`'s, but for ``attn_impl``: an artifact always
    runs the flash interior.

    ``variables``: the trained weights as the module's state dict (e.g.
    ``model.state_dict()`` of a model that ``checkpoint.load_params_only``
    or ``convert.load_jax_variables`` filled), on any device; every key
    must match the module. None: a fresh init from ``generator`` (seed 0).
    ``platforms``: recorded in the manifest; nothing is lowered.
    ``tokenizer``: a local vocab path or HF tokenizer directory ships with
    the artifact (the manifest records ``wordpiece``); any other value
    records the hash tokenizer. ``compress_weights``: int8 kernels and
    tables (:func:`compress_params`, the kernels of int8_serve dots from
    their cast to the compute type). ``data_shards``: above 1 a
    data-parallel artifact (module docstring): the batch dimension becomes
    ``"{data_shards}*b"``, so any multiple of ``data_shards`` rows serves.
    """
    _check_quant(quant)
    build = dict(is_clip=is_clip, num_classes=num_classes, quant=quant,
                 scan_impl=scan_impl, precision=precision, image_size=image_size,
                 context_length=context_length, vocab_size=vocab_size,
                 attn_impl="flash")
    if variables is None:
        model = _build_model(model_name, generator=generator or
                             torch.Generator().manual_seed(0), **build)
        variables = model.state_dict()
    else:
        with torch.device("meta"):
            model = _build_model(model_name, generator=None, **build)
        model.load_state_dict(variables, assign=True)  # strict: keys and shapes
    stored = (compress_params(variables, model,
                              compute_dtype=get_policy(precision).compute_dtype)
              if compress_weights else variables)
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: t.detach().to("cpu", copy=True) for k, t in stored.items()},
               os.path.join(out_dir, _PARAMS))

    meta = _meta(model_name, quant, precision, image_size, staging_size, context_length,
                 vocab_size, num_classes)
    s = str(meta["staging_size"])
    b = f"{data_shards}*b" if data_shards > 1 else "b"
    in_specs = {
        "classify": ([b, s, s, "3"], "uint8"),
        "image_embed": ([b, s, s, "3"], "uint8"),
        "text_embed": ([b, str(context_length)], "int32"),
    }
    names = (("classify",) if _is_classifier(model_name, is_clip)
             else ("image_embed", "text_embed"))
    entry_points = {name: {"input_shape": in_specs[name][0], "input_dtype": in_specs[name][1]}
                    for name in names}

    tok_meta: Dict[str, Any] = {"type": "hash", "context_length": context_length}
    if tokenizer and os.path.exists(tokenizer):
        tok_dir = os.path.join(out_dir, "tokenizer")
        os.makedirs(tok_dir, exist_ok=True)
        if os.path.isdir(tokenizer):  # HF tokenizer dir: ship its files
            for fname in os.listdir(tokenizer):
                src = os.path.join(tokenizer, fname)
                if os.path.isfile(src):  # HF saves can nest dirs; skip them
                    shutil.copyfile(src, os.path.join(tok_dir, fname))
        else:  # bare vocab.txt: write the minimal BERT config
            shutil.copyfile(tokenizer, os.path.join(tok_dir, "vocab.txt"))
            with open(os.path.join(tok_dir, "tokenizer_config.json"), "w") as f:
                json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True}, f)
        tok_meta = {"type": "wordpiece", "dir": "tokenizer", "context_length": context_length}

    manifest = dict(meta, entry_points=entry_points, data_shards=data_shards,
                    weights="int8_cols" if compress_weights else "raw",
                    tokenizer=tok_meta,
                    platforms=list(platforms) if platforms else [_default_platform()],
                    is_clip=is_clip, scan_impl=scan_impl,
                    format="torch", params=_PARAMS)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_serving(out_dir: str, device: str | torch.device = "cuda",
                 devices: Optional[Sequence[str | torch.device]] = None) -> Dict[str, Any]:
    """Reload an artifact directory -> ``{"manifest": ..., entry point:
    fn(x) -> fp32 tensor on device, "tokenize": text -> ids}``.

    The module is rebuilt from the manifest without a random init and its
    weights are loaded onto ``device`` (the card unless the caller asks for
    the CPU), dequantized where the artifact is ``int8_cols``. A
    data-sharded artifact (``data_shards`` S above 1) takes one replica a
    device of ``devices`` (S of them; by default ``cuda:0`` ... ``cuda:{S-1}``,
    or the CPU S times when ``device`` is the CPU; a device named twice holds
    one replica), and its entry points return on ``devices[0]``."""
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != "torch":
        raise ValueError(
            f"{out_dir}: not an artifact of this package (manifest format "
            f"{manifest.get('format')!r}); a StableHLO artifact is read by the JAX "
            "package's load_serving")
    shards = int(manifest.get("data_shards", 1))
    if devices is None:
        dev = torch.device(device)
        devices = ([dev] if shards == 1 else
                   [torch.device("cuda", i) for i in range(shards)] if dev.type == "cuda"
                   else [dev] * shards)
    devices = [torch.device(d) for d in devices]
    if len(devices) != shards:
        raise ValueError(f"data_shards={shards}: {len(devices)} device(s) given")
    m = manifest
    one = len(set(devices)) == 1
    stored = torch.load(os.path.join(out_dir, m.get("params", _PARAMS)),
                        map_location=devices[0] if one else "cpu", weights_only=True)
    if m.get("weights") == "int8_cols":
        stored = decompress_params(stored)
    replicas = {}
    for dev in dict.fromkeys(devices):
        with torch.device("meta"):
            model = _build_model(
                m["model"], is_clip=m["is_clip"], num_classes=m["num_classes"],
                quant=m["quant"], scan_impl=m["scan_impl"], precision=m["precision"],
                image_size=m["image_size"], context_length=m["context_length"],
                vocab_size=m["vocab_size"], attn_impl="flash", generator=None)
        model.load_state_dict({k: t.to(dev) for k, t in stored.items()}, assign=True)
        model.eval()
        entries = _entry_points(m["model"], m["is_clip"], m["precision"], m["image_size"], dev)
        replicas[dev] = {name: functools.partial(fn, model) for name, fn in entries.items()}

    if shards == 1:
        fns: Dict[str, Any] = dict(replicas[devices[0]])
    else:
        fns = {name: _sharded_entry(name, [replicas[d][name] for d in devices], devices)
               for name in replicas[devices[0]]}
    # a text -> token-ids callable matching the artifact's tokenizer; the hash
    # tokenizer's ids stay below the text tower's vocabulary
    tok = manifest.get("tokenizer") or {}
    if "text_embed" in fns:
        from .data.tokenizer import HashTokenizer, get_tokenizer

        context_length = int(tok.get("context_length", 256))
        if tok.get("type") == "wordpiece":
            fns["tokenize"] = get_tokenizer(os.path.join(out_dir, tok["dir"]),
                                            context_length=context_length, require_real=True)
        else:
            fns["tokenize"] = HashTokenizer(context_length=context_length,
                                            vocab_size=int(m["vocab_size"]))
    return {"manifest": manifest, **fns}


def _sharded_entry(name, fns, devices):
    """The entry point ``name`` of a data-sharded artifact: a batch of S·b
    rows split into S slices, slice i run by ``fns[i]`` on ``devices[i]``,
    the results concatenated on ``devices[0]``. The slices are issued in
    turn from the calling thread: the launches are asynchronous, so card i
    computes while the host issues slice i + 1. (One host thread a card
    gave 0.30 and 0.44 times one card's rows/s for ``classify`` and
    ``image_embed`` at S = 4 on four H100s: the forwards are host-bound,
    and their many short calls contend for the interpreter lock.)"""
    shards = len(fns)

    def run(i, x):
        with (torch.cuda.device(devices[i]) if devices[i].type == "cuda"
              else contextlib.nullcontext()):
            return fns[i](x)

    def call(x):
        n = int(x.shape[0])
        if n % shards:
            raise ValueError(
                f"{name}: a batch of {n} rows does not split over data_shards={shards}")
        k = n // shards
        outs = [run(i, x[i * k:(i + 1) * k]) for i in range(shards)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return call
