"""Weights bridge: a Flax variable tree (VSSM classifier, ViT, BERT or
CLIP) -> the port's state dict.

The JAX package's variables are ``{"params": ..., "batch_stats": ...,
"quant": ...}``, nested dicts whose leaves are arrays (numpy, or anything ``np.asarray``
takes). The port's modules keep the Flax child names, except for Flax's
auto-named children, so each leaf maps by its path:

- ``ConvBranch_0`` -> ``conv_branch``, ``BatchNorm_k`` -> ``bn{k}``,
  ``Conv_k`` -> ``conv{k}``;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in), the VSSM decoder's
  ``expand`` (``PatchExpand2D``, ``FinalPatchExpand2D``) among them;
- Conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise (3, 3, 1, C) ->
  (C, 1, 3, 3));
- Embed ``embedding`` (vocab, width) -> ``weight`` as it is;
- LayerNorm/BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- BatchNorm ``mean``/``var`` (batch_stats) -> ``running_mean``/``running_var``;
- the delayed int8 scales (the ``quant`` collection of ``--quant
  int8_delayed*``): ``amax_lhs``/``amax_rhs`` of a Dense's
  ``Int8DelayedDotGeneral_0`` and ``amax_q``/``amax_k``/``amax_v`` of an
  attention module, as they are, under the same module names;
- the raw SS2D parameters (``x_proj_weight``, ``dt_projs_weight``,
  ``dt_projs_bias``, ``A_logs``, ``Ds``) and the raw parameters of the
  towers and the CLIP wrapper (``cls_token``, ``pos_embed``, ``pos_emb``,
  ``type_emb``, ``logit_scale``, ``logit_bias``) as they are.

:func:`mask_from_jax` maps a boolean pytree over the ``params`` (a JAX
``lock_mask``) to the port's parameter names by the same rules.

The inverse, :func:`flax_arrays`, gives a module's parameters as the Flax
tree's leaves in Flax layouts, keyed by their paths joined with ``/``, the
keys of the ``.npz`` that ``tools/convert_weights.py`` writes and
``checkpoint.load_torch_clip`` reads; :func:`write_converted_npz` writes
them as that file with numpy alone. A ``weight`` maps to ``kernel``,
``embedding`` or ``scale`` by the type of the module that owns it.
:func:`train_state_from_jax` carries a whole JAX ``TrainState`` over:
parameters, batch statistics, the Adam moments and count, the step and the
loss scale and the delayed scales. :func:`quant_to_jax` gives a module's
delayed scales back as the ``quant`` tree. A ``ClipClassifier``'s leaves
(``clip/...``, ``fc1``, ``fc2``) map by the same rules.

Every leaf must land on a parameter or buffer of the module and every
parameter or buffer must be covered (BatchNorm's ``num_batches_tracked``
counter aside, which Flax does not keep), or the bridge raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_RAW = {"x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs", "Ds",
        "cls_token", "pos_embed", "pos_emb", "type_emb", "logit_scale", "logit_bias"}
_RENAMES = (
    (re.compile(r"^ConvBranch_0$"), "conv_branch"),
    (re.compile(r"^BatchNorm_(\d+)$"), r"bn\1"),
    (re.compile(r"^Conv_(\d+)$"), r"conv\1"),
)
_QUANT = {"amax_lhs", "amax_rhs", "amax_q", "amax_k", "amax_v"}
_COLLECTIONS = ("params", "batch_stats", "quant")
_FLAX_RENAMES = (
    (re.compile(r"^conv_branch$"), "ConvBranch_0"),
    (re.compile(r"^bn(\d+)$"), r"BatchNorm_\1"),
    (re.compile(r"^conv(\d+)$"), r"Conv_\1"),
)


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _module_name(name: str) -> str:
    for pat, repl in _RENAMES:
        if pat.match(name):
            return pat.sub(repl, name)
    return name


def _leaf_name(collection: str, path) -> str:
    """The port's name of the leaf at ``path`` of a Flax collection."""
    leaf = path[-1]
    where = "/".join((collection,) + tuple(path))
    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unmapped batch_stats leaf {where}")
        return names[leaf]
    if collection == "quant":
        if leaf not in _QUANT:
            raise KeyError(f"unmapped quant leaf {where}")
        return leaf
    if leaf in ("kernel", "scale", "embedding"):
        return "weight"
    if leaf == "bias" or leaf in _RAW:
        return leaf
    raise KeyError(f"unmapped params leaf {where}")


def _key(collection: str, path) -> str:
    return ".".join([_module_name(m) for m in path[:-1]] + [_leaf_name(collection, path)])


def _convert_value(path, arr: np.ndarray) -> np.ndarray:
    """Dense kernels transposed, convolution kernels HWIO -> OIHW."""
    if path[-1] != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"params/{'/'.join(path)}: kernel of rank {arr.ndim}")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A leaf as a tensor of its own float type: fp16 stays fp16, and a JAX
    bfloat16 array (numpy's ``bfloat16`` type, which ml_dtypes registers)
    becomes bf16 bit for bit through its 16-bit pattern, so that the port
    never imports ml_dtypes; any other type becomes fp32."""
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype == np.float16:
        return torch.from_numpy(np.array(arr, np.float16, order="C"))
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def _array(t: torch.Tensor, dtype=None) -> np.ndarray:
    """The inverse of :func:`_tensor`: a tensor as a numpy array of its
    own type (bf16 as numpy's ``bfloat16``, which needs ml_dtypes imported
    first, as JAX imports it), or of ``dtype``."""
    t = t.detach().to("cpu")
    if dtype is not None:
        return t.to(torch.float32).numpy().astype(dtype)
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError(
            "a bf16 parameter as a numpy array needs numpy's bfloat16 type, which "
            "ml_dtypes registers (import it first, as JAX does), or an explicit "
            "dtype=np.float32") from None
    return t.view(torch.int16).numpy().view(bf16)


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Map a Flax variable tree to state-dict entries, each in its leaf's
    type (fp32, bf16 or fp16; see :func:`_tensor`)."""
    extra = sorted(set(variables) - set(_COLLECTIONS))
    if extra:
        raise KeyError(f"unmapped variable collections {extra}")
    out: Dict[str, torch.Tensor] = {}
    for collection in _COLLECTIONS:
        for path, arr in _walk(variables.get(collection, {})):
            key = _key(collection, path)
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = _tensor(_convert_value(path, arr))
    return out


def mask_from_jax(mask) -> Dict[str, bool]:
    """Map a boolean pytree over a Flax ``params`` tree (with or without
    the ``params`` level), such as the JAX package's ``lock_mask`` result,
    to ``{the port's parameter name: bool}``."""
    tree = mask["params"] if "params" in mask else mask
    return {_key("params", path): bool(value) for path, value in _walk(tree)}


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy a Flax variable tree into ``module`` in place (onto its device);
    raises on any leaf left over in either direction or any shape
    mismatch."""
    sd = state_dict_from_jax(variables)
    want = {k: v for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(
            f"JAX variables do not match the module: missing {missing}, "
            f"unexpected {unexpected}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"{k}: JAX leaf has shape {tuple(v.shape)}, module expects "
                f"{tuple(want[k].shape)}")
    module.load_state_dict(sd, strict=False)
    return module


def train_state_from_jax(model: nn.Module, tx, *, params, mu, nu, count, step,
                         batch_stats=None, loss_scale=None, quant_stats=None):
    """The port's ``TrainState`` from the pieces of a JAX one, given as
    trees of numpy arrays: ``params``, ``batch_stats`` and ``quant_stats``
    (the delayed scales) are loaded into ``model`` in place; ``mu`` and
    ``nu`` (the two moment trees of optax's ``ScaleByAdamState``, shaped
    like ``params``) become the ``AdamState`` of
    ``tx`` with ``count``; ``step`` the step; ``loss_scale`` (a mapping with
    ``scale`` and ``growth_count``, the fp16 policies) the loss-scale state.
    The moments of leaves that ``tx``'s trainable mask freezes are dropped;
    a trainable leaf without moments raises."""
    from .optim import AdamState
    from .train import TrainState
    from .utils.precision import LossScaleState

    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    if quant_stats:
        variables["quant"] = quant_stats
    load_jax_variables(model, variables)
    named = dict(model.named_parameters())
    fresh = tx.init(named)
    moments = []
    def prune(tree):
        """Without optax's empty ``MaskedNode`` leaves (frozen leaves)."""
        return {k: prune(v) if isinstance(v, Mapping) else v for k, v in tree.items()
                if not (isinstance(v, tuple) and len(v) == 0)}

    for tree, what in ((mu, "mu"), (nu, "nu")):
        sd = state_dict_from_jax({"params": prune(tree)})
        missing = sorted(set(fresh.mu) - set(sd))
        if missing:
            raise KeyError(f"JAX optimizer state: {what} lacks the trainable leaves {missing}")
        moments.append({k: sd[k].to(named[k].device) for k in fresh.mu})
    ls = None
    if loss_scale is not None:
        ls = LossScaleState(scale=float(loss_scale["scale"]),
                            growth_count=int(loss_scale["growth_count"]))
    return TrainState(step=int(step), model=model,
                      opt_state=AdamState(count=int(count), mu=moments[0], nu=moments[1]),
                      loss_scale=ls)


def quant_to_jax(module: nn.Module) -> Dict:
    """``module``'s delayed int8 scales as the JAX package's ``quant``
    collection: a nested dict of fp32 numpy arrays (empty without them)."""
    from .ops.qdot import delayed_scales

    tree: Dict = {}
    for key, buf in delayed_scales(module).items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(_flax_module_name(m), {})
        node[leaf] = buf.detach().to("cpu", torch.float32).numpy().copy()
    return tree


def _flax_module_name(name: str) -> str:
    for pat, repl in _FLAX_RENAMES:
        if pat.match(name):
            return pat.sub(repl, name)
    return name


def _flax_leaf_name(module: nn.Module, leaf: str, where: str) -> str:
    """The Flax name of ``module``'s parameter ``leaf``."""
    if leaf == "weight":
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            return "kernel"
        if isinstance(module, nn.Embedding):
            return "embedding"
        if isinstance(module, (nn.LayerNorm, nn.modules.batchnorm._NormBase)):
            return "scale"
        raise KeyError(f"unmapped weight {where} of a {type(module).__name__}")
    if leaf == "bias" or leaf in _RAW:
        return leaf
    raise KeyError(f"unmapped parameter {where}")


def _flax_value(leaf: str, arr: np.ndarray) -> np.ndarray:
    """Dense kernels transposed, convolution kernels OIHW -> HWIO."""
    if leaf != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    return arr.transpose(2, 3, 1, 0)


def _flax_leaves(module: nn.Module):
    """(``/``-joined Flax path, Flax leaf name, parameter) of every
    parameter of ``module``."""
    for mod_name, mod in module.named_modules():
        path = [_flax_module_name(m) for m in mod_name.split(".") if m]
        for leaf, t in mod.named_parameters(recurse=False):
            name = _flax_leaf_name(mod, leaf, ".".join(path + [leaf]))
            yield "/".join(path + [name]), name, t


def flax_leaf_names(module: nn.Module) -> Dict[str, str]:
    """The Flax leaf name (``kernel``, ``embedding``, ``scale``, ``bias`` or a
    raw name) of each parameter of ``module``, by its state-dict key."""
    out = {}
    for mod_name, mod in module.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            out[key] = _flax_leaf_name(mod, leaf, key)
    return out


def flax_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The Flax shape of each parameter of ``module``, by Flax path."""
    return {key: _flax_value(name, np.empty(tuple(t.shape), np.bool_)).shape
            for key, name, t in _flax_leaves(module)}


def flax_arrays(module: nn.Module, dtype=None) -> Dict[str, np.ndarray]:
    """``module``'s parameters as numpy arrays in Flax layouts, keyed by
    the ``/``-joined paths of the Flax ``params`` tree: the inverse of
    :func:`state_dict_from_jax` on that collection. Each array keeps its
    parameter's type (a bf16 one needs ml_dtypes imported, see
    :func:`_array`) unless ``dtype`` is given."""
    return {key: np.array(_flax_value(name, _array(t, dtype)), order="C")
            for key, name, t in _flax_leaves(module)}


def write_converted_npz(module: nn.Module, path: str) -> None:
    """Write ``module``'s parameters as a converted ``.npz`` (Flax keys,
    Flax layouts, fp32 as ``tools/convert_weights.py`` writes it), the file
    ``checkpoint.load_torch_clip`` reads."""
    np.savez(path, **flax_arrays(module, np.float32))
