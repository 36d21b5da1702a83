"""Weights bridge: a Flax variable tree (VSSM classifier, ViT, BERT or
CLIP) -> the port's state dict.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``,
nested dicts whose leaves are arrays (numpy, or anything ``np.asarray``
takes). The port's modules keep the Flax child names, except for Flax's
auto-named children, so each leaf maps by its path:

- ``ConvBranch_0`` -> ``conv_branch``, ``BatchNorm_k`` -> ``bn{k}``,
  ``Conv_k`` -> ``conv{k}``;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise (3, 3, 1, C) ->
  (C, 1, 3, 3));
- Embed ``embedding`` (vocab, width) -> ``weight`` as it is;
- LayerNorm/BatchNorm ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- BatchNorm ``mean``/``var`` (batch_stats) -> ``running_mean``/``running_var``;
- the raw SS2D parameters (``x_proj_weight``, ``dt_projs_weight``,
  ``dt_projs_bias``, ``A_logs``, ``Ds``) and the raw parameters of the
  towers and the CLIP wrapper (``cls_token``, ``pos_embed``, ``pos_emb``,
  ``type_emb``, ``logit_scale``, ``logit_bias``) as they are.

:func:`mask_from_jax` maps a boolean pytree over the ``params`` (a JAX
``lock_mask``) to the port's parameter names by the same rules.

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
_COLLECTIONS = ("params", "batch_stats")


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


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """Map a Flax variable tree to state-dict entries."""
    extra = sorted(set(variables) - set(_COLLECTIONS))
    if extra:
        raise KeyError(f"unmapped variable collections {extra}")
    out: Dict[str, torch.Tensor] = {}
    for collection in _COLLECTIONS:
        for path, arr in _walk(variables.get(collection, {})):
            key = _key(collection, path)
            if key in out:
                raise KeyError(f"two leaves map to {key}")
            out[key] = torch.from_numpy(
                np.array(_convert_value(path, arr), np.float32, order="C"))
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
