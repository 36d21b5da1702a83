"""CLIP model: vision tower + text tower + logit scale, in PyTorch.

Counterpart of ``mamba_clip_tpu/models/clip.py``: ``l2_normalize``,
``VssmTower``, ``ClipModel`` (``encode_image``, ``encode_text``, the
forward's output dict with ``logit_scale`` and, under ``siglip``,
``logit_bias``, ``get_logits``), ``LOGIT_SCALE_MAX``,
``resolve_gelu_approx``, ``build_clip``, and the training helpers
``clamp_logit_scale`` and ``lock_mask``. ``logit_scale`` is stored as its
log, initialized to ln(1/0.07), and exp'd in the forward. In training
mode the forward takes the explicit generator that the visual tower draws
its masks from (the ViT's patch dropout, the VSSM's DropPath).

LiT tower locking is a trainability mask over the parameter names
(``named_parameters``), the ``trainable_mask`` of
``optim.build_optimizer``: frozen parameters get a zero update and no
decay and stay exactly at their values.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .text_bert import TextBert
from .vit import VisionTransformer, _dense
from .vssm import VSSM, _linear

LOGIT_SCALE_MAX = math.log(100.0)  # the train step clamps the log scale to ln(100)
INIT_LOGIT_SCALE = math.log(1.0 / 0.07)
INIT_LOGIT_BIAS = -10.0  # --siglip


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return (x / torch.clamp_min(n, eps)).to(x.dtype)


class VssmTower(nn.Module):
    """VSSM backbone (``num_classes=0``: pooled features) + fp32
    projection ``proj`` without bias, usable as a CLIP vision tower."""

    def __init__(self, vssm: VSSM, embed_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vssm = vssm
        self.proj = _dense(vssm.num_features, embed_dim, generator, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return _linear(self.vssm(x, generator=generator), self.proj, torch.float32)


class ClipModel(nn.Module):
    """Two-tower CLIP with a shared embedding space."""

    def __init__(self, visual: nn.Module, text: nn.Module, siglip: bool = False):
        super().__init__()
        self.visual = visual
        self.text = text
        self.siglip = siglip
        self.logit_scale = nn.Parameter(torch.tensor(INIT_LOGIT_SCALE, dtype=torch.float32))
        self.logit_bias = (nn.Parameter(torch.tensor(INIT_LOGIT_BIAS, dtype=torch.float32))
                           if siglip else None)

    def encode_image(self, image, normalize: bool = False,
                     generator: Optional[torch.Generator] = None):
        feats = self.visual(image, generator=generator)
        return l2_normalize(feats) if normalize else feats

    def encode_text(self, text, normalize: bool = False):
        feats = self.text(text)
        return l2_normalize(feats) if normalize else feats

    def forward(self, image=None, text=None, generator: Optional[torch.Generator] = None):
        out = {"logit_scale": torch.exp(self.logit_scale)}
        if image is not None:
            out["image_features"] = self.encode_image(image, normalize=True,
                                                      generator=generator)
        if text is not None:
            out["text_features"] = self.encode_text(text, normalize=True)
        if self.siglip:
            out["logit_bias"] = self.logit_bias
        return out

    def get_logits(self, image, text):
        """(image_logits, text_logits) pair."""
        out = self(image=image, text=text)
        logits = out["logit_scale"] * out["image_features"] @ out["text_features"].T
        if "logit_bias" in out:
            logits = logits + out["logit_bias"]
        return logits, logits.T


def clamp_logit_scale(params: Mapping[str, torch.Tensor]) -> None:
    """Clamp every ``logit_scale`` among ``params`` (a name -> parameter
    mapping, ``named_parameters``) to [0, ln 100], in place. A bf16 or fp16
    leaf gets what ``jnp.clip`` gives against the bounds rounded to its
    type: no value of the type lies between ln 100 and its rounding."""
    with torch.no_grad():
        for name, p in params.items():
            if name.rsplit(".", 1)[-1] == "logit_scale":
                p.clamp_(0.0, LOGIT_SCALE_MAX)


def _split_tower(tower, layer_prefix: str, stem_keys, always_prefixes, post_keys):
    """Partition a tower's top-level names into (stem, [block...], post,
    always-trainable). The partition is exhaustive over a declared map: a
    top-level module that matches no group raises instead of silently
    freezing or training."""
    blocks = sorted(
        [k for k in tower
         if k.startswith(layer_prefix) and k[len(layer_prefix):].isdigit()],
        key=lambda s: int(s[len(layer_prefix):]))
    always = [k for k in tower if any(k.startswith(a) for a in always_prefixes)]
    post = [k for k in tower if k in post_keys and k not in always]
    stem = [k for k in tower
            if k in stem_keys and k not in blocks and k not in always and k not in post]
    unknown = sorted(k for k in tower
                     if k not in blocks and k not in always and k not in post
                     and k not in stem)
    if unknown:
        raise ValueError(
            f"lock_mask: unrecognized tower module(s) {unknown}; known groups: "
            f"stem keys {sorted(stem_keys)}, blocks '{layer_prefix}<N>', "
            f"post keys {sorted(post_keys)}, always-trainable prefixes "
            f"{sorted(always_prefixes)}. Locking must not guess — add the "
            "module to the group map in models/clip.py lock_mask."
        )
    return stem, blocks, post, always


def _is_layer_norm(name: str) -> bool:
    return name.lower().startswith(("ln", "norm"))


def lock_mask(
    params: Mapping[str, torch.Tensor],
    lock_image: bool = False,
    lock_image_unlocked_groups: int = 0,
    lock_text: bool = False,
    lock_text_unlocked_layers: int = 0,
    lock_text_freeze_layer_norm: bool = True,
) -> Dict[str, bool]:
    """Trainability of every parameter of a :class:`ClipModel` by name
    (``named_parameters``): True = trainable.

    - image tower (``visual.``): the ordered groups are [stem:
      ``patch_embed``, ``cls_token``, ``pos_embed``] [``block0``] ...
      [``norm``] for the ViT, with ``layer<N>`` stages for a VSSM;
      ``lock_image_unlocked_groups=N`` keeps the last N groups trainable.
      The projection (``proj``, ``head``) is never locked.
    - text tower (``text.``): the embeddings (``tok_emb``, ``pos_emb``,
      ``type_emb``, ``ln_emb``) are the first group, then the blocks; there
      is no trailing group. The projection (``proj*``) is never locked. In
      frozen text modules the LayerNorm parameters (modules named ``ln*`` or
      ``norm*``) stay trainable unless ``lock_text_freeze_layer_norm``.

    ``N`` beyond the number of groups unlocks everything.
    """
    mask = {name: True for name in params}

    def lock_tower(prefix: str, unlocked_tail: int, freeze_ln: bool, **groups):
        names = [n for n in params if n.startswith(prefix + ".")]
        tower = list(dict.fromkeys(n.split(".")[1] for n in names))  # top-level, in order
        stem, blocks, post, always = _split_tower(tower, **groups)
        ordered = [stem] + [[b] for b in blocks] + ([post] if post else [])
        # clamp: n > len(ordered) means "unlock everything", not a
        # negative-index wrap that would leave only a tail sliver trainable
        n = min(max(int(unlocked_tail), 0), len(ordered))
        unlocked = {k for g in (ordered[len(ordered) - n:] if n else []) for k in g}
        for name in names:
            parts = name.split(".")
            if parts[1] in always or parts[1] in unlocked:
                continue
            # within a frozen module, a LayerNorm's parameters may stay trainable
            mask[name] = not freeze_ln and any(_is_layer_norm(m) for m in parts[1:-1])

    if lock_image and any(n.startswith("visual.") for n in params):
        is_vssm = any(n.split(".")[1].startswith("layer") and n.split(".")[1][5:].isdigit()
                      for n in params if n.startswith("visual."))
        lock_tower("visual", lock_image_unlocked_groups, True,
                   layer_prefix="layer" if is_vssm else "block",
                   stem_keys=("patch_embed", "cls_token", "pos_embed"),
                   always_prefixes=("proj", "head"), post_keys=("norm",))
    if lock_text and any(n.startswith("text.") for n in params):
        lock_tower("text", lock_text_unlocked_layers, lock_text_freeze_layer_norm,
                   layer_prefix="block",
                   stem_keys=("tok_emb", "pos_emb", "type_emb", "ln_emb"),
                   always_prefixes=("proj",), post_keys=())
    return mask


def resolve_gelu_approx(gelu: str, dtype: torch.dtype) -> bool:
    """Resolve the ``--gelu`` flag to the tanh form (True) or erf (False):
    "auto" picks the tanh form iff the compute dtype is bfloat16."""
    if gelu == "auto":
        return dtype == torch.bfloat16
    if gelu in ("exact", "erf"):
        return False
    if gelu == "tanh":
        return True
    raise ValueError(f"--gelu must be auto|exact|tanh, got {gelu!r}")


def build_clip(
    model_name: str = "biomedclip",
    embed_dim: int = 512,
    image_size: int = 224,
    context_length: int = 256,
    vocab_size: int = 30522,
    quick_gelu: bool = False,
    patch_dropout: float = 0.0,
    grad_checkpointing: bool = False,
    siglip: bool = False,
    dtype: torch.dtype = torch.float32,
    scan_impl: Optional[str] = None,
    quant: Optional[str] = None,
    gelu: str = "auto",
    attn_remat: bool = False,
    attn_flash: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ClipModel:
    """CLIP factory. ``biomedclip``/ViT names -> ViT-B/16 + PubMedBERT-shaped
    towers; ``medmamba``/``vssm`` -> the VSSM vision tower. Parameters are
    made on the CPU from ``generator``. ``attn_flash`` puts every attention
    interior on the flash path (``--attn-impl flash``). ``quant``: the
    ``--quant`` mode (``ops/quant.py``): its int8 dot goes into the towers'
    Dense layers, and the ``_attn`` modes also quantize the einsum interior,
    which the flash interior would replace."""
    from ..ops.quant import attn_int8, attn_int8_delayed, make_dot_general_cls

    dg_cls = make_dot_general_cls(quant)
    ai8, ai8d = attn_int8(quant), attn_int8_delayed(quant)
    if attn_flash and (ai8 or ai8d):
        raise ValueError(
            "--attn-impl flash replaces the attention interior the "
            f"int8 attention modes quantize; drop flash or use --quant "
            f"{quant!r} without the _attn suffix"
        )
    gelu_approx = resolve_gelu_approx(gelu, dtype)
    g = generator
    name = (model_name or "biomedclip").lower()
    if "medmamba" in name or "vssm" in name:
        vssm = VSSM(depths=(2, 2, 8, 2), dims=(64, 128, 256, 512), num_classes=0,
                    dtype=dtype, scan_impl=scan_impl, generator=g, dot_general_cls=dg_cls)
        visual = VssmTower(vssm, embed_dim=embed_dim, generator=g)
    else:
        visual = VisionTransformer(
            image_size=image_size, embed_dim=embed_dim, quick_gelu=quick_gelu,
            patch_dropout=patch_dropout, gelu_approx=gelu_approx,
            grad_checkpointing=grad_checkpointing, dtype=dtype, attn_remat=attn_remat,
            attn_flash=attn_flash, generator=g, dot_general_cls=dg_cls, attn_int8=ai8,
            attn_int8_delayed=ai8d)
    text = TextBert(
        vocab_size=vocab_size, context_length=context_length, embed_dim=embed_dim,
        grad_checkpointing=grad_checkpointing, dtype=dtype, gelu_approx=gelu_approx,
        attn_remat=attn_remat, attn_flash=attn_flash, generator=g, dot_general_cls=dg_cls,
        attn_int8=ai8, attn_int8_delayed=ai8d)
    return ClipModel(visual=visual, text=text, siglip=siglip)
