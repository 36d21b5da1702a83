"""Serving entry points, in PyTorch.

Counterpart of ``mamba_clip_tpu/serving.py::make_serving_fns``. The
classifier zoo gets ``classify``: raw ``uint8 [B, staging, staging, 3]``
images (the host JPEG-decode wire format) -> eval preprocess -> model ->
fp32 class probabilities. The CLIP models (``is_clip``, or a non-mamba
name) get ``image_embed`` (uint8 images -> L2-normalized fp32
``[B, embed_dim]``) and ``text_embed`` (int32 ``[B, context]`` tokens ->
the same). Everything runs on the model's device. The exported-artifact
path (``export_serving``, ``load_serving``, ``compress_params``) is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from .data.preprocess_cfg import get_transform_config
from .models import build_classifier, build_clip
from .ops.flash_attn import resolve_attn_flash
from .ops.preprocess import eval_preprocess
from .utils.precision import get_policy


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
    if quant in ("int8_delayed", "int8_delayed_attn"):
        raise ValueError(
            f"--quant {quant} is a TRAINING mode (its scales live in "
            "mutable model state); export serving artifacts with "
            "--quant int8_serve (per-channel weight scales) instead -- "
            "checkpoints trained under int8_delayed load fine either way"
        )
    policy = get_policy(precision)
    tcfg = get_transform_config(None, image_size, is_train=False)
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def prep(image_u8):
        return eval_preprocess(
            torch.as_tensor(image_u8, device=dev), out_size=tcfg.image_size,
            mean=tcfg.mean, std=tcfg.std, out_dtype=policy.compute_dtype,
            interpolation=tcfg.interpolation or "bilinear",
        )

    # Mamba-family names default to the classifier zoo; is_clip=True builds
    # the VSSM-towered CLIP instead, as the JAX package does.
    if not is_clip and (
        model_name in (None, "vssm", "medmamba") or "mamba" in str(model_name)
    ):
        model = build_classifier(
            model_name, num_classes=num_classes, dtype=policy.compute_dtype,
            quant=quant, scan_impl=scan_impl, generator=generator,
        )

        def classify(model, image_u8):
            with torch.inference_mode():
                return torch.softmax(model(prep(image_u8)).float(), dim=-1)

        fns = {"classify": classify}
    else:
        model = build_clip(
            model_name=model_name, image_size=image_size,
            context_length=context_length, vocab_size=vocab_size,
            dtype=policy.compute_dtype, quant=quant, scan_impl=scan_impl,
            attn_flash=resolve_attn_flash(attn_impl), generator=generator,
        )

        def image_embed(model, image_u8):
            with torch.inference_mode():
                return model.encode_image(prep(image_u8), normalize=True).float()

        def text_embed(model, tokens):
            with torch.inference_mode():
                return model.encode_text(
                    torch.as_tensor(tokens, device=dev), normalize=True).float()

        fns = {"image_embed": image_embed, "text_embed": text_embed}
    model = model.to(dev).eval()

    meta = {
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
    return model, fns, meta
