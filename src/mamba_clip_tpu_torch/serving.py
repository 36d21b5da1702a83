"""Serving entry points, in PyTorch.

Counterpart of ``mamba_clip_tpu/serving.py::make_serving_fns`` for the
classifier zoo: ``classify`` takes raw ``uint8 [B, staging, staging, 3]``
images (the host JPEG-decode wire format), runs the eval preprocess and the
model on the model's device, and returns fp32 class probabilities. The CLIP
towers (``image_embed``/``text_embed``) and the exported-artifact path
(``export_serving``, ``load_serving``, ``compress_params``) are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from .data.preprocess_cfg import get_transform_config
from .models import build_classifier
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
):
    """Build ``(model, {entry_point: fn(model, x)}, meta)`` for serving.

    The model is initialized on the CPU from ``generator`` (seed 0 when
    None), then moved to ``device`` in eval mode; load trained weights with
    ``convert.load_jax_variables`` or ``load_state_dict``. ``device`` is the
    card unless the caller asks for the CPU.
    """
    if quant in ("int8_delayed", "int8_delayed_attn"):
        raise ValueError(
            f"--quant {quant} is a TRAINING mode (its scales live in "
            "mutable model state); export serving artifacts with "
            "--quant int8_serve (per-channel weight scales) instead -- "
            "checkpoints trained under int8_delayed load fine either way"
        )
    if is_clip or not (
        model_name in (None, "vssm", "medmamba") or "mamba" in str(model_name)
    ):
        raise NotImplementedError(
            "image_embed/text_embed need the CLIP towers, which are not "
            "ported yet (ROADMAP.md, Queue 1, 'Towers and the CLIP wrapper')")
    policy = get_policy(precision)
    tcfg = get_transform_config(None, image_size, is_train=False)
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    model = build_classifier(
        model_name, num_classes=num_classes, dtype=policy.compute_dtype,
        quant=quant, scan_impl=scan_impl, generator=generator,
    )
    model = model.to(dev).eval()

    def classify(model, image_u8):
        with torch.inference_mode():
            x = eval_preprocess(
                torch.as_tensor(image_u8, device=dev), out_size=tcfg.image_size,
                mean=tcfg.mean, std=tcfg.std, out_dtype=policy.compute_dtype,
                interpolation=tcfg.interpolation or "bilinear",
            )
            logits = model(x)
            return torch.softmax(logits.float(), dim=-1)

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
    return model, {"classify": classify}, meta
