"""Transform configuration descriptors.

A copy of ``mamba_clip_tpu/data/preprocess_cfg.py``: the host only
decodes, the math runs on the device (ops/preprocess.py), so a "transform"
is a small config record. The JAX module imports its constants from a JAX
module, hence the copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..ops.preprocess import OPENAI_MEAN, OPENAI_STD


@dataclass(frozen=True)
class TransformConfig:
    image_size: int = 224
    staging_size: int = 256          # host decode/resize target (square)
    is_train: bool = False
    mean: Tuple[float, ...] = tuple(OPENAI_MEAN)
    std: Tuple[float, ...] = tuple(OPENAI_STD)
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip: float = 0.5
    re_prob: float = 0.0             # timm re_mode="pixel", prob defaults 0
    interpolation: str = "bilinear"


def get_transform_config(
    aug_cfg: Optional[dict],
    image_size: int = 224,
    is_train: bool = False,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    interpolation: Optional[str] = None,
) -> TransformConfig:
    """``interpolation`` carries --image-interpolation; an aug_cfg
    'interpolation' entry overrides it (timm's aug-cfg-beats-default
    precedence)."""
    aug = dict(aug_cfg or {})
    return TransformConfig(
        image_size=image_size,
        staging_size=max(image_size + 32, int(image_size * 256 / 224)),
        is_train=is_train,
        mean=tuple(mean) if mean else tuple(OPENAI_MEAN),
        std=tuple(std) if std else tuple(OPENAI_STD),
        scale=tuple(aug.get("scale", (0.08, 1.0))),
        ratio=tuple(aug.get("ratio", (0.75, 4.0 / 3.0))),
        hflip=float(aug.get("hflip", 0.5)),
        re_prob=float(aug.get("re_prob", 0.0)),
        interpolation=str(aug.get("interpolation", interpolation or "bilinear")),
    )
