"""The port's eval preprocess and transform config against the JAX package.

Tolerance: fp32 atol 1e-5. Both sides compute the same float32 sample
grid and the same separable weights in the same order; what differs is
only the rounding of the gathers' sums, well below 1e-5 on values of
order 1/std ~ 4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_clip_tpu.data.preprocess_cfg import get_transform_config as jax_cfg
from mamba_clip_tpu.ops.preprocess import eval_preprocess as jax_eval
from mamba_clip_tpu_torch.data.preprocess_cfg import get_transform_config as torch_cfg
from mamba_clip_tpu_torch.ops.preprocess import eval_preprocess as torch_eval

ATOL = 1e-5


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest", "bicubic", "random"])
@pytest.mark.parametrize("hw", [(64, 64), (40, 56)])
def test_eval_preprocess_matches_jax(interpolation, hw):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, size=(3, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_eval(
        jnp.asarray(imgs), out_size=32, out_dtype=jnp.float32,
        interpolation=interpolation))
    got = torch_eval(torch.from_numpy(imgs), out_size=32, out_dtype=torch.float32,
                     interpolation=interpolation).numpy()
    assert got.shape == want.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_eval_preprocess_dtype_and_errors():
    imgs = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert torch_eval(imgs, out_size=4).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown interpolation"):
        torch_eval(imgs, out_size=4, interpolation="lanczos")
    with pytest.raises(ValueError, match="uint8"):
        torch_eval(imgs.float(), out_size=4)


@pytest.mark.parametrize("kw", [
    dict(aug_cfg=None, image_size=224),
    dict(aug_cfg={"scale": (0.5, 1.0), "hflip": 0.0, "interpolation": "bicubic"},
         image_size=32, is_train=True),
    dict(aug_cfg=None, image_size=96, mean=(0.5, 0.5, 0.5), std=(0.2, 0.2, 0.2),
         interpolation="nearest"),
])
def test_transform_config_matches_jax(kw):
    assert torch_cfg(**kw).__dict__ == jax_cfg(**kw).__dict__
