"""Train steps under the low-precision policies in the port against the JAX
package's jitted steps, on the CPU.

A small CLIP (``tests/test_torch_port_low_precision.py``: ViT image 32,
patch 16, width 32, depth 2; BERT vocab 128, context 16; embed 16; the
einsum interior, which on the CPU the flash interior is) takes the same
fp32 values from a numpy seed on both sides, cast as each pipeline casts
them, and takes three contrastive steps (deterministic crop, AdamW with
clipping at 1.0, weight decay 0.05) under ``pure_bf16`` (whose policy
``bf16`` is), ``fp16`` and ``pure_fp16``:

- the loss within rel 1e-2 and the grad norm within rel 5e-2 of JAX's at
  every step: bf16 and fp16 activations round at the same points in both
  frameworks but sum their GEMMs in other orders, so a few ulps move (the
  forward's envelope), and an Adam step moves a parameter by about lr
  whatever the gradient's size, so an ulp of a gradient moves a parameter
  by up to lr. Measured: the loss within 3e-4, the grad norm within
  1.3e-2;
- the types after every step equal JAX's leaf for leaf: the parameters in
  the policy's type, the moments too, except under ``pure_fp16``, whose
  gradients are unscaled by the fp32 loss scale and so are fp32, and so
  make fp32 moments (JAX ``train.py:320-340``);
- ``pure_fp16`` at ``--eps 1e-4`` and at the default 1e-8: in the train
  step the moments are fp32, so 1e-8 is not lost to fp16 and both packages
  stay finite at the same steps with no step skipped (the fp16 optimizer
  alone, fed fp16 gradients at 1e-8, is inf or NaN in both:
  ``test_adamw_update_is_optax_bit_for_bit[fp16_default_eps]``).
"""

import numpy as np
import pytest
import torch
from mamba_clip_tpu.utils.precision import get_policy as jax_get_policy
from mamba_clip_tpu_torch.utils.precision import get_policy
from test_torch_port_low_precision import (GNORM_REL, LOSS_REL, _batches, _Pair,  # noqa: F401
                                           _rel, clip_vars)

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

# bf16 is pure_bf16's policy in both packages (the same parameter, compute
# and output types), so its steps are pure_bf16's;
# tests/test_torch_port_cli.py runs it through the CLI
POLICIES = {"pure_bf16": ("pure_bf16", 1e-6), "fp16": ("fp16", 1e-6),
            "pure_fp16": ("pure_fp16", 1e-4), "pure_fp16_default_eps": ("pure_fp16", 1e-8)}


def test_bf16_is_pure_bf16s_policy():
    assert get_policy("bf16") == get_policy("pure_bf16")
    assert jax_get_policy("bf16") == jax_get_policy("pure_bf16")


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_three_steps_under_each_policy_match_jax(case, clip_vars):
    precision, eps = POLICIES[case]
    pair = _Pair(precision, clip_vars["vit"], eps=eps)
    for i, batch in enumerate(_batches(3)):
        got, want = pair.step(batch)
        for key in ("loss", "grad_norm"):
            assert np.isfinite(got[key]) and np.isfinite(want[key]), (case, i, key, got, want)
        assert _rel(got["loss"], want["loss"]) <= LOSS_REL, (case, i, got, want)
        assert _rel(got["grad_norm"], want["grad_norm"]) <= GNORM_REL, (case, i, got, want)
        assert got.get("skipped_steps", 0) == want.get("skipped_steps", 0)
        mine, theirs = pair.types()
        assert mine == theirs, (case, i)
