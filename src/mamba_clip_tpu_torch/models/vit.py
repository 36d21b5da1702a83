"""Vision Transformer tower (ViT-B/16), in PyTorch.

Counterpart of ``mamba_clip_tpu/models/vit.py``: ``FusedAttention``,
``MlpBlock``, ``EncoderBlock`` and ``VisionTransformer``, with the Flax
child names and parameter shapes, so that ``convert.py`` maps a Flax
variable tree onto them leaf by leaf.

- Inputs are NHWC, as in the JAX package. The patchify is a reshape into
  patches in ``(gh, gw, p_row, p_col, C)`` order and a Linear
  ``patch_embed`` (the Flax kernel ``(p*p*C, width)``), not a convolution.
- Parameters are fp32; each module casts at its use sites as the JAX
  package does (``dtype=cdt`` for the Linears, fp32 for the LayerNorms,
  eps 1e-6, the final norm and the projection).
- The attention interior is ``ops/flash_attn.py``: the plain (einsum)
  interior, or with ``flash_interior`` the flash interior, which launches
  the CUDA kernels for tensors on the card, forward and backward.
- Training mode: ``patch_dropout`` zeroes patch tokens (never CLS) and
  divides the kept ones by the keep rate, with a mask drawn from the
  explicit generator passed to ``forward`` (drawn outside any checkpointed
  region). ``grad_checkpointing`` recomputes each block in the backward
  (``torch.utils.checkpoint``, the counterpart of ``nn.remat``);
  ``attn_remat`` recomputes the einsum interior only, and changes nothing
  under the flash interior, which keeps no probabilities to recompute.
- ``dot_general_cls`` (``ops/quant.py``) puts the int8 dot of a
  ``--quant`` mode into ``patch_embed`` and every block's ``qkv``, ``out``,
  ``fc1`` and ``fc2``; the fp32 projection stays unquantized. With
  ``attn_int8`` (``int8_fast_attn``) the einsum interior runs its two dots
  in int8 with scales calibrated on the call, with ``attn_int8_delayed``
  (``int8_delayed_attn``) with delayed per-head q/k/v scales
  (``amax_q``, ``amax_k``, ``amax_v`` of each ``attn``) and the static 1/127
  scale of the probabilities. Neither goes with the flash interior.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import qdot
from ..ops.flash_attn import _MASKED, attention_plain, flash_attention_interior
from ..parallel.sharding import whole
from .vssm import _apply_keep, _layer_norm_f32, _lecun_normal_, _linear, keep_mask


def remat(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward instead of keeping
    its activations. Nothing inside draws from a global generator, so there
    is no RNG state to stash and restore."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def _dense(d_in: int, d_out: int, generator, bias: bool = True,
           dot_general_cls=None) -> nn.Linear:
    """``nn.Dense``: lecun_normal kernel, zero bias (made without
    ``nn.Linear``'s own init, which would be drawn and thrown away), on the
    default device: the CPU, or no storage under ``torch.device("meta")``;
    ``dot_general_cls``: the injected int8 dot."""
    layer = nn.Linear(d_in, d_out, bias=bias, device="meta").to_empty(
        device=torch.get_default_device())
    _lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return qdot.inject(layer, dot_general_cls)


def _normal_param(shape, std: float, generator) -> nn.Parameter:
    """flax ``initializers.normal(std)``."""
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


def gelu(x, approximate: bool):
    """``flax.linen.gelu``: the tanh form when ``approximate``, else erf."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _head_amax(t: torch.Tensor) -> torch.Tensor:
    """The per-head absmax (h,) of a ``[B, T, h, hd]`` tensor, floored at
    the dots' epsilon."""
    return torch.clamp_min(t.detach().float().abs().amax(dim=(0, 1, 3)), qdot._EPS)


def attention_int8(q, k, v, pad_mask=None, *, sm_scale: float, scales=None):
    """The einsum interior with its two dots in int8: per-(batch, head)
    scales calibrated on the call, or with ``scales`` (sq, sk, sv, each
    (1, 1, h, 1)) the delayed dots. Returns ``[B, T, h*hd]`` in q's type."""
    B, T, h, hd = q.shape
    if scales is None:
        s = qdot.int8_qk_dot(q, k) * sm_scale
    else:
        s = qdot.int8_qk_dot_delayed(q, k, scales[0], scales[1]) * sm_scale
    s = s.float()
    if pad_mask is not None:
        s = s.masked_fill(~pad_mask, _MASKED)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if scales is None:
        return qdot.int8_pv_dot(p, v).reshape(B, T, h * hd)
    return qdot.int8_pv_dot_delayed(p, v, scales[2]).reshape(B, T, h * hd)


class FusedAttention(nn.Module):
    """Multi-head attention with a fused (d, 3d) ``qkv`` projection, split
    into contiguous thirds, and an ``out`` projection. ``pad_mask``
    ``[B, 1, 1, T]`` masks keys only. ``remat_probs`` recomputes the einsum
    interior in the backward, keeping q, k and v instead of the
    ``[B, h, T, T]`` probabilities. ``int8_interior`` and
    ``int8_delayed_interior`` run the einsum interior in int8
    (:func:`attention_int8`); the delayed one keeps the per-head absmax of q,
    k and v as ``amax_q``, ``amax_k`` and ``amax_v``."""

    def __init__(self, width: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 flash_interior: bool = False, remat_probs: bool = False,
                 generator: Optional[torch.Generator] = None, dot_general_cls=None,
                 int8_interior: bool = False, int8_delayed_interior: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.flash_interior = flash_interior
        self.remat_probs = remat_probs
        self.int8_interior = int8_interior
        self.int8_delayed_interior = int8_delayed_interior
        self.qkv = _dense(width, 3 * width, generator, dot_general_cls=dot_general_cls)
        self.out = _dense(width, width, generator, dot_general_cls=dot_general_cls)
        if int8_delayed_interior:
            qdot.register_delayed(self, amax_q=(num_heads,), amax_k=(num_heads,),
                                  amax_v=(num_heads,))

    def forward(self, x, pad_mask=None):
        B, T, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = (t.reshape(B, T, h, hd)
                   for t in _linear(x, self.qkv, self.dtype).split(d, dim=-1))
        sm = hd ** -0.5
        if self.flash_interior:
            return _linear(flash_attention_interior(q, k, v, pad_mask, sm_scale=sm),
                           self.out, self.dtype)
        kw = {"sm_scale": sm}
        interior = attention_plain
        if self.int8_delayed_interior:
            kw["scales"] = tuple(
                qdot._over_127(qdot.delayed_amax(self, name, _head_amax(t))).reshape(
                    1, 1, h, 1)
                for name, t in (("amax_q", q), ("amax_k", k), ("amax_v", v)))
            interior = attention_int8
        elif self.int8_interior:
            interior = attention_int8
        if self.remat_probs and torch.is_grad_enabled():
            o = remat(interior, q, k, v, pad_mask, **kw)
        else:
            o = interior(q, k, v, pad_mask, **kw)
        return _linear(o, self.out, self.dtype)


class MlpBlock(nn.Module):
    """``fc1`` -> GELU (tanh form when ``gelu_approx``) or quick GELU ->
    ``fc2``."""

    def __init__(self, width: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, quick_gelu: bool = False,
                 gelu_approx: bool = False, generator: Optional[torch.Generator] = None,
                 dot_general_cls=None):
        super().__init__()
        self.dtype = dtype
        self.quick_gelu = quick_gelu
        self.gelu_approx = gelu_approx
        self.fc1 = _dense(width, hidden_dim, generator, dot_general_cls=dot_general_cls)
        self.fc2 = _dense(hidden_dim, out_dim, generator, dot_general_cls=dot_general_cls)

    def forward(self, x):
        x = _linear(x, self.fc1, self.dtype)
        if self.quick_gelu:
            x = x * torch.sigmoid(1.702 * x)
        else:
            x = gelu(x, self.gelu_approx)
        return _linear(x, self.fc2, self.dtype)


class EncoderBlock(nn.Module):
    """Pre-norm transformer block (timm ViT style)."""

    gather_unit = True  # per-layer gathering on a placed model (parallel/sharding.py)

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, quick_gelu: bool = False,
                 gelu_approx: bool = False, attn_flash: bool = False,
                 attn_remat: bool = False, generator: Optional[torch.Generator] = None,
                 dot_general_cls=None, attn_int8: bool = False,
                 attn_int8_delayed: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = FusedAttention(width, num_heads, dtype=dtype, flash_interior=attn_flash,
                                   remat_probs=attn_remat, generator=generator,
                                   dot_general_cls=dot_general_cls, int8_interior=attn_int8,
                                   int8_delayed_interior=attn_int8_delayed)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = MlpBlock(width, int(width * mlp_ratio), width, dtype=dtype,
                            quick_gelu=quick_gelu, gelu_approx=gelu_approx,
                            generator=generator, dot_general_cls=dot_general_cls)

    def forward(self, x):
        x = x + self.attn(_layer_norm_f32(x, self.norm1).to(self.dtype))
        return x + self.mlp(_layer_norm_f32(x, self.norm2).to(self.dtype))


class VisionTransformer(nn.Module):
    """ViT with CLS pooling and an optional projection (``embed_dim=None``:
    the raw width). Defaults are ViT-B/16 at 224 px, the BiomedCLIP visual
    tower."""

    def __init__(
        self,
        image_size: int = 224,
        patch_size: int = 16,
        width: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        embed_dim: Optional[int] = 512,
        patch_dropout: float = 0.0,
        quick_gelu: bool = False,
        gelu_approx: bool = False,
        grad_checkpointing: bool = False,
        dtype: torch.dtype = torch.float32,
        attn_remat: bool = False,
        attn_int8: bool = False,
        attn_int8_delayed: bool = False,
        attn_flash: bool = False,
        generator: Optional[torch.Generator] = None,
        dot_general_cls=None,
    ):
        super().__init__()
        g = generator
        self.patch_size = patch_size
        self.patch_dropout = patch_dropout
        self.grad_checkpointing = grad_checkpointing
        self.width = width
        self.depth = depth
        self.embed_dim = embed_dim
        self.dtype = dtype
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = _dense(patch_size * patch_size * 3, width, g,  # RGB patches
                                  dot_general_cls=dot_general_cls)
        self.cls_token = _normal_param((1, 1, width), 0.02, g)
        self.pos_embed = _normal_param((1, n_patches + 1, width), 0.02, g)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                width, num_heads, mlp_ratio, dtype=dtype, quick_gelu=quick_gelu,
                gelu_approx=gelu_approx, attn_flash=attn_flash, attn_remat=attn_remat,
                generator=g, dot_general_cls=dot_general_cls, attn_int8=attn_int8,
                attn_int8_delayed=attn_int8_delayed))
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.proj = _dense(width, embed_dim, g, bias=False) if embed_dim is not None else None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator``: the explicit generator, on ``x``'s device, that
        training mode draws the patch-dropout mask from."""
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        patches = (x.to(self.dtype).reshape(B, gh, p, gw, p, C)
                   .permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C))
        x = _linear(patches, self.patch_embed, self.dtype)
        cls = whole(self, "cls_token").to(self.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + whole(self, "pos_embed").to(self.dtype)
        if self.patch_dropout > 0.0 and self.training:
            mask = keep_mask((B, x.shape[1] - 1, 1), self.patch_dropout, generator, x.device)
            x = torch.cat([x[:, :1], _apply_keep(x[:, 1:], mask, self.patch_dropout)], dim=1)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.grad_checkpointing and torch.is_grad_enabled():
                x = remat(block, x)
            else:
                x = block(x)
        x = _layer_norm_f32(x[:, 0], self.norm)
        if self.proj is not None:
            x = _linear(x, self.proj, torch.float32)
        return x
