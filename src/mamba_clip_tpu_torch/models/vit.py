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
- The quantized modes (the int8 interiors) are not ported: asked for, they
  raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attn import attention_plain, flash_attention_interior
from .vssm import _apply_keep, _layer_norm_f32, _lecun_normal_, _linear, keep_mask

_NOT_PORTED = "is a quantized mode, not ported yet (ROADMAP.md, Queue 1, 'Quantized modes')"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {_NOT_PORTED}")


def remat(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward instead of keeping
    its activations. Nothing inside draws from a global generator, so there
    is no RNG state to stash and restore."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def _dense(d_in: int, d_out: int, generator, bias: bool = True) -> nn.Linear:
    """``nn.Dense``: lecun_normal kernel, zero bias (made without
    ``nn.Linear``'s own init, which would be drawn and thrown away)."""
    layer = nn.Linear(d_in, d_out, bias=bias, device="meta").to_empty(device="cpu")
    _lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _normal_param(shape, std: float, generator) -> nn.Parameter:
    """flax ``initializers.normal(std)``."""
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


def gelu(x, approximate: bool):
    """``flax.linen.gelu``: the tanh form when ``approximate``, else erf."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


class FusedAttention(nn.Module):
    """Multi-head attention with a fused (d, 3d) ``qkv`` projection, split
    into contiguous thirds, and an ``out`` projection. ``pad_mask``
    ``[B, 1, 1, T]`` masks keys only. ``remat_probs`` recomputes the einsum
    interior in the backward, keeping q, k and v instead of the
    ``[B, h, T, T]`` probabilities."""

    def __init__(self, width: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 flash_interior: bool = False, remat_probs: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.flash_interior = flash_interior
        self.remat_probs = remat_probs
        self.qkv = _dense(width, 3 * width, generator)
        self.out = _dense(width, width, generator)

    def forward(self, x, pad_mask=None):
        B, T, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = (t.reshape(B, T, h, hd)
                   for t in _linear(x, self.qkv, self.dtype).split(d, dim=-1))
        if self.flash_interior:
            o = flash_attention_interior(q, k, v, pad_mask, sm_scale=hd ** -0.5)
        elif self.remat_probs and torch.is_grad_enabled():
            o = remat(attention_plain, q, k, v, pad_mask, sm_scale=hd ** -0.5)
        else:
            o = attention_plain(q, k, v, pad_mask, sm_scale=hd ** -0.5)
        return _linear(o, self.out, self.dtype)


class MlpBlock(nn.Module):
    """``fc1`` -> GELU (tanh form when ``gelu_approx``) or quick GELU ->
    ``fc2``."""

    def __init__(self, width: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, quick_gelu: bool = False,
                 gelu_approx: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.quick_gelu = quick_gelu
        self.gelu_approx = gelu_approx
        self.fc1 = _dense(width, hidden_dim, generator)
        self.fc2 = _dense(hidden_dim, out_dim, generator)

    def forward(self, x):
        x = _linear(x, self.fc1, self.dtype)
        if self.quick_gelu:
            x = x * torch.sigmoid(1.702 * x)
        else:
            x = gelu(x, self.gelu_approx)
        return _linear(x, self.fc2, self.dtype)


class EncoderBlock(nn.Module):
    """Pre-norm transformer block (timm ViT style)."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, quick_gelu: bool = False,
                 gelu_approx: bool = False, attn_flash: bool = False,
                 attn_remat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = FusedAttention(width, num_heads, dtype=dtype, flash_interior=attn_flash,
                                   remat_probs=attn_remat, generator=generator)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = MlpBlock(width, int(width * mlp_ratio), width, dtype=dtype,
                            quick_gelu=quick_gelu, gelu_approx=gelu_approx,
                            generator=generator)

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
    ):
        super().__init__()
        if attn_int8 or attn_int8_delayed:
            raise not_ported("the int8 attention interior")
        g = generator
        self.patch_size = patch_size
        self.patch_dropout = patch_dropout
        self.grad_checkpointing = grad_checkpointing
        self.width = width
        self.depth = depth
        self.embed_dim = embed_dim
        self.dtype = dtype
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = _dense(patch_size * patch_size * 3, width, g)  # RGB patches
        self.cls_token = _normal_param((1, 1, width), 0.02, g)
        self.pos_embed = _normal_param((1, n_patches + 1, width), 0.02, g)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                width, num_heads, mlp_ratio, dtype=dtype, quick_gelu=quick_gelu,
                gelu_approx=gelu_approx, attn_flash=attn_flash, attn_remat=attn_remat,
                generator=g))
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
        cls = self.cls_token.to(self.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
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
            x = F.linear(x, self.proj.weight)
        return x
