"""BERT-style text tower (PubMedBERT shape), in PyTorch.

Counterpart of ``mamba_clip_tpu/models/text_bert.py``: ``BertBlock``
(post-LN, eps 1e-12) and ``TextBert`` (token, position and type
embeddings, ``ln_emb``, the blocks, CLS pooling, then the ``mlp``,
``linear`` or ``none`` projection), with the Flax child names and
parameter shapes. The key mask is ``input_ids != pad_id``. The projection
MLP's GELU is always the exact (erf) form; the blocks' follows
``gelu_approx``. The tower has no dropout, so training mode differs from
eval only by ``grad_checkpointing`` (each block recomputed in the
backward) and ``attn_remat`` (the einsum interior recomputed).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .vit import FusedAttention, _dense, _normal_param, gelu, not_ported, remat
from .vssm import _layer_norm_f32, _linear


class BertBlock(nn.Module):
    """Post-LN transformer block: attention -> add & LN -> GELU MLP -> add & LN."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, gelu_approx: bool = False,
                 attn_flash: bool = False, attn_remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.gelu_approx = gelu_approx
        self.attn = FusedAttention(width, num_heads, dtype=dtype, flash_interior=attn_flash,
                                   remat_probs=attn_remat, generator=generator)
        self.ln_attn = nn.LayerNorm(width, eps=1e-12)
        self.fc1 = _dense(width, int(width * mlp_ratio), generator)
        self.fc2 = _dense(int(width * mlp_ratio), width, generator)
        self.ln_mlp = nn.LayerNorm(width, eps=1e-12)

    def forward(self, x, mask=None):
        x = _layer_norm_f32(x + self.attn(x, pad_mask=mask), self.ln_attn).to(self.dtype)
        y = _linear(gelu(_linear(x, self.fc1, self.dtype), self.gelu_approx), self.fc2,
                    self.dtype)
        return _layer_norm_f32(x + y, self.ln_mlp).to(self.dtype)


class TextBert(nn.Module):
    """BERT encoder with CLS pooling and a projection."""

    def __init__(
        self,
        vocab_size: int = 30522,
        context_length: int = 256,
        width: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        embed_dim: int = 512,
        proj_type: str = "mlp",
        pad_id: int = 0,
        grad_checkpointing: bool = False,
        dtype: torch.dtype = torch.float32,
        gelu_approx: bool = False,
        attn_remat: bool = False,
        attn_int8: bool = False,
        attn_int8_delayed: bool = False,
        attn_flash: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if attn_int8 or attn_int8_delayed:
            raise not_ported("the int8 attention interior")
        if proj_type not in ("mlp", "linear", "none"):
            raise ValueError(f"proj_type must be mlp|linear|none, got {proj_type!r}")
        g = generator
        self.depth = depth
        self.width = width
        self.embed_dim = embed_dim
        self.proj_type = proj_type
        self.pad_id = pad_id
        self.grad_checkpointing = grad_checkpointing
        self.dtype = dtype
        self.tok_emb = nn.Embedding(vocab_size, width, device="meta").to_empty(device="cpu")
        with torch.no_grad():
            self.tok_emb.weight.normal_(0.0, 0.02, generator=g)
        self.pos_emb = _normal_param((1, context_length, width), 0.02, g)
        self.type_emb = _normal_param((1, 1, width), 0.02, g)
        self.ln_emb = nn.LayerNorm(width, eps=1e-12)
        for i in range(depth):
            self.add_module(f"block{i}", BertBlock(
                width, num_heads, mlp_ratio, dtype=dtype, gelu_approx=gelu_approx,
                attn_flash=attn_flash, attn_remat=attn_remat, generator=g))
        if proj_type == "linear":
            self.proj = _dense(width, embed_dim, g, bias=False)
        elif proj_type == "mlp":
            self.proj_fc1 = _dense(width, (width + embed_dim) // 2, g)
            self.proj_fc2 = _dense((width + embed_dim) // 2, embed_dim, g, bias=False)

    def forward(self, input_ids):
        L = input_ids.shape[1]
        cdt = self.dtype
        x = (F.embedding(input_ids, self.tok_emb.weight).to(cdt)
             + self.pos_emb[:, :L].to(cdt) + self.type_emb.to(cdt))
        x = _layer_norm_f32(x, self.ln_emb).to(cdt)
        pad_mask = (input_ids != self.pad_id)[:, None, None, :]  # (B, 1, 1, L)
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.grad_checkpointing and torch.is_grad_enabled():
                x = remat(block, x, pad_mask)
            else:
                x = block(x, pad_mask)
        cls = x[:, 0].float()
        if self.proj_type == "linear":
            cls = F.linear(cls, self.proj.weight)
        elif self.proj_type == "mlp":
            h = gelu(F.linear(cls, self.proj_fc1.weight, self.proj_fc1.bias), False)
            cls = F.linear(h, self.proj_fc2.weight)
        return cls
