"""VSSM ("medmamba") classifier, in PyTorch.

Counterpart of the classification path of ``mamba_clip_tpu/models/vssm.py``:
``SS2D``, ``ConvBranch``, ``SSConvSSM``, ``PatchEmbed2D``, ``PatchMerging2D``,
``VSSLayer``, ``VSSM`` and ``medmamba``, with the same names, child names
and parameter shapes, so that ``convert.py`` maps a Flax variable tree onto
them leaf by leaf.

- Activations are NHWC at every module boundary, as in the JAX package;
  the convolutions permute to NCHW around ``F.conv2d`` and pad like Flax's
  ``padding="SAME"``.
- Parameters are fp32. Each module casts at its use sites as the JAX
  package does (``dtype=cdt`` for the GEMMs and convolutions, fp32 for the
  LayerNorms, the BatchNorm arithmetic and the head); no autocast region.
- The selective scan is ``ops/selective_scan.py``: the CUDA kernels for
  tensors on the card, the plain loops on the CPU, differentiable either
  way.
- ``train()``/``eval()`` play the part of Flax's ``deterministic``: in
  training mode BatchNorm normalizes with the batch statistics and updates
  its running ones, and DropPath and dropout draw their keep masks from the
  explicit ``torch.Generator`` passed to ``VSSM.forward`` (on the
  activations' device). The masks follow jax.random's distribution, not
  its bits: the two frameworks draw different streams.
- ``VSSLayer(use_checkpoint=True)`` recomputes each block in the backward
  (``torch.utils.checkpoint``, the counterpart of ``nn.remat``). A block's
  masks are drawn before the checkpointed function, and its recompute
  does not update the running statistics again.
- Initialization draws the JAX inits' distributions from a
  ``torch.Generator`` on the CPU; values differ from JAX's at the same seed.
- The decoder parts belong to later work.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.selective_scan import selective_scan_tm

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


def _trunc_normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """flax ``truncated_normal(stddev)``: a standard normal cut to [-2, 2],
    times ``std``, drawn as ``jax.random.truncated_normal`` draws it: the
    inverse error function of a uniform on [-erf(2/sqrt(2)), erf(2/sqrt(2))],
    times sqrt(2)."""
    with torch.no_grad():
        t.uniform_(-_ERF_2, _ERF_2, generator=generator).erfinv_()
        return t.mul_(math.sqrt(2.0) * std)


def _conv_kaiming_(w: torch.Tensor, generator) -> torch.Tensor:
    """flax ``variance_scaling(2.0, "fan_out", "truncated_normal")`` on a
    torch (O, I/groups, kh, kw) weight: fan_out = O * kh * kw, as for the
    Flax (kh, kw, I/groups, O) kernel."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    return _trunc_normal_(w, math.sqrt(2.0 / fan_out) / _TRUNC_STD, generator)


def _lecun_normal_(w: torch.Tensor, generator) -> torch.Tensor:
    """flax ``lecun_normal`` (nn.Dense's default) on a torch (out, in) weight."""
    return _trunc_normal_(w, math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD, generator)


def _linear(x, layer: nn.Linear, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _conv_nhwc(x, conv: nn.Conv2d, dtype):
    """``nn.Conv(..., padding="SAME", dtype=dtype)`` on NHWC input: XLA's
    SAME padding (the extra pixel, if any, after), computed in ``dtype``."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    H, W = x.shape[1], x.shape[2]
    ph = max((-(-H // sh) - 1) * sh + kh - H, 0)
    pw = max((-(-W // sw) - 1) * sw + kw - W, 0)
    xc = x.to(dtype).permute(0, 3, 1, 2)
    if ph or pw:
        xc = F.pad(xc, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    bias = None if conv.bias is None else conv.bias.to(dtype)
    out = F.conv2d(xc, conv.weight.to(dtype), bias, conv.stride,
                   groups=conv.groups)
    return out.permute(0, 2, 3, 1)


def _layer_norm_f32(x, ln: nn.LayerNorm):
    """``nn.LayerNorm(dtype=float32)``: statistics and output in fp32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave channel groups of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(b, h, w, c)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator], device):
    """A Bernoulli(1 - rate) keep mask of ``shape``, drawn from an explicit
    generator on ``device`` (``jax.random.bernoulli``'s counterpart: same
    distribution, another stream)."""
    if generator is None:
        raise ValueError(
            "dropout and DropPath in training mode draw from an explicit "
            "torch.Generator: pass generator= to the model's forward")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _apply_keep(x, mask, rate: float):
    """Flax ``Dropout``/``DropPath``: ``where(mask, x / keep, 0)`` in x's type."""
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (identity in eval mode or at rate 0).

    In training mode ``forward`` takes the per-sample keep mask, a bool
    tensor (batch,) that :meth:`draw` made from an explicit generator, and
    scales the kept samples by 1/keep, as JAX's ``DropPath`` does. The mask
    is drawn by the caller so that a checkpointed block's recompute applies
    the same one."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    @property
    def active(self) -> bool:
        return self.training and self.rate > 0.0

    def draw(self, batch: int, generator: Optional[torch.Generator], device):
        return keep_mask((batch,), self.rate, generator, device)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if not self.active:
            return x
        if mask is None:
            raise ValueError("DropPath in training mode needs its keep mask (DropPath.draw)")
        return _apply_keep(x, mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1)), self.rate)


class SS2D(nn.Module):
    """2D selective scan block: in_proj -> depthwise 3x3 conv + SiLU -> 4
    directional sequences -> per-direction projections -> selective scan
    -> merge -> LayerNorm -> y * silu(z) -> out_proj."""

    def __init__(
        self,
        d_model: int,
        d_state: int = 16,
        d_conv: int = 3,
        expand: int = 2,
        dt_rank: Optional[int] = None,
        dt_min: float = 0.001,
        dt_max: float = 0.1,
        dt_scale: float = 1.0,
        dt_init_floor: float = 1e-4,
        dropout: float = 0.0,
        conv_bias: bool = True,
        bias: bool = False,
        dtype: torch.dtype = torch.float32,
        scan_impl: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        K = 4
        d_inner = int(expand * d_model)
        self.d_inner = d_inner
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.d_state = N = d_state
        self.dtype = dtype
        self.scan_impl = scan_impl
        g = generator

        self.in_proj = nn.Linear(d_model, d_inner * 2, bias=bias)
        _trunc_normal_(self.in_proj.weight, 0.02, g)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv, groups=d_inner,
                                bias=conv_bias)
        _conv_kaiming_(self.conv2d.weight, g)

        R = self.dt_rank
        # variance_scaling(1/3, "fan_in", "uniform") over (K, R+2N, d_inner):
        # Flax's fan_in is shape[-2] times the leading K.
        lim = math.sqrt(1.0 / ((R + 2 * N) * K))
        self.x_proj_weight = nn.Parameter(
            torch.empty(K, R + 2 * N, d_inner).uniform_(-lim, lim, generator=g))
        std = R**-0.5 * dt_scale
        self.dt_projs_weight = nn.Parameter(
            torch.empty(K, d_inner, R).uniform_(-std, std, generator=g))
        # inverse-softplus of log-uniform [dt_min, dt_max]
        u = torch.rand(K, d_inner, generator=g)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = torch.clamp_min(dt, dt_init_floor)
        self.dt_projs_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        # S4D-real: A[d, n] = n + 1, stored as its log
        self.A_logs = nn.Parameter(torch.log(
            torch.arange(1, N + 1, dtype=torch.float32).repeat(K * d_inner, 1)))
        self.Ds = nn.Parameter(torch.ones(K * d_inner))

        self.out_norm = nn.LayerNorm(d_inner, eps=1e-5)
        self.out_proj = nn.Linear(d_inner, d_model, bias=bias)
        _trunc_normal_(self.out_proj.weight, 0.02, g)
        self.dropout = dropout
        for layer in (self.in_proj, self.conv2d, self.out_proj):
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor,
                drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_mask``: the output dropout's keep mask, (B, H, W, d_model)
        bool, needed in training mode when ``dropout > 0``."""
        B, H, W, _ = x.shape
        L = H * W
        d_inner, R, N, cdt = self.d_inner, self.dt_rank, self.d_state, self.dtype

        xz = _linear(x, self.in_proj, cdt)
        xpart, z = xz.chunk(2, dim=-1)
        xpart = F.silu(_conv_nhwc(xpart, self.conv2d, cdt))

        # 4 directional time-major sequences: row-major, col-major, and both
        # reversed.
        x_hw = xpart.reshape(B, L, d_inner)
        x_wh = xpart.transpose(1, 2).reshape(B, L, d_inner)
        xs = torch.stack([x_hw, x_wh, x_hw.flip(1), x_wh.flip(1)], dim=1)

        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight.to(cdt))
        dts_r, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts_r, self.dt_projs_weight.to(cdt))

        As = -torch.exp(self.A_logs)  # (K*D, N) fp32
        ys = selective_scan_tm(
            xs, dts, As, Bs, Cs,
            D=self.Ds, delta_bias=self.dt_projs_bias.reshape(-1),
            delta_softplus=True, impl=self.scan_impl,
        )  # (B, K, L, D) fp32

        # Merge the 4 directions back into row-major order.
        def wh_to_hw(y):
            return y.reshape(B, W, H, d_inner).transpose(1, 2).reshape(B, L, d_inner)

        y = (
            ys[:, 0]
            + wh_to_hw(ys[:, 1])
            + ys[:, 2].flip(1)
            + wh_to_hw(ys[:, 3].flip(1))
        )
        y = _layer_norm_f32(y, self.out_norm)
        y = y * F.silu(z.float().reshape(B, L, d_inner))
        y = y.reshape(B, H, W, d_inner).to(cdt)
        out = _linear(y, self.out_proj, cdt)
        if self.training and self.dropout > 0.0:
            if drop_mask is None:
                raise ValueError("SS2D dropout in training mode needs its keep mask")
            out = _apply_keep(out, drop_mask, self.dropout)
        return out


class ConvBranch(nn.Module):
    """BN -> 3x3 -> BN -> ReLU -> 3x3 -> BN -> ReLU -> 1x1 -> ReLU, NHWC in
    and out. ``bn{k}``/``conv{k}`` are Flax's ``BatchNorm_k``/``Conv_k``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        for k, ksize in enumerate((3, 3, 1)):
            # Flax momentum 0.9 on the running average is torch's 0.1.
            self.add_module(f"bn{k}", nn.BatchNorm2d(dim, eps=1e-5, momentum=0.1))
            conv = nn.Conv2d(dim, dim, ksize)
            _conv_kaiming_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f"conv{k}", conv)

    def _bn(self, x, bn: nn.BatchNorm2d, update_stats: bool):
        """Flax BatchNorm(dtype=cdt): normalize in fp32, return cdt.

        In training mode the statistics are the batch's, in fp32, with the
        biased variance E[x^2] - E[x]^2 (clipped at 0) that Flax's
        ``_compute_stats`` takes, and ``update_stats`` moves the running
        ones by Flax's momentum 0.9 (torch's 0.1) toward them: the biased
        variance there too, where ``F.batch_norm`` would store the unbiased
        one."""
        if not self.training:
            y = F.batch_norm(
                x.float().permute(0, 3, 1, 2), bn.running_mean, bn.running_var,
                bn.weight, bn.bias, False, bn.momentum, bn.eps)
            return y.permute(0, 2, 3, 1).to(self.dtype)
        x32 = x.float()
        mean = x32.mean(dim=(0, 1, 2))
        var = torch.clamp_min((x32 * x32).mean(dim=(0, 1, 2)) - mean * mean, 0.0)
        if update_stats:
            with torch.no_grad():
                m = bn.momentum
                bn.running_mean.mul_(1.0 - m).add_(m * mean)
                bn.running_var.mul_(1.0 - m).add_(m * var)
        y = (x32 - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        return y.to(self.dtype)

    def forward(self, x, update_stats: bool = True):
        cdt = self.dtype
        x = self._bn(x, self.bn0, update_stats)
        x = _conv_nhwc(x, self.conv0, cdt)
        x = F.relu(self._bn(x, self.bn1, update_stats))
        x = _conv_nhwc(x, self.conv1, cdt)
        x = F.relu(self._bn(x, self.bn2, update_stats))
        return F.relu(_conv_nhwc(x, self.conv2, cdt))


class SSConvSSM(nn.Module):
    """Split-channel block: conv branch || SS2D branch, concat, channel
    shuffle, residual."""

    def __init__(
        self,
        hidden_dim: int,
        drop_path: float = 0.0,
        attn_drop_rate: float = 0.0,
        d_state: int = 16,
        dtype: torch.dtype = torch.float32,
        scan_impl: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        half = hidden_dim // 2
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(half, eps=1e-6)
        self.self_attention = SS2D(
            d_model=half, d_state=d_state, dropout=attn_drop_rate, dtype=dtype,
            scan_impl=scan_impl, generator=generator)
        self.drop_path = DropPath(drop_path)
        self.conv_branch = ConvBranch(half, dtype=dtype, generator=generator)

    def draw_masks(self, x, generator: Optional[torch.Generator]):
        """The block's keep masks for input ``x`` in training mode:
        ``(drop_path, attn_drop)``, each None where it does not apply."""
        dp = self.drop_path.draw(x.shape[0], generator, x.device) \
            if self.drop_path.active else None
        sa = self.self_attention
        ad = None
        if self.training and sa.dropout > 0.0:
            ad = keep_mask(x.shape[:-1] + (x.shape[-1] // 2,), sa.dropout,
                           generator, x.device)
        return dp, ad

    def forward(self, x, masks=(None, None), update_stats: bool = True):
        """``masks`` from :meth:`draw_masks`; ``update_stats=False`` keeps
        BatchNorm's running statistics (a checkpoint's recompute)."""
        drop_path_mask, attn_drop_mask = masks
        left, right = x.chunk(2, dim=-1)
        r = _layer_norm_f32(right, self.ln_1)
        r = self.self_attention(r.to(self.dtype), attn_drop_mask)
        r = self.drop_path(r, drop_path_mask)
        l = self.conv_branch(left, update_stats)
        out = channel_shuffle(torch.cat([l, r], dim=-1), groups=2)
        return (out + x).to(x.dtype)


class PatchEmbed2D(nn.Module):
    """Conv patchify + optional LN."""

    def __init__(self, patch_size: int = 4, in_chans: int = 3, embed_dim: int = 96,
                 patch_norm: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        _conv_kaiming_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x):
        x = _conv_nhwc(x, self.proj, self.dtype)
        if self.norm is not None:
            x = _layer_norm_f32(x, self.norm).to(self.dtype)
        return x


class PatchMerging2D(nn.Module):
    """2x2 space-to-channel + LN + Linear 4C -> 2C."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        _trunc_normal_(self.reduction.weight, 0.02, generator)

    def forward(self, x):
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], dim=-1)
        x = _layer_norm_f32(x, self.norm).to(self.dtype)
        return _linear(x, self.reduction, self.dtype)


def _checkpointed_block(block: SSConvSSM, x, masks):
    """``block(x, masks)`` under ``torch.utils.checkpoint``: only the first
    run, the forward, updates BatchNorm's running statistics; the recompute
    in the backward reuses the masks drawn outside."""
    runs = []

    def run(x):
        runs.append(None)
        return block(x, masks, update_stats=len(runs) == 1)

    # Nothing inside draws from a global generator, so there is no RNG
    # state to stash and restore.
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class VSSLayer(nn.Module):
    """One stage: ``depth`` SSConvSSM blocks (``block{i}``), then an optional
    PatchMerging2D ``downsample``. With ``use_checkpoint`` each block is
    recomputed in the backward instead of keeping its activations."""

    def __init__(
        self,
        dim: int,
        depth: int,
        d_state: int = 16,
        attn_drop: float = 0.0,
        drop_path: Sequence[float] = (),
        downsample: bool = False,
        use_checkpoint: bool = False,
        dtype: torch.dtype = torch.float32,
        scan_impl: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        for i in range(depth):
            dp = drop_path[i] if i < len(drop_path) else 0.0
            self.add_module(f"block{i}", SSConvSSM(
                hidden_dim=dim, drop_path=dp, attn_drop_rate=attn_drop,
                d_state=d_state, dtype=dtype, scan_impl=scan_impl,
                generator=generator))
        self.downsample = (
            PatchMerging2D(dim, dtype=dtype, generator=generator)
            if downsample else None)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            masks = block.draw_masks(x, generator)
            if self.use_checkpoint and torch.is_grad_enabled():
                x = _checkpointed_block(block, x, masks)
            else:
                x = block(x, masks)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class VSSM(nn.Module):
    """MedMamba classifier: patch_embed -> stages (``layer{i}``, PatchMerging
    between) -> global average pool -> linear ``head``. With
    ``num_classes == 0`` the pooled features are returned."""

    def __init__(
        self,
        patch_size: int = 4,
        in_chans: int = 3,
        num_classes: int = 1000,
        depths: Sequence[int] = (2, 2, 4, 2),
        dims: Sequence[int] = (96, 192, 384, 768),
        d_state: int = 16,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        patch_norm: bool = True,
        use_checkpoint: bool = False,
        dtype: torch.dtype = torch.float32,
        scan_impl: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.num_classes = num_classes
        g = generator
        self.patch_embed = PatchEmbed2D(
            patch_size=patch_size, in_chans=in_chans, embed_dim=dims[0],
            patch_norm=patch_norm, dtype=dtype, generator=g)
        self.drop_rate = drop_rate
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        n = len(depths)
        for i in range(n):
            self.add_module(f"layer{i}", VSSLayer(
                dim=dims[i], depth=depths[i], d_state=d_state,
                attn_drop=attn_drop_rate,
                drop_path=dpr[sum(depths[:i]): sum(depths[: i + 1])],
                downsample=i < n - 1, use_checkpoint=use_checkpoint, dtype=dtype,
                scan_impl=scan_impl, generator=g))
        if num_classes > 0:
            self.head = nn.Linear(dims[-1], num_classes)
            _trunc_normal_(self.head.weight, 0.02, g)
            nn.init.zeros_(self.head.bias)
        else:
            self.head = None

    @property
    def num_features(self) -> int:
        return self.dims[-1]

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator``: the explicit generator, on ``x``'s device, that
        training mode draws the dropout and DropPath masks from."""
        x = self.patch_embed(x)
        if self.training and self.drop_rate > 0.0:
            x = _apply_keep(x, keep_mask(x.shape, self.drop_rate, generator, x.device),
                            self.drop_rate)
        for i in range(len(self.depths)):
            x = getattr(self, f"layer{i}")(x, generator)
        feats = x.mean(dim=(1, 2))  # (B, num_features)
        if self.head is None:
            return feats
        return F.linear(feats.float(), self.head.weight, self.head.bias)


def medmamba(num_classes: int = 2, **kw) -> VSSM:
    """The "medmamba" configuration: depths (2, 2, 8, 2), dims
    (64, 128, 256, 512)."""
    return VSSM(depths=(2, 2, 8, 2), dims=(64, 128, 256, 512),
                num_classes=num_classes, **kw)
