"""Transformer primitives (counterpart of `iggt_official_tpu/layers/blocks.py`).

Parameters are stored in fp32 and cast to the module's compute dtype at use,
as flax does with ``dtype=bf16``.  LayerNorms run in fp32 with flax's fast
variance E[x^2] - mu^2 (clamped at 0), which `torch.nn.LayerNorm` does not
compute; with ``fused_ln=True`` a block's pre-norms go through the fused
LayerNorm kernel (`ops/fused_ln.py`, two-pass variance) instead, on the same
parameters.  Q/K/V keep the (B, N, heads, head_dim) layout of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from iggt_official_tpu_torch.layers.rope import Rope2DTables, pack_rope_tables
from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm


class Linear(nn.Linear):
    """nn.Linear that computes in ``dtype`` (weights kept fp32, cast at use)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """fp32 LayerNorm over the last axis with flax's fast variance.

    y = (x - mu) * (rsqrt(var + eps) * weight) + bias, var = max(E[x^2] - mu^2, 0),
    computed and returned in fp32 (callers cast)."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mu) * mul
        if self.bias is not None:
            y = y + self.bias
        return y


class HeadLayerNorm(nn.Module):
    """fp32 LayerNorm over head_dim: (x - mu) * rsqrt(var + eps) * weight + bias.

    The fused attention protocol hands (weight, bias) to the kernel, which
    applies the same normalization in-kernel."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (xf - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU."""
    return F.gelu(x)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matmul-softmax attention over (B, N, H, D), softmax in fp32.

    Mirrors `sdpa_xla`, which the JAX package computes outside any Pallas
    kernel (the camera head's blocks attend over S tokens)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Mlp(nn.Module):
    """fc1 -> GELU (erf) -> fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, bias=bias, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features, bias=bias,
                          dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


class LayerScale(nn.Module):
    """Learnable per-channel residual scale."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    """MHA with optional qk-norm (LayerNorm over head_dim) and 2D RoPE.

    With qk-norm or RoPE, raw q/k go to ``attn_fn`` with the packed RoPE
    tables and the norm params, and the prep (fp32 LN + RoPE, one rounding)
    happens there -- inside the fused kernel on the card.  Such an
    ``attn_fn`` must set ``supports_fused_qk_prep``; there is no prep here.
    ``forward``'s ``attn_fn`` replaces the module's for one call (the merged
    global attention of one forward, `ops/token_merge.py`)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attn_fn: Callable = sdpa_plain):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        if qk_norm:
            self.q_norm = HeadLayerNorm(self.head_dim)
            self.k_norm = HeadLayerNorm(self.head_dim)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Linear(dim, dim, bias=proj_bias, dtype=dtype)

    def forward(self, x: torch.Tensor, rope: Optional[Rope2DTables] = None,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        B, N, C = x.shape
        attn_fn = attn_fn or self.attn_fn
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        qk_norm = self.q_norm is not None
        if rope is not None or qk_norm:
            if not getattr(attn_fn, "supports_fused_qk_prep", False):
                raise ValueError("qk-norm and RoPE need an attn_fn with "
                                 "supports_fused_qk_prep")
            norm_params = None
            if qk_norm:
                norm_params = (self.q_norm.weight, self.q_norm.bias,
                               self.k_norm.weight, self.k_norm.bias)
            cos = sin = None
            if rope is not None:
                cos, sin = pack_rope_tables(rope)
            out = attn_fn(q, k, v, rope_cos=cos, rope_sin=sin, qk_norm_params=norm_params)
        else:
            out = attn_fn(q, k, v)
        return self.proj(out.reshape(B, N, C))


class CrossAttention(nn.Module):
    """croco-style cross-attention: q from ``query``, k/v from a context map.

    ``attn_fn`` defaults to the flash-attention dispatcher."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        if attn_fn is None:
            from iggt_official_tpu_torch.ops.flash_attention import attention as attn_fn
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.projq = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.projk = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.projv = Linear(dim, dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        B, Nq, C = query.shape
        hd = C // self.num_heads
        q = self.projq(query).reshape(B, Nq, self.num_heads, hd)
        k = self.projk(key).reshape(B, -1, self.num_heads, hd)
        v = self.projv(value).reshape(B, -1, self.num_heads, hd)
        return self.proj(self.attn_fn(q, k, v).reshape(B, Nq, C))


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale residuals (inference path)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 ffn_bias: bool = True, init_values: Optional[float] = None,
                 qk_norm: bool = False, dtype: torch.dtype = torch.float32,
                 ln_eps: float = 1e-5, attn_fn: Callable = sdpa_plain):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, proj_bias=proj_bias,
                              qk_norm=qk_norm, dtype=dtype, attn_fn=attn_fn)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), bias=ffn_bias, dtype=dtype)
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()

    def _pre_norm(self, norm: LayerNorm, x: torch.Tensor, fused_ln: bool) -> torch.Tensor:
        if fused_ln:
            return fused_layernorm(x, norm.weight, norm.bias, norm.eps, out_dtype=self.dtype)
        return norm(x).to(self.dtype)

    def forward(self, x: torch.Tensor, rope: Optional[Rope2DTables] = None,
                fused_ln: bool = False, attn_fn: Optional[Callable] = None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self._pre_norm(self.norm1, x, fused_ln), rope=rope,
                                   attn_fn=attn_fn))
        return x + self.ls2(self.mlp(self._pre_norm(self.norm2, x, fused_ln)))
