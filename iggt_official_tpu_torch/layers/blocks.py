"""Transformer primitives (counterpart of `iggt_official_tpu/layers/blocks.py`).

Parameters are stored in fp32 and cast to the module's compute dtype at use,
as flax does with ``dtype=bf16``.  LayerNorms run in fp32 with flax's fast
variance E[x^2] - mu^2 (clamped at 0), which `torch.nn.LayerNorm` does not
compute; with ``fused_ln=True`` a block's pre-norms go through the fused
LayerNorm kernel (`ops/fused_ln.py`, two-pass variance) instead, on the same
parameters.  Q/K/V keep the (B, N, heads, head_dim) layout of the JAX package.

Tensor parallelism (`parallel/mesh.py::parallelize` sets ``tp``, the "model"
axis, on an `Mlp` or `Attention` whose weights it split): ``mlp.fc1`` runs
column-parallel and ``mlp.fc2`` / ``attn.proj`` row-parallel, their partial
products summed over "model" before the bias; `Attention` keeps ``qkv``
replicated and runs its slice of heads, or, when the head count does not
divide the axis, all heads with ``proj`` taking the rank's slice of its input
features.  The region's input and its replicated weights (``qkv``, the
qk-norms) pass through `parallel/comm.py::copy_to_parallel`, so their
gradients sum each rank's part.  With ``tp`` None (every module that
`parallelize` has not touched) the forward is the one-card forward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from iggt_official_tpu_torch.layers.rope import Rope2DTables, apply_rope_2d, pack_rope_tables
from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm
from iggt_official_tpu_torch.parallel.comm import (
    AxisGroup,
    copy_to_parallel,
    head_slice,
    reduce_parallel,
)


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

    def row_parallel(self, x: torch.Tensor, tp: AxisGroup) -> torch.Tensor:
        """x @ W^T summed over ``tp`` (this rank holds W's input-feature slice),
        then the bias."""
        dt = self.compute_dtype
        y = reduce_parallel(F.linear(x.to(dt), self.weight.to(dt)), tp)
        return y if self.bias is None else y + self.bias.to(dt)


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

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight`` / ``bias`` replace the parameters for one call (the
        tensor-parallel route passes them through `copy_to_parallel`)."""
        weight = self.weight if weight is None else weight
        bias = self.bias if bias is None else bias
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (xf - mu) * torch.rsqrt(var + self.eps) * weight + bias


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU."""
    return F.gelu(x)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matmul-softmax attention over (B, N, H, D), softmax in fp32.

    Mirrors `sdpa_xla`, which the JAX package computes outside any Pallas
    kernel (the camera head's blocks attend over S tokens, and the training
    step attends through it everywhere: it is differentiable, the kernels
    are not)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Mlp(nn.Module):
    """fc1 -> GELU (erf) -> fc2; with ``tp``, fc1 column- and fc2 row-parallel."""

    tp: Optional[AxisGroup] = None

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, bias=bias, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features, bias=bias,
                          dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.fc2(gelu_exact(self.fc1(x)))
        h = gelu_exact(self.fc1(copy_to_parallel(x, self.tp)))
        return self.fc2.row_parallel(h, self.tp)


class SwiGLUFFN(nn.Module):
    """w12 -> silu(x1) * x2 -> w3, the halves of w12's output in that order;
    hidden width (int(hidden_features * 2 / 3) + 7) // 8 * 8 (2736 at dim
    1024, mlp_ratio 4).  Tensor parallelism leaves it replicated, as the
    JAX package shards only ``mlp/fc1``, ``mlp/fc2`` and ``attn/proj``."""

    def __init__(self, in_features: int, hidden_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = swiglu_hidden(hidden_features)
        self.w12 = Linear(in_features, 2 * hidden, bias=bias, dtype=dtype)
        self.w3 = Linear(hidden, in_features, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


def swiglu_hidden(hidden_features: int) -> int:
    return (int(hidden_features * 2 / 3) + 7) // 8 * 8


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

    With qk-norm or RoPE and an ``attn_fn`` that sets
    ``supports_fused_qk_prep``, raw q/k go to ``attn_fn`` with the packed
    RoPE tables and the norm params, and the prep (fp32 LN + RoPE, one
    rounding) happens there -- inside the fused kernel on the card.  Any
    other ``attn_fn`` (`sdpa_plain`, as the training step passes) takes the
    unfused branch of the JAX package: the fp32 LN cast to the compute dtype,
    then RoPE in fp32 cast again (two roundings), then ``attn_fn(q, k, v)``.
    ``forward``'s ``attn_fn`` replaces the module's for one call (the merged
    global attention of one forward, `ops/token_merge.py`, or the training
    route)."""

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

    tp: Optional[AxisGroup] = None

    def forward(self, x: torch.Tensor, rope: Optional[Rope2DTables] = None,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        B, N, C = x.shape
        attn_fn = attn_fn or self.attn_fn
        if self.tp is not None:
            return self._forward_tp(x, rope, attn_fn)
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        norm_params = None
        if self.q_norm is not None:
            norm_params = (self.q_norm.weight, self.q_norm.bias,
                           self.k_norm.weight, self.k_norm.bias)
        out = self._attend(q, k, v, rope, norm_params, attn_fn)
        return self.proj(out.reshape(B, N, C))

    def _attend(self, q, k, v, rope, norm_params, attn_fn) -> torch.Tensor:
        """The fused protocol when ``attn_fn`` takes it, else the unfused prep
        (LN cast to the compute dtype, then RoPE) and ``attn_fn(q, k, v)``."""
        if (rope is not None or norm_params) and getattr(attn_fn, "supports_fused_qk_prep",
                                                         False):
            cos = sin = None
            if rope is not None:
                cos, sin = pack_rope_tables(rope)
            return attn_fn(q, k, v, rope_cos=cos, rope_sin=sin, qk_norm_params=norm_params)
        if norm_params:
            gq, bq, gk, bk = norm_params
            q = self.q_norm(q, gq, bq).to(self.dtype)
            k = self.k_norm(k, gk, bk).to(self.dtype)
        if rope is not None:
            q = apply_rope_2d(q, rope)
            k = apply_rope_2d(k, rope)
        return attn_fn(q, k, v)

    def _forward_tp(self, x, rope, attn_fn) -> torch.Tensor:
        """This model rank's heads (all of them when the count does not divide
        the axis), then the row-parallel ``proj``."""
        tp, H, D = self.tp, self.num_heads, self.head_dim
        B, N, C = x.shape
        dt = self.dtype
        heads = head_slice(H, tp)
        h = H if heads is None else heads.stop - heads.start
        x = copy_to_parallel(x, tp)
        w = copy_to_parallel(self.qkv.weight, tp).reshape(3, H, D, C)
        b = self.qkv.bias
        b = None if b is None else copy_to_parallel(b, tp).reshape(3, H, D)
        if heads is not None:
            w = w[:, heads]
            b = None if b is None else b[:, heads]
        qkv = F.linear(x.to(dt), w.reshape(3 * h * D, C).to(dt),
                       None if b is None else b.reshape(-1).to(dt))
        q, k, v = qkv.reshape(B, N, 3, h, D).unbind(2)
        norm_params = None
        if self.q_norm is not None:
            norm_params = tuple(copy_to_parallel(t, tp) for t in (
                self.q_norm.weight, self.q_norm.bias, self.k_norm.weight, self.k_norm.bias))
        out = self._attend(q, k, v, rope, norm_params, attn_fn).reshape(B, N, h * D)
        if heads is None:
            n = C // tp.size
            out = out[..., tp.rank * n:(tp.rank + 1) * n]
        return self.proj.row_parallel(out, tp)


class CrossAttention(nn.Module):
    """croco-style cross-attention: q from ``query``, k/v from a context map.

    ``attn_fn`` defaults to the flash-attention dispatcher; ``forward``'s
    replaces it for one call (the training route)."""

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

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        B, Nq, C = query.shape
        hd = C // self.num_heads
        q = self.projq(query).reshape(B, Nq, self.num_heads, hd)
        k = self.projk(key).reshape(B, -1, self.num_heads, hd)
        v = self.projv(value).reshape(B, -1, self.num_heads, hd)
        return self.proj((attn_fn or self.attn_fn)(q, k, v).reshape(B, Nq, C))


FFN_LAYERS = {"mlp": Mlp, "swiglu": SwiGLUFFN}


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale residuals (inference path);
    ``ffn_layer`` "mlp" (`Mlp`) or "swiglu" (`SwiGLUFFN`), both under ``mlp``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 ffn_bias: bool = True, init_values: Optional[float] = None,
                 qk_norm: bool = False, dtype: torch.dtype = torch.float32,
                 ln_eps: float = 1e-5, attn_fn: Callable = sdpa_plain,
                 ffn_layer: str = "mlp"):
        super().__init__()
        if ffn_layer not in FFN_LAYERS:
            raise ValueError(f"unknown ffn_layer {ffn_layer}")
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, proj_bias=proj_bias,
                              qk_norm=qk_norm, dtype=dtype, attn_fn=attn_fn)
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else nn.Identity()
        self.norm2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = FFN_LAYERS[ffn_layer](dim, int(dim * mlp_ratio), bias=ffn_bias, dtype=dtype)
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
