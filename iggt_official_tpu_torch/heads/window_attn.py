"""HAT-style window attention used by the part head, channels-last.

Counterpart of `iggt_official_tpu/heads/window_attn.py`:
- ``SwinSA``: window self-attention (HAB: plain bias-free windowed MHA +
  channel-attention conv branch x0.01 + MLP) in a conv-residual body.
- ``SwinCA``: overlapping-window cross-attention (OCAB: ws x ws query windows
  against (ws + ws/2)^2 key/value windows with a relative-position bias).

The windowed attention is plain matmul-softmax, as in the JAX package (it is
computed outside any Pallas kernel there).  OCAB's ``q_window_mode``:
"reference" (the default) replicates the checkpoint's channel-scrambled q
partition, "hat" takes the spatially-correct upstream-HAT partition (for
training from scratch), as in the JAX package.  Windows are
unshifted (the shipped config uses shift 0); sizes that are not multiples of
the window are edge-padded and cropped back.  Module names follow the
reference checkpoint (`patch_embed.norm`, `atten_block.attn.qkv`,
`conv_block.cab.<i>`, `conv_before_upsample.0`).  Everything computes in
``dtype`` (fp32, or bf16 as the fast mode) except the LayerNorms and the
softmax, which run in fp32 and cast back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm, Linear, Mlp
from iggt_official_tpu_torch.ops.conv import Conv2d


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nh*nw, ws*ws, C) row-major windows."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B*nh*nw, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def scrambled_q_partition(q: torch.Tensor, ws: int) -> torch.Tensor:
    """The reference OCAB's q-window partition, op for op: q permuted to NCHW,
    cut into windows over (C, H) with W as channels, then the buffer read as
    (-1, ws*ws, C).  q: (B, H, W, C) -> (B*H*W/ws^2, ws*ws, C)."""
    B, H, W, C = q.shape
    if C % ws or H % ws:
        raise ValueError(f"reference OCAB q-partition needs C({C}) and H({H}) % ws({ws}) == 0")
    x = q.permute(0, 3, 1, 2).reshape(B, C // ws, ws, H // ws, ws, W)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, W)
    return x.reshape(-1, ws * ws, C)


def extract_overlapping_windows(x: torch.Tensor, ws: int, ows: int) -> torch.Tensor:
    """Overlapping ows x ows windows at stride ws, zero padded by (ows-ws)/2.
    x: (B, H, W, C), H and W multiples of ws -> (B*nh*nw, ows*ows, C)."""
    B, H, W, C = x.shape
    p = (ows - ws) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    wins = xp.unfold(1, ows, ws).unfold(2, ows, ws)      # (B, nh, nw, C, ows, ows)
    wins = wins.permute(0, 1, 2, 4, 5, 3)
    return wins.reshape(-1, ows * ows, C)


def rpi_window_sa(ws: int) -> np.ndarray:
    """Relative-position index for ws x ws self-attention windows."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def rpi_window_oca(ws: int, ows: int) -> np.ndarray:
    """Relative-position index: ws x ws queries vs ows x ows keys."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    ce = np.stack(np.meshgrid(np.arange(ows), np.arange(ows), indexing="ij"))
    fo = co.reshape(2, -1)
    fe = ce.reshape(2, -1)
    rel = fe[:, None, :] - fo[:, :, None]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


def _pad_to_multiple(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pad H and W of (B, H, W, C) up to multiples of ws."""
    H, W = x.shape[1], x.shape[2]
    ph, pw = (-H) % ws, (-W) % ws
    if ph:
        x = torch.cat([x, x[:, -1:].expand(-1, ph, -1, -1)], dim=1)
    if pw:
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw, -1)], dim=2)
    return x, (H, W)


def _window_mha(q, k, v, bias=None):
    """(BN, nq, h, d) x (BN, nk, h, d) windows; softmax in fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias[None]
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class WindowAttention(nn.Module):
    """Windowed MHA with a relative-position-bias table over (B_, N, C)
    windows, ``rpi`` the (N, N) index (`rpi_window_sa`).  No block of the
    model uses it: `HAB` attends without the bias, as the reference
    checkpoint's path does (the JAX package keeps this class for parity)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, rpi) -> torch.Tensor:
        B_, N, C = x.shape
        x = x.to(self.dtype)
        qkv = self.qkv(x).reshape(B_, N, 3, self.num_heads, C // self.num_heads)
        rpi = torch.as_tensor(rpi, device=x.device).reshape(-1)
        bias = self.relative_position_bias_table[rpi].reshape(N, N, -1).permute(2, 0, 1)
        out = _window_mha(*qkv.unbind(2), bias)
        return self.proj(out.reshape(B_, N, C))


class _Pool(nn.Module):
    """Global average pool over H, W of an NHWC map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2), keepdim=True)


class ChannelAttention(nn.Module):
    """Squeeze-excite channel gate."""

    def __init__(self, features: int, squeeze_factor: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = features // squeeze_factor
        self.attention = nn.Sequential(
            _Pool(), Conv2d(features, hidden, 1, dtype=dtype), nn.ReLU(),
            Conv2d(hidden, features, 1, dtype=dtype), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.attention(x)


class _AttnProjections(nn.Module):
    """Holds the window self-attention's qkv / proj under the reference names."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)


class HAB(nn.Module):
    """Hybrid attention block (no shift), NHWC in/out."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 conv_scale: float = 0.01, mlp_ratio: float = 4.0,
                 compress_ratio: int = 3, squeeze_factor: int = 30,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.conv_scale = conv_scale
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = _AttnProjections(dim, dtype)
        self.conv_block = nn.Module()
        self.conv_block.cab = nn.Sequential(
            Conv2d(dim, dim // compress_ratio, 3, padding=1, dtype=dtype),
            nn.GELU(),
            Conv2d(dim // compress_ratio, dim, 3, padding=1, dtype=dtype),
            ChannelAttention(dim, squeeze_factor, dtype))
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        xn = self.norm1(x).to(self.dtype)
        conv_x = self.conv_block.cab(xn)
        xw, (H0, W0) = _pad_to_multiple(xn, self.window_size)
        Hp, Wp = xw.shape[1], xw.shape[2]
        wins = window_partition(xw, self.window_size)
        hd = C // self.num_heads
        qkv = self.attn.qkv(wins).reshape(wins.shape[0], wins.shape[1], 3,
                                          self.num_heads, hd)
        attn = _window_mha(*qkv.unbind(2)).reshape(wins.shape[0], wins.shape[1], C)
        attn = self.attn.proj(attn)
        attn = window_reverse(attn, self.window_size, Hp, Wp)[:, :H0, :W0]
        x = x + attn + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    """Overlapping-window cross-attention block; q, k and v share ``norm1``.
    ``q_window_mode``: "reference" (the checkpoint's scrambled q partition)
    or "hat" (row-major ws x ws windows)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0,
                 q_window_mode: str = "reference", dtype: torch.dtype = torch.float32):
        super().__init__()
        if q_window_mode not in ("reference", "hat"):
            raise ValueError(f"unknown q_window_mode {q_window_mode!r}")
        self.q_window_mode = q_window_mode
        ws = window_size
        ows = int(ws * overlap_ratio) + ws
        self.num_heads = num_heads
        self.window_size = ws
        self.overlap_win_size = ows
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((ws + ows - 1) ** 2, num_heads))
        self.register_buffer("rpi", torch.tensor(rpi_window_oca(ws, ows)),
                             persistent=False)
        self.norm1 = LayerNorm(dim)
        self.q = Linear(dim, dim, dtype=dtype)
        self.k = Linear(dim, dim, dtype=dtype)
        self.v = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, ows = self.window_size, self.overlap_win_size
        q = self.q(self.norm1(x))
        kk = self.k(self.norm1(k))
        vv = self.v(self.norm1(v))
        q, (H0, W0) = _pad_to_multiple(q, ws)
        kk, _ = _pad_to_multiple(kk, ws)
        vv, _ = _pad_to_multiple(vv, ws)
        Hp, Wp = q.shape[1], q.shape[2]
        if self.q_window_mode == "reference":
            qw = scrambled_q_partition(q, ws)
        else:
            qw = window_partition(q, ws)
        kw = extract_overlapping_windows(kk, ws, ows)
        vw = extract_overlapping_windows(vv, ws, ows)
        hd = C // self.num_heads
        BN, nq, nk = qw.shape[0], qw.shape[1], kw.shape[1]
        bias = self.relative_position_bias_table[self.rpi.reshape(-1)]
        bias = bias.reshape(nq, nk, -1).permute(2, 0, 1)
        attn = _window_mha(qw.reshape(BN, nq, self.num_heads, hd),
                           kw.reshape(BN, nk, self.num_heads, hd),
                           vw.reshape(BN, nk, self.num_heads, hd), bias)
        attn = window_reverse(attn.reshape(BN, nq, C), ws, Hp, Wp)[:, :H0, :W0]
        x = self.proj(attn) + x
        return x + self.mlp(self.norm2(x))


class _PatchNorm(nn.Module):
    """The reference's `patch_embed` wrapper: a LayerNorm over channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


def _conv_tail(embed_dim: int, out_chans: int, dtype: torch.dtype):
    after = Conv2d(embed_dim, embed_dim, 3, padding=1, dtype=dtype)
    before = nn.Sequential(Conv2d(embed_dim, 64, 3, padding=1, dtype=dtype),
                           nn.LeakyReLU(0.01))
    last = Conv2d(64, out_chans, 3, padding=1, dtype=dtype)
    return after, before, last


class SwinSA(nn.Module):
    """Window self-attention body + conv tail: (B, H, W, embed_dim) -> out_chans."""

    def __init__(self, embed_dim: int, out_chans: int, num_heads: int = 4,
                 window_size: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = _PatchNorm(embed_dim)
        self.atten_block = HAB(embed_dim, num_heads, window_size, dtype=dtype)
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body, self.conv_before_upsample, self.conv_last = _conv_tail(
            embed_dim, out_chans, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        feats = self.norm(self.atten_block(self.patch_embed(x).to(dt))).to(dt)
        x = self.conv_after_body(feats) + x
        return self.conv_last(self.conv_before_upsample(x))


class SwinCA(nn.Module):
    """Overlapping-window cross-attention body + conv tail; x, k, v each
    (B, H, W, embed_dim)."""

    def __init__(self, embed_dim: int, out_chans: int, num_heads: int = 4,
                 window_size: int = 8, overlap_ratio: float = 0.5,
                 mlp_ratio: float = 4.0, q_window_mode: str = "reference",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = _PatchNorm(embed_dim)
        self.atten_block = OCAB(embed_dim, num_heads, window_size, overlap_ratio, mlp_ratio,
                                q_window_mode=q_window_mode, dtype=dtype)
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body, self.conv_before_upsample, self.conv_last = _conv_tail(
            embed_dim, out_chans, dtype)

    def forward(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)

        def pn(t):
            return self.patch_embed(t).to(dt)

        feats = self.norm(self.atten_block(pn(x), pn(k), pn(v))).to(dt)
        x = self.conv_after_body(feats) + x
        return self.conv_last(self.conv_before_upsample(x))
