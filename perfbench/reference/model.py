"""Plain fp32 reference of the IGGT / VGGT forward (no kernels, no port).

A frozen copy of the arithmetic of the measured port's plain code, written
for this benchmark alone: the Aggregator (DINOv2 ViT-L/14 with registers,
then alternating frame / global blocks with qk-LayerNorm and 2D RoPE), the
camera head, the depth and point DPT heads, and IGGT's SamProjector and part
head.  It imports nothing of the port: the benchmark builds it from the same
configuration file, fills it with the same seeded weights
(`perfbench/weights.py`) and compares what the port's timed path produced
with it.  Parameter names are those of the port's (and the published
checkpoint's) ``state_dict``.

Everything computes in float32; the caller turns TF32 off.  Attention runs
in blocks of queries, so the 64-view global attention (55,616 tokens) fits.
The bilinear resizes go through ``F.interpolate`` (align_corners=True), which
the port writes as two dense contractions: the same weights, summed in
another order.

Precision for the control (`set_precision`): ``trunk`` rounds every matmul
operand of the Aggregator (linear inputs and weights, q, k, v and the
attention probabilities) and ``heads`` every matmul and convolution operand
of the heads, each through a callable (`perfbench/reference/precision.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
# logits of one query block stay under this many fp32 elements
ATTN_BLOCK_ELEMENTS = 1 << 29


def _q(quant: Quant, t: torch.Tensor) -> torch.Tensor:
    return t if quant is None else quant(t)


class Linear(nn.Linear):
    quant: Quant = None

    def forward(self, x):
        return F.linear(_q(self.quant, x), _q(self.quant, self.weight), self.bias)


class Conv2d(nn.Conv2d):
    """Conv2d on NHWC maps."""

    quant: Quant = None

    def forward(self, x):
        y = F.conv2d(_q(self.quant, x.permute(0, 3, 1, 2)), _q(self.quant, self.weight),
                     self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d on NHWC maps."""

    quant: Quant = None

    def forward(self, x):
        y = F.conv_transpose2d(_q(self.quant, x.permute(0, 3, 1, 2)),
                               _q(self.quant, self.weight), self.bias, self.stride,
                               self.padding)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm with the fast variance max(E[x^2] - mu^2, 0)."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


def attend(q, k, v, quant: Quant = None, bias=None):
    """softmax(q k^T / sqrt(D) + bias) v over (B, N, H, D), in query blocks."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    q, k, v = _q(quant, q), _q(quant, k), _q(quant, v)
    block = max(1, min(Nq, ATTN_BLOCK_ELEMENTS // max(1, B * H * Nk)))
    outs = []
    for s in range(0, Nq, block):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:s + block], k) / math.sqrt(D)
        if bias is not None:
            logits = logits + bias[:, :, s:s + block]
        p = _q(quant, torch.softmax(logits, dim=-1))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# 2D RoPE (1-based patch grid, special tokens at (0, 0))

def rope_tables(h: int, w: int, batch: int, psi: int, head_dim: int, freq: float, device):
    y = torch.arange(h, device=device)[:, None] + 1
    x = torch.arange(w, device=device)[None, :] + 1
    grid = torch.stack(torch.broadcast_tensors(y, x), -1).reshape(h * w, 2)
    pos = torch.cat([torch.zeros((psi, 2), dtype=grid.dtype, device=device), grid]).float()
    dim = head_dim // 2
    inv = 1.0 / freq ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    ay, ax = pos[:, 0:1] * inv, pos[:, 1:2] * inv
    tabs = [torch.cos(ay), torch.sin(ay), torch.cos(ax), torch.sin(ax)]
    return [t[None].expand(batch, -1, -1) for t in tabs]


def _rope_1d(x, cos, sin):
    cs = torch.cat([cos, cos], -1)[..., None, :]
    sn = torch.cat([sin, sin], -1)[..., None, :]
    x1, x2 = x.chunk(2, -1)
    return x * cs + torch.cat([-x2, x1], -1) * sn


def apply_rope(x, tabs):
    cy, sy, cx, sx = tabs
    a, b = x.chunk(2, -1)
    return torch.cat([_rope_1d(a, cy, sy), _rope_1d(b, cx, sx)], -1)


# ---------------------------------------------------------------------------
# transformer blocks

class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(value)))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    quant: Quant = None

    def __init__(self, dim: int, heads: int, qk_norm: bool):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = LayerNorm(dim // heads)
            self.k_norm = LayerNorm(dim // heads)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Linear(dim, dim)

    def forward(self, x, rope=None):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = apply_rope(q, rope), apply_rope(k, rope)
        return self.proj(attend(q, k, v, self.quant).reshape(B, N, C))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, init_values: float,
                 qk_norm: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_eps)
        self.attn = Attention(dim, heads, qk_norm)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = LayerNorm(dim, ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x, rope=None):
        x = x + self.ls1(self.attn(self.norm1(x), rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


# ---------------------------------------------------------------------------
# DINOv2 patch embedder

def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) antialiased Keys-cubic resize weights (a = -0.5, kernel
    widened by the downscale factor, columns normalized), fp32."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    ks = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / ks
    w = _keys_cubic(x.astype(f32))
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class PatchConv(nn.Module):
    def __init__(self, p: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, p, stride=p)

    def forward(self, x):
        y = self.proj(x)
        return y.reshape(y.shape[0], -1, y.shape[-1])


class DinoViT(nn.Module):
    def __init__(self, vit: Dict):
        super().__init__()
        self.cfg = vit
        D, grid = vit["embed_dim"], vit["img_size"] // vit["patch_size"]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, D))
        self.register_tokens = nn.Parameter(torch.zeros(1, vit["num_register_tokens"], D))
        self.patch_embed = PatchConv(vit["patch_size"], D)
        self.blocks = nn.ModuleList(
            Block(D, vit["num_heads"], vit["mlp_ratio"], vit["init_values"],
                  ln_eps=vit["ln_eps"]) for _ in range(vit["depth"]))
        self.norm = LayerNorm(D, vit["ln_eps"])

    def pos(self, h0: int, w0: int):
        grid = self.cfg["img_size"] // self.cfg["patch_size"]
        if (h0, w0) == (grid, grid):
            return self.pos_embed
        D = self.pos_embed.shape[-1]
        pe = self.pos_embed[:, 1:].reshape(grid, grid, D)
        if h0 != grid:
            wh = torch.from_numpy(cubic_weights(grid, h0)).to(pe.device)
            pe = torch.einsum("Hh,Hwc->hwc", wh, pe)
        if w0 != grid:
            ww = torch.from_numpy(cubic_weights(grid, w0)).to(pe.device)
            pe = torch.einsum("Ww,hWc->hwc", ww, pe)
        return torch.cat([self.pos_embed[:, :1], pe.reshape(1, h0 * w0, D)], 1)

    def forward(self, images):
        B, H, W, _ = images.shape
        p = self.cfg["patch_size"]
        x = self.patch_embed(images)
        D = x.shape[-1]
        x = torch.cat([self.cls_token.expand(B, 1, D), x], 1) + self.pos(H // p, W // p)
        x = torch.cat([x[:, :1], self.register_tokens.expand(B, -1, -1), x[:, 1:]], 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.cfg["num_register_tokens"]:]


def _special(tok, B: int, S: int):
    """(1, 2, X, C) -> (B*S, X, C): index 0 for view 0, index 1 for the rest."""
    first = tok[:, 0:1].expand(B, 1, *tok.shape[2:])
    rest = tok[:, 1:2].expand(B, S - 1, *tok.shape[2:])
    return torch.cat([first, rest], 1).reshape(B * S, *tok.shape[2:])


class Aggregator(nn.Module):
    def __init__(self, agg: Dict):
        super().__init__()
        self.cfg = agg
        C = agg["embed_dim"]
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, agg["num_register_tokens"], C))
        self.patch_embed = DinoViT(agg["vit"])

        def blocks():
            return nn.ModuleList(Block(C, agg["num_heads"], agg["mlp_ratio"],
                                       agg["init_values"], qk_norm=agg["qk_norm"])
                                 for _ in range(agg["depth"]))

        self.frame_blocks = blocks()
        self.global_blocks = blocks()

    def forward(self, images, keep: Sequence[int]) -> Dict[int, torch.Tensor]:
        """images (B, S, H, W, 3) in [0, 1] -> {layer: (B, S, P, 2C)} for the
        layers in ``keep``."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        p, psi, C = cfg["patch_size"], 1 + cfg["num_register_tokens"], cfg["embed_dim"]
        mean = torch.tensor(RESNET_MEAN, device=images.device)
        std = torch.tensor(RESNET_STD, device=images.device)
        x = ((images - mean) / std).reshape(B * S, H, W, 3)
        tokens = torch.cat([_special(self.camera_token, B, S),
                            _special(self.register_token, B, S),
                            self.patch_embed(x)], 1)
        P = tokens.shape[1]
        rf = rope_tables(H // p, W // p, B * S, psi, C // cfg["num_heads"], cfg["rope_freq"],
                         images.device)
        rg = [t.reshape(B, S * P, -1) for t in rf]
        out = {}
        for i, (fb, gb) in enumerate(zip(self.frame_blocks, self.global_blocks)):
            tokens = fb(tokens.reshape(B * S, P, C), rf)
            frame = tokens.reshape(B, S, P, C)
            tokens = gb(tokens.reshape(B, S * P, C), rg)
            if i in keep:
                out[i] = torch.cat([frame, tokens.reshape(B, S, P, C)], -1)
        return out


# ---------------------------------------------------------------------------
# heads

def activate(fmap, activation: str):
    xyz, conf = fmap[..., :-1], fmap[..., -1]
    if activation == "exp":
        v = torch.exp(xyz)
    elif activation == "inv_log":
        v = torch.sign(xyz) * torch.expm1(xyz.abs())
    else:
        raise ValueError(f"activation {activation} is not in the reference")
    return v, 1 + torch.exp(conf)


class CameraHead(nn.Module):
    def __init__(self, cam: Dict):
        super().__init__()
        self.cfg = cam
        D, T = cam["dim_in"], cam["target_dim"]
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, T))
        self.trunk = nn.Sequential(*[Block(D, cam["num_heads"], cam["mlp_ratio"],
                                           cam["init_values"])
                                     for _ in range(cam["trunk_depth"])])
        self.token_norm = LayerNorm(D)
        self.trunk_norm = LayerNorm(D)
        self.embed_pose = Linear(T, D)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), Linear(D, 3 * D))
        self.pose_branch = Mlp(D, D // 2, T)
        self.adaln_norm = LayerNorm(D, 1e-6, affine=False)

    def forward(self, tokens) -> List[torch.Tensor]:
        cfg = self.cfg
        pose_tokens = self.token_norm(tokens[:, :, 0])
        B, S, _ = pose_tokens.shape
        pred, out = None, []
        for _ in range(cfg["num_iterations"]):
            inp = self.empty_pose_tokens.expand(B, S, -1) if pred is None else pred.detach()
            shift, scale, gate = self.poseLN_modulation(self.embed_pose(inp)).chunk(3, -1)
            x = gate * (self.adaln_norm(pose_tokens) * (1 + scale) + shift)
            x = self.trunk(x + pose_tokens)
            delta = self.pose_branch(self.trunk_norm(x))
            pred = delta if pred is None else pred + delta
            # trans / quat linear, focal relu
            out.append(torch.cat([pred[..., :7], torch.relu(pred[..., 7:])], -1))
        return out


def sincos(dim: int, pos, omega_0: float = 100.0):
    omega = 1.0 / omega_0 ** (torch.arange(dim // 2, dtype=torch.float32,
                                           device=pos.device) / (dim / 2.0))
    out = pos.reshape(-1, 1) * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], 1)


def uv_embed(x, img_w: int, img_h: int, ratio: float = 0.1):
    """x (N, H, W, C) + ratio * the sincos embedding of its UV grid."""
    H, W, C = x.shape[-3:]
    aspect = img_w / img_h
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    u = torch.linspace(-sx * (W - 1) / W, sx * (W - 1) / W, W, device=x.device)
    v = torch.linspace(-sy * (H - 1) / H, sy * (H - 1) / H, H, device=x.device)
    uu, vv = u[None, :].expand(H, W).reshape(-1), v[:, None].expand(H, W).reshape(-1)
    emb = torch.cat([sincos(C // 2, uu), sincos(C // 2, vv)], -1).reshape(H, W, C)
    return x + emb * ratio


def resize(x, size):
    """Bilinear align-corners resize of an NHWC map."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, padding=1)
        self.conv2 = Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        a = torch.relu(x)
        return self.conv2(torch.relu(self.conv1(a))) + a


class FeatureFusionBlock(nn.Module):
    def __init__(self, f: int, residual: bool):
        super().__init__()
        self.out_conv = Conv2d(f, f, 1)
        self.resConfUnit1 = ResidualConvUnit(f) if residual else None
        self.resConfUnit2 = ResidualConvUnit(f)

    def forward(self, x, res=None, size=None):
        if self.resConfUnit1 is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        size = size or (2 * x.shape[1], 2 * x.shape[2])
        return self.out_conv(resize(x, size))


def fusion_scratch(in_ch: Sequence[int], f: int, out_dim: int) -> nn.Module:
    s = nn.Module()
    for i, c in enumerate(in_ch):
        setattr(s, f"layer{i + 1}_rn", Conv2d(c, f, 3, padding=1, bias=False))
    for i in range(1, 5):
        setattr(s, f"refinenet{i}", FeatureFusionBlock(f, i != 4))
    s.output_conv1 = Conv2d(f, f // 2, 3, padding=1)
    s.output_conv2 = nn.Sequential(Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                   Conv2d(32, out_dim, 1))
    return s


def fuse(s, levels):
    rn = [getattr(s, f"layer{i + 1}_rn")(levels[i]) for i in range(4)]
    out4 = s.refinenet4(rn[3], size=rn[2].shape[1:3])
    out3 = s.refinenet3(out4, rn[2], size=rn[1].shape[1:3])
    out2 = s.refinenet2(out3, rn[1], size=rn[0].shape[1:3])
    return s.refinenet1(out2, rn[0]), out2, out3, out4


def _patch_map(tok, psi, grid, norm, proj):
    x = tok[:, :, psi:]
    B, S = x.shape[:2]
    return proj(norm(x.reshape(B * S, grid[0], grid[1], -1)))


class DPTHead(nn.Module):
    def __init__(self, dim_in: int, out_dim: int, activation: str, layers: Sequence[int],
                 patch: int = 14, features: int = 256, oc=(256, 512, 1024, 1024),
                 pyramid: bool = False):
        super().__init__()
        self.layers, self.patch, self.act, self.pyramid = list(layers), patch, activation, pyramid
        self.norm = LayerNorm(dim_in)
        self.projects = nn.ModuleList(Conv2d(dim_in, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4), ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(), Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = fusion_scratch(oc, features, out_dim)

    def forward(self, toks: Dict[int, torch.Tensor], hw, psi: int):
        H, W = hw
        p = self.patch
        grid = (H // p, W // p)
        levels = []
        for i, li in enumerate(self.layers):
            x = _patch_map(toks[li], psi, grid, self.norm, self.projects[i])
            levels.append(self.resize_layers[i](uv_embed(x, W, H)))
        out1, out2, out3, out4 = fuse(self.scratch, levels)
        out = uv_embed(resize(self.scratch.output_conv1(out1), (grid[0] * p, grid[1] * p)), W, H)
        pred, conf = activate(self.scratch.output_conv2(out), self.act)
        B, S = toks[self.layers[0]].shape[:2]
        pred, conf = pred.reshape(B, S, *pred.shape[1:]), conf.reshape(B, S, *conf.shape[1:])
        return (pred, conf, (out2, out3, out4)) if self.pyramid else (pred, conf)


class FrozenBatchNorm(nn.Module):
    def __init__(self, f: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(f))
        self.bias = nn.Parameter(torch.zeros(f))
        self.running_mean = nn.Parameter(torch.zeros(f))
        self.running_var = nn.Parameter(torch.ones(f))

    def forward(self, x):
        return (x - self.running_mean) * (torch.rsqrt(self.running_var + self.eps)
                                          * self.weight) + self.bias


class Projects(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.input_proj = nn.Sequential(Conv2d(f, f, 1, bias=False), FrozenBatchNorm(f),
                                        nn.ReLU())
        self.residual_conv = nn.Sequential(
            Conv2d(f, f, 3, padding=1, bias=False), FrozenBatchNorm(f), nn.ReLU(),
            Conv2d(f, f, 3, padding=1, bias=False), FrozenBatchNorm(f))
        self.output_proj = Conv2d(f, f, 1)

    def forward(self, x):
        x = self.input_proj(x)
        return self.output_proj(self.residual_conv(x) + x)


class SamProjector(nn.Module):
    def __init__(self, dim_in: int, patch: int, layers: Sequence[int], oc: Sequence[int]):
        super().__init__()
        self.patch, self.layers = patch, list(layers)
        self.norm = LayerNorm(dim_in)
        self.projects = nn.ModuleList(Conv2d(dim_in, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.Sequential(ConvTranspose2d(oc[0], oc[0], 4, stride=2, padding=1), Projects(oc[0]),
                          ConvTranspose2d(oc[0], oc[0], 4, stride=2, padding=1), Projects(oc[0])),
            nn.Sequential(ConvTranspose2d(oc[1], oc[1], 2, stride=2), Projects(oc[1])),
            nn.Sequential(nn.Identity(), Projects(oc[2])),
            nn.Sequential(Conv2d(oc[3], oc[3], 3, stride=2, padding=1), Projects(oc[3]))])

    def forward(self, toks, hw, psi):
        grid = (hw[0] // self.patch, hw[1] // self.patch)
        return [self.resize_layers[i](_patch_map(toks[li], psi, grid, self.norm,
                                                 self.projects[i]))
                for i, li in enumerate(self.layers)]


class CrossAttention(nn.Module):
    quant: Quant = None

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.projq, self.projk = Linear(dim, dim), Linear(dim, dim)
        self.projv, self.proj = Linear(dim, dim), Linear(dim, dim)

    def forward(self, q, k, v):
        B, N, C = q.shape
        hd = C // self.heads
        o = attend(self.projq(q).reshape(B, N, self.heads, hd),
                   self.projk(k).reshape(B, -1, self.heads, hd),
                   self.projv(v).reshape(B, -1, self.heads, hd), self.quant)
        return self.proj(o.reshape(B, N, C))


def window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(win, ws, H, W):
    C = win.shape[-1]
    B = win.shape[0] // ((H // ws) * (W // ws))
    x = win.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def scrambled_q_partition(q, ws):
    """The checkpoint's OCAB q windows: q as NCHW cut over (C, H) with W as
    channels, the buffer then read as (-1, ws*ws, C)."""
    B, H, W, C = q.shape
    x = q.permute(0, 3, 1, 2).reshape(B, C // ws, ws, H // ws, ws, W)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def overlapping_windows(x, ws, ows):
    p = (ows - ws) // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    w = xp.unfold(1, ows, ws).unfold(2, ows, ws).permute(0, 1, 2, 4, 5, 3)
    return w.reshape(-1, ows * ows, x.shape[-1])


def rpi_oca(ws, ows):
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(ows), np.arange(ows), indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


def pad_to(x, ws):
    H, W = x.shape[1:3]
    ph, pw = (-H) % ws, (-W) % ws
    if ph:
        x = torch.cat([x, x[:, -1:].expand(-1, ph, -1, -1)], 1)
    if pw:
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw, -1)], 2)
    return x


class _Pool(nn.Module):
    def forward(self, x):
        return x.mean(dim=(1, 2), keepdim=True)


class ChannelAttention(nn.Module):
    def __init__(self, f: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(_Pool(), Conv2d(f, f // squeeze, 1), nn.ReLU(),
                                       Conv2d(f // squeeze, f, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class _Proj(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv, self.proj = Linear(dim, 3 * dim), Linear(dim, dim)


class HAB(nn.Module):
    """Window self-attention (no bias, no shift) + channel-attention convs x0.01 + MLP."""

    quant: Quant = None

    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.norm1 = LayerNorm(dim)
        self.attn = _Proj(dim)
        self.conv_block = nn.Module()
        self.conv_block.cab = nn.Sequential(Conv2d(dim, dim // 3, 3, padding=1), nn.GELU(),
                                            Conv2d(dim // 3, dim, 3, padding=1),
                                            ChannelAttention(dim, 30))
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        B, H, W, C = x.shape
        xn = self.norm1(x)
        conv = self.conv_block.cab(xn)
        xw = pad_to(xn, self.ws)
        Hp, Wp = xw.shape[1:3]
        win = window_partition(xw, self.ws)
        qkv = self.attn.qkv(win).reshape(win.shape[0], win.shape[1], 3, self.heads,
                                         C // self.heads)
        a = attend(*qkv.unbind(2), self.quant).reshape(win.shape[0], win.shape[1], C)
        a = window_reverse(self.attn.proj(a), self.ws, Hp, Wp)[:, :H, :W]
        x = x + a + conv * 0.01
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    quant: Quant = None

    def __init__(self, dim, heads, ws, mlp_ratio):
        super().__init__()
        ows = ws + ws // 2
        self.heads, self.ws, self.ows = heads, ws, ows
        self.relative_position_bias_table = nn.Parameter(torch.zeros((ws + ows - 1) ** 2, heads))
        self.rpi = rpi_oca(ws, ows)
        self.norm1 = LayerNorm(dim)
        self.q, self.k, self.v = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        self.proj = Linear(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, k, v):
        B, H, W, C = x.shape
        ws, ows, h = self.ws, self.ows, self.heads
        q = pad_to(self.q(self.norm1(x)), ws)
        kk = pad_to(self.k(self.norm1(k)), ws)
        vv = pad_to(self.v(self.norm1(v)), ws)
        Hp, Wp = q.shape[1:3]
        qw = scrambled_q_partition(q, ws)
        kw, vw = overlapping_windows(kk, ws, ows), overlapping_windows(vv, ws, ows)
        BN, nq, nk = qw.shape[0], qw.shape[1], kw.shape[1]
        rpi = torch.as_tensor(self.rpi, device=x.device).reshape(-1)
        bias = self.relative_position_bias_table[rpi].reshape(nq, nk, -1).permute(2, 0, 1)
        a = attend(qw.reshape(BN, nq, h, C // h), kw.reshape(BN, nk, h, C // h),
                   vw.reshape(BN, nk, h, C // h), self.quant, bias[None])
        a = window_reverse(a.reshape(BN, nq, C), ws, Hp, Wp)[:, :H, :W]
        x = self.proj(a) + x
        return x + self.mlp(self.norm2(x))


class _PatchNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(x)


class _SwinBody(nn.Module):
    def __init__(self, dim, out_ch):
        super().__init__()
        self.patch_embed = _PatchNorm(dim)
        self.norm = LayerNorm(dim)
        self.conv_after_body = Conv2d(dim, dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(Conv2d(dim, 64, 3, padding=1),
                                                  nn.LeakyReLU(0.01))
        self.conv_last = Conv2d(64, out_ch, 3, padding=1)

    def tail(self, feats, x):
        x = self.conv_after_body(self.norm(feats)) + x
        return self.conv_last(self.conv_before_upsample(x))


class SwinSA(_SwinBody):
    def __init__(self, dim, out_ch, heads, ws):
        super().__init__(dim, out_ch)
        self.atten_block = HAB(dim, heads, ws)

    def forward(self, x):
        return self.tail(self.atten_block(self.patch_embed(x)), x)


class SwinCA(_SwinBody):
    def __init__(self, dim, out_ch, heads, ws):
        super().__init__(dim, out_ch)
        self.atten_block = OCAB(dim, heads, ws, 4.0)

    def forward(self, x, k, v):
        pn = self.patch_embed
        return self.tail(self.atten_block(pn(x), pn(k), pn(v)), x)


class PartHead(nn.Module):
    def __init__(self, part: Dict):
        super().__init__()
        f = part["features"]
        self.patch = part["patch_size"]
        self.scratch = fusion_scratch(part["out_channels"], f, part["output_dim"])
        self.cross_attention_1 = CrossAttention(f, part["ca_num_heads"])   # unused, as upstream
        self.cross_attention_2 = CrossAttention(f, part["ca_num_heads"])
        self.window_self_atten = SwinSA(f // 2, f // 2, part["swin_num_heads"],
                                        part["window_size"])
        self.window_cross_attention = SwinCA(f, f, part["swin_num_heads"], part["window_size"])

    def forward(self, proj, pyr, hw, bs):
        B, S = bs
        H, W = hw
        p = self.patch
        sc = self.scratch
        rn = [getattr(sc, f"layer{i + 1}_rn")(proj[i]) for i in range(4)]
        pt2, _, pt4 = pyr
        out = sc.refinenet4(rn[3], size=rn[2].shape[1:3])
        flat = out.reshape(out.shape[0], -1, out.shape[-1])
        f4 = pt4.reshape(pt4.shape[0], -1, pt4.shape[-1])
        out = self.cross_attention_2(flat, f4, f4).reshape(out.shape)
        out = sc.refinenet3(out, rn[2], size=rn[1].shape[1:3])
        out = sc.refinenet2(out, rn[1], size=rn[0].shape[1:3])
        out = self.window_cross_attention(out, pt2, pt2)
        out = sc.refinenet1(out, rn[0])
        out = self.window_self_atten(sc.output_conv1(out))
        out = sc.output_conv2(resize(out, ((H // p) * p, (W // p) * p)))
        return out.reshape(B, S, *out.shape[1:])


# ---------------------------------------------------------------------------
# the model

class Reference(nn.Module):
    """IGGT (``model["name"] == "iggt"``) or VGGT without the track head, from
    the ``model`` group of a configuration file."""

    def __init__(self, model: Dict):
        super().__init__()
        self.cfg = model
        agg = dict(model["aggregator"])
        self.layers = list(model["intermediate_layer_idx"])
        C2 = 2 * agg["embed_dim"]
        self.psi = 1 + agg["num_register_tokens"]
        self.patch = agg["patch_size"]
        self.aggregator = Aggregator(agg)
        self.camera_head = CameraHead(model["camera"])
        self.point_head = DPTHead(C2, 4, "inv_log", self.layers, self.patch,
                                  pyramid=model["name"] == "iggt")
        self.depth_head = DPTHead(C2, 2, "exp", self.layers, self.patch)
        self.iggt = model["name"] == "iggt" and model.get("enable_part", True)
        if self.iggt:
            part = model["part"]
            self.part_adaptor = SamProjector(C2, part["patch_size"],
                                             part["intermediate_layer_idx"],
                                             part["out_channels"])
            self.part_head = PartHead(part)

    def keep_layers(self) -> List[int]:
        """The trunk layers the heads read (the last one for the camera head)."""
        keep = set(self.layers) | {self.cfg["aggregator"]["depth"] - 1}
        if self.iggt:
            keep |= set(self.cfg["part"]["intermediate_layer_idx"])
        return sorted(keep)

    def trunk(self, images) -> Dict[int, torch.Tensor]:
        return self.aggregator(images, self.keep_layers())

    def heads(self, toks: Dict[int, torch.Tensor], hw, views_per_chunk: int = 8
              ) -> Dict[str, torch.Tensor]:
        """The outputs from trunk layers ``toks`` (B, S, P, 2C), decoding the
        dense heads over chunks of views; ``pose_enc_list`` holds every
        iteration of the camera head."""
        last = toks[self.cfg["aggregator"]["depth"] - 1]
        B, S = last.shape[:2]
        poses = self.camera_head(last)
        out = {"pose_enc": poses[-1], "pose_enc_list": poses}
        acc: Dict[str, list] = {}
        for v0 in range(0, S, views_per_chunk):
            t = {i: x[:, v0:v0 + views_per_chunk] for i, x in toks.items()}
            cs = t[self.layers[0]].shape[1]
            d, dc = self.depth_head(t, hw, self.psi)
            pt = self.point_head(t, hw, self.psi)
            for k, x in (("depth", d), ("depth_conf", dc), ("world_points", pt[0]),
                         ("world_points_conf", pt[1])):
                acc.setdefault(k, []).append(x)
            if self.iggt:
                proj = self.part_adaptor(t, hw, self.psi)
                acc.setdefault("part_feat", []).append(
                    self.part_head(proj, pt[2], hw, (B, cs)))
        out.update({k: torch.cat(v, 1) for k, v in acc.items()})
        return out

    def forward(self, images):
        return self.heads(self.trunk(images), images.shape[2:4])

    def set_precision(self, trunk: Quant = None, heads: Quant = None) -> None:
        """Round the matmul and convolution operands of the trunk / the heads
        through ``trunk`` / ``heads`` (None: fp32)."""
        for name, m in self.named_modules():
            if hasattr(type(m), "quant"):
                m.quant = trunk if name.startswith("aggregator") else heads
