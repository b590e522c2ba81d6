"""Operations and bytes the IGGT / VGGT forward needs, counted from shapes.

Counts are multiply-adds times two over what the configuration's shapes need:
every linear layer, every attention's Q K^T and P V, every convolution and
transposed convolution (torch's convention: a transposed convolution costs
2 * in * out * kh * kw per input pixel), and the DINOv2 position
embedding's resize when the patch grid differs from the trained one.
Bilinear resizes, norms and elementwise work are not counted.  The totals
equal `torch.utils.flop_counter.FlopCounterMode` on `reference/model.py`
(the CPU tests hold them to it).

``PEAK`` is the table of one H100 SXM's published dense rates (NVIDIA's data
sheet, 700 W): every roofline and utilization metric reads it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

PEAK = {"bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes": 3.35e12}


def _lin(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def _conv(c_in: int, c_out: int, k: int, pixels_out: int) -> int:
    return 2 * c_in * c_out * k * k * pixels_out


def _convt(c_in: int, c_out: int, k: int, pixels_in: int) -> int:
    return 2 * c_in * c_out * k * k * pixels_in


def _attn(nq: int, nk: int, width: int) -> int:
    """Q K^T and P V summed over heads (width = heads * head_dim)."""
    return 4 * nq * nk * width


def _block(tokens: int, dim: int, mlp_ratio: float) -> int:
    hidden = int(dim * mlp_ratio)
    return _lin(tokens, dim, 3 * dim) + _lin(tokens, dim, dim) + 2 * _lin(tokens, dim, hidden)


def _half(n: int) -> int:
    """Output size of a 3x3, stride 2, pad 1 convolution."""
    return (n - 1) // 2 + 1


def _pad8(n: int, ws: int) -> int:
    return n + (-n) % ws


class Grid(NamedTuple):
    S: int
    H: int
    W: int
    gh: int
    gw: int

    @property
    def np(self) -> int:
        return self.gh * self.gw


def grid(model: Dict, S: int, H: int, W: int) -> Grid:
    p = model["aggregator"]["patch_size"]
    return Grid(S, H, W, H // p, W // p)


def trunk_flops(model: Dict, g: Grid) -> Dict[str, int]:
    agg = model["aggregator"]
    vit = agg["vit"]
    C, p = agg["embed_dim"], agg["patch_size"]
    P = 1 + agg["num_register_tokens"] + g.np
    Pd = 1 + vit["num_register_tokens"] + g.np
    vg = vit["img_size"] // vit["patch_size"]
    dino = g.S * _conv(3, vit["embed_dim"], p, g.np)
    if (g.gh, g.gw) != (vg, vg):
        if g.gh != vg:
            dino += 2 * vg * g.gh * vg * vit["embed_dim"]
        if g.gw != vg:
            dino += 2 * vg * g.gh * g.gw * vit["embed_dim"]
    dino += vit["depth"] * g.S * (_block(Pd, vit["embed_dim"], vit["mlp_ratio"])
                                  + _attn(Pd, Pd, vit["embed_dim"]))
    frame = agg["depth"] * g.S * (_block(P, C, agg["mlp_ratio"]) + _attn(P, P, C))
    glob = agg["depth"] * (_block(g.S * P, C, agg["mlp_ratio"]) + _attn(g.S * P, g.S * P, C))
    return {"dino": dino, "frame": frame, "global": glob}


def camera_flops(model: Dict, g: Grid) -> int:
    cam = model["camera"]
    D, T, S = cam["dim_in"], cam["target_dim"], g.S
    it = (_lin(S, T, D) + _lin(S, D, 3 * D)
          + cam["trunk_depth"] * (_block(S, D, cam["mlp_ratio"]) + _attn(S, S, D))
          + _lin(S, D, D // 2) + _lin(S, D // 2, T))
    return cam["num_iterations"] * it


def _levels(g: Grid):
    """Pixels of the four pyramid levels: 4x, 2x, 1x and half the patch grid."""
    h3, w3 = _half(g.gh), _half(g.gw)
    return [16 * g.np, 4 * g.np, g.np, h3 * w3]


def _rcu(f: int, pixels: int) -> int:
    return 2 * _conv(f, f, 3, pixels)


def _fusion(f: int, in_ch, lv, out_dim: int, full: int) -> int:
    """layerN_rn, the four RefineNet blocks, output_conv1 and output_conv2."""
    n = sum(_conv(c, f, 3, px) for c, px in zip(in_ch, lv))
    n += _rcu(f, lv[3]) + _conv(f, f, 1, lv[2])                        # refinenet4
    n += 2 * _rcu(f, lv[2]) + _conv(f, f, 1, lv[1])                    # refinenet3
    n += 2 * _rcu(f, lv[1]) + _conv(f, f, 1, lv[0])                    # refinenet2
    n += 2 * _rcu(f, lv[0]) + _conv(f, f, 1, 4 * lv[0])                # refinenet1
    n += _conv(f, f // 2, 3, 4 * lv[0])                                # output_conv1
    n += _conv(f // 2, 32, 3, full) + _conv(32, out_dim, 1, full)      # output_conv2
    return n


def dpt_flops(model: Dict, g: Grid, out_dim: int) -> int:
    """One DPT head over all views (dim_in 2C, out_channels 256/512/1024/1024)."""
    oc, f = (256, 512, 1024, 1024), 256
    dim_in = 2 * model["aggregator"]["embed_dim"]
    lv = _levels(g)
    full = g.gh * g.gw * model["aggregator"]["patch_size"] ** 2
    n = sum(_conv(dim_in, c, 1, g.np) for c in oc)
    n += _convt(oc[0], oc[0], 4, g.np) + _convt(oc[1], oc[1], 2, g.np)
    n += _conv(oc[3], oc[3], 3, lv[3])
    n += _fusion(f, oc, lv, out_dim, full)
    return g.S * n


def _projects(f: int, pixels: int) -> int:
    return 2 * _conv(f, f, 1, pixels) + 2 * _conv(f, f, 3, pixels)


def part_flops(model: Dict, g: Grid) -> int:
    """SamProjector and the part head over all views."""
    part = model["part"]
    f, ws = part["features"], part["window_size"]
    oc = tuple(part["out_channels"])
    dim_in = 2 * model["aggregator"]["embed_dim"]
    lv = _levels(g)
    full = g.gh * g.gw * model["aggregator"]["patch_size"] ** 2
    # SamProjector
    n = sum(_conv(dim_in, c, 1, g.np) for c in oc)
    n += (_convt(oc[0], oc[0], 4, g.np) + _projects(oc[0], 4 * g.np)
          + _convt(oc[0], oc[0], 4, 4 * g.np) + _projects(oc[0], 16 * g.np))
    n += _convt(oc[1], oc[1], 2, g.np) + _projects(oc[1], 4 * g.np)
    n += _projects(oc[2], g.np)
    n += _conv(oc[3], oc[3], 3, lv[3]) + _projects(oc[3], lv[3])
    # part head: the fusion stack, with its two attentions between
    n += _fusion(f, oc, lv, part["output_dim"], full)
    n += 4 * _lin(g.np, f, f) + _attn(g.np, g.np, f)                   # cross_attention_2
    h0, w0 = 4 * g.gh, 4 * g.gw                                        # window cross-attention
    wins = _pad8(h0, ws) * _pad8(w0, ws) // (ws * ws)
    ows = ws + ws // 2
    n += 4 * _lin(h0 * w0, f, f) + wins * _attn(ws * ws, ows * ows, f)
    n += 2 * _lin(h0 * w0, f, 4 * f)
    n += _conv(f, f, 3, h0 * w0) + _conv(f, 64, 3, h0 * w0) + _conv(64, f, 3, h0 * w0)
    h5, w5, c5 = 8 * g.gh, 8 * g.gw, f // 2                            # window self-attention
    px5, pad5 = h5 * w5, _pad8(h5, ws) * _pad8(w5, ws)
    n += _conv(c5, c5 // 3, 3, px5) + _conv(c5 // 3, c5, 3, px5)
    n += 2 * _conv(c5, c5 // 30, 1, 1)
    n += _lin(pad5, c5, 3 * c5) + (pad5 // (ws * ws)) * _attn(ws * ws, ws * ws, c5)
    n += _lin(pad5, c5, c5) + 2 * _lin(px5, c5, 4 * c5)
    n += _conv(c5, c5, 3, px5) + _conv(c5, 64, 3, px5) + _conv(64, c5, 3, px5)
    return g.S * n


def forward_flops(model: Dict, S: int, H: int, W: int) -> Dict[str, int]:
    """Operations of one forward of ``S`` views at H x W, by part."""
    g = grid(model, S, H, W)
    out = dict(trunk_flops(model, g))
    out["camera"] = camera_flops(model, g)
    out["depth"] = dpt_flops(model, g, 2)
    out["point"] = dpt_flops(model, g, 4)
    if model["name"] == "iggt" and model.get("enable_part", True):
        out["part"] = part_flops(model, g)
    return out


class AttentionCall(NamedTuple):
    batch: int
    nq: int
    nk: int
    heads: int
    head_dim: int
    fused: bool      # q/k LayerNorm + RoPE prep before the attention

    def ops(self) -> int:
        return 4 * self.batch * self.heads * self.nq * self.nk * self.head_dim

    def bytes(self, itemsize: int = 2) -> int:
        """q, k, v read and the output written once; the fused calls also
        read the fp32 cos / sin tables of their rows."""
        n = (2 * self.nq + 2 * self.nk) * self.batch * self.heads * self.head_dim * itemsize
        if self.fused:
            n += 2 * self.batch * self.nq * self.head_dim * 4
        return n

    def bound_s(self) -> float:
        """Least time on one H100: bf16 operations or HBM bytes."""
        return max(self.ops() / PEAK["bf16_flops"], self.bytes() / PEAK["hbm_bytes"])


def trunk_attention_calls(model: Dict, S: int, H: int, W: int) -> List[AttentionCall]:
    """The trunk's bf16 attentions of one forward: the DINOv2 blocks, then
    the frame and global blocks (q/k-norm and RoPE fused)."""
    agg = model["aggregator"]
    vit = agg["vit"]
    g = grid(model, S, H, W)
    P = 1 + agg["num_register_tokens"] + g.np
    Pd = 1 + vit["num_register_tokens"] + g.np
    hd = agg["embed_dim"] // agg["num_heads"]
    vhd = vit["embed_dim"] // vit["num_heads"]
    return ([AttentionCall(S, Pd, Pd, vit["num_heads"], vhd, False)] * vit["depth"]
            + [AttentionCall(S, P, P, agg["num_heads"], hd, True)] * agg["depth"]
            + [AttentionCall(1, S * P, S * P, agg["num_heads"], hd, True)] * agg["depth"])
