"""Seeded weights, made on the device in a few large draws.

Both sides of a comparison get their parameters from `fill`: the measured
program and the plain reference are filled in the same order (the sorted
names of the reference's parameters), from one `torch.Generator` seeded with
``--seed``, in draws of at most ``DRAW_ELEMENTS`` normal numbers, so equal
names receive equal values.  The rules follow the flax initializers the
models were written against (lecun normal truncated at 2 std for matrices and
kernels, zero biases, unit norms, LayerScale at its configured value, tiny
special tokens); they are the benchmark's, not read from the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

DRAW_ELEMENTS = 1 << 27
_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def rule(name: str, shape: Tuple[int, ...], model: Dict) -> Tuple[str, float]:
    """("normal", std) for a normal draw clamped to +-2 std, or ("const", value)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "relative_position_bias_table":
        return "normal", 0.02
    if leaf in ("bias", "running_mean", "cls_token", "register_tokens", "empty_pose_tokens"):
        return "const", 0.0
    if leaf == "running_var":
        return "const", 1.0
    if leaf == "gamma":
        if name.startswith("aggregator.patch_embed."):
            return "const", model["aggregator"]["vit"]["init_values"]
        if name.startswith("aggregator."):
            return "const", model["aggregator"]["init_values"]
        return "const", model["camera"]["init_values"]
    if leaf in ("camera_token", "register_token"):
        return "normal", 1e-6
    if leaf == "pos_embed":
        return "normal", 0.02
    if leaf == "weight":
        if len(shape) == 1:
            return "const", 1.0
        return "normal", math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
    raise ValueError(f"no weight rule for {name} {shape}")


@torch.no_grad()
def fill(params: Dict[str, torch.Tensor], names: Iterable[str], seed: int, model: Dict) -> None:
    """Fill ``params[name]`` for each of ``names`` (in sorted order) from ``seed``."""
    order = sorted(names)
    device = params[order[0]].device
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))
    pending: List[Tuple[torch.Tensor, float]] = []
    count = 0

    def draw():
        nonlocal pending, count
        if not pending:
            return
        buf = torch.randn(count, generator=gen, device=device).clamp_(-2.0, 2.0)
        off = 0
        for p, std in pending:
            n = p.numel()
            p.copy_(buf[off:off + n].view(p.shape).mul_(std))
            off += n
        pending, count = [], 0

    for name in order:
        p = params[name]
        kind, value = rule(name, tuple(p.shape), model)
        if kind == "const":
            p.fill_(value)
            continue
        if count + p.numel() > DRAW_ELEMENTS:
            draw()
        pending.append((p, value))
        count += p.numel()
    draw()
