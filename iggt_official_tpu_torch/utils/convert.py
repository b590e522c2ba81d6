"""Carry JAX-package parameters into the port's (reference-layout) state dict.

`jax_params_to_torch_state_dict` is the inverse of the rule set in
`iggt_official_tpu/utils/torch_convert.py` (reference torch names -> flax
paths), copied here, not imported:

- flax path ``a/blocks_3/attn/qkv/kernel`` -> module path
  ``a.blocks.3.attn.qkv``, with the reference's module renames undone
  (`scratch.`, `resize_layers.<i>[.<j>]`, Projects and Swin internals,
  `poseLN_modulation.1`);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- ConvTranspose ``kernel`` (kh, kw, in, out), stored spatially flipped ->
  ``weight`` (in, out, kh, kw) un-flipped;
- norm ``scale`` -> ``weight``; BatchNorm ``mean`` / ``var`` ->
  ``running_mean`` / ``running_var`` (+ ``num_batches_tracked`` = 0);
- everything else (bias, gamma, tokens, pos_embed, bias tables) copies.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# module paths (flax side, dot-joined) whose 4-D kernel is a ConvTranspose2d
_CONVTRANSPOSE_PATTERNS = (
    r"(^|\.)resize_[01]$",
    r"resize_0_up[12]$",
    r"resize_1_up$",
)

# flax module path -> reference module path, applied in order to "." + path
_INVERSE_RULES = (
    (r"\.resize_0_up1(?=\.|$)", ".resize_layers.0.0"),
    (r"\.resize_0_proj1(?=\.|$)", ".resize_layers.0.1"),
    (r"\.resize_0_up2(?=\.|$)", ".resize_layers.0.2"),
    (r"\.resize_0_proj2(?=\.|$)", ".resize_layers.0.3"),
    (r"\.resize_1_up(?=\.|$)", ".resize_layers.1.0"),
    (r"\.resize_1_proj(?=\.|$)", ".resize_layers.1.1"),
    (r"\.resize_2_proj(?=\.|$)", ".resize_layers.2.1"),
    (r"\.resize_3_down(?=\.|$)", ".resize_layers.3.0"),
    (r"\.resize_3_proj(?=\.|$)", ".resize_layers.3.1"),
    (r"\.resize_([0-3])$", r".resize_layers.\1"),
    (r"\.input_proj_conv$", ".input_proj.0"),
    (r"\.input_proj_bn$", ".input_proj.1"),
    (r"\.res_conv1$", ".residual_conv.0"),
    (r"\.res_bn1$", ".residual_conv.1"),
    (r"\.res_conv2$", ".residual_conv.3"),
    (r"\.res_bn2$", ".residual_conv.4"),
    (r"\.poseLN_modulation$", ".poseLN_modulation.1"),
    (r"\.(layer[1-4]_rn|refinenet[1-4]|output_conv1|output_conv2_\d+)(?=\.|$)",
     r".scratch.\1"),
    (r"\.patch_norm$", ".patch_embed.norm"),
    (r"\.atten_block\.attn_qkv$", ".atten_block.attn.qkv"),
    (r"\.atten_block\.attn_proj$", ".atten_block.attn.proj"),
    (r"\.conv_block\.conv1$", ".conv_block.cab.0"),
    (r"\.conv_block\.conv2$", ".conv_block.cab.2"),
    (r"\.conv_block\.ca\.fc1$", ".conv_block.cab.3.attention.1"),
    (r"\.conv_block\.ca\.fc2$", ".conv_block.cab.3.attention.3"),
    (r"\.conv_before_upsample$", ".conv_before_upsample.0"),
    (r"\.(blocks|frame_blocks|global_blocks|trunk|projects|output_conv2)_(\d+)(?=\.|$)",
     r".\1.\2"),
)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_module_to_torch(module_path: str) -> str:
    probe = "." + module_path
    for pattern, repl in _INVERSE_RULES:
        probe = re.sub(pattern, repl, probe)
    return probe[1:]


def jax_params_to_torch_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays, optionally under "params") -> the
    port's state dict, names and layouts as the reference checkpoint."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.asarray(value)
        flax_module, leaf = ".".join(path[:-1]), path[-1]
        module = flax_module_to_torch(flax_module)
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4 and any(re.search(p, flax_module)
                                       for p in _CONVTRANSPOSE_PATTERNS):
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unhandled kernel rank {arr.ndim} at {'/'.join(path)}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf in ("mean", "var"):
            leaf = "running_" + leaf
            out[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        name = f"{module}.{leaf}" if module else leaf
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
