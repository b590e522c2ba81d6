"""Carry JAX-package parameters into the port's (reference-layout) state dict.

`jax_params_to_torch_state_dict` is the inverse of the rule set in
`iggt_official_tpu/utils/torch_convert.py` (reference torch names -> flax
paths), copied here, not imported:

- flax path ``a/blocks_3/attn/qkv/kernel`` -> module path
  ``a.blocks.3.attn.qkv``, with the reference's module renames undone
  (`scratch.`, `resize_layers.<i>[.<j>]`, Projects and Swin internals,
  `poseLN_modulation.1`, the tracker's Sequential heads
  `ffeat_updater.0` / `vis_predictor.0` / `conf_predictor.0`);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- ConvTranspose ``kernel`` (kh, kw, in, out), stored spatially flipped ->
  ``weight`` (in, out, kh, kw) un-flipped;
- norm ``scale`` -> ``weight``; BatchNorm ``mean`` / ``var`` ->
  ``running_mean`` / ``running_var`` (+ ``num_batches_tracked`` = 0);
- everything else (bias, gamma, tokens, pos_embed, bias tables) copies.

`jax_sam2_params_to_torch_state_dict` does the same for the JAX package's
SAM2 (the inverse of its `sam2_state_dict_to_flax`), into the layout of a
released SAM2 checkpoint.
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
    (r"\.(ffeat_updater|vis_predictor|conf_predictor)$", r".\1.0"),
    (r"\.(blocks|frame_blocks|global_blocks|trunk|projects|output_conv2|time_blocks"
     r"|space_virtual_blocks|space_point2virtual_blocks|space_virtual2point_blocks)"
     r"_(\d+)(?=\.|$)", r".\1.\2"),
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


# ---------------------------------------------------------------------------
# SAM2: the inverse of `iggt_official_tpu/utils/torch_convert.py::sam2_state_dict_to_flax`
# (its `_SAM2_RENAME_RULES`, the ConvTranspose paths and the layout specials), copied

# reference module path -> flax module path rules of the JAX package, undone:
# applied in order to the dot-joined flax module path after each `name_<i>`
# segment became `name.<i>`
_SAM2_INVERSE_RULES = (
    (r"^image_encoder\.neck_convs\.(\d+)$", r"image_encoder.neck.convs.\1.conv"),
    (r"\.trunk\.patch_embed_proj$", ".trunk.patch_embed.proj"),
    (r"^memory_encoder\.fuser_layers\.(\d+)", r"memory_encoder.fuser.layers.\1"),
    (r"^conv_s([01])$", r"sam_mask_decoder.conv_s\1"),
    (r"\.mask_conv1$", ".mask_downscaling.0"),
    (r"\.mask_ln1$", ".mask_downscaling.1"),
    (r"\.mask_conv2$", ".mask_downscaling.3"),
    (r"\.mask_ln2$", ".mask_downscaling.4"),
    (r"\.mask_conv3$", ".mask_downscaling.6"),
)
_SAM2_CONVTRANSPOSE = r"output_upscaling\.[03]$"
_SAM2_TOKENS = ("iou_token", "mask_tokens", "obj_score_token")


def sam2_flax_module_to_torch(path) -> str:
    module = ".".join(re.sub(r"^(.*)_(\d+)$", r"\1.\2", p) for p in path)
    for pattern, repl in _SAM2_INVERSE_RULES:
        module = re.sub(pattern, repl, module)
    return module


def jax_sam2_params_to_torch_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SAM2 params (`SAM2Base.init_all`'s tree, optionally
    under "params") -> the port's state dict, names and layouts of a released
    SAM2 checkpoint: the rename rules undone; HWC position embeddings ->
    (1, C, H, W); the stacked ``point_embeddings`` -> 4 x (1, C);
    ``no_mask_embed`` / ``not_a_point_embed`` -> (1, C); ``maskmem_tpos_enc``
    (M, 1, D) -> (M, 1, 1, D); the token tables as Embedding ``.weight``; the
    ``output_upscaling.{0,3}`` ConvTranspose kernels un-flipped; Dense and
    Conv kernels and norm scales as `jax_params_to_torch_state_dict` maps them."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, np.float32))

    for path, value in _flatten(params):
        arr = np.asarray(value)
        leaf = path[-1]
        if path[:2] == ("image_encoder", "trunk") and leaf in ("pos_embed", "pos_embed_window"):
            put(f"image_encoder.trunk.{leaf}", arr.transpose(2, 0, 1)[None])
        elif path == ("maskmem_tpos_enc",):
            put(leaf, arr[:, :, None])
        elif path[0] == "sam_prompt_encoder" and leaf in ("no_mask_embed", "not_a_point_embed"):
            put(f"sam_prompt_encoder.{leaf}.weight", arr[None])
        elif path[0] == "sam_prompt_encoder" and leaf == "point_embeddings":
            for i, row in enumerate(arr):
                put(f"sam_prompt_encoder.point_embeddings.{i}.weight", row[None])
        elif path[0] == "sam_mask_decoder" and leaf in _SAM2_TOKENS:
            put(f"sam_mask_decoder.{leaf}.weight", arr)
        else:
            module = sam2_flax_module_to_torch(path[:-1])
            if leaf == "kernel":
                if arr.ndim == 2:
                    arr = arr.T
                elif re.search(_SAM2_CONVTRANSPOSE, module):
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                else:
                    arr = arr.transpose(3, 2, 0, 1)
                leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            put(f"{module}.{leaf}" if module else leaf, arr)
    return out
