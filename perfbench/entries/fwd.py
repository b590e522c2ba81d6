"""Entry ``fwd``: a closed loop of scene forwards with one client.

Each request is one scene of ``views`` images at ``height`` x ``width``, made
from the seed and the request's index on the device, through the model as
`IGGTProcessor._run_inference` drives it (inference mode, TF32 off for
matmuls and cuDNN as the configuration's runtime group states, the default
runtime path), ending in a device synchronize.  One request, drawn from the
seed among the first ``check_among``, keeps the trunk's token maps the heads
read (a forward hook on the aggregator) and its outputs; after the window
the plain fp32 reference checks them in two stages:

- ``trunk_rel_l2``: the reference trunk on the same images against the
  program's token maps (relative L2, the worst of the kept layers);
- ``trunk_worst_token``: the largest gap of one token over the median
  token's norm, the worst of the kept layers;
- ``heads_max_rel``: the reference heads run on the program's own token
  maps (cast to fp32) against the program's outputs (largest absolute gap
  over the largest reference magnitude, the worst output).

The heads follow the program's own trunk state, because the bf16 trunk's
rounding would hide theirs; the trunk stage checks that state.
"""

from __future__ import annotations

import random
import time
from typing import Dict

import torch

from perfbench import flops, program

OUTPUTS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf",
           "part_feat")


def request_images(seed: int, index: int, traffic: Dict, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % (1 << 63))
    shape = (1, traffic["views"], traffic["height"], traffic["width"], 3)
    return torch.rand(shape, generator=gen, device=device)


def _set_tf32(runtime: Dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(runtime["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(runtime["tf32"])


def setup(ctx: Dict) -> Dict:
    config, traffic, device, seed = ctx["config"], ctx["traffic"], ctx["device"], ctx["seed"]
    runtime = config["runtime"]
    _set_tf32(runtime)
    if device.type == "cuda":
        program.build_kernels()
    program.log_since("program imported, kernels built")
    model = program.build_program(config["model"], device, seed)
    program.log_since("model built and filled")
    kw = {"fused_ln": runtime["fused_ln"], "global_merge_r": runtime["global_merge_r"]}
    if not runtime["use_flash_attention"]:
        from iggt_official_tpu_torch.layers.blocks import sdpa_plain
        from iggt_official_tpu_torch.ops.flash_attention import attention

        kw.update(attn_fn=sdpa_plain, part_attn_fn=attention)
    state = {"ctx": ctx, "model": model, "kw": kw, "count": 0, "elapsed": 0.0,
             "failed": torch.zeros((), dtype=torch.int64, device=device), "sample": None,
             "check_index": random.Random(seed).randrange(
                 min(traffic["check_among"], traffic["traced_requests"]))}
    for i in range(traffic["warmup_requests"]):
        _forward(state, request_images(seed, -1 - i, traffic, device))
    _sync(device)
    program.log_since("warm-up requests")
    return state


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def _forward(state: Dict, images: torch.Tensor) -> Dict:
    return state["model"](images, **state["kw"])


def window(state: Dict, done) -> None:
    ctx = state["ctx"]
    traffic, device, seed = ctx["traffic"], ctx["device"], ctx["seed"]
    model = state["model"]
    if device.type == "cuda":
        program.zero_launches()
    t0 = time.perf_counter()
    count = 0
    while True:
        images = request_images(seed, count, traffic, device)
        hook = None
        if count == state["check_index"] and state["sample"] is None:
            keep = program.reference_keep_layers(ctx["config"]["model"])
            captured = {}
            hook = model.aggregator.register_forward_hook(
                lambda m, args, out: captured.update({i: out[0][i] for i in keep}))
        out = _forward(state, images)
        state["failed"] += (~torch.isfinite(out["pose_enc"])).any()
        _sync(device)
        if hook is not None:
            hook.remove()
            state["sample"] = {"tokens": captured,
                               "outputs": {k: out[k] for k in OUTPUTS if k in out}}
        del out
        count += 1
        elapsed = time.perf_counter() - t0
        if done(count, elapsed):
            break
    state["count"], state["elapsed"] = count, elapsed


def end_to_end(state: Dict) -> Dict[str, float]:
    views = state["count"] * state["ctx"]["traffic"]["views"]
    return {"views_per_s": views / state["elapsed"]}


def facts(state: Dict) -> Dict:
    ctx = state["ctx"]
    traffic, model = ctx["traffic"], ctx["config"]["model"]
    S, H, W = traffic["views"], traffic["height"], traffic["width"]
    report = {"requests": state["count"], "window_s": state["elapsed"]}
    if ctx["device"].type == "cuda":
        launches = program.read_launches()
        report["launches per request"] = {k: v / state["count"] for k, v in launches.items()}
    return {"attempted": state["count"], "failed": int(state["failed"]),
            "requests": state["count"], "views": state["count"] * S,
            "flops_per_request": sum(flops.forward_flops(model, S, H, W).values()),
            "attention_calls": flops.trunk_attention_calls(model, S, H, W),
            "report": report}


def release(state: Dict) -> None:
    state.pop("model", None)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp(min=1e-30))


def worst_token(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest per-token gap ||a_t - b_t|| over the median token norm."""
    gap = torch.linalg.vector_norm((a - b).double(), dim=-1)
    return float(gap.max() / torch.linalg.vector_norm(b.double(), dim=-1).median())


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@torch.no_grad()
def check(state: Dict, trunk_quant=None, heads_quant=None):
    """[(name, value, limit)]; with ``trunk_quant`` / ``heads_quant`` the
    reference itself at that precision stands in the program's place (the
    control)."""
    ctx = state["ctx"]
    traffic, device, seed, model_cfg = ctx["traffic"], ctx["device"], ctx["seed"], \
        ctx["config"]["model"]
    limits = ctx["cell"]["limits"]
    _set_tf32({"tf32": False})
    sample = state["sample"]
    images = request_images(seed, state["check_index"], traffic, device)
    ref = program.build_reference(model_cfg, device, seed)
    hw = images.shape[2:4]
    if trunk_quant is not None or heads_quant is not None:
        ref.set_precision(trunk=trunk_quant)
        tokens = {i: t.float() for i, t in ref.trunk(images).items()}
        ref.set_precision(heads=heads_quant)
        outputs = ref.heads(tokens, hw)
        ref.set_precision()
        sample = {"tokens": tokens, "outputs": outputs}
    ref_tokens = ref.trunk(images)
    trunk = max(rel_l2(sample["tokens"][i].float(), ref_tokens[i]) for i in ref_tokens)
    token = max(worst_token(sample["tokens"][i].float(), ref_tokens[i]) for i in ref_tokens)
    del ref_tokens
    ref_out = ref.heads({i: t.float() for i, t in sample["tokens"].items()}, hw)
    per_output = {k: max_rel(sample["outputs"][k].float(), ref_out[k])
                  for k in OUTPUTS if k in ref_out}
    program.log_detail(per_output)
    return [("trunk_rel_l2", trunk, limits["trunk_rel_l2"]),
            ("trunk_worst_token", token, limits["trunk_worst_token"]),
            ("heads_max_rel", max(per_output.values()), limits["heads_max_rel"])]


def control(config: Dict, precision) -> Dict:
    """The control's precisions: one step below the configuration's trunk
    (bf16 -> fp8) and heads (fp32 with TF32 off -> TF32; fp32 -> bf16)."""
    trunk = {"bfloat16": precision.fp8, "float32": precision.tf32}[config["model"]["trunk_dtype"]]
    heads = precision.bf16 if config["runtime"]["tf32"] else precision.tf32
    return {"trunk_quant": trunk, "heads_quant": heads}


def min_requests(state: Dict) -> int:
    """Requests the window must run before the check can be read."""
    return state["check_index"] + 1
