#!/usr/bin/env python3
"""Card smoke test of the PyTorch / CUDA port (`iggt_official_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a).  Phases, in
order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: every kernel source under `iggt_official_tpu_torch/csrc/`, one nvcc
   per source, in parallel; the ptxas register / spill report is printed.
3. kernels: each kernel's wrapper at the main path's shapes (all three
   requests) against its plain PyTorch version on the same inputs, with the
   limit and max|ref| printed beside the error, and planted faults (wrong
   softmax scale, a dropped key tile, a wrong RoPE sign) shown to exceed it;
   kernel, plain and `F.scaled_dot_product_attention` (`library_ms`, a
   yardstick the port never calls) timed with CUDA events.
4. agreement: a scaled IGGT (fp32 trunk, then bf16 trunk), on the card through
   the kernels and on the CPU through the plain versions, same weights and
   images.
5. requests: the full-width `ModelConfig()` (ViT-L/14 trunk in bf16, fp32
   heads, random weights from a seed) through `IGGTProcessor` on synthetic
   seeded scenes: 3 and 8 views at 504x336, 8 views at 518x518.  Each prints
   the median wall time and views/s of three requests and of three bare
   forwards (after a warm-up), peak memory, output shapes and finiteness,
   and the kernel launch counts of the first timed request (counts set to 0
   just before it); then one 518x518 forward under `torch.profiler` gives
   device time by kernel bucket and the device's busy share.

The line before the last is the card's nvidia-smi line, the one before that a
JSON summary of the kernels, and the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 tensor / fp32 FMA
BF16_REL = 2.0 ** -6
FP32_ABS = 1e-5
# bf16: 2^-6 * max|ref|, 2 to 4 bf16 ulps of the largest output.  Kernel and
# plain version both keep fp32 logits and round the output to bf16 once (P is
# rounded unnormalized in the kernel, normalized in the plain version); the
# errors seen are one ulp of max|ref|.  Attention outputs shrink as
# ~sqrt(e / N) with N keys, so the limit scales with the output, and every
# case shows that planted faults exceed it.
# fp32: the kernel multiplies in full fp32 (no TF32); only summation order differs.


def error_limit(dtype_name: str, ref_max: float) -> float:
    return BF16_REL * ref_max if dtype_name == "bfloat16" else FP32_ABS

def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, Nq, Nk, H, D, dtype_name, extra_bytes=0):
    """Least time for the work: each input read once and the output written
    once over the HBM rate, against Q.K^T + P.V flops over the dtype's peak."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * B * Nq * H * D + 2 * B * Nk * H * D) * itemsize + extra_bytes
    flops = 4 * B * H * Nq * Nk * D
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: per-kernel checks

KERNEL_CASES = (
    # (label, kernel, (B, N, H, D), dtype, key bias); the frame, DINOv2 and
    # global blocks hold 5 special tokens + the patch grid per view
    ("global block, 8 views 518px", "flash_attention", (1, 10992, 16, 64), "bfloat16", False),
    ("frame/DINOv2 block, 8 views 518px", "flash_attention", (8, 1374, 16, 64), "bfloat16", False),
    ("part cross-attention, 8 views 518px", "flash_attention", (8, 1369, 8, 32), "float32", False),
    ("frame block q/k prep, 8 views 518px", "flash_attention_fused", (8, 1374, 16, 64), "bfloat16",
     False),
    ("global block, 8 views 504x336", "flash_attention", (1, 6952, 16, 64), "bfloat16", False),
    ("frame/DINOv2 block, 8 views 504x336", "flash_attention", (8, 869, 16, 64), "bfloat16", False),
    ("part cross-attention, 8 views 504x336", "flash_attention", (8, 864, 8, 32), "float32", False),
    ("frame block q/k prep, 8 views 504x336", "flash_attention_fused", (8, 869, 16, 64), "bfloat16",
     False),
    ("global block, 3 views 504x336", "flash_attention", (1, 2607, 16, 64), "bfloat16", False),
    ("frame/DINOv2 block, 3 views 504x336", "flash_attention", (3, 869, 16, 64), "bfloat16", False),
    ("part cross-attention, 3 views 504x336", "flash_attention", (3, 864, 8, 32), "float32", False),
    ("frame block q/k prep, 3 views 504x336", "flash_attention_fused", (3, 869, 16, 64), "bfloat16",
     False),
    ("key_bias", "flash_attention", (2, 1374, 16, 64), "bfloat16", True),
)
PATCH_GRID = {1374: (37, 37), 869: (24, 36)}     # tokens per view -> (h, w) patches
MAIN_CASE = {"flash_attention": "global block, 8 views 518px",
             "flash_attention_fused": "frame block q/k prep, 8 views 518px"}
REPLACES = {
    "flash_attention": "iggt_official_tpu/ops/flash_attention.py:117",
    "flash_attention_fused": "iggt_official_tpu/ops/flash_attention.py:335",
}
KEY_TILE = 64


def check_kernels():
    """Each case: kernel against plain version (error, limit, max|ref|), then
    three planted faults, made by handing the kernel altered inputs, which
    must each exceed the limit: the softmax scale off by sqrt(2) (q, or the
    q-norm affine, times sqrt(2)), the last key tile dropped, and (fused) the
    RoPE sine's sign flipped on a quarter of the head dims."""
    import torch
    import torch.nn.functional as F

    from iggt_official_tpu_torch.layers.rope import (
        compute_rope_2d, make_patch_positions, pack_rope_tables,
    )
    from iggt_official_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = []
    for label, kernel, (B, N, H, D), dtype_name, with_bias in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        # q/k/v as the main path hands them over: strided views of one qkv
        qkv = torch.randn((B, N, 3, H, D), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.unbind(2)
        bias = (torch.randn((B, N), generator=gen, device=dev) if with_bias else None)
        extra = 0 if bias is None else bias.numel() * 4
        kept = N - (N % KEY_TILE or KEY_TILE)

        def cut(t, kept=kept):
            return None if t is None else t[:, :kept]

        if kernel == "flash_attention_fused":
            h, w = PATCH_GRID[N]
            pos = make_patch_positions(h, w, B, N - h * w, device=dev)
            cos, sin = pack_rope_tables(compute_rope_2d(pos, D))
            norm = tuple(torch.randn((D,), generator=gen, device=dev) * 0.5 + c
                         for c in (1.0, 0.0, 1.0, 0.0))
            extra += 2 * cos.numel() * 4 + 4 * D * 4

            def run_kernel():
                return fa.flash_attention_fused(q, k, v, cos, sin, norm, bias)

            def run_plain():
                qp = fa.qk_prep_plain(q, norm[0], norm[1], cos, sin)
                kp = fa.qk_prep_plain(k, norm[2], norm[3], cos, sin)
                return fa.flash_attention_plain(qp, kp, v, bias)

            flipped = sin.clone(memory_format=torch.contiguous_format)
            flipped[..., :D // 4] *= -1
            faults = {
                "scale x sqrt2": lambda: fa.flash_attention_fused(
                    q, k, v, cos, sin,
                    (norm[0] * 2 ** 0.5, norm[1] * 2 ** 0.5, norm[2], norm[3]), bias),
                "last key tile dropped": lambda: fa.flash_attention_fused(
                    q, cut(k), cut(v), cos, sin, norm, cut(bias)),
                "rope sign on D/4": lambda: fa.flash_attention_fused(
                    q, k, v, cos.contiguous(), flipped, norm, bias),
            }
            qp = fa.qk_prep_plain(q, norm[0], norm[1], cos, sin).transpose(1, 2)
            kp = fa.qk_prep_plain(k, norm[2], norm[3], cos, sin).transpose(1, 2)
        else:
            def run_kernel():
                return fa.flash_attention(q, k, v, bias)

            def run_plain():
                return fa.flash_attention_plain(q, k, v, bias)

            faults = {
                "scale x sqrt2": lambda: fa.flash_attention(
                    (q.float() * 2 ** 0.5).to(dtype), k, v, bias),
                "last key tile dropped": lambda: fa.flash_attention(
                    q, cut(k), cut(v), cut(bias)),
            }
            qp, kp = q.transpose(1, 2), k.transpose(1, 2)
        vt = v.transpose(1, 2)
        mask = None if bias is None else bias[:, None, None, :].to(dtype)

        def run_library():
            return F.scaled_dot_product_attention(qp, kp, vt, attn_mask=mask)

        out = run_kernel()
        torch.cuda.synchronize()
        ref = run_plain().float()
        ref_max = ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all().item())
        limit = error_limit(dtype_name, ref_max)
        fault_errs = {name: (fn().float() - ref).abs().max().item()
                      for name, fn in faults.items()}
        caught = all(e > limit for e in fault_errs.values())
        ms = time_ms(run_kernel)
        plain_ms = time_ms(run_plain, iters=3, warmup=1)
        library_ms = time_ms(run_library)
        bound_ms, bound_by = attention_bound_ms(B, N, N, H, D, dtype_name, extra)
        ok = finite and err <= limit and caught
        log(f"[kernels] {kernel:22s} {label:38s} {(B, N, H, D)} {dtype_name:8s} "
            f"max_abs_err={err:.3e} (limit {limit:.3e}, max|ref| {ref_max:.3e}) "
            f"{'ok' if ok else 'FAIL'} | "
            f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f}")
        log(f"[kernels]   planted faults: "
            + ", ".join(f"{name} err {e:.3e} ({e / limit:.1f}x limit)"
                        for name, e in fault_errs.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel=kernel, label=label, shape=[B, N, H, D], dtype=dtype_name,
            key_bias=with_bias, max_abs_err=err, limit=limit, max_abs_ref=ref_max,
            fault_errs=fault_errs, ok=ok, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        ))
        del qkv, q, k, v, out, ref, faults
    torch.cuda.empty_cache()
    return results

def kernels_summary(results, launches):
    out = []
    for kernel in ("flash_attention", "flash_attention_fused"):
        cases = [r for r in results if r["kernel"] == kernel]
        main = next(r for r in cases if r["label"] == MAIN_CASE[kernel])
        out.append({
            "name": kernel,
            "route": "cuda",
            "source": "iggt_official_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES[kernel],
            "launches": launches.get(kernel, 0),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            "cases": [{k: r[k] for k in ("label", "shape", "dtype", "key_bias",
                                          "max_abs_err", "limit", "max_abs_ref",
                                          "fault_errs", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}
                      for r in cases],
        })
    return out


# ---------------------------------------------------------------------------
# phase 4: card (kernels) against CPU (plain versions) on a scaled model

AGREEMENT_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# fp32: TF32 is off, so card and CPU differ only in summation order.
# bf16: the trunk rounds to 8 mantissa bits at every matmul, in different
# orders on the two devices.
OUTPUTS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf",
           "part_feat")


def rel_err(ref, out) -> float:
    ref, out = ref.float().cpu(), out.float().cpu()
    return ((ref - out).abs().max() / ref.abs().max().clamp_min(1e-12)).item()


def check_agreement() -> bool:
    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.models.vggt import build_model
    from iggt_official_tpu_torch.ops import flash_attention as fa

    ok = True
    imgs = np.random.default_rng(SEED).uniform(0, 1, (1, 2, 112, 154, 3)).astype(np.float32)
    for trunk in ("float32", "bfloat16"):
        cfg = dataclasses.replace(
            ModelConfig().scaled(embed_dim=128, depth=2, num_heads=2, vit_depth=2,
                                 img_size=112), trunk_dtype=trunk)
        cpu = build_model(cfg, "cpu", seed=SEED)
        card = build_model(cfg, "cuda", seed=SEED + 1)
        card.load_state_dict(cpu.state_dict())
        with torch.inference_mode():
            ref = cpu(torch.from_numpy(imgs))
            fa.flash_attention.launches = fa.flash_attention_fused.launches = 0
            out = card(torch.from_numpy(imgs).cuda())
            torch.cuda.synchronize()
        counts = (fa.flash_attention_fused.launches, fa.flash_attention.launches)
        want = (cfg.aggregator.depth, cfg.aggregator.vit.depth + cfg.aggregator.depth + 1)
        errs = {k: rel_err(ref[k], out[k]) for k in OUTPUTS}
        good = counts == want and all(e < AGREEMENT_TOL[trunk] for e in errs.values())
        ok &= good
        log(f"[agreement] scaled IGGT, {trunk} trunk, 2 views 112x154: card vs CPU "
            f"max rel err {max(errs.values()):.3e} (limit {AGREEMENT_TOL[trunk]:.0e}); "
            + ", ".join(f"{k}={e:.2e}" for k, e in errs.items())
            + f"; launches fused={counts[0]} flash={counts[1]} (want {want[0]}, {want[1]}) "
            + ("ok" if good else "FAIL"))
        del cpu, card
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 5: full-width requests through IGGTProcessor

REQUESTS = (("3 views 504x336", 3, (504, 336)),
            ("8 views 504x336", 8, (504, 336)),
            ("8 views 518x518", 8, (518, 518)))


def write_scene(root: str, n_views: int, seed: int) -> str:
    """Synthetic seeded 640x480 views: smooth random colour fields plus noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    scene = os.path.join(root, f"scene_{n_views}_{seed}")
    os.makedirs(os.path.join(scene, "images"))
    for i in range(n_views):
        coarse = rng.uniform(0, 255, (6, 8, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((640, 480), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(scene, "images", f"{i:04d}.png"))
    return scene


def check_outputs(preds, S, H, W):
    shapes = {"pose_enc": (1, S, 9), "depth": (S, H, W, 1), "depth_conf": (S, H, W),
              "world_points": (S, H, W, 3), "world_points_conf": (S, H, W),
              "part_feat": (S, H, W, 8), "extrinsic": (S, 3, 4), "intrinsic": (S, 3, 3),
              "world_points_from_depth": (S, H, W, 3), "images": (S, H, W, 3)}
    problems = [f"{k} {preds[k].shape} != {v}" for k, v in shapes.items()
                if preds[k].shape != v]
    # random weights: a view whose decoded field of view is 0 (the fov goes
    # through a ReLU) has an infinite focal length, so its intrinsics and
    # unprojected points are not finite; every model output must be
    fov_ok = (preds["pose_enc"][0, :, 7:9] > 0).all(-1)
    for k in shapes:
        vals = preds[k][fov_ok] if k in ("intrinsic", "world_points_from_depth") else preds[k]
        if not np.isfinite(vals).all():
            problems.append(f"{k} not finite")
    return problems, int((~fov_ok).sum())


BUCKETS = (("flash attention (ours)", ("flash_kernel",)),
           ("convolution", ("fprop", "dgrad", "conv", "cudnn", "winograd", "fft")),
           ("matmul", ("gemm", "cutlass", "xmma", "matmul")),
           ("LayerNorm / softmax / reductions", ("reduce", "norm", "softmax")))


def profile_forward(model, x, fwd_s: float, top: int = 10) -> None:
    """Device time by kernel over one forward (torch.profiler), grouped into
    buckets by kernel name, and the device's busy share of the unprofiled
    forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    total = sum(ms for ms, _, _ in rows)
    if not total:
        log("[profile] the profiler recorded no device time")
        return
    buckets = {name: 0.0 for name, _ in BUCKETS}
    buckets["other (elementwise, copies)"] = 0.0
    for ms, _, key in rows:
        low = key.lower()
        name = next((n for n, pats in BUCKETS if any(p in low for p in pats)),
                    "other (elementwise, copies)")
        buckets[name] += ms
    log(f"[profile] 8 views 518x518 forward: device time {total:.1f} ms over "
        f"{sum(c for _, c, _ in rows)} kernel launches; busy {100 * total / 1e3 / fwd_s:.1f}% "
        f"of the unprofiled forward's {fwd_s * 1e3:.1f} ms wall")
    for name, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {name:36s} {ms:9.2f} ms  {100 * ms / total:5.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"[profile]   top: {ms:9.2f} ms  x{count:<5d} {key[:110]}")


def wall_s(fn) -> float:
    """Host wall time of ``fn`` between two device synchronizations."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def run_requests(launches_out: dict) -> bool:
    import torch

    from iggt_official_tpu_torch.app.demo import IGGTProcessor
    from iggt_official_tpu_torch.config import RuntimeConfig
    from iggt_official_tpu_torch.ops import flash_attention as fa

    t0 = time.time()
    proc = IGGTProcessor(device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in proc.model.parameters())
    log(f"[requests] full-width ModelConfig(): {n_params / 1e9:.3f} B parameters, "
        f"trunk {proc.cfg.trunk_dtype}, heads float32, built in "
        f"{time.time() - t0:.1f} s")
    want = (proc.cfg.aggregator.depth,
            proc.cfg.aggregator.vit.depth + proc.cfg.aggregator.depth + 1)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, S, (W, H)) in enumerate(REQUESTS):
            scene = write_scene(tmp, S, SEED + i)
            out_dir = os.path.join(tmp, f"out_{i}")
            proc.runtime = RuntimeConfig(image_size=(W, H))
            proc.process_scene(scene, out_dir)                 # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention.launches = fa.flash_attention_fused.launches = 0
            t = time.perf_counter()
            preds = proc.process_scene(scene, out_dir)
            torch.cuda.synchronize()
            walls = [time.perf_counter() - t]
            counts = (fa.flash_attention_fused.launches, fa.flash_attention.launches)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            walls += [wall_s(lambda: proc.process_scene(scene, out_dir)) for _ in range(2)]
            wall = float(np.median(walls))
            x = torch.from_numpy(preds["images"][None]).cuda()
            with torch.inference_mode():
                fwd = float(np.median([wall_s(lambda: proc.model(x)) for _ in range(3)]))
            problems, zero_fov = check_outputs(preds, S, H, W)
            if counts != want:
                problems.append(f"launches fused={counts[0]} flash={counts[1]}, "
                                f"want {want[0]} and {want[1]}")
            ok &= not problems
            launches_out["flash_attention_fused"], launches_out["flash_attention"] = counts
            log(f"[requests] {label}: request {wall:.3f} s ({S / wall:.2f} views/s), "
                f"forward {fwd:.3f} s ({S / fwd:.2f} views/s), peak "
                f"{peak:.2f} GiB allocated; launches fused={counts[0]} flash={counts[1]}; "
                f"outputs {'finite, shapes ok' if not problems else problems}"
                f"{f' (views with zero fov: {zero_fov})' if zero_fov else ''}")
        profile_forward(proc.model, x, fwd)
    return ok


# ---------------------------------------------------------------------------

def main(phases=("device", "build", "kernels", "agreement", "requests")) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from iggt_official_tpu_torch.ops import cuda_build, flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc})", file=sys.stderr)
        return 1

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if "build" in phases:
        t0 = time.time()
        logs = cuda_build.build_all()
        log(f"[build] {len(logs)} source(s) built in {time.time() - t0:.1f} s")
        for src, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"[build] {src}: {line.strip()}")

    results = []
    ok = True
    if "kernels" in phases:
        results = check_kernels()
        ok &= all(r["ok"] for r in results)
    if "agreement" in phases:
        ok &= check_agreement()
    launches = {}
    if "requests" in phases:
        ok &= run_requests(launches)

    summary = kernels_summary(results, launches) if results else []
    log(json.dumps({"kernels": summary}))
    log(smi)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
