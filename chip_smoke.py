#!/usr/bin/env python3
"""Card smoke test of the PyTorch / CUDA port (`iggt_official_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a).  Phases, in
order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: every kernel source under `iggt_official_tpu_torch/csrc/` (one nvcc
   per source) and the native host library (g++), all in parallel; each
   build's time and the ptxas register / spill report are printed.
3. kernels: each kernel's wrapper at the main path's shapes (all three
   requests) against its plain PyTorch version on the same inputs, and
   planted faults shown to fail the check.  Flash attention: error against a
   limit (printed with max|ref|); faults are a wrong softmax scale, a dropped
   key tile, a wrong RoPE sign.  nn1: index mismatches, limit 0 (the kernel
   rounds as the plain version does); faults are a dropped last reference
   tile, a dropped last feature, and reversed tie order.  Kernel, plain and
   one PyTorch call computing the same function (`library_ms`, a yardstick
   the port never calls) timed with CUDA events.
4. agreement: a scaled IGGT (fp32 trunk, then bf16 trunk), on the card through
   the kernels and on the CPU through the plain versions, same weights and
   images; then the post-processing (PCA, smoothing, `_cluster_mv_device`)
   of one synthetic scene on the card and on the CPU.
5. postproc: the 10-view 504x336 synthetic scene of the JAX package's bench
   (M = 1,693,440, six regions) through the port's smoothing and clustering
   on the card, with the wall time of each stage; it must give 6 clusters.
6. requests: the full-width `ModelConfig()` (ViT-L/14 trunk in bf16, fp32
   heads, random weights from a seed) through `IGGTProcessor` on synthetic
   seeded scenes: 3 and 8 views at 504x336, 8 views at 518x518, with the
   post-processing.  Each prints the median wall time and views/s of three
   requests, of three bare forwards and of three post-processings (after a
   warm-up), peak memory, output shapes, ranges and finiteness, the clusters
   found, and the kernel launch counts of the first timed request (counts
   set to 0 just before it); then one 518x518 forward under `torch.profiler`
   gives device time by kernel bucket and the device's busy share.

The line before the last is the card's nvidia-smi line, the one before that a
JSON summary of the kernels, and the last line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
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


def voronoi_scene(views: int, h: int, w: int, seed: int = 1):
    """Synthetic post-processing scene (the JAX package's `bench.py:436-460`):
    per view a Voronoi partition of the image plane under 6 random sites, each
    region one of 6 feature centres in 8-D plus noise, and world points on a
    smooth depth surface with a per-region depth offset.  Returns (points
    (views, h, w, 3), features (views, h, w, 8)) float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (6, 8)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = np.empty((views, h, w), np.int64)
    for v in range(views):
        sites = rng.uniform(0, 1, (6, 2)).astype(np.float32)
        d2 = ((yy[None] / h - sites[:, :1, None]) ** 2
              + (xx[None] / w - sites[:, 1:, None]) ** 2)
        blob[v] = np.argmin(d2, axis=0)
    blob = blob.reshape(-1)
    fts = (centers[blob] + rng.normal(0, 0.05, (views * h * w, 8))
           ).astype(np.float32).reshape(views, h, w, 8)
    depth = 2.0 + 0.5 * np.sin(yy / 40.0)[None] + 0.3 * np.cos(xx / 55.0)[None]
    depth = depth + 0.4 * blob.reshape(views, h, w)
    pts = np.stack([(xx[None] / w - 0.5) * depth, (yy[None] / h - 0.5) * depth, depth],
                   axis=-1).astype(np.float32)
    pts += rng.normal(0, 0.003, pts.shape).astype(np.float32)
    return pts, fts


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
             "flash_attention_fused": "frame block q/k prep, 8 views 518px",
             "nn1": "backfill, 8 views 518x518"}
REPLACES = {
    "flash_attention": "iggt_official_tpu/ops/flash_attention.py:117",
    "flash_attention_fused": "iggt_official_tpu/ops/flash_attention.py:335",
    "nn1": "iggt_official_tpu/ops/nn1_pallas.py:82",
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

NN1_REF = 150_000        # the clustering subsample (`ClusteringConfig` budget)
NN1_COMPARE = 65_536     # queries compared with the plain version per case
NN1_LIBRARY_Q = 16_384   # queries of the cdist yardstick (full Q needs ~1 TB)
NN1_TILE = 1024          # reference rows per shared-memory stage in csrc/nn1.cu
NN1_DUP = 64             # planted duplicate references (ties) per case
NN1_CASES = (
    # (label, Q, R): the backfill of each request (Q = every pixel, R = the
    # subsample), a noise-reassignment size, and a ragged case with ties
    ("backfill, 3 views 504x336", 3 * 504 * 336, NN1_REF),
    ("backfill, 8 views 504x336", 8 * 504 * 336, NN1_REF),
    ("backfill, 8 views 518x518", 8 * 518 * 518, NN1_REF),
    ("noise reassignment", 30_000, 120_000),
    ("ragged, ties", 1_000, 2_500),
)
SOURCE = {"flash_attention": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "flash_attention_fused": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "nn1": "iggt_official_tpu_torch/csrc/nn1.cu"}


def nn1_bound_ms(Q: int, R: int, D: int = 8):
    """3 * Q * R * D fp32 operations (the Pallas CostEstimate) over the fp32
    peak, against each input read once and the int64 output written once;
    and the instruction floor without FMA (each operation one instruction,
    twice the flop bound)."""
    t_ops = 3 * Q * R * D / PEAK_OPS_PER_S["float32"]
    t_bytes = ((Q + R) * D * 4 + Q * 8) / PEAK_BYTES_PER_S
    bound = max(t_ops, t_bytes)
    return bound * 1e3, ("bytes" if t_bytes > t_ops else "operations"), 2 * t_ops * 1e3


def nn1_inputs(Q: int, R: int, gen):
    """Clustered features as the pipeline has them (6 unit centres in 8-D
    plus noise); the references a random subset of the queries, as in the
    backfill; NN1_DUP references duplicated (ties) and hit exactly by the
    first NN1_DUP queries."""
    import torch

    dev = gen.device
    centers = torch.randn((6, 8), generator=gen, device=dev)
    centers /= centers.norm(dim=1, keepdim=True)

    def sample(n):
        lab = torch.randint(0, 6, (n,), generator=gen, device=dev)
        return centers[lab] + 0.05 * torch.randn((n, 8), generator=gen, device=dev)

    qry = sample(Q)
    ref = (qry[torch.randperm(Q, generator=gen, device=dev)[:R]].clone() if R <= Q
           else sample(R))
    ref[R // 2:R // 2 + NN1_DUP] = ref[:NN1_DUP]
    qry[:NN1_DUP] = ref[:NN1_DUP]
    return qry, ref


def check_nn1():
    """Each case: the kernel at full Q against the plain version on the first
    NN1_COMPARE queries (mismatches must be 0), three planted faults on the
    same queries (each must mismatch), then times: kernel and plain at full
    Q, `torch.cdist(q, r).argmin(1)` and the kernel on NN1_LIBRARY_Q queries."""
    import torch

    from iggt_official_tpu_torch.ops.nn1 import nn1, nn1_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for label, Q, R in NN1_CASES:
        qry, ref = nn1_inputs(Q, R, gen)
        C = min(Q, NN1_COMPARE)
        out = nn1(qry, ref)
        torch.cuda.synchronize()
        want = nn1_plain(qry[:C], ref)
        mismatches = int((out[:C] != want).sum())
        in_range = bool(((out >= 0) & (out < R)).all())
        kept = R - (R % NN1_TILE or NN1_TILE)
        q_nolast, r_nolast = qry[:C].clone(), ref.clone()
        q_nolast[:, -1] = 0
        r_nolast[:, -1] = 0
        faults = {
            "last ref tile dropped": nn1(qry[:C], ref[:kept]),
            "last feature dropped": nn1(q_nolast, r_nolast),
            "reversed tie order": R - 1 - nn1(qry[:C], ref.flip(0)),
        }
        fault_mm = {name: int((j != want).sum()) for name, j in faults.items()}
        caught = all(m > 0 for m in fault_mm.values())
        ms = time_ms(lambda: nn1(qry, ref), iters=3, warmup=1)
        plain_ms = time_ms(lambda: nn1_plain(qry, ref), iters=1, warmup=0)
        L = min(Q, NN1_LIBRARY_Q)
        library_ms = time_ms(lambda: torch.cdist(qry[:L], ref).argmin(1), iters=3, warmup=1)
        library_kernel_ms = time_ms(lambda: nn1(qry[:L], ref), iters=3, warmup=1)
        bound_ms, bound_by, floor_ms = nn1_bound_ms(Q, R)
        ok = mismatches == 0 and in_range and caught
        log(f"[kernels] nn1 {label:28s} Q={Q} R={R}: mismatches {mismatches} of {C} "
            f"(limit 0) {'ok' if ok else 'FAIL'} | ms={ms:.3f} bound_ms={bound_ms:.3f} "
            f"({bound_by}; no-FMA instruction floor {floor_ms:.3f}) plain_ms={plain_ms:.3f} | "
            f"on {L} queries: library_ms={library_ms:.3f} (cdist+argmin) kernel "
            f"{library_kernel_ms:.3f}")
        log("[kernels]   planted faults: "
            + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel="nn1", label=label, shape=[Q, R, 8], dtype="float32",
            max_abs_err=float(mismatches), mismatches=mismatches, compared=C,
            fault_mismatches=fault_mm, ok=ok, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_queries=L, library_kernel_ms=library_kernel_ms,
            bound_ms=bound_ms, bound_by=bound_by, instruction_floor_ms=floor_ms,
        ))
        del qry, ref, out, want, faults, q_nolast, r_nolast
    torch.cuda.empty_cache()
    return results


CASE_KEYS = {
    "flash_attention": ("label", "shape", "dtype", "key_bias", "max_abs_err", "limit",
                        "max_abs_ref", "fault_errs", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"),
    "nn1": ("label", "shape", "mismatches", "compared", "fault_mismatches", "ms",
            "plain_ms", "bound_ms", "bound_by", "instruction_floor_ms", "library_ms",
            "library_queries", "library_kernel_ms"),
}
CASE_KEYS["flash_attention_fused"] = CASE_KEYS["flash_attention"]


def kernels_summary(results, launches):
    out = []
    for kernel in ("flash_attention", "flash_attention_fused", "nn1"):
        cases = [r for r in results if r["kernel"] == kernel]
        if not cases:
            continue
        main = next(r for r in cases if r["label"] == MAIN_CASE[kernel])
        out.append({
            "name": kernel,
            "route": "cuda",
            "source": SOURCE[kernel],
            "replaces": REPLACES[kernel],
            "launches": launches.get(kernel, 0),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **{k: main[k] for k in ("instruction_floor_ms", "library_queries",
                                    "library_kernel_ms") if k in main},
            "cases": [{k: r[k] for k in CASE_KEYS[kernel]} for r in cases],
        })
        if kernel == "nn1":
            out[-1]["max_abs_err_is"] = "index mismatches against the plain version"
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


PP_AGREE = (3, 96, 128)   # M = 36,864
PP_AGREE_BUDGET = 4_096   # subsampled, so the backfill and refinement run
PP_TOL = 1e-5             # PCA and smoothing: fp32, summation order differs
PP_AGREE_MIN = 0.995      # mask agreement (tests/test_cluster_device.py's bar)


def max_err_up_to_flip(got, want) -> float:
    """Max abs error per channel of the last axis, taking each channel as it
    is or flipped (x -> 1 - x, an eigenvector of the other sign)."""
    return max(min(np.abs(got[..., c] - want[..., c]).max(),
                   np.abs(got[..., c] - (1 - want[..., c])).max())
               for c in range(want.shape[-1]))


def check_postproc_agreement() -> bool:
    """PCA, smoothing and `_cluster_mv_device` on the card (the nn1 kernel,
    exact brute-force core kNN, rank Boruvka) against the same functions on
    CPU tensors (plain nn1), and the exact (every pixel) clustering on the
    card against the host path's, on one synthetic scene."""
    import torch

    from iggt_official_tpu_torch.ops import cluster as cl
    from iggt_official_tpu_torch.ops.knn import knn_smooth_features
    from iggt_official_tpu_torch.ops.nn1 import nn1
    from iggt_official_tpu_torch.ops.pca import normalize_and_pca

    S, H, W = PP_AGREE
    pts, fts = voronoi_scene(S, H, W, seed=SEED + 2)
    out = {}
    for dev in ("cuda", "cpu"):
        feat, pca = normalize_and_pca(torch.from_numpy(fts).to(dev))
        smoothed = knn_smooth_features(torch.from_numpy(pts).to(dev), feat, k=20)
        out[dev] = pca.cpu().numpy(), smoothed.cpu().numpy()
    pca_err = max_err_up_to_flip(out["cuda"][0], out["cpu"][0])
    smooth_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())

    flat = torch.from_numpy(out["cpu"][1].reshape(-1, 8))
    kw = dict(eps=0.06, min_samples=100, min_cluster_size=500, budget=PP_AGREE_BUDGET)
    nn1.launches = 0
    trace = {}
    card = cl._cluster_mv_device(flat.cuda(), S, H, W, trace=trace, **kw)
    launches = nn1.launches
    cpu = cl._cluster_mv_device(flat, S, H, W, **kw)
    agree = float((card == cpu).mean())
    n_card, n_cpu = (len(np.unique(m[m >= 0])) for m in (card, cpu))
    ok = (pca_err <= PP_TOL and smooth_err <= PP_TOL and n_card == n_cpu
          and agree >= PP_AGREE_MIN and launches >= 1)
    log(f"[agreement] post-processing, Voronoi scene {S} views {W}x{H}, budget "
        f"{PP_AGREE_BUDGET}: card vs CPU PCA err {pca_err:.2e} (up to sign), smoothing err "
        f"{smooth_err:.2e} (limit {PP_TOL:.0e}); clusters {n_card} vs {n_cpu}, mask agreement "
        f"{agree:.5f} (limit {PP_AGREE_MIN}); nn1 launches {launches}; card stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in trace.items()) + f" {'ok' if ok else 'FAIL'}")

    exact = dict(eps=0.06, min_samples=100, min_cluster_size=500, exact=True)
    fmap = out["cpu"][1].reshape(S, H, W, 8)
    t0 = time.perf_counter()
    card = cl.cluster_features_to_masks_mv(torch.from_numpy(fmap).cuda(), **exact)
    card_s = time.perf_counter() - t0
    host = cl.cluster_features_to_masks_mv(fmap, **exact)
    agree = float((card == host).mean())
    n_card, n_host = (len(np.unique(m[m >= 0])) for m in (card, host))
    good = n_card == n_host and agree >= PP_AGREE_MIN
    log(f"[agreement] exact clustering (every pixel), same scene: card {card_s:.3f} s vs "
        f"host path: clusters {n_card} vs {n_host}, mask agreement {agree:.5f} "
        f"(limit {PP_AGREE_MIN}) {'ok' if good else 'FAIL'}")
    return ok and good


# ---------------------------------------------------------------------------
# phase 5: the 10-view post-processing scene

PP_SCENE = (10, 336, 504)  # bench.py's postproc smoke: M = 1,693,440
PP_SCENE_CLUSTERS = 6      # the JAX package's record on this scene (BENCH_r05.json)


def run_postproc() -> bool:
    """The 10-view synthetic scene through the port's smoothing and
    clustering on the card, traced stage by stage; nn1 counts set to 0 just
    before and read just after."""
    import torch

    from iggt_official_tpu_torch.ops.cluster import cluster_features_to_masks_mv
    from iggt_official_tpu_torch.ops.knn import knn_smooth_features
    from iggt_official_tpu_torch.ops.nn1 import nn1

    S, H, W = PP_SCENE
    pts, fts = voronoi_scene(S, H, W, seed=1)
    pts, fts = torch.from_numpy(pts).cuda(), torch.from_numpy(fts).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nn1.launches = 0
    t0 = time.perf_counter()
    smoothed = knn_smooth_features(pts, fts, k=20)
    torch.cuda.synchronize()
    trace = {"smoothing": time.perf_counter() - t0}
    t1 = time.perf_counter()
    masks = cluster_features_to_masks_mv(smoothed, trace=trace)
    total = time.perf_counter() - t0
    clusters = len(np.unique(masks[masks >= 0]))
    ok = (masks.shape == (S, H, W) and clusters == PP_SCENE_CLUSTERS
          and nn1.launches >= 1)
    log(f"[postproc] Voronoi scene {S} views {W}x{H} (M = {S * H * W}): smoothing + "
        f"clustering {total:.3f} s (clustering {time.perf_counter() - t1:.3f} s); stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in trace.items() if k != "noise share")
        + f"; noise share before reassignment {trace.get('noise share', 0.0):.4f}; clusters "
        f"{clusters} (want {PP_SCENE_CLUSTERS}); nn1 launches {nn1.launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB {'ok' if ok else 'FAIL'}")
    del pts, fts, smoothed
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 6: full-width requests through IGGTProcessor

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
              "world_points_from_depth": (S, H, W, 3), "images": (S, H, W, 3),
              "part_feat_pca": (S, H, W, 3), "instance_masks": (S, H, W),
              "instance_masks_colored": (S, H, W, 3)}
    problems = [f"{k} {preds[k].shape} != {v}" for k, v in shapes.items()
                if preds[k].shape != v]
    pca, masks = preds["part_feat_pca"], preds["instance_masks"]
    if not (pca.min() >= 0 and pca.max() <= 1):
        problems.append(f"part_feat_pca outside [0, 1]: {pca.min()}..{pca.max()}")
    if masks.dtype != np.int64 or masks.min() < -1:
        problems.append(f"instance_masks {masks.dtype}, min {masks.min()}")
    if preds["instance_masks_colored"].dtype != np.uint8:
        problems.append(f"instance_masks_colored {preds['instance_masks_colored'].dtype}")
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
    from iggt_official_tpu_torch.ops.cluster import BUDGET
    from iggt_official_tpu_torch.ops.nn1 import nn1

    t0 = time.time()
    proc = IGGTProcessor(device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in proc.model.parameters())
    log(f"[requests] full-width ModelConfig(): {n_params / 1e9:.3f} B parameters, "
        f"trunk {proc.cfg.trunk_dtype}, heads float32, built in "
        f"{time.time() - t0:.1f} s; clustering {proc.runtime.clustering}")
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
            nn1.launches = 0
            t = time.perf_counter()
            preds = proc.process_scene(scene, out_dir)
            torch.cuda.synchronize()
            walls = [time.perf_counter() - t]
            counts = (fa.flash_attention_fused.launches, fa.flash_attention.launches,
                      nn1.launches)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            walls += [wall_s(lambda: proc.process_scene(scene, out_dir)) for _ in range(2)]
            wall = float(np.median(walls))
            x = torch.from_numpy(preds["images"][None]).cuda()
            with torch.inference_mode():
                fwd = float(np.median([wall_s(lambda: proc.model(x)) for _ in range(3)]))
            raw = proc._run_inference(scene)
            post = float(np.median([wall_s(lambda: proc._post_process(dict(raw)))
                                    for _ in range(3)]))
            stages = {}
            proc._post_process(dict(raw), trace=stages)
            del raw
            problems, zero_fov = check_outputs(preds, S, H, W)
            if counts[:2] != want:
                problems.append(f"launches fused={counts[0]} flash={counts[1]}, "
                                f"want {want[0]} and {want[1]}")
            if S * H * W > BUDGET and counts[2] < 1:
                problems.append("no nn1 launch although M exceeds the subsample budget")
            pngs = [len(os.listdir(os.path.join(out_dir, d))) for d in ("masks", "pca")]
            if pngs != [S, S]:
                problems.append(f"mask / pca PNGs {pngs}, want {S} each")
            ok &= not problems
            (launches_out["flash_attention_fused"], launches_out["flash_attention"],
             launches_out["nn1"]) = counts
            masks = preds["instance_masks"]
            log(f"[requests] {label}: request {wall:.3f} s ({S / wall:.2f} views/s), "
                f"forward {fwd:.3f} s ({S / fwd:.2f} views/s), post-processing "
                f"{post:.3f} s, peak {peak:.2f} GiB allocated; launches "
                f"fused={counts[0]} flash={counts[1]} nn1={counts[2]}; clusters "
                f"{len(np.unique(masks[masks >= 0]))}, noise pixels {(masks < 0).mean():.4f}; "
                f"outputs {'finite, shapes and ranges ok' if not problems else problems}"
                f"{f' (views with zero fov: {zero_fov})' if zero_fov else ''}")
            log(f"[requests]   post-processing stages (one traced run): "
                + ", ".join(f"{k} {v:.3f}" for k, v in stages.items() if k != "noise share")
                + f"; noise share before reassignment {stages.get('noise share', 0.0):.4f}")
        profile_forward(proc.model, x, fwd)
    return ok


# ---------------------------------------------------------------------------

def build_all() -> None:
    """nvcc for every kernel source and g++ for the native host library, all
    started together; prints each build's time and the ptxas report."""
    from iggt_official_tpu_torch import native
    from iggt_official_tpu_torch.ops import cuda_build

    def timed(fn, *args):
        t = time.time()
        _, text = fn(*args)
        return time.time() - t, text

    t0 = time.time()
    jobs = {f"{name}.cu (nvcc)": (cuda_build.build, name) for name in cuda_build.SOURCES}
    jobs["postproc.cpp (g++)"] = (native.build,)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {src: pool.submit(timed, *job) for src, job in jobs.items()}
        done = {src: fut.result() for src, fut in futures.items()}
    log(f"[build] {len(done)} builds in {time.time() - t0:.1f} s")
    for src, (secs, text) in done.items():
        log(f"[build] {src}: {secs:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {src}: {line.strip()}")


def main(phases=("device", "build", "kernels", "agreement", "postproc", "requests")) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import iggt_official_tpu_torch  # noqa: F401
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
        build_all()

    results = []
    ok = True
    if "kernels" in phases:
        results = check_kernels() + check_nn1()
        ok &= all(r["ok"] for r in results)
    if "agreement" in phases:
        ok &= check_agreement()
        ok &= check_postproc_agreement()
    launches = {}
    if "postproc" in phases:
        ok &= run_postproc()
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
