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
   planted faults shown to fail the check.  Flash attention (the frame, global
   and DINOv2 blocks, the fused q/k prep at the frame and the global shape in
   bf16 and, as `trunk_dtype="float32"` runs them, in fp32, the part head's
   cross-attention in fp32 and, as bf16 heads run it, in bf16): error against
   a limit (printed with max|ref|), time and share of the bound (fp32: three
   TF32 passes at the TF32 peak, the fp32 FMA figure beside it); faults are a
   wrong softmax scale, a dropped key tile, a wrong RoPE sign, and in fp32 one
   TF32 pass instead of three and V^T without its key permutation.
   nn1: index mismatches, limit 0 (the kernel's answer is the exact chain's);
   faults are a dropped last reference tile, a dropped last feature, and
   reversed tie order; a near-tie case (4,096 unit queries, 16 references
   each at 1e-4 to 1e-3 among the 150,000) is compared in full, and two
   faults of the filter must mismatch there: a recheck window of zero and a
   single TF32 pass.  Every case reports the exact chains rechecked per
   query (counted on the card) and, beside it in the log, the bytes the
   filter reads from L2 as computed from the shapes; a probe of the tensor-core
   approximation gives its largest error against the window.  fused_ln: at every
   request's row count (eps 1e-5 and 1e-6, bf16), fp32 rows, and the scaled
   model's width; limit 1 bf16 ulp (1e-6 relative in fp32), with the share
   of elements that differ; faults are the last 8-element chunk left out of
   the reductions, the bias not added, the weight not applied; at the main
   shape also the device time per call of the kernel and of `F.layer_norm`
   (torch.profiler).  bucket_topk
   at Q = R = 150,000, k = 64, nb = 1024: 0 index mismatches in the bucket
   minima and the top-k; faults are bucket = index mod (nb - 1), reversed tie
   order, a dropped last reference tile; rechecks per (query, bucket); then
   the bucket minima on nn1's near-tie case with duplicates across chunks,
   compared in full, where the filter's faults (window zero, one TF32 pass)
   must mismatch.  Kernel, plain and one PyTorch call
   computing the same function (`library_ms`, a yardstick the port never
   calls) timed with CUDA events.
4. agreement: a scaled IGGT on the card through the kernels and on the CPU
   through the plain versions, same weights and images: fp32 trunk, bf16
   trunk, bf16 trunk with `fused_ln=True`, bf16 trunk with bf16 heads (its
   own limits, and a control against the CPU's fp32 heads that must fail
   them), an fp32 trunk merged at r = 40 (`global_merge_r`: the q/k prep
   kernel alone, the merge, the key-biased flash kernel) and an fp32 trunk
   with the track head and 16 query points (two refinement iterations; track,
   vis and conf at the fp32 limit, view 0's track equal to the queries); then
   the post-processing (PCA, smoothing, `_cluster_mv_device`) of one
   synthetic scene on the card and on the CPU.
5. postproc: the 10-view 504x336 synthetic scene of the JAX package's bench
   (M = 1,693,440, six regions) through the port's smoothing and clustering
   on the card, with the wall time of each stage; it must give 6 clusters.
   Then the bucket top-k path: `bucket_topk` (no module calls it, as in the
   JAX package) as a core-kNN candidate on the clustering's 150,000-point
   subsample of that scene, with its recall against the exact core kNN, and
   its bucket minima there (smoothed features, full of near ties) against
   the plain version on the first 16,384 queries: 0 index mismatches, with
   the kernel's time and rechecks per (query, bucket).
6. requests: the full-width `ModelConfig()` (ViT-L/14 trunk in bf16, fp32
   heads, random weights from a seed) through `IGGTProcessor.process_scene`
   on synthetic seeded scenes: 3 views at 504x336 (with seeded ground truth,
   so it evaluates), 8 views at 504x336 and 8 views at 518x518, each writing
   the demo's whole file set (npz, masks, PCA, depth_vis, three GLBs, the
   evaluation report).  Each prints the median wall time and views/s of three
   requests, of three bare forwards and of three post-processings (after a
   warm-up), peak memory, output shapes, ranges and finiteness, the clusters
   found, the kernel launch counts of the first timed request (counts set to
   0 just before it), and the stages of one traced request (forward,
   post-processing stages, evaluation, writes, GLB export).  The 8x518
   request's own backfill inputs, captured on their way into `nn1`, go
   through the kernel again: rechecks per query, and 0 mismatches against
   the plain version on the first 65,536 queries and on 65,536 more drawn
   from the seed over all of them.  Then the 8-view
   518x518 scene with `RuntimeConfig(fused_ln=True)` and with
   `head_dtype="bfloat16"` (same weights): the same request numbers, launch
   counts (144 fused_ln per forward), the difference from the baseline
   request; the three bare forwards timed in turns; the baseline forward with
   the global blocks on the fused wrapper (the q/k prep kernel, the port's
   route) and on the plain torch prep, in turns; one forward of each
   under `torch.profiler` gives device time by kernel bucket and the
   device's busy share.  Then token merging and the track head: the 8x518
   scene again through `process_scene` with
   `RuntimeConfig(global_merge_r=4096)` (the demo's `--merge_tokens`; 4,795
   candidates, so 6,896 keys), its file set and launch counts (per forward 24
   fused + 24 prep-only + 49 flash: 24 key-biased global, 24 DINOv2, the part
   head), its depth and world points against the exact request (log only:
   random weights); its bare forward timed in turns with the exact one, two
   merged forwards compared byte for byte; 32 views at 504x336 (N = 27,808)
   merged at r = 8192 and exact, timed in turns, with peak memory; and the
   full-width IGGT with `enable_track=True` at 8x518 with 256 query points
   on a grid in view 0: shapes, finite values, vis and conf in [0, 1], view
   0's track equal to the queries, the forward's time and the track head's
   share of it (CUDA events), peak memory.

The kernels phase also holds token merging's two launches at the merged
8x518 global block: the q/k prep kernel alone (1, 10992, 16, 64) against
`qk_prep_plain` (bf16 within 1 ulp, fp32 within 1e-5; faults: the RoPE
sine's sign, gamma x sqrt2) and the key-biased flash kernel at Nq = 10992,
Nk = 6896 (limit 2^-6 max|ref|; faults: the key bias dropped, the scale,
the last key tile), with SDPA on a float mask as its library call.

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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12,   # dense tensor-core rates
                  "float32": 67e12}                       # fp32 FMA outside the tensor cores
BF16_REL = 2.0 ** -6
FP32_ABS = 1e-5
# bf16: 2^-6 * max|ref|, 2 to 4 bf16 ulps of the largest output.  Kernel and
# plain version both keep fp32 logits and round the output to bf16 once (P is
# rounded unnormalized in the kernel, normalized in the plain version); the
# errors seen are one ulp of max|ref|.  Attention outputs shrink as
# ~sqrt(e / N) with N keys, so the limit scales with the output, and every
# case shows that planted faults exceed it.
# fp32: the kernel runs three TF32 passes (hi.lo + lo.hi + hi.hi of the split
# operands; 2^-20 |x||y| per product) and adds each key tile's P.V to O in fp32
# registers, so it stays within ~3e-6 of the plain version; one TF32 pass, or
# V^T without its key permutation, is a planted fault that must exceed 1e-5.


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


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of everything ``fn`` launches (torch.profiler's
    self device time of all kernels over ``iters`` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()) / iters / 1e3


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
    once over the HBM rate, against Q.K^T + P.V flops over the peak of the
    route that can reach the accuracy: bf16 tensor cores for bf16; for fp32
    three TF32 passes (one pass cannot hold 1e-5), 3 x the flops at the TF32
    peak.  Returns (bound ms, what bounds it, the fp32 FMA figure in ms: the
    flops once at the fp32 peak, printed beside the fp32 bound)."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * B * Nq * H * D + 2 * B * Nk * H * D) * itemsize + extra_bytes
    flops = 4 * B * H * Nq * Nk * D
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = (flops / PEAK_OPS_PER_S["bfloat16"] if dtype_name == "bfloat16"
             else 3 * flops / PEAK_OPS_PER_S["tf32"])
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations"),
            flops / PEAK_OPS_PER_S["float32"] * 1e3)


# ---------------------------------------------------------------------------
# phase 3: per-kernel checks

KERNEL_CASES = (
    # (label, kernel, (B, N, H, D), dtype, key bias: None, "random" (B, N), or
    # "merged": K/V at N - MERGE_R contiguous keys, as `merge_kv` leaves them,
    # with the log-size bias of merged keys); the frame, DINOv2 and global
    # blocks hold 5 special tokens + the patch grid per view
    ("global block, 8 views 518px", "flash_attention", (1, 10992, 16, 64), "bfloat16", None),
    ("frame/DINOv2 block, 8 views 518px", "flash_attention", (8, 1374, 16, 64), "bfloat16", None),
    ("part cross-attention, 8 views 518px", "flash_attention", (8, 1369, 8, 32), "float32", None),
    ("frame block q/k prep, 8 views 518px", "flash_attention_fused", (8, 1374, 16, 64), "bfloat16",
     None),
    ("global block q/k prep, 8 views 518px", "flash_attention_fused", (1, 10992, 16, 64),
     "bfloat16", None),
    # trunk_dtype="float32": the frame and global blocks' fused route in fp32
    ("frame block q/k prep, fp32 trunk, 8 views 518px", "flash_attention_fused",
     (8, 1374, 16, 64), "float32", None),
    ("global block q/k prep, fp32 trunk, 8 views 518px", "flash_attention_fused",
     (1, 10992, 16, 64), "float32", None),
    ("global block, 8 views 504x336", "flash_attention", (1, 6952, 16, 64), "bfloat16", None),
    ("frame/DINOv2 block, 8 views 504x336", "flash_attention", (8, 869, 16, 64), "bfloat16", None),
    ("part cross-attention, 8 views 504x336", "flash_attention", (8, 864, 8, 32), "float32", None),
    ("frame block q/k prep, 8 views 504x336", "flash_attention_fused", (8, 869, 16, 64), "bfloat16",
     None),
    ("global block, 3 views 504x336", "flash_attention", (1, 2607, 16, 64), "bfloat16", None),
    ("frame/DINOv2 block, 3 views 504x336", "flash_attention", (3, 869, 16, 64), "bfloat16", None),
    ("part cross-attention, 3 views 504x336", "flash_attention", (3, 864, 8, 32), "float32", None),
    ("frame block q/k prep, 3 views 504x336", "flash_attention_fused", (3, 869, 16, 64), "bfloat16",
     None),
    ("key_bias", "flash_attention", (2, 1374, 16, 64), "bfloat16", "random"),
    # head_dtype="bfloat16": the part head's cross-attention in bf16
    ("part cross-attention, bf16 heads, 8 views 518px", "flash_attention", (8, 1369, 8, 32),
     "bfloat16", None),
    ("part cross-attention, bf16 heads, 8 views 504x336", "flash_attention", (8, 864, 8, 32),
     "bfloat16", None),
    ("part cross-attention, bf16 heads, 3 views 504x336", "flash_attention", (3, 864, 8, 32),
     "bfloat16", None),
    # --merge_tokens: the 24 merged global blocks, Nq 10992 against Nk 6896
    ("merged global block, key bias, 8 views 518px", "flash_attention", (1, 10992, 16, 64),
     "bfloat16", "merged"),
)
# tokens per (batch) row -> (h, w) patches of a view, views in the row: the
# frame blocks hold one view, the global block all 8 views of the request
PATCH_GRID = {1374: (37, 37, 1), 869: (24, 36, 1), 10992: (37, 37, 8)}
MAIN_CASE = {"flash_attention": "frame/DINOv2 block, 8 views 518px",
             "flash_attention_fused": "frame block q/k prep, 8 views 518px",
             "qk_prep": "merged global block q/k prep, bfloat16, 8 views 518px",
             "nn1": "backfill, 8 views 518x518",
             "fused_ln": "frame/global pre-norm, 8 views 518px",
             "bucket_topk": "core kNN candidate, Q = R = 150000"}
REPLACES = {
    "flash_attention": "iggt_official_tpu/ops/flash_attention.py:117",
    "flash_attention_fused": "iggt_official_tpu/ops/flash_attention.py:335",
    "qk_prep": "iggt_official_tpu/ops/flash_attention.py:335",
    "nn1": "iggt_official_tpu/ops/nn1_pallas.py:82",
    "fused_ln": "iggt_official_tpu/ops/fused_ln.py:39",
    "bucket_topk": "iggt_official_tpu/ops/nn1_pallas.py:190",
}
KEY_TILE = 64
MERGE_R = 4096           # the merged 8x518 request's --merge_tokens (4,795 candidates)
# The prep's bf16 outputs are held to 1 ulp at max(|out|, |ref|, 1/64): both
# sides prep in fp32 and round once, but their fp32 sums differ by ~1e-6 of
# the O(1) LayerNorm output (fp32 is held to 1e-5); where RoPE's two terms
# cancel to |x| < 1/64 that difference is many bf16 spacings of the small
# result (40 read on the card without the floor), so there the spacing at
# 1/64 (2^-13) is the unit.
PREP_ULP_FLOOR = 2.0 ** -6
MERGE_GLOBAL = (1, 10992, 16, 64)


def merged_key_sizes(gen, n_keys: int, r: int, n_targets: int):
    """Sizes of merged keys as a plan gives them: r sources spread over the
    first n_targets keys (the unprotected targets), every key at least 1."""
    import torch

    dst = torch.randint(0, n_targets, (r,), generator=gen, device=gen.device)
    sizes = torch.ones(n_keys, device=gen.device)
    sizes.index_add_(0, dst, torch.ones(r, device=gen.device))
    return sizes[None]


def check_kernels():
    """Each case: kernel against plain version (error, limit, max|ref|), then
    planted faults that must each exceed the limit: made by handing the kernel
    altered inputs, the softmax scale off by sqrt(2) (q, or the q-norm affine,
    times sqrt(2)), the last key tile dropped, and (fused) the RoPE sine's
    sign flipped on a quarter of the head dims; with a key bias, the bias
    dropped; and in fp32 two faults of the kernel itself
    (`flash_attention.FP32_FAULTS`): one TF32 pass instead of three, V^T
    without the key permutation."""
    import torch
    import torch.nn.functional as F

    from iggt_official_tpu_torch.layers.rope import (
        compute_rope_2d, make_patch_positions, pack_rope_tables,
    )
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.ops.token_merge import protected_tokens

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = []
    for label, kernel, (B, N, H, D), dtype_name, bias_kind in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        if bias_kind == "merged":
            nk = N - MERGE_R
            q = torch.randn((B, N, H, D), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, nk, H, D), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            h, w, views = PATCH_GRID[N]
            specials = N // views - h * w
            targets = int((~protected_tokens(views, N // views, specials))[0::2].sum())
            bias = torch.log(merged_key_sizes(gen, nk, MERGE_R, targets))
        else:
            nk = N
            # q/k/v as the main path hands them over: strided views of one qkv
            q, k, v = torch.randn((B, N, 3, H, D), generator=gen, device=dev).to(dtype).unbind(2)
            bias = (torch.randn((B, N), generator=gen, device=dev) if bias_kind else None)
        extra = 0 if bias is None else bias.numel() * 4
        kept = nk - (nk % KEY_TILE or KEY_TILE)

        def cut(t, kept=kept):
            return None if t is None else t[:, :kept]

        if kernel == "flash_attention_fused":
            h, w, views = PATCH_GRID[N]
            pos = make_patch_positions(h, w, B * views, N // views - h * w,
                                       device=dev).reshape(B, N, 2)
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
        if bias is not None:
            faults["key bias dropped"] = (
                (lambda: fa.flash_attention_fused(q, k, v, cos, sin, norm))
                if kernel == "flash_attention_fused" else (lambda: fa.flash_attention(q, k, v)))
        if dtype_name == "float32":
            prep_args = (cos, sin, norm) if kernel == "flash_attention_fused" else ()
            for fault in fa.FP32_FAULTS:
                faults[fault] = (lambda fault=fault, prep_args=prep_args:
                                 fa._launch(q, k, v, bias, *prep_args, fault=fault))
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
        bound_ms, bound_by, fma_ms = attention_bound_ms(B, N, nk, H, D, dtype_name, extra)
        ok = finite and err <= limit and caught
        fp32_note = (f"; three TF32 passes, fp32 FMA figure {fma_ms:.4f}"
                     if dtype_name == "float32" else "")
        bias_note = ("" if bias is None else
                     f"; the same call without the bias {time_ms(faults['key bias dropped']):.4f}")
        shape = (B, N, H, D) if nk == N else f"q {(B, N, H, D)} k/v {(B, nk, H, D)}"
        log(f"[kernels] {kernel:22s} {label:38s} {shape} {dtype_name:8s} "
            f"max_abs_err={err:.3e} (limit {limit:.3e}, max|ref| {ref_max:.3e}) "
            f"{'ok' if ok else 'FAIL'} | "
            f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}{fp32_note}; "
            f"{100 * bound_ms / ms:.1f}% of the bound) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f}{bias_note}")
        log(f"[kernels]   planted faults: "
            + ", ".join(f"{name} err {e:.3e} ({e / limit:.1f}x limit)"
                        for name, e in fault_errs.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel=kernel, label=label, shape=[B, N, H, D] if nk == N else [B, N, nk, H, D],
            dtype=dtype_name, key_bias=bias is not None, max_abs_err=err, limit=limit, max_abs_ref=ref_max,
            fault_errs=fault_errs, ok=ok, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / ms,
        ))
        del q, k, v, out, ref, faults
    torch.cuda.empty_cache()
    return results

def qk_prep_bound_ms(B, N, H, D, dtype_name):
    """q and k read once and written once, plus the fp32 rope tables (B, N,
    D) and the four norm vectors, over the HBM rate (the prep's ~20 fp32
    operations per element take 0.05 of that at the fp32 peak)."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * N * H * D * itemsize + 2 * B * N * D * 4 + 4 * D * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def merge_costs(gen) -> None:
    """Log the torch-op costs around the two launches at the 8x518 merged
    global block (CUDA events): the plan (once per forward) on seeded tokens
    and `merge_kv` of one block's K and V (each global block)."""
    import torch

    from iggt_official_tpu_torch.ops import token_merge as tm

    B, N, H, D = MERGE_GLOBAL
    views = PATCH_GRID[N][2]
    x = torch.randn((B, N, H * D), generator=gen, device="cuda")
    protect = torch.from_numpy(tm.protected_tokens(views, N // views, 5)).cuda().expand(B, N)
    plan = tm.compute_merge_plan(x, MERGE_R, protect)
    segments = tm._segments(plan, N)
    k, v = (torch.randn((B, N, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    plan_ms = time_ms(lambda: tm.compute_merge_plan(x, MERGE_R, protect), iters=5, warmup=1)
    merge_ms = time_ms(lambda: tm.merge_kv(k, v, plan, segments))
    log(f"[kernels] token merge torch ops, 8 views 518px, r = {MERGE_R}: plan {plan_ms:.4f} ms "
        f"per forward, merge_kv (K and V of one global block) {merge_ms:.4f} ms")


def prep_f64_witness(q, k, cos, sin, norm, out, ref) -> dict:
    """A third reading of the bf16 prep at the elements where kernel and plain
    version differ by more than 1 bf16 ulp without PREP_ULP_FLOOR: the fp32
    prep kernel on the same (bf16-valued) inputs gives the value the bf16
    kernel rounds, `qk_prep_plain` in fp32 the value the plain version
    rounds, and `qk_prep_plain` in float64 the exact prep of those inputs."""
    import torch

    from iggt_official_tpu_torch.ops import flash_attention as fa

    k32 = fa.qk_prep(q.float(), k.float(), cos, sin, norm)
    p32 = (fa.qk_prep_plain(q.float(), norm[0], norm[1], cos, sin),
           fa.qk_prep_plain(k.float(), norm[2], norm[3], cos, sin))
    r64 = (fa.qk_prep_plain(q.double(), norm[0], norm[1], cos.double(), sin.double()),
           fa.qk_prep_plain(k.double(), norm[2], norm[3], cos.double(), sin.double()))
    over = [bf16_ulps(o, r) > 1 for o, r in zip(out, ref)]
    n_over = sum(int(m.sum().item()) for m in over)

    def at_over(parts):
        return max([(a.double() - b).abs()[m].max().item()
                    for a, b, m in zip(parts, r64, over) if m.any()] or [0.0])

    return dict(
        over_1ulp=n_over,
        over_1ulp_max_abs=max([torch.maximum(o.float().abs(), r.float().abs())[m].max().item()
                               for o, r, m in zip(out, ref, over) if m.any()] or [0.0]),
        kernel32_vs_f64_at_over=at_over(k32), plain32_vs_f64_at_over=at_over(p32),
        kernel32_vs_f64=max((a.double() - b).abs().max().item() for a, b in zip(k32, r64)),
        plain32_vs_f64=max((a.double() - b).abs().max().item() for a, b in zip(p32, r64)),
        bf16_is_kernel32_rounded=all(torch.equal(a.to(torch.bfloat16), o)
                                     for a, o in zip(k32, out)))


def check_qk_prep():
    """Token merging's q/k prep kernel launched alone at the merged 8x518
    global block: bf16 within 1 ulp of `qk_prep_plain`, counted at
    PREP_ULP_FLOOR or above (with `prep_f64_witness`: every element over 1
    ulp below the floor must lie below 1/64, where both fp32 sides hold 1e-5
    of the float64 prep), fp32 within 1e-5; faults: the RoPE sine's sign
    flipped on D/4 dims, gamma x sqrt2.  No library call computes it.  Then
    the costs of the torch ops around it (`merge_costs`); the key-biased
    flash kernel at the merged shape is a row of KERNEL_CASES."""
    import torch

    from iggt_official_tpu_torch.layers.rope import (
        compute_rope_2d, make_patch_positions, pack_rope_tables,
    )
    from iggt_official_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    B, N, H, D = MERGE_GLOBAL
    h, w, views = PATCH_GRID[N]
    pos = make_patch_positions(h, w, B * views, N // views - h * w, device=dev).reshape(B, N, 2)
    cos, sin = pack_rope_tables(compute_rope_2d(pos, D))
    flipped = sin.clone(memory_format=torch.contiguous_format)
    flipped[..., :D // 4] *= -1
    results = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        q, k, _ = torch.randn((B, N, 3, H, D), generator=gen, device=dev).to(dtype).unbind(2)
        norm = tuple(torch.randn((D,), generator=gen, device=dev) * 0.5 + c
                     for c in (1.0, 0.0, 1.0, 0.0))

        def run_kernel():
            return fa.qk_prep(q, k, cos, sin, norm)

        def run_plain():
            return (fa.qk_prep_plain(q, norm[0], norm[1], cos, sin),
                    fa.qk_prep_plain(k, norm[2], norm[3], cos, sin))

        def error(out, ref):
            if dtype_name == "bfloat16":
                return max(bf16_ulps(o, r, PREP_ULP_FLOOR).max().item()
                           for o, r in zip(out, ref))
            return max((o - r).abs().max().item() for o, r in zip(out, ref))

        faults = {"rope sign on D/4": lambda: fa.qk_prep(q, k, cos.contiguous(), flipped, norm),
                  "gamma x sqrt2": lambda: fa.qk_prep(
                      q, k, cos, sin, (norm[0] * 2 ** 0.5, norm[1], norm[2], norm[3]))}
        out = run_kernel()
        torch.cuda.synchronize()
        ref = run_plain()
        err = error(out, ref)
        limit = 1.0 if dtype_name == "bfloat16" else FP32_ABS
        finite = all(bool(torch.isfinite(o).all().item()) for o in out)
        fault_errs = {name: error(fn(), ref) for name, fn in faults.items()}
        caught = all(e > limit for e in fault_errs.values())
        ms = time_ms(run_kernel)
        plain_ms = time_ms(run_plain, iters=3, warmup=1)
        bound_ms, bound_by = qk_prep_bound_ms(B, N, H, D, dtype_name)
        ok = finite and err <= limit and caught
        witness = {}
        if dtype_name == "bfloat16":
            witness = prep_f64_witness(q, k, cos, sin, norm, out, ref)
            ok &= (witness["over_1ulp_max_abs"] < PREP_ULP_FLOOR
                   and witness["kernel32_vs_f64_at_over"] <= FP32_ABS
                   and witness["plain32_vs_f64_at_over"] <= FP32_ABS)
        unit = "bf16 ulps" if dtype_name == "bfloat16" else "abs"
        log(f"[kernels] qk_prep (alone)          merged global block, 8 views 518px "
            f"{(B, N, H, D)} {dtype_name:8s} max_err={err:.3e} {unit} (limit {limit:.0e}) "
            f"{'ok' if ok else 'FAIL'} | ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
            f"{100 * bound_ms / ms:.1f}% of the bound) plain_ms={plain_ms:.4f} "
            f"library_ms=none")
        log(f"[kernels]   planted faults: "
            + ", ".join(f"{name} err {e:.3e}" for name, e in fault_errs.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        if witness:
            log(f"[kernels]   float64 witness: {witness['over_1ulp']} elements over 1 ulp "
                f"without the floor, all at |x| <= {witness['over_1ulp_max_abs']:.3e} (must be "
                f"< 1/64); there the fp32 kernel errs {witness['kernel32_vs_f64_at_over']:.3e} "
                f"and fp32 plain {witness['plain32_vs_f64_at_over']:.3e} abs against float64 "
                f"(limit {FP32_ABS:.0e}; everywhere {witness['kernel32_vs_f64']:.3e} / "
                f"{witness['plain32_vs_f64']:.3e}); bf16 kernel output = its fp32 value rounded: "
                f"{witness['bf16_is_kernel32_rounded']}")
        results.append(dict(
            kernel="qk_prep", label=f"merged global block q/k prep, {dtype_name}, 8 views 518px",
            shape=[B, N, H, D], dtype=dtype_name, key_bias=False,
            max_abs_err=max((o.float() - r.float()).abs().max().item()
                            for o, r in zip(out, ref)),
            err=err, err_unit=unit, limit=limit, fault_errs=fault_errs, ok=ok, ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
        del q, k, out, ref

    merge_costs(gen)
    torch.cuda.empty_cache()
    return results


NN1_REF = 150_000        # the clustering subsample (`ClusteringConfig` budget)
NN1_COMPARE = 65_536     # queries compared with the plain version per case
NN1_LIBRARY_Q = 16_384   # queries of the cdist yardstick (full Q needs ~1 TB)
NN1_TILE = 256           # references per ring stage in csrc/nn1.cu (R is padded to it)
NN1_BLOCK_Q = 256        # query rows per block of the filter kernel
NN1_SPLIT_BYTES = 68     # split reference row: hi and lo (32 bytes each) and |r|^2
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
NN1_NEAR_Q = 4_096       # near-tie case: unit queries, each with
NN1_NEAR_K = 16          # 16 planted references at q + eps v
NN1_NEAR_EPS = (1e-4, 1e-3)
SOURCE = {"flash_attention": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "flash_attention_fused": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "qk_prep": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "nn1": "iggt_official_tpu_torch/csrc/nn1.cu",
          "fused_ln": "iggt_official_tpu_torch/csrc/fused_ln.cu",
          "bucket_topk": "iggt_official_tpu_torch/csrc/nn1.cu"}


def nn1_bound_ms(Q: int, R: int, D: int = 8):
    """The least time for the work the filter design must do: one TF32 pass
    over every pair's dot product, 2 Q R D operations at the TF32 peak,
    against each input read once and the int64 output written once.  Beside
    it, named as such: the three passes' tensor-core floor, and the exact
    chain's figures (3 Q R D fp32 operations over the fp32 FMA peak, the
    Pallas CostEstimate, and twice that, the floor without FMA) that bound a
    design running the chain on every pair."""
    t_ops = 2 * Q * R * D / PEAK_OPS_PER_S["tf32"]
    t_bytes = ((Q + R) * D * 4 + Q * 8) / PEAK_BYTES_PER_S
    chain_ms = 3 * Q * R * D / PEAK_OPS_PER_S["float32"] * 1e3
    return (max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            {"tensor_floor_3_passes_ms": 3 * t_ops * 1e3, "exact_chain_flop_bound_ms": chain_ms,
             "exact_chain_no_fma_floor_ms": 2 * chain_ms})


def nn1_l2_bytes_model(Q: int, R: int) -> int:
    """Bytes the filter kernel reads from L2 per call, computed from the
    shapes (the card's traffic counters cannot be read here): every block
    streams the split references (R padded to NN1_TILE); the queries once."""
    r_pad = -(-R // NN1_TILE) * NN1_TILE
    return -(-Q // NN1_BLOCK_Q) * r_pad * NN1_SPLIT_BYTES + Q * 32


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


def nn1_near_tie_inputs(gen, R: int = NN1_REF):
    """NN1_NEAR_Q unit-norm queries (the clustered features, normalized), each
    with NN1_NEAR_K planted references q + eps v (eps spread over
    NN1_NEAR_EPS, v random unit directions) at random places among the R
    backfill references, so that the expansion's rounding reorders the
    nearest ones."""
    import torch

    dev = gen.device
    base, ref = nn1_inputs(8 * NN1_NEAR_Q, R, gen)
    qry = base[:NN1_NEAR_Q] / base[:NN1_NEAR_Q].norm(dim=1, keepdim=True)
    v = torch.randn((NN1_NEAR_Q, NN1_NEAR_K, 8), generator=gen, device=dev)
    v /= v.norm(dim=2, keepdim=True)
    lo, hi = NN1_NEAR_EPS
    eps = lo + (hi - lo) * torch.rand((NN1_NEAR_Q, NN1_NEAR_K, 1), generator=gen, device=dev)
    planted = (qry[:, None, :] + eps * v).reshape(-1, 8)
    where = torch.randperm(R, generator=gen, device=dev)[:planted.shape[0]]
    ref[where] = planted
    return qry.contiguous(), ref


def nn1_rechecks(qry, ref, fault=None) -> float:
    """Exact chains the kernel computed per query (a launch of `_launch`
    outside the wrapper, so it does not count as a launch of the path)."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    counter = torch.zeros(1, dtype=torch.int64, device=qry.device)
    nn1_mod._launch(qry, ref, fault=fault, rechecks=counter)
    return counter.item() / qry.shape[0]


def nn1_probe_ratio(qry, ref) -> float:
    """The tensor-core approximation against the exact chain on the first
    256 queries and 64 references: max |(|q|^2 + a~) - d2_chain| in units of
    U (|q|^2 + max |r|^2), |q|^2 exact.  The derivation in csrc/nn1.cu bounds
    it by 102.5 + 10.02 d2 / (|q|^2 + max |r|^2); the window allows KAPPA."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    probe = torch.zeros((NN1_BLOCK_Q, 64), dtype=torch.float32, device=qry.device)
    q, r = qry[:NN1_BLOCK_Q], ref[:64]
    nn1_mod._launch(q, ref, probe=probe)
    q2 = q.double().pow(2).sum(1, keepdim=True)
    max_r2 = ref.double().pow(2).sum(1).max()
    chain = nn1_mod._sq_dist_block(q, r).double()
    err = (q2 + probe[:q.shape[0]].double() - chain).abs()
    return (err / (nn1_mod.U * (q2 + max_r2))).max().item()


def check_nn1():
    """Each case: the kernel at full Q against the plain version on the first
    NN1_COMPARE queries (mismatches must be 0), three planted faults on the
    same queries (each must mismatch), then times: kernel and plain at full
    Q, `torch.cdist(q, r).argmin(1)` and the kernel on NN1_LIBRARY_Q
    queries; rechecks per query and L2 bytes per call.  Then the near-tie
    case, compared in full, with the two filter faults; and the probe."""
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
        rechecks = nn1_rechecks(qry, ref)
        ms = time_ms(lambda: nn1(qry, ref), iters=3, warmup=1)
        plain_ms = time_ms(lambda: nn1_plain(qry, ref), iters=1, warmup=0)
        L = min(Q, NN1_LIBRARY_Q)
        library_ms = time_ms(lambda: torch.cdist(qry[:L], ref).argmin(1), iters=3, warmup=1)
        library_kernel_ms = time_ms(lambda: nn1(qry[:L], ref), iters=3, warmup=1)
        bound_ms, bound_by, floors = nn1_bound_ms(Q, R)
        l2 = nn1_l2_bytes_model(Q, R)
        ok = mismatches == 0 and in_range and caught
        log(f"[kernels] nn1 {label:28s} Q={Q} R={R}: mismatches {mismatches} of {C} "
            f"(limit 0) {'ok' if ok else 'FAIL'} | ms={ms:.3f} bound_ms={bound_ms:.3f} "
            f"({bound_by}, one TF32 pass; {100 * bound_ms / ms:.1f}% of it; three-pass tensor "
            f"floor {floors['tensor_floor_3_passes_ms']:.3f}; exact chain: flop bound "
            f"{floors['exact_chain_flop_bound_ms']:.3f}, no-FMA floor "
            f"{floors['exact_chain_no_fma_floor_ms']:.3f}) plain_ms={plain_ms:.3f} | rechecks "
            f"{rechecks:.2f} per query | L2 read (model, from the shapes) {l2 / 1e9:.2f} GB "
            f"per call ({l2 / ms / 1e9:.1f} TB/s at the measured time) | on {L} queries: "
            f"library_ms={library_ms:.3f} (cdist+argmin) kernel {library_kernel_ms:.3f}")
        log("[kernels]   planted faults: "
            + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel="nn1", label=label, shape=[Q, R, 8], dtype="float32",
            max_abs_err=float(mismatches), mismatches=mismatches, compared=C,
            fault_mismatches=fault_mm, ok=ok, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_queries=L, library_kernel_ms=library_kernel_ms,
            bound_ms=bound_ms, bound_by=bound_by, **floors, rechecks_per_query=rechecks,
            l2_bytes_model=l2,
        ))
        if label == MAIN_CASE["nn1"]:
            ratio = nn1_probe_ratio(qry, ref)
            results[-1]["probe_error_units"] = ratio
            log(f"[kernels]   probe (256 x 64 pairs): max |(|q|^2 + a~) - d2_chain| = "
                f"{ratio:.2f} U (|q|^2 + max|r|^2); derived bound ~102.5-123, window "
                f"kappa/2 = 128")
        del qry, ref, out, want, faults, q_nolast, r_nolast
    results.append(check_nn1_near_ties(gen))
    torch.cuda.empty_cache()
    return results


def check_nn1_near_ties(gen):
    """The near-tie case against the plain version on every query, and the
    two faults of the filter, which must mismatch there."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    qry, ref = nn1_near_tie_inputs(gen)
    Q, R = qry.shape[0], ref.shape[0]
    out = nn1_mod.nn1(qry, ref)
    want = nn1_mod.nn1_plain(qry, ref)
    mismatches = int((out != want).sum())
    fault_mm = {name: int((nn1_mod._launch(qry, ref, fault=name) != want).sum())
                for name in nn1_mod.FAULTS}
    caught = all(m > 0 for m in fault_mm.values())
    rechecks = nn1_rechecks(qry, ref)
    ratio = nn1_probe_ratio(qry, ref)
    ms = time_ms(lambda: nn1_mod.nn1(qry, ref), iters=3, warmup=1)
    plain_ms = time_ms(lambda: nn1_mod.nn1_plain(qry, ref), iters=1, warmup=0)
    library_ms = time_ms(lambda: torch.cdist(qry, ref).argmin(1), iters=3, warmup=1)
    bound_ms, bound_by, floors = nn1_bound_ms(Q, R)
    ok = mismatches == 0 and caught
    log(f"[kernels] nn1 near ties ({NN1_NEAR_K} planted per query at eps "
        f"{NN1_NEAR_EPS[0]:g}-{NN1_NEAR_EPS[1]:g}) Q={Q} R={R}: mismatches {mismatches} of {Q} "
        f"(limit 0) {'ok' if ok else 'FAIL'} | ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.3f} | rechecks {rechecks:.2f} per query | probe "
        f"{ratio:.2f} U (|q|^2 + max|r|^2)")
    log("[kernels]   planted faults of the filter: "
        + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
        + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
    return dict(
        kernel="nn1", label="near ties", shape=[Q, R, 8], dtype="float32",
        max_abs_err=float(mismatches), mismatches=mismatches, compared=Q,
        fault_mismatches=fault_mm, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library_queries=Q, library_kernel_ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        **floors, rechecks_per_query=rechecks, l2_bytes_model=nn1_l2_bytes_model(Q, R),
        probe_error_units=ratio,
    )


def nn1_request_backfill(proc, scene) -> dict:
    """The backfill's own inputs from one post-processing of ``scene`` (the
    largest-Q kernel launch of `nn1`, captured on its way in): rechecks per query,
    mismatches against the plain version on the first NN1_COMPARE queries and
    on NN1_COMPARE more drawn from the seed over the whole query range (every
    view), and the kernel's time on all of them."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    calls = []
    launch = nn1_mod._launch

    def capture(query, ref, **kwargs):
        calls.append((query, ref))
        return launch(query, ref, **kwargs)

    raw = proc._run_inference(scene)
    nn1_mod._launch = capture
    try:
        proc._post_process(raw)
    finally:
        nn1_mod._launch = launch
    qry, ref = max(calls, key=lambda c: c[0].shape[0])
    C = min(qry.shape[0], NN1_COMPARE)
    gen = torch.Generator(device=qry.device).manual_seed(SEED)
    spread = torch.randperm(qry.shape[0], generator=gen, device=qry.device)[:C]
    mismatches = {}
    for name, rows in (("first", slice(0, C)), ("spread", spread)):
        q = qry[rows].contiguous()
        mismatches[name] = int((nn1_mod._launch(q, ref) != nn1_mod.nn1_plain(q, ref)).sum())
    return {"shape": [qry.shape[0], ref.shape[0], qry.shape[1]],
            "rechecks_per_query": nn1_rechecks(qry, ref),
            "mismatches": sum(mismatches.values()), "mismatches_first": mismatches["first"],
            "mismatches_spread": mismatches["spread"], "compared": 2 * C, "ms": time_ms(lambda: nn1_mod._launch(qry, ref), iters=3, warmup=1),
            "norm2_max": qry.pow(2).sum(1).max().item()}


LN_ROWS = {"8 views 518px": 8 * 1374, "8 views 504x336": 8 * 869, "3 views 504x336": 3 * 869}
LN_CASES = tuple(
    (f"{where} pre-norm, {req}", rows, 1024, "bfloat16", "bfloat16", eps)
    for req, rows in LN_ROWS.items()
    for where, eps in (("frame/global", 1e-5), ("DINOv2", 1e-6))
) + (
    ("fp32 trunk pre-norm, 8 views 518px", 8 * 1374, 1024, "float32", "float32", 1e-5),
    ("scaled model width, ragged rows", 1001, 64, "bfloat16", "bfloat16", 1e-5),
)
FP32_LN_REL = 1e-6


def bf16_ulps(out, ref, floor: float = 0.0):
    """|out - ref| in units of the bf16 spacing at max(|out|, |ref|, floor)."""
    import torch

    a, b = out.float(), ref.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(max(floor, torch.finfo(torch.bfloat16).tiny))
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def ln_error(out, ref, dtype_name):
    """(error, limit): bf16 output in ulps against 1; fp32 as max|out - ref|
    over max|ref| against 1e-6."""
    if dtype_name == "bfloat16":
        return bf16_ulps(out, ref).max().item(), 1.0
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item(), FP32_LN_REL


def ln_bound_ms(rows, D, in_name, out_name):
    """Each row read once and written once over the HBM rate (gamma and beta
    too), against 7 fp32 operations per element over the fp32 peak."""
    size = {"bfloat16": 2, "float32": 4}
    t_bytes = (rows * D * (size[in_name] + size[out_name]) + 2 * D * 4) / PEAK_BYTES_PER_S
    t_ops = 7 * rows * D / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def check_fused_ln():
    """Each case: the kernel against `fused_layernorm_plain` on rows with a
    per-row offset and three outlier channels, the share of elements that
    differ, three planted faults that must exceed the limit (the last 8-element
    chunk of each row left out of the reductions, the bias not added, the
    weight not applied), and times: kernel, plain, `F.layer_norm`."""
    import torch
    import torch.nn.functional as F

    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm, fused_layernorm_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for label, rows, D, in_name, out_name, eps in LN_CASES:
        in_dt, out_dt = getattr(torch, in_name), getattr(torch, out_name)
        x = (2 * torch.randn((rows, D), generator=gen, device="cuda")
             + torch.randn((rows, 1), generator=gen, device="cuda"))
        x[:, [3, D // 2 + 5, D - 4]] *= 25   # "massive activation" channels, one in the last chunk
        x = x.to(in_dt)
        w = 1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
        b = 0.1 * torch.randn((D,), generator=gen, device="cuda")

        def run_kernel(x=x, w=w, b=b, eps=eps, out_dt=out_dt):
            return fused_layernorm(x, w, b, eps, out_dt)

        def run_plain():
            return fused_layernorm_plain(x, w, b, eps, out_dt)

        out = run_kernel()
        torch.cuda.synchronize()
        ref = run_plain()
        err, limit = ln_error(out, ref, out_name)
        differ = (out != ref).float().mean().item()
        faults = {
            "last chunk out of the reductions": ln_error(
                run_kernel(x[:, :D - 8], w[:D - 8], b[:D - 8]), ref[:, :D - 8], out_name)[0],
            "bias not added": ln_error(run_kernel(b=torch.zeros_like(b)), ref, out_name)[0],
            "weight not applied": ln_error(run_kernel(w=torch.ones_like(w)), ref, out_name)[0],
        }
        caught = all(e > limit for e in faults.values())
        ms = time_ms(run_kernel, iters=50, warmup=5)
        plain_ms = time_ms(run_plain, iters=10, warmup=2)
        wl, bl = w.to(in_dt), b.to(in_dt)
        library_ms = time_ms(lambda: F.layer_norm(x, (D,), wl, bl, eps), iters=50, warmup=5)
        bound_ms, bound_by = ln_bound_ms(rows, D, in_name, out_name)
        ok = bool(torch.isfinite(out).all()) and err <= limit and caught
        unit = "ulp" if out_name == "bfloat16" else "rel"
        device = {}
        if label == MAIN_CASE["fused_ln"]:
            device = {"device_ms": device_ms(run_kernel),
                      "library_device_ms": device_ms(
                          lambda: F.layer_norm(x, (D,), wl, bl, eps))}
        log(f"[kernels] fused_ln {label:40s} ({rows}, {D}) {in_name}->{out_name} eps {eps:g}: "
            f"max err {err:.3g} {unit} (limit {limit:g}), {100 * differ:.4f}% of elements "
            f"differ {'ok' if ok else 'FAIL'} | ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (F.layer_norm)"
            + (f" | device time per call (profiler): kernel {device['device_ms']:.4f} ms, "
               f"F.layer_norm {device['library_device_ms']:.4f} ms" if device else ""))
        log("[kernels]   planted faults: "
            + ", ".join(f"{name} {e:.3g} {unit}" for name, e in faults.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel="fused_ln", label=label, shape=[rows, D], dtype=f"{in_name}->{out_name}",
            eps=eps, max_abs_err=(out.float() - ref.float()).abs().max().item(),
            err=err, err_unit=unit, limit=limit, differ_share=differ, fault_errs=faults,
            ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, **device,
        ))
        del x, out, ref
    torch.cuda.empty_cache()
    return results


BT_Q = 150_000           # the clustering subsample: Q = R, self-kNN as its core kNN
BT_K = 64
BT_NB = 1024
BT_COMPARE = 16_384      # queries compared with the plain version (and the library slice)
BT_DUP = 64              # planted duplicates: in the same bucket, and across buckets


def bucket_topk_inputs(gen):
    """Clustered 8-D features (6 unit centres plus noise, as `nn1_inputs`),
    query = ref; references 0..63 duplicated at 73 * 1024 + t (same bucket: a
    tie inside the bucket) and at Q / 2 + t (another bucket: a tie between
    buckets)."""
    import torch

    centers = torch.randn((6, 8), generator=gen, device=gen.device)
    centers /= centers.norm(dim=1, keepdim=True)
    lab = torch.randint(0, 6, (BT_Q,), generator=gen, device=gen.device)
    pts = centers[lab] + 0.05 * torch.randn((BT_Q, 8), generator=gen, device=gen.device)
    t = torch.arange(BT_DUP, device=pts.device)
    pts[73 * BT_NB + t] = pts[t]
    pts[BT_Q // 2 + t] = pts[t]
    return pts


def within_bucket_reversal(R: int, nb: int):
    """(perm, inverse): ``ref[perm]`` reverses the order of the references
    inside every bucket (index mod nb) and keeps each bucket's members."""
    import torch

    idx = torch.arange(R)
    j, b = idx // nb, idx % nb
    count = (R - b + nb - 1) // nb
    pos = (count - 1 - j) * nb + b        # where reference idx goes
    perm = torch.empty_like(idx)
    perm[pos] = idx
    return perm, pos


def bucket_topk_bound_ms(Q: int, R: int, nb: int, D: int = 8):
    """The least time for the work the bucket kernel's design must do: one
    TF32 pass over every pair's dot product, 2 Q R D operations at the TF32
    peak, against the inputs read once and the (Q, nb) minima and their int64
    indices written once.  Beside it, named as such: the three passes'
    tensor-core floor, the minima's write time alone, and the fp32 FMA figure
    of the exact chain on every pair (3 Q R D at the fp32 peak), the bound
    of the design before this one."""
    t_ops = 2 * Q * R * D / PEAK_OPS_PER_S["tf32"]
    t_write = Q * nb * 12 / PEAK_BYTES_PER_S
    t_bytes = (Q + R) * D * 4 / PEAK_BYTES_PER_S + t_write
    return (max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            {"tensor_floor_3_passes_ms": 3 * t_ops * 1e3, "minima_write_ms": t_write * 1e3,
             "exact_chain_fma_ms": 3 * Q * R * D / PEAK_OPS_PER_S["float32"] * 1e3})


def bucket_rechecks(qry, ref, nb) -> float:
    """Exact chains the bucket kernel computed per (query, bucket) (a launch
    outside the main path's count)."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    counter = torch.zeros(1, dtype=torch.int64, device=qry.device)
    nn1_mod.bucket_minima_kernel(qry, ref, nb, rechecks=counter)
    return counter.item() / (qry.shape[0] * nb)


def check_bucket_near_ties(gen):
    """The bucket minima on nn1's near-tie case (4,096 unit queries, 16
    references each within 1e-4 to 1e-3 among 150,000), with exact duplicates
    in other chunks of the same buckets (references 3 nb + t copied to
    100 nb + t, and queries 0..63 on them), compared in full; the two filter
    faults (`nn1.FAULTS`) must mismatch there."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    nb = BT_NB
    qry, ref = nn1_near_tie_inputs(gen)
    t = torch.arange(BT_DUP, device=ref.device)
    ref[100 * nb + t] = ref[3 * nb + t]
    qry[:BT_DUP] = ref[3 * nb + t]
    Q, R = qry.shape[0], ref.shape[0]
    bd, bi = nn1_mod.bucket_minima_kernel(qry, ref, nb)
    pd, pi = nn1_mod.bucket_minima_plain(qry, ref, nb)
    mismatches = int((bi != pi).sum())
    d_equal = bool(torch.equal(bd, pd))
    fault_mm = {name: int((nn1_mod.bucket_minima_kernel(qry, ref, nb, fault=name)[1] != pi).sum())
                for name in nn1_mod.FAULTS}
    caught = all(m > 0 for m in fault_mm.values())
    rechecks = bucket_rechecks(qry, ref, nb)
    ms = time_ms(lambda: nn1_mod.bucket_minima_kernel(qry, ref, nb), iters=3, warmup=1)
    plain_ms = time_ms(lambda: nn1_mod.bucket_minima_plain(qry, ref, nb), iters=1, warmup=0)
    bound_ms, bound_by, _ = bucket_topk_bound_ms(Q, R, nb)
    ok = mismatches == 0 and d_equal and caught
    log(f"[kernels] bucket_min near ties ({NN1_NEAR_K} planted per query at eps "
        f"{NN1_NEAR_EPS[0]:g}-{NN1_NEAR_EPS[1]:g}, {BT_DUP} duplicates across chunks) Q={Q} "
        f"R={R} nb={nb}: {mismatches} index mismatches of {Q * nb} (limit 0), distances equal "
        f"{d_equal} {'ok' if ok else 'FAIL'} | rechecks {rechecks:.3f} per (query, bucket) | "
        f"kernel ms={ms:.3f} plain_ms={plain_ms:.3f}")
    log("[kernels]   planted faults of the filter: "
        + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
        + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
    return dict(
        kernel="bucket_topk", label="bucket minima, near ties", shape=[Q, R, 8, 0, nb],
        dtype="float32", max_abs_err=float(mismatches), mismatches=mismatches, compared=Q,
        distances_equal=d_equal, fault_mismatches=fault_mm, ok=ok, ms=ms, kernel_ms=ms,
        plain_ms=plain_ms, library_ms=None, library_queries=0, library_kernel_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, rechecks_per_pair=rechecks,
    )


def check_bucket_topk():
    """The kernel at full Q against the plain version on the first BT_COMPARE
    queries: 0 index mismatches in the (Q, nb) bucket minima and in the top-k,
    equal squared distances and distances; three planted faults that must
    mismatch: bucket = index mod (nb - 1), reversed tie order inside each
    bucket, the last tile of nb references dropped; rechecks per (query,
    bucket), counted on the card; then times: the wrapper (kernel + stable
    sort), the kernel alone, the plain version at full Q, and `torch.cdist` +
    `torch.topk` on BT_COMPARE queries (kernel there too).  Then the near-tie
    case (`check_bucket_near_ties`)."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    pts = bucket_topk_inputs(gen)
    Q, C, k, nb = BT_Q, BT_COMPARE, BT_K, BT_NB
    bd, bi = nn1_mod.bucket_minima_kernel(pts, pts, nb)
    torch.cuda.synchronize()
    pd, pi = nn1_mod.bucket_minima_plain(pts[:C], pts, nb)
    dist, idx = nn1_mod.topk_over_buckets(bd[:C], bi[:C], k)
    want_d, want_i = nn1_mod.bucket_topk_plain(pts[:C], pts, k, nb)
    mm_min = int((bi[:C] != pi).sum())
    mm_topk = int((idx != want_i).sum())
    d_equal = bool(torch.equal(bd[:C], pd)) and bool(torch.equal(dist, want_d))
    self_first = bool((dist[:, 0] == 0).all())

    kept = Q - (Q % nb or nb)
    perm, pos = within_bucket_reversal(Q, nb)
    perm, pos = perm.to(pts.device), pos.to(pts.device)
    _, rev_i = nn1_mod.topk_over_buckets(*nn1_mod.bucket_minima_kernel(pts[:C], pts[perm], nb), k)
    faults = {
        "bucket = index mod (nb - 1)": nn1_mod.topk_over_buckets(
            *nn1_mod.bucket_minima_kernel(pts[:C], pts, nb - 1), k)[1],
        "reversed tie order": perm[rev_i],
        "last reference tile dropped": nn1_mod.topk_over_buckets(
            *nn1_mod.bucket_minima_kernel(pts[:C], pts[:kept], nb), k)[1],
    }
    fault_mm = {name: int((j != want_i).sum()) for name, j in faults.items()}
    caught = all(m > 0 for m in fault_mm.values())
    rechecks = bucket_rechecks(pts, pts, nb)

    ms = time_ms(lambda: nn1_mod.bucket_topk(pts, pts, k, nb), iters=3, warmup=1)
    kernel_ms = time_ms(lambda: nn1_mod.bucket_minima_kernel(pts, pts, nb), iters=3, warmup=1)
    plain_ms = time_ms(lambda: nn1_mod.bucket_topk_plain(pts, pts, k, nb), iters=1, warmup=0)
    library_ms = time_ms(lambda: torch.topk(torch.cdist(pts[:C], pts), k, largest=False),
                         iters=3, warmup=1)
    slice_ms = time_ms(lambda: nn1_mod.bucket_topk(pts[:C], pts, k, nb), iters=3, warmup=1)
    bound_ms, bound_by, floors = bucket_topk_bound_ms(Q, Q, nb)
    ok = mm_min == 0 and mm_topk == 0 and d_equal and self_first and caught
    log(f"[kernels] bucket_topk Q=R={Q} k={k} nb={nb}: on {C} queries {mm_min} bucket-minimum "
        f"and {mm_topk} top-k index mismatches (limit 0), distances equal {d_equal}, self "
        f"at distance 0 {self_first} {'ok' if ok else 'FAIL'} | rechecks {rechecks:.3f} per "
        f"(query, bucket) | ms={ms:.3f} (wrapper) kernel alone {kernel_ms:.3f}, bound_ms="
        f"{bound_ms:.3f} ({bound_by}, one TF32 pass; {100 * bound_ms / kernel_ms:.1f}% of it "
        f"for the kernel; three-pass floor {floors['tensor_floor_3_passes_ms']:.3f}, minima "
        f"write {floors['minima_write_ms']:.3f}, exact-chain fp32 FMA figure "
        f"{floors['exact_chain_fma_ms']:.3f}) plain_ms={plain_ms:.1f} | on {C} queries: "
        f"library_ms={library_ms:.3f} (cdist + topk) bucket_topk {slice_ms:.3f}")
    log("[kernels]   planted faults: "
        + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
        + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
    result = dict(
        kernel="bucket_topk", label=f"core kNN candidate, Q = R = {Q}", shape=[Q, Q, 8, k, nb],
        dtype="float32", max_abs_err=float(mm_min + mm_topk), mismatches=mm_min + mm_topk,
        compared=C, distances_equal=d_equal, fault_mismatches=fault_mm, ok=ok, ms=ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, library_queries=C,
        library_kernel_ms=slice_ms, bound_ms=bound_ms, bound_by=bound_by,
        rechecks_per_pair=rechecks,
    )
    del pts, bd, bi, pd, pi, faults
    near = check_bucket_near_ties(gen)
    torch.cuda.empty_cache()
    return [result, near]


CASE_KEYS = {
    "flash_attention": ("label", "shape", "dtype", "key_bias", "max_abs_err", "limit",
                        "max_abs_ref", "fault_errs", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"),
    "nn1": ("label", "shape", "mismatches", "compared", "fault_mismatches", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_queries",
            "library_kernel_ms", "rechecks_per_query"),
    "fused_ln": ("label", "shape", "dtype", "eps", "max_abs_err", "err", "err_unit", "limit",
                 "differ_share", "fault_errs", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms"),
    "bucket_topk": ("label", "shape", "mismatches", "compared", "distances_equal",
                    "fault_mismatches", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_queries", "library_kernel_ms", "rechecks_per_pair"),
}
CASE_KEYS["flash_attention_fused"] = CASE_KEYS["flash_attention"]
CASE_KEYS["qk_prep"] = ("label", "shape", "dtype", "max_abs_err", "err", "err_unit", "limit",
                        "fault_errs", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
LAUNCHES_FROM = {
    "qk_prep": f"the 8 views 518x518 request with RuntimeConfig(global_merge_r={MERGE_R}): "
               "one launch per merged global block (the q/k prep kernel alone, which "
               "flash_attention_fused also runs before its attention)",
    "nn1": "calls of the nn1 wrapper in the 8 views 518x518 request (noise reassignment "
           "and backfill); each call launches nn1_split_kernel once, then "
           "nn1_filter_kernel once",
    "fused_ln": "the 8 views 518x518 request with RuntimeConfig(fused_ln=True)",
    "bucket_topk": "the bucket top-k path (core-kNN candidate) on the 10-view scene's "
                   "150,000-point subsample; no module calls it, as in the JAX package",
}


def kernels_summary(results, launches, extra):
    out = []
    for kernel in ("flash_attention", "flash_attention_fused", "qk_prep", "nn1", "fused_ln",
                   "bucket_topk"):
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
            **{k: main[k] for k in ("library_queries", "library_kernel_ms", "kernel_ms",
                                    "rechecks_per_query", "rechecks_per_pair",
                                    "probe_error_units",
                                    "device_ms", "library_device_ms")
               if k in main},
            "cases": [{k: r[k] for k in CASE_KEYS[kernel]} for r in cases],
        })
        if kernel in ("nn1", "bucket_topk"):
            out[-1]["max_abs_err_is"] = "index mismatches against the plain version"
        if kernel in LAUNCHES_FROM:
            out[-1]["launches_from"] = LAUNCHES_FROM[kernel]
        if kernel == "nn1" and "nn1_request_backfill" in extra:
            out[-1]["request_backfill"] = extra["nn1_request_backfill"]
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


AGREEMENT_VARIANTS = (
    # (label, trunk dtype, head dtype, fused_ln, global_merge_r, track head)
    ("fp32 trunk", "float32", "float32", False, 0, False),
    ("bf16 trunk", "bfloat16", "float32", False, 0, False),
    ("bf16 trunk, fused_ln", "bfloat16", "float32", True, 0, False),
    ("bf16 trunk, bf16 heads", "bfloat16", "bfloat16", False, 0, False),
    # the merged route (q/k prep kernel alone, merge, key-biased flash
    # kernel) with each trunk; where the two devices' plans differ (the
    # scores that decide them are rounded to the trunk's dtype on each), the
    # card runs again on the CPU's plan, so that only the kernels differ
    ("fp32 trunk, merged r=40", "float32", "float32", False, 40, False),
    ("bf16 trunk, merged r=40", "bfloat16", "float32", False, 40, False),
    # the track head (fp32), two refinement iterations as in
    # tests/test_torch_track.py: with random weights each iteration
    # multiplies a difference in its input by 10 to 50
    ("fp32 trunk, track head", "float32", "float32", False, 0, True),
)
AGREEMENT_QUERIES = 16
AGREEMENT_TRACK_ITERS = 2
BF16_HEADS_MEDIAN, BF16_HEADS_MAX = 8e-3, 4e-2
# bf16 heads: the decode heads' bf16 convolutions and matmuls round in other
# orders on the two devices.  Readings on this model: max 9.6e-3 to 2.6e-2,
# medians 1.4e-3 to 5.2e-3 (|a - b| / max(|a|, 1), the JAX package's measure
# of this mode); the limits give 1.5x room.  The control -- the card's bf16
# heads against the CPU's fp32 heads -- reads max 3.8e-2 to 7.3e-2 and medians
# up to 8.8e-3 on the CPU, and must fail them.


def median_rel(ref, out) -> float:
    ref, out = ref.float().cpu(), out.float().cpu()
    return ((ref - out).abs() / ref.abs().clamp_min(1.0)).median().item()


def bf16_heads_errors(ref, out):
    """(passes the bf16-heads limits, description) of ``out`` against ``ref``."""
    errs = {k: rel_err(ref[k], out[k]) for k in OUTPUTS}
    medians = {k: median_rel(ref[k], out[k]) for k in OUTPUTS}
    good = (all(e < BF16_HEADS_MAX for e in errs.values())
            and all(m < BF16_HEADS_MEDIAN for m in medians.values()))
    text = (f"max {max(errs.values()):.3e} (limit {BF16_HEADS_MAX:.0e}), median "
            f"{max(medians.values()):.3e} (limit {BF16_HEADS_MEDIAN:.0e}); "
            + ", ".join(f"{k}={errs[k]:.2e}/{medians[k]:.2e}" for k in OUTPUTS))
    return good, text


def merge_rank_gap(x, r, protect) -> float:
    """Gap between the r-th and (r+1)-th best candidate scores of the merge
    plan on tokens ``x`` (1, N, C): the margin by which the plan's choice of
    candidates is decided (`ops/token_merge.py::compute_merge_plan`)."""
    import torch

    xn = x.double() * torch.rsqrt((x.double() ** 2).sum(-1, keepdim=True) + 1e-6)
    s = torch.einsum("bac,bkc->bak", xn[:, 1::2], xn[:, 0::2])
    s = s.masked_fill(protect[:, 1::2, None] | protect[:, None, 0::2], -torch.inf)
    best = s.amax(-1).sort(-1, descending=True).values
    return (best[:, r - 1] - best[:, r]).min().item()


def check_agreement() -> bool:
    """The scaled IGGT on the card (kernels) against the CPU (plain versions),
    same weights and images, in each of AGREEMENT_VARIANTS; launch counts of
    the card's forward must be the path's.  The bf16-heads variant is held
    to its own limits, and its control (against the CPU's fp32 heads, the
    "bf16 trunk" variant's output) must fail them.  A merged variant whose
    plans differ between the devices logs the gap at the r-th place and
    runs the card again on the CPU's plan."""
    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.models import aggregator as agg_mod
    from iggt_official_tpu_torch.models.vggt import build_model
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm

    ok = True
    plan_fn = agg_mod.compute_merge_plan
    rng = np.random.default_rng(SEED)
    imgs = rng.uniform(0, 1, (1, 2, 112, 154, 3)).astype(np.float32)
    queries = torch.from_numpy(np.stack(
        [rng.uniform(0, 153, (1, AGREEMENT_QUERIES)), rng.uniform(0, 111, (1, AGREEMENT_QUERIES))],
        -1).astype(np.float32))
    weights = None
    refs = {}
    for label, trunk, head, fused, merge_r, track in AGREEMENT_VARIANTS:
        cfg = dataclasses.replace(
            ModelConfig().scaled(embed_dim=128, depth=2, num_heads=2, vit_depth=2,
                                 img_size=112), trunk_dtype=trunk, head_dtype=head)
        if track:
            cfg = dataclasses.replace(cfg, enable_track=True, track=dataclasses.replace(
                cfg.track, iters=AGREEMENT_TRACK_ITERS))
        cpu = build_model(cfg, "cpu", seed=SEED)
        weights = weights or cpu.state_dict()
        cpu.load_state_dict(weights, strict=not track)
        card = build_model(cfg, "cuda", seed=SEED + 1)
        card.load_state_dict(cpu.state_dict())
        kw = dict(fused_ln=fused, global_merge_r=merge_r)
        plans = []

        def record_plan(x, r, protect):
            plans.append((x.cpu(), r, protect.cpu(), plan_fn(x, r, protect)))
            return plans[-1][3]

        agg_mod.compute_merge_plan = record_plan
        try:
            with torch.inference_mode():
                ref = cpu(torch.from_numpy(imgs), query_points=queries if track else None, **kw)
                zero_counts()
                out = card(torch.from_numpy(imgs).cuda(),
                           query_points=queries.cuda() if track else None, **kw)
                torch.cuda.synchronize()
                if merge_r and not all(torch.equal(a, b.cpu())
                                       for a, b in zip(plans[0][3], plans[1][3])):
                    log(f"[agreement]   {label}: the card's plan differs from the CPU's (gap "
                        f"at the r-th place {merge_rank_gap(*plans[0][:3]):.3e} on the CPU, "
                        f"{merge_rank_gap(*plans[1][:3]):.3e} on the card); the card runs "
                        f"again on the CPU's plan")
                    agg_mod.compute_merge_plan = (
                        lambda x, r, protect: type(plans[0][3])(*(t.to(x.device)
                                                                  for t in plans[0][3])))
                    zero_counts()
                    out = card(torch.from_numpy(imgs).cuda(),
                               query_points=queries.cuda() if track else None, **kw)
                    torch.cuda.synchronize()
                elif merge_r:
                    log(f"[agreement]   {label}: card and CPU plans equal (gap at the r-th "
                        f"place {merge_rank_gap(*plans[0][:3]):.3e})")
        finally:
            agg_mod.compute_merge_plan = plan_fn
        agg = cfg.aggregator
        counts = (fa.flash_attention_fused.launches, fa.qk_prep.launches,
                  fa.flash_attention.launches, fused_layernorm.launches)
        want = (agg.depth if merge_r else 2 * agg.depth, agg.depth if merge_r else 0,
                agg.vit.depth + 1 + (agg.depth if merge_r else 0),
                2 * (agg.vit.depth + 2 * agg.depth) if fused else 0)
        refs[label] = ref
        launch_text = (f"launches fused={counts[0]} qk_prep={counts[1]} flash={counts[2]} "
                       f"fused_ln={counts[3]} (want {', '.join(map(str, want))})")
        if head == "bfloat16":
            good, text = bf16_heads_errors(ref, out)
            control_passes, control = bf16_heads_errors(refs["bf16 trunk"], out)
            good &= counts == want and not control_passes
            log(f"[agreement] scaled IGGT, {label}, 2 views 112x154: card vs CPU rel err "
                f"max / median {text}; {launch_text} " + ("ok" if good else "FAIL"))
            log(f"[agreement]   control, card bf16 heads vs CPU fp32 heads: {control} -- "
                + ("fails the limits, as it must" if not control_passes
                   else "PASSES the limits: they cannot tell bf16 from fp32 heads"))
        else:
            keys = OUTPUTS + (("track", "vis", "conf") if track else ())
            errs = {k: rel_err(ref[k], out[k]) for k in keys}
            good = all(e < AGREEMENT_TOL[trunk] for e in errs.values()) and counts == want
            if track:
                good &= bool(torch.equal(out["track"][:, 0].cpu(), queries))
            log(f"[agreement] scaled IGGT, {label}, 2 views 112x154: card vs CPU max rel err "
                f"{max(errs.values()):.3e} (limit {AGREEMENT_TOL[trunk]:.0e}); "
                + ", ".join(f"{k}={e:.2e}" for k, e in errs.items())
                + f"; {launch_text} " + ("ok" if good else "FAIL"))
        ok &= good
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


def run_postproc(launches_out: dict) -> bool:
    """The 10-view synthetic scene through the port's smoothing and
    clustering on the card, traced stage by stage; nn1 counts set to 0 just
    before and read just after.  Then the bucket top-k path: `bucket_topk` as
    a core-kNN candidate (what the JAX package's `benchmarks/ab_bucket_topk.py`
    measured) on the clustering's own 150,000-point subsample of this scene,
    k = 64, its count set to 0 just before and read just after, its recall
    against the clustering's exact core kNN (`brute_knn`).  On the same
    smoothed features (full of near ties): the bucket minima of the first
    BT_COMPARE queries against the plain version (0 index mismatches), the
    kernel's time alone and its rechecks per (query, bucket)."""
    import torch

    from iggt_official_tpu_torch.ops import nn1 as nn1_mod
    from iggt_official_tpu_torch.ops.cluster import (
        BUDGET, _subsample, cluster_features_to_masks_mv,
    )
    from iggt_official_tpu_torch.ops.knn import brute_knn, knn_smooth_features
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

    flat = smoothed.reshape(-1, smoothed.shape[-1])
    sample_idx, _, _ = _subsample(flat.shape[0], BUDGET, 100, 500)
    sub = flat[torch.as_tensor(sample_idx, device=flat.device)].contiguous()
    torch.cuda.synchronize()
    nn1_mod.bucket_minima_kernel.launches = 0
    t0 = time.perf_counter()
    dist, idx = nn1_mod.bucket_topk(sub, sub, BT_K)
    torch.cuda.synchronize()
    bt_s = time.perf_counter() - t0
    launches_out["bucket_topk"] = nn1_mod.bucket_minima_kernel.launches
    t0 = time.perf_counter()
    ex_d, ex_i = brute_knn(sub, sub, BT_K)
    torch.cuda.synchronize()
    ex_s = time.perf_counter() - t0
    probe = torch.arange(0, sub.shape[0], 97, device=sub.device)
    hits = (idx[probe][:, :, None] == ex_i[probe][:, None, :]).any(-1).float().mean().item()
    bd, bi = nn1_mod.bucket_minima_kernel(sub[:BT_COMPARE], sub, BT_NB)
    pd, pi = nn1_mod.bucket_minima_plain(sub[:BT_COMPARE], sub, BT_NB)
    mismatches = int((bi != pi).sum())
    d_equal = bool(torch.equal(bd, pd))
    kernel_ms = time_ms(lambda: nn1_mod.bucket_minima_kernel(sub, sub, BT_NB), iters=3, warmup=1)
    rechecks = bucket_rechecks(sub, sub, BT_NB)
    good = (launches_out["bucket_topk"] == 1 and bool((dist[:, 0] == 0).all())
            and bool(torch.isfinite(dist).all()) and hits > 0.9 and mismatches == 0 and d_equal)
    log(f"[postproc] bucket top-k path (core-kNN candidate) on the scene's {sub.shape[0]}-point "
        f"subsample, k={BT_K}: {1e3 * bt_s:.2f} ms against the exact core kNN's "
        f"{1e3 * ex_s:.2f} ms; recall@{BT_K} {hits:.4f} on {probe.numel()} probed queries; "
        f"bucket_topk launches {launches_out['bucket_topk']}; bucket minima on the first "
        f"{BT_COMPARE} queries: {mismatches} index mismatches (limit 0), distances equal "
        f"{d_equal}; kernel alone {kernel_ms:.3f} ms, rechecks {rechecks:.3f} per (query, "
        f"bucket) {'ok' if good else 'FAIL'}")
    del pts, fts, smoothed, flat, sub, dist, idx, ex_d, ex_i, bd, bi, pd, pi
    torch.cuda.empty_cache()
    return ok and good


# ---------------------------------------------------------------------------
# phase 6: full-width requests through IGGTProcessor

REQUESTS = (("3 views 504x336", 3, (504, 336)),
            ("8 views 504x336", 8, (504, 336)),
            ("8 views 518x518", 8, (518, 518)))


def write_scene(root: str, n_views: int, seed: int, gt: bool = False,
                size=(640, 480)) -> str:
    """Synthetic seeded views (``size`` = (W, H)): smooth random colour fields
    plus noise; with ``gt`` also ground truth as the demo reads it, per view
    a 16-bit depth PNG in millimetres (a smooth surface at 1-5 m) under
    ``depth/`` and an npz with a camera-to-world ``pose`` (a random rotation
    and translation) and pinhole ``intrinsics`` under ``cam/``."""
    from PIL import Image

    W, H = size
    rng = np.random.default_rng(seed)
    scene = os.path.join(root, f"scene_{n_views}_{seed}")
    os.makedirs(os.path.join(scene, "images"))
    if gt:
        os.makedirs(os.path.join(scene, "depth"))
        os.makedirs(os.path.join(scene, "cam"))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(n_views):
        coarse = rng.uniform(0, 255, (6, 8, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((W, H), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(scene, "images", f"{i:04d}.png"))
        if not gt:
            continue
        a, b = rng.uniform(0, 2 * np.pi, 2)
        depth_m = (3.0 + np.sin(yy / H * 3 + a) + np.cos(xx / W * 4 + b)).astype(np.float32)
        Image.fromarray(np.round(depth_m * 1000).astype(np.uint16)).save(
            os.path.join(scene, "depth", f"{i:04d}.png"))
        q = rng.normal(0, 1, 4)
        w, x, y, z = q / np.linalg.norm(q)
        pose = np.eye(4)
        pose[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        pose[:3, 3] = rng.normal(0, 1, 3)
        focal = 0.8 * W
        K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
        np.savez(os.path.join(scene, "cam", f"{i:04d}.npz"), pose=pose.astype(np.float32),
                 intrinsics=K.astype(np.float32))
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


def export_problems(out_dir: str, S: int, with_gt: bool):
    """The demo's file set (minus sky masking): npz, masks/, pca/, depth_vis/
    (per view 4 maps, plain and scale bar; comparison, GIF, 2 npy), 3 GLBs,
    and the evaluation report exactly when the scene has ground truth."""
    problems = []
    counts = {d: len(os.listdir(os.path.join(out_dir, d))) for d in ("masks", "pca", "depth_vis")}
    want = {"masks": S, "pca": S, "depth_vis": 6 * S + 4}
    if counts != want:
        problems.append(f"files {counts}, want {want}")
    top = set(os.listdir(out_dir))
    need = {"predictions.npz", "scene_rgb.glb", "scene_mask.glb", "scene_pca.glb"}
    if not need <= top:
        problems.append(f"missing {sorted(need - top)}")
    if ("evaluation_report.json" in top) != with_gt:
        problems.append(f"evaluation_report.json {'missing' if with_gt else 'unexpected'}")
    return problems


BUCKETS = (("flash attention (ours)", ("flash_kernel",)),
           ("fused LayerNorm (ours)", ("ln_kernel",)),
           ("token merge (segment sums)", ("segment_reduce",)),
           ("convolution", ("fprop", "dgrad", "conv", "cudnn", "winograd", "fft")),
           ("matmul", ("gemm", "cutlass", "xmma", "matmul")),
           ("LayerNorm / softmax / reductions", ("reduce", "norm", "softmax")))


def profile_forward(label, model, x, fwd_s: float, fused_ln: bool = False,
                    top: int = 10, **kw) -> None:
    """Device time by kernel over one forward (torch.profiler), grouped into
    buckets by kernel name, and the device's busy share of the unprofiled
    forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, fused_ln=fused_ln, **kw)
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
    log(f"[profile] {label} forward: device time {total:.1f} ms over "
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


def zero_counts():
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm
    from iggt_official_tpu_torch.ops.nn1 import nn1

    fa.flash_attention.launches = fa.flash_attention_fused.launches = fa.qk_prep.launches = 0
    nn1.launches = fused_layernorm.launches = 0


def read_counts():
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm
    from iggt_official_tpu_torch.ops.nn1 import nn1

    return {"flash_attention_fused": fa.flash_attention_fused.launches,
            "flash_attention": fa.flash_attention.launches, "qk_prep": fa.qk_prep.launches,
            "nn1": nn1.launches, "fused_ln": fused_layernorm.launches}


def plain_prep_global_attention(q, k, v, key_bias=None, rope_cos=None, rope_sin=None,
                                qk_norm_params=None):
    """The global blocks' route before the q/k prep kernel: the plain torch
    q/k prep (about fifteen fp32 elementwise passes), then the flash kernel.
    Used only as the other arm of the global-route A/B."""
    from iggt_official_tpu_torch.ops import flash_attention as fa

    gq, bq, gk, bk = qk_norm_params if qk_norm_params is not None else (None,) * 4
    if rope_cos is not None or gq is not None:
        q = fa.qk_prep_plain(q, gq, bq, rope_cos, rope_sin)
        k = fa.qk_prep_plain(k, gk, bk, rope_cos, rope_sin)
    return fa.flash_attention(q, k, v, key_bias)


plain_prep_global_attention.supports_fused_qk_prep = True


def global_route_ab(model, x, S: int) -> None:
    """The bare forward with the global blocks on the fused wrapper (the
    prep kernel, then the flash kernel: the route the port takes) and on
    `plain_prep_global_attention`, four of each in turns after a warm-up of
    each, and the largest difference of their outputs."""
    import torch

    from iggt_official_tpu_torch.ops import flash_attention as fa

    blocks = model.aggregator.global_blocks
    routes = (("prep kernel (fused wrapper)", fa.attention),
              ("plain torch prep + flash", plain_prep_global_attention))
    times = {name: [] for name, _ in routes}
    outs = {}

    def use(fn):
        for blk in blocks:
            blk.attn.attn_fn = fn

    with torch.inference_mode():
        for name, fn in routes:
            use(fn)
            outs[name] = model(x)
        for r in range(4):
            for name, fn in (routes if r % 2 == 0 else routes[::-1]):
                use(fn)
                times[name].append(wall_s(lambda: model(x)))
    use(fa.attention)
    a, b = (outs[name] for name, _ in routes)
    diffs = {k: rel_err(a[k], b[k]) for k in ("depth", "world_points", "part_feat")}
    med = {k: float(np.median(v)) for k, v in times.items()}
    base = med[routes[1][0]]
    log(f"[requests] global-route A/B, bare forward (median of 4, in turns): "
        + ", ".join(f"{k} {v:.4f} s ({S / v:.2f} views/s, {100 * (v / base - 1):+.1f}%)"
                    for k, v in med.items())
        + "; max rel difference of the outputs "
        + ", ".join(f"{k} {e:.2e}" for k, e in diffs.items())
        + "; all runs " + json.dumps({k: [round(t, 4) for t in v] for k, v in times.items()}))


def timed_request(proc, scene, out_dir):
    """Warm-up, then three requests: the first with the launch counts set to 0
    just before and read just after, and its peak memory; returns (results
    of the first, counts, peak GiB, median wall s)."""
    import torch

    proc.process_scene(scene, out_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    results = proc.process_scene(scene, out_dir)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    walls += [wall_s(lambda: proc.process_scene(scene, out_dir)) for _ in range(2)]
    return results, counts, peak, float(np.median(walls))


def run_requests(launches_out: dict, extra: dict) -> bool:
    """The three requests through `IGGTProcessor.process_scene` (the 3-view
    scene with seeded ground truth), then the two fast modes at 8 views
    518x518 on the same weights and images: `RuntimeConfig(fused_ln=True)` and
    `head_dtype="bfloat16"`, with the bare forwards of all three timed in
    turns.  The last request's backfill inputs go through the nn1 kernel once
    more for its rechecks per query (``extra["nn1_request_backfill"]``)."""
    import torch

    from iggt_official_tpu_torch.app.demo import IGGTProcessor
    from iggt_official_tpu_torch.config import RuntimeConfig
    from iggt_official_tpu_torch.ops.cluster import BUDGET

    t0 = time.time()
    proc = IGGTProcessor(device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in proc.model.parameters())
    log(f"[requests] full-width ModelConfig(): {n_params / 1e9:.3f} B parameters, "
        f"trunk {proc.cfg.trunk_dtype}, heads {proc.cfg.head_dtype}, built in "
        f"{time.time() - t0:.1f} s; clustering {proc.runtime.clustering}")
    agg = proc.cfg.aggregator
    want = (2 * agg.depth, agg.vit.depth + 1)   # frame + global blocks fused
    want_ln = 2 * (agg.vit.depth + 2 * agg.depth)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, S, (W, H)) in enumerate(REQUESTS):
            with_gt = i == 0
            scene = write_scene(tmp, S, SEED + i, gt=with_gt)
            out_dir = os.path.join(tmp, f"out_{i}")
            proc.runtime = RuntimeConfig(image_size=(W, H))
            results, counts, peak, wall = timed_request(proc, scene, out_dir)
            preds = results["predictions"]
            x = torch.from_numpy(preds["images"][None]).cuda()
            with torch.inference_mode():
                fwd = float(np.median([wall_s(lambda: proc.model(x)) for _ in range(3)]))
            raw = proc._run_inference(scene)
            post = float(np.median([wall_s(lambda: proc._post_process(dict(raw)))
                                    for _ in range(3)]))
            del raw
            stages = {}
            proc.process_scene(scene, out_dir, trace=stages)
            problems, zero_fov = check_outputs(preds, S, H, W)
            if (counts["flash_attention_fused"], counts["flash_attention"]) != want:
                problems.append(f"launches {counts}, want fused {want[0]} and flash {want[1]}")
            if counts["fused_ln"]:
                problems.append("fused_ln launched with RuntimeConfig(fused_ln=False)")
            if counts["qk_prep"]:
                problems.append("the prep kernel launched alone without token merging")
            if S * H * W > BUDGET and counts["nn1"] < 1:
                problems.append("no nn1 launch although M exceeds the subsample budget")
            problems += export_problems(out_dir, S, with_gt)
            if with_gt and "evaluation" not in results:
                problems.append("no evaluation although the scene has ground truth")
            ok &= not problems
            launches_out.update({k: v for k, v in counts.items()
                                 if k not in ("fused_ln", "qk_prep")})
            masks = preds["instance_masks"]
            log(f"[requests] {label}{' (with ground truth)' if with_gt else ''}: request "
                f"{wall:.3f} s ({S / wall:.2f} views/s), forward {fwd:.3f} s "
                f"({S / fwd:.2f} views/s), post-processing {post:.3f} s, peak {peak:.2f} GiB "
                f"allocated; launches fused={counts['flash_attention_fused']} "
                f"flash={counts['flash_attention']} nn1={counts['nn1']}; clusters "
                f"{len(np.unique(masks[masks >= 0]))}, noise pixels {(masks < 0).mean():.4f}; "
                f"outputs and files {'ok' if not problems else problems}"
                f"{f' (views with zero fov: {zero_fov})' if zero_fov else ''}")
            log(f"[requests]   stages (one traced request): "
                + ", ".join(f"{k} {v:.3f}" for k, v in stages.items() if k != "noise share")
                + f"; noise share before reassignment {stages.get('noise share', 0.0):.4f}")
            if with_gt:
                summary = results["evaluation"]["summary"]
                log(f"[requests]   evaluation against the seeded ground truth (random "
                    f"weights): {json.dumps(summary)}")
            if i == len(REQUESTS) - 1:
                rb = extra["nn1_request_backfill"] = nn1_request_backfill(proc, scene)
                ok &= rb["mismatches"] == 0
                log(f"[requests]   nn1 on this request's backfill features {rb['shape']}: "
                    f"rechecks {rb['rechecks_per_query']:.2f} per query, {rb['ms']:.3f} ms, "
                    f"mismatches {rb['mismatches_first']} on the first {rb['compared'] // 2} "
                    f"queries and {rb['mismatches_spread']} on {rb['compared'] // 2} drawn over "
                    f"all of them (limit 0), max |q|^2 "
                    f"{rb['norm2_max']:.4f}")
        # the fast modes on the last request's scene, same weights and images;
        # one model on the card during each request, so peaks compare
        base_preds, base_fwd, main = preds, fwd, label
        bf16 = None
        modes = (("fused_ln=True", RuntimeConfig(image_size=(W, H), fused_ln=True)),
                 ('head_dtype="bfloat16"', RuntimeConfig(image_size=(W, H))))
        fwds = {"baseline": [], "fused_ln=True": [], 'head_dtype="bfloat16"': []}
        for label, runtime in modes:
            p = proc
            if label.startswith("head_dtype"):
                proc.model.to("cpu")
                torch.cuda.empty_cache()
                bf16 = p = IGGTProcessor(
                    model_cfg=dataclasses.replace(proc.cfg, head_dtype="bfloat16"),
                    device="cuda", seed=SEED)
                p.model.load_state_dict(proc.model.state_dict())
            p.runtime = runtime
            out_dir = os.path.join(tmp, f"out_{label}")
            results, counts, peak, wall = timed_request(p, scene, out_dir)
            preds = results["predictions"]
            problems, zero_fov = check_outputs(preds, S, H, W)
            ln_want = want_ln if runtime.fused_ln else 0
            if ((counts["flash_attention_fused"], counts["flash_attention"]) != want
                    or counts["fused_ln"] != ln_want or counts["nn1"] < 1):
                problems.append(f"launches {counts}, want fused {want[0]}, flash {want[1]}, "
                                f"fused_ln {ln_want}, nn1 >= 1")
            problems += export_problems(out_dir, S, False)
            ok &= not problems
            if runtime.fused_ln:
                launches_out["fused_ln"] = counts["fused_ln"]
            diffs = {k: (rel_err(torch.from_numpy(base_preds[k]), torch.from_numpy(preds[k])),
                         median_rel(torch.from_numpy(base_preds[k]), torch.from_numpy(preds[k])))
                     for k in ("depth", "world_points", "part_feat")}
            log(f"[requests] {main}, {label}: request {wall:.3f} s ({S / wall:.2f} "
                f"views/s), peak {peak:.2f} GiB allocated; launches "
                f"fused={counts['flash_attention_fused']} flash={counts['flash_attention']} "
                f"fused_ln={counts['fused_ln']} nn1={counts['nn1']}; against the baseline "
                f"request (max / median rel): "
                + ", ".join(f"{k} {a:.3e} / {m:.3e}" for k, (a, m) in diffs.items())
                + f"; outputs and files {'ok' if not problems else problems}")
        # bare forwards of the three, in turns (baseline, fused, bf16 heads, then reversed)
        proc.model.to("cuda")
        with torch.inference_mode():
            runs = (("baseline", lambda: proc.model(x)),
                    ("fused_ln=True", lambda: proc.model(x, fused_ln=True)),
                    ('head_dtype="bfloat16"', lambda: bf16.model(x)))
            for fn in runs:
                fn[1]()
            for r in range(4):
                for name, fn in (runs if r % 2 == 0 else runs[::-1]):
                    fwds[name].append(wall_s(fn))
        med = {k: float(np.median(v)) for k, v in fwds.items()}
        global_route_ab(proc.model, x, S)
        log(f"[requests] {main} bare forward A/B (median of 4, in turns; the "
            f"baseline request phase read {base_fwd:.3f} s): "
            + ", ".join(f"{k} {v:.4f} s ({S / v:.2f} views/s, "
                        f"{100 * (v / med['baseline'] - 1):+.1f}%)" for k, v in med.items())
            + "; all runs " + json.dumps({k: [round(t, 4) for t in v] for k, v in fwds.items()}))
        profile_forward(f"{main} baseline", proc.model, x, med["baseline"])
        profile_forward(f"{main} fused_ln=True", proc.model, x, med["fused_ln=True"],
                        fused_ln=True)
        profile_forward(f'{main} head_dtype="bfloat16"', bf16.model, x,
                        med['head_dtype="bfloat16"'])
        del bf16, p
        torch.cuda.empty_cache()
        ok &= run_merged_request(proc, scene, x, tmp, base_preds, launches_out)
        ok &= run_long_sequence(proc.model)
        ok &= run_track_forward(proc, x)
    return ok


def merged_forward_want(cfg, S: int):
    """(fused, qk_prep, flash) launches of one merged forward of S views: the
    frame blocks fused, the global blocks' prep alone and key-biased flash,
    the DINOv2 blocks and the part head's flash (once per view chunk)."""
    from iggt_official_tpu_torch.models.vggt import _view_chunks

    agg = cfg.aggregator
    parts = len(_view_chunks(S, cfg.part.frames_chunk_size))
    return agg.depth, agg.depth, agg.depth + agg.vit.depth + parts


def run_merged_request(proc, scene, x, tmp, base_preds, launches_out) -> bool:
    """The 8x518 scene through `process_scene` with
    RuntimeConfig(global_merge_r=MERGE_R): its file set, launch counts (set
    to 0 just before, read just after), the difference of depth and world
    points from the exact request (log only: the weights are random); then
    the bare merged and exact forwards timed in turns (4 each after a
    warm-up), of which two merged forwards must give equal bytes."""
    import torch

    from iggt_official_tpu_torch.config import RuntimeConfig
    from iggt_official_tpu_torch.ops.token_merge import merge_count, protected_tokens

    S, H, W = x.shape[1:4]
    proc.runtime = RuntimeConfig(image_size=(W, H), global_merge_r=MERGE_R)
    out_dir = os.path.join(tmp, "out_merged")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    results = proc.process_scene(scene, out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    preds = results["predictions"]
    problems, zero_fov = check_outputs(preds, S, H, W)
    want = merged_forward_want(proc.cfg, S)
    got = (counts["flash_attention_fused"], counts["qk_prep"], counts["flash_attention"])
    if got != want or counts["nn1"] < 1 or counts["fused_ln"]:
        problems.append(f"launches {counts}, want fused/qk_prep/flash {want}, nn1 >= 1")
    problems += export_problems(out_dir, S, False)
    launches_out["qk_prep"] = counts["qk_prep"]
    diffs = {k: (rel_err(torch.from_numpy(base_preds[k]), torch.from_numpy(preds[k])),
                 median_rel(torch.from_numpy(base_preds[k]), torch.from_numpy(preds[k])))
             for k in ("depth", "world_points")}
    agg = proc.cfg.aggregator
    P = agg.patch_start_idx + (H // agg.patch_size) * (W // agg.patch_size)
    r = merge_count(MERGE_R, protected_tokens(S, P, agg.patch_start_idx))
    log(f"[requests] {S} views {W}x{H}, global_merge_r={MERGE_R} (r = {r} of "
        f"{merge_count(S * P, protected_tokens(S, P, agg.patch_start_idx))} candidates, "
        f"Nk = {S * P - r} keys): request {wall:.3f} s, peak {peak:.2f} GiB allocated; launches "
        f"fused={got[0]} qk_prep={got[1]} flash={got[2]} nn1={counts['nn1']} (want "
        f"{want[0]}, {want[1]}, {want[2]}, >= 1); merged vs exact request (max / median "
        f"rel, random weights, no limit): "
        + ", ".join(f"{k} {a:.3e} / {m:.3e}" for k, (a, m) in diffs.items())
        + f"; outputs and files {'ok' if not problems else problems}"
        + (f" (views with zero fov: {zero_fov})" if zero_fov else ""))

    times = {"exact": [], f"merged r={MERGE_R}": []}
    runs = (("exact", lambda: proc.model(x)),
            (f"merged r={MERGE_R}", lambda: proc.model(x, global_merge_r=MERGE_R)))
    with torch.inference_mode():
        first, second = runs[1][1](), runs[1][1]()
        torch.cuda.synchronize()
        same = all(torch.equal(first[k], second[k]) for k in first
                   if isinstance(first[k], torch.Tensor))
        del first, second
        runs[0][1]()
        for r in range(4):
            for name, fn in (runs if r % 2 == 0 else runs[::-1]):
                times[name].append(wall_s(fn))
    med = {k: float(np.median(v)) for k, v in times.items()}
    if not same:
        problems.append("two merged forwards differ")
    log(f"[requests] {S} views {W}x{H} bare forward, exact vs merged (median of 4, in turns): "
        + ", ".join(f"{k} {v:.4f} s ({S / v:.2f} views/s, {100 * (v / med['exact'] - 1):+.1f}%)"
                    for k, v in med.items())
        + f"; two merged forwards {'equal bytes' if same else 'DIFFER'}; all runs "
        + json.dumps({k: [round(t, 4) for t in v] for k, v in times.items()}))
    profile_forward(f"{S} views {W}x{H} merged r={MERGE_R}", proc.model, x,
                    med[f"merged r={MERGE_R}"], global_merge_r=MERGE_R)
    proc.runtime = RuntimeConfig(image_size=(W, H))
    return not problems


LONG_VIEWS, LONG_HW, LONG_MERGE_R = 32, (336, 504), 8192


def run_long_sequence(model) -> bool:
    """32 views at 504x336 (N = 27,808 global tokens) through the bare
    forward, merged at r = LONG_MERGE_R and exact, timed in turns (merged,
    exact, exact, merged after a warm-up of each) with the peak memory of
    each; outputs finite, launch counts of a merged forward the route's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    x = torch.rand((1, LONG_VIEWS, *LONG_HW, 3), generator=gen, device="cuda")
    runs = {f"merged r={LONG_MERGE_R}": dict(global_merge_r=LONG_MERGE_R), "exact": {}}
    times = {k: [] for k in runs}
    peaks, problems = {}, []
    with torch.inference_mode():
        for name, kw in runs.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            out = model(x, **kw)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = read_counts()
            bad = [k for k, v in out.items() if isinstance(v, torch.Tensor)
                   and not bool(torch.isfinite(v).all().item())]
            if bad:
                problems.append(f"{name}: {bad} not finite")
            if kw:
                want = merged_forward_want(model.cfg, LONG_VIEWS)
                got = (counts["flash_attention_fused"], counts["qk_prep"],
                       counts["flash_attention"])
                if got != want:
                    problems.append(f"{name}: launches {got}, want {want}")
            del out
        order = list(runs)
        for name in order + order[::-1]:
            times[name].append(wall_s(lambda: model(x, **runs[name])))
    med = {k: float(np.median(v)) for k, v in times.items()}
    agg = model.cfg.aggregator
    P = agg.patch_start_idx + (LONG_HW[0] // agg.patch_size) * (LONG_HW[1] // agg.patch_size)
    log(f"[requests] {LONG_VIEWS} views {LONG_HW[1]}x{LONG_HW[0]} bare forward (N = "
        f"{LONG_VIEWS * P} global tokens; median of 2, in turns): "
        + ", ".join(f"{k} {v:.4f} s ({LONG_VIEWS / v:.2f} views/s, peak {peaks[k]:.2f} GiB)"
                    for k, v in med.items())
        + f"; merged {100 * (med[order[0]] / med['exact'] - 1):+.1f}%; all runs "
        + json.dumps({k: [round(t, 4) for t in v] for k, v in times.items()})
        + f"; {'ok' if not problems else problems}")
    del x
    torch.cuda.empty_cache()
    return not problems


TRACK_GRID = 16     # 16 x 16 = 256 query points on a grid in view 0


def run_track_forward(proc, x) -> bool:
    """The full-width IGGT with enable_track=True (the trunk and heads of
    ``proc.model``, the track head from the seed) at 8x518 with 256 query
    points on a grid in view 0: output shapes, finite values, vis and conf
    in [0, 1], view 0's track equal to the query points; the forward's time
    (after a warm-up) and the track head's share of it (CUDA events around
    the head's call), and the peak memory."""
    import torch

    from iggt_official_tpu_torch.models.vggt import build_model

    S, H, W = x.shape[1:4]
    t0 = time.time()
    cfg = dataclasses.replace(proc.cfg, enable_track=True)
    model = build_model(cfg, "cuda", seed=SEED)
    model.load_state_dict(proc.model.state_dict(), strict=False)
    proc.model.to("cpu")
    torch.cuda.empty_cache()
    built = time.time() - t0
    weights = torch.cuda.memory_allocated() / 2 ** 30
    g = (torch.arange(TRACK_GRID, device="cuda", dtype=torch.float32) + 0.5) / TRACK_GRID
    qp = torch.stack(torch.meshgrid(g * (W - 1), g * (H - 1), indexing="xy"), -1)
    qp = qp.reshape(1, -1, 2)
    events, peaks = [], []

    def mark(*_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def peak_so_far(*_):
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)

    head = model.track_head
    hooks = [head.register_forward_pre_hook(mark), head.register_forward_hook(mark),
             head.register_forward_pre_hook(peak_so_far),
             head.feature_extractor.register_forward_hook(peak_so_far),
             head.tracker.register_forward_hook(peak_so_far)]
    with torch.inference_mode():
        model(x, query_points=qp)
        torch.cuda.synchronize()
        events.clear()
        peaks.clear()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(x, query_points=qp)
        end.record()
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    fwd_ms = start.elapsed_time(end)
    head_ms = events[0].elapsed_time(events[1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    N = qp.shape[1]
    problems = []
    for k, shape in (("track", (1, S, N, 2)), ("vis", (1, S, N)), ("conf", (1, S, N))):
        if tuple(out[k].shape) != shape:
            problems.append(f"{k} {tuple(out[k].shape)} != {shape}")
        if not bool(torch.isfinite(out[k]).all().item()):
            problems.append(f"{k} not finite")
    for k in ("vis", "conf"):
        if not (out[k].min().item() >= 0 and out[k].max().item() <= 1):
            problems.append(f"{k} outside [0, 1]")
    if not torch.equal(out["track"][:, 0], qp):
        problems.append("view 0's track differs from the query points")
    moved = (out["track"][:, 1:] - qp[:, None]).norm(dim=-1)
    log(f"[requests] {S} views {W}x{H} with the track head, {N} query points: forward "
        f"{fwd_ms:.1f} ms, of it the track head {head_ms:.1f} ms "
        f"({100 * head_ms / fwd_ms:.1f}%), peak {peak:.2f} GiB allocated (weights "
        f"{weights:.2f} GiB; peak so far before the track head {peaks[0]:.2f}, after its "
        f"DPT feature extractor {peaks[1]:.2f}, after the tracker {peaks[2]:.2f}; model "
        f"built in {built:.1f} s); tracks moved median {moved.median().item():.2f} px in views 1-{S - 1}, "
        f"vis mean {out['vis'].mean().item():.3f}, conf mean {out['conf'].mean().item():.3f}; "
        f"{'ok' if not problems else problems}")
    del model, out
    torch.cuda.empty_cache()
    proc.model.to("cuda")
    return not problems


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
        results = (check_kernels() + check_qk_prep() + check_nn1() + check_fused_ln()
                   + check_bucket_topk())
        ok &= all(r["ok"] for r in results)
    if "agreement" in phases:
        ok &= check_agreement()
        ok &= check_postproc_agreement()
    launches, extra = {}, {}
    if "postproc" in phases:
        ok &= run_postproc(launches)
    if "requests" in phases:
        ok &= run_requests(launches, extra)

    summary = kernels_summary(results, launches, extra) if results else []
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
