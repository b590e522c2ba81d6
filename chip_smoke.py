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
   (torch.profiler), and a call of each timed in turns in the same run (the
   median of 60, CUDA events around each call).  bucket_topk
   at Q = R = 150,000, k = 64, nb = 1024: 0 index mismatches in the bucket
   minima and the top-k; faults are bucket = index mod (nb - 1), reversed tie
   order, a dropped last reference tile; rechecks per (query, bucket); then
   the bucket minima on nn1's near-tie case with duplicates across chunks,
   compared in full, where the filter's faults (window zero, one TF32 pass)
   must mismatch.  Kernel, plain and one PyTorch call
   computing the same function (`library_ms`, a yardstick the port never
   calls) timed with CUDA events; for nn1 and bucket_topk, whose full query
   sets do not fit one `torch.cdist`, the calls over every query in
   16,384-query chunks, summed (the 16,384-query call's time beside it).
3b. conv3x3: the heads' 3x3 convolution kernel (`csrc/conv3x3.cu`, three
   TF32 passes) at every (input channels, output channels, map) the heads
   route to it in the benchmark's two cells, and at ragged edges, against a
   float64 convolution: its error at most twice cuDNN fp32's (TF32 off) on
   the same inputs, every tile shape too, two calls byte-equal, and the
   planted fault (one TF32 pass) above the limit; the six largest shapes at
   the cells' 8 views checked the same way, the outputs' mean shrink toward
   zero within `CONV3X3_SHRINK` (one tensor-core chain per A slot, a planted
   fault, beyond it), and timed (kernel, plain, cuDNN fp32 as `library_ms`,
   cuDNN TF32 for scale) against max(ops / 165 TF/s, bytes / 3.35 TB/s);
   then one forward of each cell's full-width model: launches per forward
   (77 and 320), outputs within `CONV3X3_FORWARD_GAP` of the same forward on
   cuDNN fp32, and both forwards timed in turns.
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
   evaluation report).  Each prints the wall time and views/s of one
   request (after a warm-up), the median of three bare forwards and of
   three post-processings, peak memory, output shapes, ranges and finiteness, the clusters
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
   share of it (CUDA events), peak memory.  The 3-view request also prints
   the exact-forward fingerprint (SHA-256 of the bytes of depth,
   world_points and part_feat; two forwards must give the same) and runs the
   demo's --mask_sky on a 3-view scene with a sky band: sky_masks/ written
   once and read back by the next request, no sky pixel's point in the rgb
   GLB, its point count the confidence percentile's.
7. sam2: the fp32 flash kernel at head dim 72 at each of Hiera-L's eight
   attention shapes at 1024 px (windows of 16 to 4096 keys, pooled queries)
   against its plain version (limit 1e-5, max|ref| beside it), with planted
   faults (the scale of the padded head dim, V's last 8 columns dropped, the
   last key tile dropped or one key past Nk admitted), its time against the
   bound and SDPA's on the same fp32 tensors (SDPA's backend named; by CUDA
   events and by replaying a CUDA graph of the calls); a
   scaled SAM2 (embed 72, head dim 72) on the card against the CPU, same
   weights (backbone_fpn, multimask logits, IoUs, object score for a point
   and a box prompt; limit 1e-3 relative); then the full-width
   `sam2_hiera_l("2.1")` image predictor (random weights from the seed) on a
   seeded 1280x960 image: `set_image` (median of 3, 48 flash launches
   counted and split by attention shape), `predict` with a point and a box, the automatic mask generator
   with its defaults and with both thresholds at 0, peak memory, and
   `set_image` with Hiera's attention on the plain version, whose
   backbone_fpn must agree with the kernel's to 1e-3 relative.  The same
   kernel at head dims 56 (Hiera-B+) and 96 (Hiera-T and -S) at each of
   their attention shapes at 1024 px (`hiera_cases`), the same checks and
   times (faults: the padded scale at D = 56, V's last 8 columns, the last
   key tile or one key past Nk); then `set_image` of the full-width T, S and
   B+ image predictors: 12 / 16 / 24 flash launches split by shape, and
   backbone_fpn against plain attention within 1e-3 relative.
8. sam2_video: a scaled SAM2 video predictor (embed 72) card vs CPU (masks
   of both propagation loops within 1e-3 relative), then the slice's
   full-width path: `sam2_hiera_l("2.1")` at 1024 px over 25 seeded
   1024x1024 frames (`sam2.benchmark.load_frames`), two objects clicked on
   frame 0, `propagate_in_video` and `propagate_in_video_batch` in turns
   (batch masks within rtol 1e-4 / atol 2e-4 of streaming's, 48 flash
   launches per encoded frame, frames/s of each, the per-frame split by
   CUDA events, peak memory), 4 frames with plain attention within 1e-3
   relative, and `python -m iggt_official_tpu_torch.sam2.benchmark --preset
   l --image_size 1024 --size 1024` in its own process.
9. batch_eval (inside the requests phase, on its processor; alone on a
   processor of its own): `app/batch_eval.run_scenes` over a 3-view scene
   with ground truth and an 8-view scene at 504x336: predictions byte-equal
   to serial `process_scene` runs, launch counts equal to their sum,
   summary.json, and the gate passing against the serial outputs as
   goldens and failing against a golden depth scaled by 1.02.

10. data: the rest of the data layer at the sources' sizes, all seeded, no
   card: a DL3DV-style COLMAP capture (24 PNG frames 960x540, one PINHOLE
   camera, 20,000 points3D with tracks and unmatched keypoints, written with
   the port's `data/colmap.py` in .bin and .txt; geometric depth bins at
   480x270 by `preprocess/dense.py`) read back equal in both formats and
   rewritten byte-equal, then `dl3dv.process_scene` (each npy the nearest 2x
   upsample clamped to [0, 500], invalid 0), `convert_colmap_scene` (depth
   PNGs equal to clip(d * 1000) as uint16, poses the inverse of the written
   world-to-camera within 1e-6, intrinsics and colour equal) and
   `edit_resolution` on a half-size copy (the ratio rule); 4 EXR frames at
   1920x1080 (this script's own OpenEXR writer: HALF/ZIP, FLOAT/ZIPS,
   FLOAT/NONE) in MvsSynth's and MegaDepth's layouts, read through the
   registered loaders (their 24-frame minimum lowered to 4): each depth equal
   to the written array, and the loader's to its threshold; an SA-1B TSV
   shard (4 rows, a 2250x1500 JPEG and 60 RLE masks each) through `TSVFile`
   (rows seek back equal), the masks decoded equal, one `SA1BDataset`
   sample at 1024 with the shapes its docstring states; an EntitySeg COCO
   set (rectangle polygons) through `EntityImage`; a `_BASE_` YAML chain and
   dot-keyed files with overrides through the config loaders on the port's
   YAML subset reader, equal to literal dicts.  Host seconds per step.

11. train: the training path.  The trunk and the DINOv2 blocks train
   through plain attention, as the JAX step trains through XLA; the part
   head's cross-attention, which the JAX step leaves on its dispatcher (on a
   TPU the Pallas flash kernel at the cell's 1,036 tokens), runs the flash
   kernel's forward through `attention_train`, with the plain version's
   backward.  (a) each kernel wrapper raises on CUDA inputs that require
   grad; `attention_train` at the cell's part-head shape launches the
   kernel once, within the fp32 limit of the plain version, with the plain
   version's gradients (1e-6 relative); (b) one `make_train_step` of a
   scaled IGGT (DINOv2 patch embed, all four losses) on the card and on the
   CPU, same weights and batch, fp32 and bf16 trunks, TF32 off: loss terms
   and grad_norm (`TRAIN_LOSS_TOL`; bf16: or the bf16 trunk's own move of
   the term on the CPU), every gradient per tensor and in global L2
   (`TRAIN_GRAD_TOL`, `TRAIN_GRAD_L2`, `TRAIN_TENSOR_L2`), one
   flash launch per part-head view chunk and no other; for each trunk the
   planted fault -- the trunk's attention output detached, which the
   kernels' missing `grad_fn` did -- must fail the check and name the
   trunk's qkv weights; (c) the full-width cell through
   `app/train.py::main`, under torch's default TF32 settings (what the CLI
   runs: cuDNN convolutions in TF32): a synthetic Dl3dv sequence (24 frames
   640x480, masklets as COCO RLE of a Voronoi partition), B = 1 x S = 4
   views at 518x392, 8 steps with layer decay 0.9 and 2 warmup steps, one
   checkpoint at the end (the free disk checked first), then a resume to
   step 10; it prints each step's losses, grad_norm, lr, wall and loader
   wait, the median step, images/s, the loader's share, peak memory beside
   the reckoning, the launch counts (flash_attention one per step, the
   others 0), one profiled step's device time by bucket (attention einsum
   and softmax, convolution, matmul, optimizer, the rest) with the largest
   ops and kernels; it checks finite losses, finite gradients (nonzero
   except where (b) read zero on the CPU: `cross_attention_1`, computed
   and discarded), the checkpoint reloaded byte-equal, the resume's first
   step and learning rate, and a separate 10-step run on one fixed batch
   whose loss must fall; then, with that run's model and optimizer, 2 steps
   on the data phase's converted COLMAP scene (the port's `SceneDirDataset`
   through `get_data_loader`) and 1 on its MvsSynth EXR scene: finite losses
   and grad_norm, no part loss (no instance_ids), one flash launch per step
   and no other, step time and peak memory beside the card's name and power
   limit.  The train phase runs the data phase first when it runs alone.
   The kernels phase holds the flash kernel at the cell's part-head shape
   (4, 1036, 8, 32) fp32.

12. parallel: the mesh paths (`parallel/*`) on the card in a one-rank NCCL
   world (the checking machine has one H100, and NCCL refuses two ranks on
   one device, so no collective runs between cards here): (a) the
   full-width IGGT forward at 8 views 518x518 through
   `make_mesh_attention_fns(mesh)` (all-gather: 24 fused + 24 `qk_prep` + 49
   flash launches) and with `ring=True` (24 fused + 25 flash, the ring in
   plain torch), against the unsharded forward at the bf16 trunk's limit;
   (b) the training cell's batch (1 x 4 views 518x392): one step unsharded
   twice (the card's spread) and with FSDP, loss terms within 1e-3 and
   grad_norm within 1e-2 (the card's step is not bit-reproducible), or twice
   the spread, gradients within the bf16 global L2 limit; three
   steps of `train()` unsharded and with `mesh, fsdp=True` (step time and
   peak memory beside each other), the FSDP checkpoint read by the one-card
   loader into a one-card IGGT (strict), weights and moments equal; (c)
   `app/train.py --n_data 1 --fsdp` for two steps, which opens and closes its
   own one-rank world; (d) the CPU tests' gloo worlds
   (`tests/torch_parallel_worker.py`: 2 data x 2 seq, 2 x 2 x 2 with tensor
   parallelism and the 2 x 4 ring, 4 x 1 with FSDP) on this machine's torch,
   against the port in one process.  The phase's wall time is printed.

13. modules: the JAX package's last modules at full width, seeded weights.
   `Block(1024, 16, ffn_layer="swiglu")` in bf16: a frame block with qk-norm
   and RoPE on (8, 1374, 1024) and a global one on (1, 10992, 1024) (one
   `flash_attention_fused` launch each), a DINOv2-style block without them
   on (8, 1374, 1024) (one `flash_attention` launch), each against the same
   block with `sdpa_plain` on the card at the bf16 trunk's limit, and the
   frame and DINOv2 blocks on view 0 against the same block on the CPU; the
   frame block with w12's halves swapped must fail that.  `GeoProjector(2048)`
   on four seeded token maps of the 8x518 forward's shape, TF32 off, against
   the CPU on views 0-1 (1e-5 relative); a level-0 ConvTranspose kernel left
   unflipped must fail.  The 8x518 forward through `IGGTProcessor` with
   `RuntimeConfig(use_flash_attention=False)`: no `flash_attention_fused`
   launch, one `flash_attention` launch (the part head's cross-attention,
   which keeps its dispatcher as in the JAX package), 72 `sdpa_plain` calls
   (24 DINOv2, 24 frame, 24 global blocks), outputs within the bf16 trunk's
   limit of the default forward's (48 + 25 launches); both forwards' wall
   times are readings.  The phase's wall time is printed.

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

import collections
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


def chunked_ms(fn, n: int, chunk: int) -> float:
    """One pass of ``fn(rows)`` over rows [0, n) in slices of ``chunk``, timed
    with CUDA events around the whole pass (ms): a library call over an input
    too large for one call, summed over its chunks."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in range(0, n, chunk):
        fn(slice(s, min(s + chunk, n)))
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


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


def graph_ms(fn, calls: int, reps: int = 5) -> float:
    """Time per call with no host work between calls: ``calls`` calls of
    ``fn`` captured in one CUDA graph, replayed ``reps`` times between CUDA
    events; the median replay over ``calls``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


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
    # the training cell's part head (attention_train's forward), 1 x 4 views 518x392
    ("part cross-attention, train cell, 4 views 518x392", "flash_attention", (4, 1036, 8, 32),
     "float32", None),
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
             "bucket_topk": "core kNN candidate, Q = R = 150000",
             "flash_attention_hiera": "blocks 23, 33, 43, global",
             "flash_attention_hiera_d56": "global",
             "flash_attention_hiera_d96": "global",
             "conv3x3": "timed (8, 148, 148, 256) -> 256"}
REPLACES = {
    "flash_attention": "iggt_official_tpu/ops/flash_attention.py:117",
    "flash_attention_fused": "iggt_official_tpu/ops/flash_attention.py:335",
    "qk_prep": "iggt_official_tpu/ops/flash_attention.py:335",
    "nn1": "iggt_official_tpu/ops/nn1_pallas.py:82",
    "fused_ln": "iggt_official_tpu/ops/fused_ln.py:39",
    "bucket_topk": "iggt_official_tpu/ops/nn1_pallas.py:190",
    "flash_attention_hiera": "iggt_official_tpu/ops/flash_attention.py:117",
    "flash_attention_hiera_d56": "iggt_official_tpu/ops/flash_attention.py:117",
    "flash_attention_hiera_d96": "iggt_official_tpu/ops/flash_attention.py:117",
    "conv3x3": "none: the JAX package leaves convolutions to XLA (iggt_official_tpu/ops/conv.py)",
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
NN1_LIBRARY_Q = 16_384   # queries per cdist call of the yardstick (all Q at once: ~1 TB)
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
          "bucket_topk": "iggt_official_tpu_torch/csrc/nn1.cu",
          "flash_attention_hiera": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "flash_attention_hiera_d56": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "flash_attention_hiera_d96": "iggt_official_tpu_torch/csrc/flash_attention.cu",
          "conv3x3": "iggt_official_tpu_torch/csrc/conv3x3.cu"}


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
    Q, `torch.cdist(q, r).argmin(1)` over all Q queries in NN1_LIBRARY_Q-query
    chunks (summed: the like-for-like library time), that call and the kernel
    on NN1_LIBRARY_Q queries; rechecks per query and L2 bytes per call.  Then the near-tie
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
        library_slice_ms = time_ms(lambda: torch.cdist(qry[:L], ref).argmin(1), iters=3,
                                   warmup=1)
        library_kernel_ms = time_ms(lambda: nn1(qry[:L], ref), iters=3, warmup=1)
        # like for like: the same call over every query, in L-query chunks
        library_ms = chunked_ms(lambda rows: torch.cdist(qry[rows], ref).argmin(1), Q, L)
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
            f"per call ({l2 / ms / 1e9:.1f} TB/s at the measured time) | library_ms="
            f"{library_ms:.3f} (cdist+argmin over all {Q} queries in {L}-query chunks, "
            f"summed) | on {L} queries: cdist+argmin {library_slice_ms:.3f} kernel "
            f"{library_kernel_ms:.3f}")
        log("[kernels]   planted faults: "
            + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel="nn1", label=label, shape=[Q, R, 8], dtype="float32",
            max_abs_err=float(mismatches), mismatches=mismatches, compared=C,
            fault_mismatches=fault_mm, ok=ok, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_queries=Q, library_chunk=L,
            library_slice_ms=library_slice_ms, library_kernel_ms=library_kernel_ms,
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
        library_queries=Q, library_chunk=Q, library_slice_ms=library_ms,
        library_kernel_ms=ms, bound_ms=bound_ms, bound_by=bound_by,
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


LN_TURNS = 60


def calls_in_turns(fns: dict, calls: int = LN_TURNS) -> dict:
    """{name: median ms of one call}: the functions called in turns, each
    call between its own two CUDA events (host work to launch it included,
    as a caller sees it), after a warm-up of 5 rounds."""
    import torch

    for _ in range(5):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    events = {name: [] for name in fns}
    for _ in range(calls):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events[name].append((start, end))
    torch.cuda.synchronize()
    return {name: float(np.median([a.elapsed_time(b) for a, b in ev]))
            for name, ev in events.items()}


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
            def run_library():
                return F.layer_norm(x, (D,), wl, bl, eps)

            device = {"device_ms": device_ms(run_kernel),
                      "library_device_ms": device_ms(run_library),
                      **calls_in_turns({"turns_ms": run_kernel, "library_turns_ms": run_library})}
        log(f"[kernels] fused_ln {label:40s} ({rows}, {D}) {in_name}->{out_name} eps {eps:g}: "
            f"max err {err:.3g} {unit} (limit {limit:g}), {100 * differ:.4f}% of elements "
            f"differ {'ok' if ok else 'FAIL'} | ms={ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (F.layer_norm)"
            + (f" | device time per call (profiler): kernel {device['device_ms']:.4f} ms, "
               f"F.layer_norm {device['library_device_ms']:.4f} ms | in turns, median of "
               f"{LN_TURNS} calls each (CUDA events around each call): wrapper "
               f"{device['turns_ms']:.4f} ms, F.layer_norm {device['library_turns_ms']:.4f} ms "
               f"({nvidia_smi_line()})" if device else ""))
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


# conv3x3 (csrc/conv3x3.cu): every (input channels, output channels, map) the
# heads route to it in the two benchmark cells, at one or two views; then the
# six largest at the cells' 8 views, checked and timed.
CONV3X3_SHAPES = (
    # 8 views 518 px (patch grid 37): DPT and part-head fusion, SamProjector,
    # the window attentions' convolutions
    (256, 256, 148, 148), (256, 256, 74, 74), (256, 256, 37, 37), (256, 256, 19, 19),
    (512, 256, 74, 74), (1024, 256, 37, 37), (1024, 256, 19, 19), (256, 128, 296, 296),
    (128, 32, 518, 518), (256, 64, 148, 148), (64, 256, 148, 148), (128, 42, 296, 296),
    (128, 128, 296, 296), (128, 64, 296, 296), (64, 128, 296, 296),
    # 64 views 504x336 (patch grid 24 x 36): the DPT heads, 8 views a chunk
    (256, 256, 96, 144), (256, 256, 48, 72), (256, 256, 24, 36), (256, 256, 12, 18),
    (512, 256, 48, 72), (1024, 256, 24, 36), (1024, 256, 12, 18), (256, 128, 192, 288),
    (128, 32, 336, 504),
)
CONV3X3_EDGES = (  # (N, H, W, Cin, Cout, bias): ragged tiles, odd widths, 32 channels
    (3, 13, 21, 64, 42, True), (2, 7, 5, 32, 5, False), (1, 1, 1, 32, 8, True),
    (5, 9, 33, 96, 130, True), (2, 130, 3, 32, 256, False), (4, 17, 1, 64, 64, True),
)
CONV3X3_TIMED = ((8, 148, 148, 256, 256), (8, 296, 296, 256, 128), (8, 518, 518, 128, 32),
                 (8, 96, 144, 256, 256), (8, 192, 288, 256, 128), (8, 336, 504, 128, 32))
CONV3X3_PEAK = 495e12 / 3   # three TF32 passes at the TF32 peak
# the outputs' mean shrink toward zero (`conv3x3_shrink`): the tensor cores'
# truncated fp32 sums shrink a chain with every add; on an H100 at the timed
# shapes the kernel's one-tap chains read -8.7e-8, one chain per A slot
# -5.7e-7, cuDNN fp32 1e-9 or less (tests/test_torch_conv3x3.py's SHRINK_LIMIT)
CONV3X3_SHRINK = 2e-7
# the full forwards' outputs, kernel against cuDNN fp32 (largest gap over the
# largest value): the fp32 level the benchmark holds the heads to
# (`heads_max_rel` at most 3e-5, a hundredth of one TF32 pass's 2.7e-3)
CONV3X3_FORWARD_GAP = 3e-5
CONV3X3_FORWARD_LAUNCHES = {"iggt": 77, "vggt": 320}
CONV3X3_TILES = ((1, 128), (2, 64), (1, 64), (2, 32), (1, 32))  # (m64 tiles per warpgroup, BN)


def conv3x3_bound_ms(N, H, W, Cin, Cout):
    ops = 2.0 * N * H * W * Cout * 9 * Cin
    nbytes = 4.0 * (N * H * W * (Cin + Cout) + 9 * Cin * Cout)
    t_ops, t_bytes = ops / CONV3X3_PEAK, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("ops" if t_ops >= t_bytes else "bytes"), ops


def conv3x3_err(out, ref64) -> float:
    """Largest gap over the largest reference magnitude."""
    return ((out.double() - ref64).abs().max() / ref64.abs().max().clamp(min=1e-300)).item()


def conv3x3_shrink(out, ref64, bias=None) -> float:
    """The outputs' mean signed gap toward zero over their mean magnitude,
    the convolution's part of the reference (without ``bias``, which the
    epilogue adds rounded to nearest) giving sign and size:
    mean((out - ref) sign(conv)) / mean |conv|, negative where sums shrink."""
    conv = ref64 if bias is None else ref64 - bias.double()
    return ((out.double() - ref64).mul(conv.sign()).mean() / conv.abs().mean()).item()


def check_conv3x3(shapes=CONV3X3_SHAPES, edges=CONV3X3_EDGES, timed=CONV3X3_TIMED):
    """The kernel against a float64 convolution of the same inputs, beside
    cuDNN's fp32 (TF32 off) error on them: the kernel's may be at most twice
    cuDNN's, and the planted fault (one TF32 pass) must exceed that limit.
    Two calls give equal bytes.  Then the timed shapes, at the cells' 8
    views: the same check, the mean shrink within `CONV3X3_SHRINK` where one
    chain per A slot (a planted fault) exceeds it; and kernel, plain
    (`conv3x3_plain`: cuDNN fp32 on the NHWC view), `F.conv2d` on an NCHW
    tensor (`library_ms`) and cuDNN with TF32 on (one pass, a lower precision,
    for scale), against the bound: max(ops / 165 TF/s, bytes / 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F

    from iggt_official_tpu_torch.ops import conv as cv

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(2 if H * W <= 148 * 148 else 1, H, W, Cin, Cout, True)
             for Cin, Cout, H, W in shapes] + list(edges)
    results = []
    for N, H, W, Cin, Cout, has_bias in cases:
        x = torch.randn((N, H, W, Cin), generator=gen, device="cuda")
        w = torch.randn((Cout, Cin, 3, 3), generator=gen, device="cuda") / (3 * Cin ** 0.5)
        b = torch.randn((Cout,), generator=gen, device="cuda") if has_bias else None
        with torch.inference_mode():
            out = cv.conv3x3(x, w, b)
            again = cv.conv3x3(x, w, b)
            torch.cuda.synchronize()
            ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(),
                           None if b is None else b.double(), 1, 1).permute(0, 2, 3, 1)
            cudnn = cv.conv3x3_plain(x, w, b)
            one_pass = cv._launch(x, w, b, fault=1)
            tiles = {t: cv._launch(x, w, b, tile=t) for t in CONV3X3_TILES
                     if t[1] // 2 < Cout and t != cv.conv3x3_tile(x, Cout)}
        err, cudnn_err = conv3x3_err(out, ref), conv3x3_err(cudnn, ref)
        limit = 2 * cudnn_err
        fault_err = conv3x3_err(one_pass, ref)
        equal = torch.equal(out, again)
        tile_errs = {f"{128 * t[0]}x{t[1]}": conv3x3_err(o, ref) for t, o in tiles.items()}
        ok = (bool(torch.isfinite(out).all()) and err <= limit and fault_err > limit and equal
              and all(e <= limit for e in tile_errs.values()))
        mt, bn = cv.conv3x3_tile(x, Cout)
        label = f"({N}, {H}, {W}, {Cin}) -> {Cout}"
        log(f"[kernels] conv3x3 {label:28s} tile {128 * mt}x{bn}: err {err:.3g} "
            f"(cuDNN fp32 {cudnn_err:.3g}, limit {limit:.3g}; one TF32 pass {fault_err:.3g}) "
            f"two calls {'byte-equal' if equal else 'DIFFER'}; other tiles "
            + ", ".join(f"{k} {e:.3g}" for k, e in tile_errs.items()) + f" {'ok' if ok else 'FAIL'}")
        results.append(dict(kernel="conv3x3", label=label, shape=[N, H, W, Cin, Cout],
                            bias=has_bias, tile=[128 * mt, bn], max_abs_err=err,
                            cudnn_err=cudnn_err, limit=limit, fault_errs={"one TF32 pass": fault_err},
                            byte_equal=equal, ok=ok))
        del x, w, b, out, again, ref, cudnn, one_pass, tiles
    torch.cuda.empty_cache()
    for N, H, W, Cin, Cout in timed:
        x = torch.randn((N, H, W, Cin), generator=gen, device="cuda")
        w = torch.randn((Cout, Cin, 3, 3), generator=gen, device="cuda") / (3 * Cin ** 0.5)
        b = torch.randn((Cout,), generator=gen, device="cuda")
        label = f"({N}, {H}, {W}, {Cin}) -> {Cout}"
        with torch.inference_mode():
            out = cv.conv3x3(x, w, b)
            ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), b.double(),
                           1, 1).permute(0, 2, 3, 1)
            cudnn_err = conv3x3_err(cv.conv3x3_plain(x, w, b), ref)
            fault_err = conv3x3_err(cv._launch(x, w, b, fault=1), ref)
            slot_shrink = conv3x3_shrink(cv._launch(x, w, b, fault=2), ref, b)
        err, shrink, limit = conv3x3_err(out, ref), conv3x3_shrink(out, ref, b), 2 * cudnn_err
        ok = (bool(torch.isfinite(out).all()) and err <= limit and fault_err > limit
              and abs(shrink) <= CONV3X3_SHRINK and slot_shrink < -CONV3X3_SHRINK)
        log(f"[kernels] conv3x3 {label:28s} err {err:.3g} (cuDNN fp32 {cudnn_err:.3g}, limit "
            f"{limit:.3g}; one TF32 pass {fault_err:.3g}) shrink {shrink:.3g} (limit "
            f"{CONV3X3_SHRINK:.3g}; one chain per A slot {slot_shrink:.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        del out, ref
        torch.cuda.empty_cache()
        xn = x.permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            ms = time_ms(lambda: cv.conv3x3(x, w, b), iters=20, warmup=3)
            plain_ms = time_ms(lambda: cv.conv3x3_plain(x, w, b), iters=10, warmup=2)
            library_ms = time_ms(lambda: F.conv2d(xn, w, b, 1, 1), iters=10, warmup=2)
            torch.backends.cudnn.allow_tf32 = True
            tf32_ms = time_ms(lambda: F.conv2d(xn, w, b, 1, 1), iters=10, warmup=2)
            torch.backends.cudnn.allow_tf32 = False
            tile_ms = {f"{128 * t[0]}x{t[1]}": time_ms(lambda t=t: cv._launch(x, w, b, tile=t),
                                                       iters=10, warmup=2)
                       for t in CONV3X3_TILES if t[1] // 2 < Cout}
        bound_ms, bound_by, ops = conv3x3_bound_ms(N, H, W, Cin, Cout)
        mt, bn = cv.conv3x3_tile(x, Cout)
        log(f"[kernels] conv3x3 {label:28s} tile {128 * mt}x{bn}: ms={ms:.4f} "
            f"({ops / ms / 1e9:.1f} TF/s) bound_ms={bound_ms:.4f} ({bound_by}, "
            f"{100 * bound_ms / ms:.1f}%) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"(cuDNN fp32) cuDNN TF32 (one pass) {tf32_ms:.4f} ({nvidia_smi_line()}); by tile "
            + ", ".join(f"{k} {v:.4f}" for k, v in tile_ms.items()))
        results.append(dict(kernel="conv3x3", label=f"timed {label}", shape=[N, H, W, Cin, Cout],
                            tile=[128 * mt, bn], max_abs_err=err, cudnn_err=cudnn_err,
                            limit=limit, fault_errs={"one TF32 pass": fault_err},
                            shrink=shrink, slot_shrink=slot_shrink, ms=ms, bound_ms=bound_ms,
                            bound_by=bound_by, share=bound_ms / ms, plain_ms=plain_ms,
                            library_ms=library_ms, tf32_ms=tf32_ms, tile_ms=tile_ms, ok=ok))
        del x, w, b, xn
    torch.cuda.empty_cache()
    return results


CONV3X3_FORWARDS = (("iggt", 8, 518, 518), ("vggt", 64, 336, 504))


def run_conv3x3_forwards(forwards=CONV3X3_FORWARDS, timed: int = 3) -> dict:
    """The full-width model of each benchmark cell (the port's own seeded
    init) on one request of its shape: `conv3x3` launches per forward, the
    outputs with the heads' 3x3 convolutions on the kernel against the same
    forward with them on cuDNN fp32 (largest gap over the largest magnitude,
    at most `CONV3X3_FORWARD_GAP`), and the forward's time each way, in turns
    (CUDA events).  ``ok`` holds where every gap is within its limit and the
    launches are `CONV3X3_FORWARD_LAUNCHES`."""
    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.models.vggt import IGGT, VGGT
    from iggt_official_tpu_torch.ops import conv as cv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = cv.conv3x3_routes
    report = {}
    for name, S, H, W in forwards:
        torch.manual_seed(SEED)
        with torch.device("cuda"):
            model = (IGGT(ModelConfig()) if name == "iggt" else
                     VGGT(ModelConfig(name="vggt", enable_part=False, enable_track=True)))
        model = model.eval().requires_grad_(False)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.rand((1, S, H, W, 3), generator=gen, device="cuda")

        def forward(routed: bool):
            cv.conv3x3_routes = routes if routed else (lambda *args: False)
            try:
                with torch.inference_mode():
                    return model(x)
            finally:
                cv.conv3x3_routes = routes

        forward(True)
        forward(False)
        cv.conv3x3.launches = 0
        kernel_out = forward(True)
        launches = cv.conv3x3.launches
        cudnn_out = forward(False)
        gaps = {k: ((kernel_out[k].double() - cudnn_out[k].double()).abs().max()
                    / cudnn_out[k].double().abs().max()).item()
                for k in ("depth", "world_points", "part_feat") if k in kernel_out}
        del kernel_out, cudnn_out
        ms = {"kernel": [], "cudnn": []}
        for _ in range(timed):
            for routed, key in ((False, "cudnn"), (True, "kernel"), (True, "kernel"),
                                (False, "cudnn")):
                ms[key].append(time_ms(lambda: forward(routed), iters=1, warmup=0))
        med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
        ok = (launches == CONV3X3_FORWARD_LAUNCHES[name]
              and all(v <= CONV3X3_FORWARD_GAP for v in gaps.values()))
        log(f"[conv3x3] {name} {S} views {H}x{W}: {launches} conv3x3 launches per forward "
            f"(want {CONV3X3_FORWARD_LAUNCHES[name]}); kernel vs cuDNN fp32 outputs (largest "
            f"gap / largest value, limit {CONV3X3_FORWARD_GAP:.3g}) "
            + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
            + f"; forward ms (median of {2 * timed}) kernel {med['kernel']:.1f}, cuDNN "
            f"{med['cudnn']:.1f} ({nvidia_smi_line()}) {'ok' if ok else 'FAIL'}")
        report[name] = {"launches": launches, "gaps": gaps, "ms": med, "ok": ok}
        del model, x
        torch.cuda.empty_cache()
    return report


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
        plain_ms=plain_ms, library_ms=None, library_queries=0, library_chunk=None,
        library_slice_ms=None, library_kernel_ms=None,
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
    library_slice_ms = time_ms(lambda: torch.topk(torch.cdist(pts[:C], pts), k, largest=False),
                               iters=3, warmup=1)
    slice_ms = time_ms(lambda: nn1_mod.bucket_topk(pts[:C], pts, k, nb), iters=3, warmup=1)
    # like for like: every query, in C-query chunks
    library_ms = chunked_ms(lambda rows: torch.topk(torch.cdist(pts[rows], pts), k,
                                                    largest=False), Q, C)
    bound_ms, bound_by, floors = bucket_topk_bound_ms(Q, Q, nb)
    ok = mm_min == 0 and mm_topk == 0 and d_equal and self_first and caught
    log(f"[kernels] bucket_topk Q=R={Q} k={k} nb={nb}: on {C} queries {mm_min} bucket-minimum "
        f"and {mm_topk} top-k index mismatches (limit 0), distances equal {d_equal}, self "
        f"at distance 0 {self_first} {'ok' if ok else 'FAIL'} | rechecks {rechecks:.3f} per "
        f"(query, bucket) | ms={ms:.3f} (wrapper) kernel alone {kernel_ms:.3f}, bound_ms="
        f"{bound_ms:.3f} ({bound_by}, one TF32 pass; {100 * bound_ms / kernel_ms:.1f}% of it "
        f"for the kernel; three-pass floor {floors['tensor_floor_3_passes_ms']:.3f}, minima "
        f"write {floors['minima_write_ms']:.3f}, exact-chain fp32 FMA figure "
        f"{floors['exact_chain_fma_ms']:.3f}) plain_ms={plain_ms:.1f} | library_ms="
        f"{library_ms:.3f} (cdist + topk over all {Q} queries in {C}-query chunks, summed) | "
        f"on {C} queries: cdist + topk {library_slice_ms:.3f} bucket_topk {slice_ms:.3f}")
    log("[kernels]   planted faults: "
        + ", ".join(f"{name} {m} mismatches" for name, m in fault_mm.items())
        + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
    result = dict(
        kernel="bucket_topk", label=f"core kNN candidate, Q = R = {Q}", shape=[Q, Q, 8, k, nb],
        dtype="float32", max_abs_err=float(mm_min + mm_topk), mismatches=mm_min + mm_topk,
        compared=C, distances_equal=d_equal, fault_mismatches=fault_mm, ok=ok, ms=ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, library_queries=Q,
        library_chunk=C, library_slice_ms=library_slice_ms,
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
            "library_chunk", "library_slice_ms", "library_kernel_ms", "rechecks_per_query"),
    "fused_ln": ("label", "shape", "dtype", "eps", "max_abs_err", "err", "err_unit", "limit",
                 "differ_share", "fault_errs", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms"),
    "bucket_topk": ("label", "shape", "mismatches", "compared", "distances_equal",
                    "fault_mismatches", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_queries", "library_chunk", "library_slice_ms",
                    "library_kernel_ms", "rechecks_per_pair"),
}
CASE_KEYS["flash_attention_fused"] = CASE_KEYS["flash_attention"]
CASE_KEYS["flash_attention_hiera"] = CASE_KEYS["flash_attention"] + (
    "graph_ms", "library_graph_ms", "calls_per_set_image", "library_backend")
CASE_KEYS["flash_attention_hiera_d56"] = CASE_KEYS["flash_attention_hiera"]
CASE_KEYS["flash_attention_hiera_d96"] = CASE_KEYS["flash_attention_hiera"]
CASE_KEYS["conv3x3"] = ("label", "shape", "tile", "max_abs_err", "cudnn_err", "limit",
                        "fault_errs", "byte_equal", "shrink", "slot_shrink", "ms", "bound_ms",
                        "bound_by", "share", "plain_ms", "library_ms", "tf32_ms", "tile_ms")
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
    "flash_attention_hiera": "one SAM2ImagePredictor.set_image of sam2_hiera_l at 1024 px "
                             "(the flash_attention wrapper's count: fp32, head dim 72, "
                             "every Hiera attention)",
    "flash_attention_hiera_d56": "one SAM2ImagePredictor.set_image of sam2_hiera_b_plus at "
                                 "1024 px (fp32, head dim 56)",
    "flash_attention_hiera_d96": "one SAM2ImagePredictor.set_image each of sam2_hiera_t and "
                                 "sam2_hiera_s at 1024 px (fp32, head dim 96)",
    "conv3x3": "one forward of the iggt.fwd.8x518 cell's model (IGGT, 8 views 518x518); "
               "launches_vggt: of the vggt.fwd.64x504 cell's (64 views 504x336)",
}


def kernels_summary(results, launches, extra):
    out = []
    for kernel in ("flash_attention", "flash_attention_fused", "qk_prep", "nn1", "fused_ln",
                   "bucket_topk", "flash_attention_hiera", "flash_attention_hiera_d56",
                   "flash_attention_hiera_d96", "conv3x3"):
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
            "max_abs_err": max(r["max_abs_err"] for r in cases if "max_abs_err" in r),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **{k: main[k] for k in ("library_queries", "library_chunk", "library_slice_ms",
                                    "library_kernel_ms", "kernel_ms",
                                    "rechecks_per_query", "rechecks_per_pair",
                                    "probe_error_units",
                                    "device_ms", "library_device_ms", "turns_ms",
                                    "library_turns_ms")
               if k in main},
            "cases": [{k: r[k] for k in CASE_KEYS[kernel] if k in r} for r in cases],
        })
        if kernel.startswith("flash_attention_hiera"):
            out[-1]["wrapper"] = "flash_attention"
        if kernel == "flash_attention" and "flash_attention_train" in launches:
            out[-1]["launches_train"] = launches["flash_attention_train"]
            out[-1]["launches_train_from"] = (
                f"the training cell's {TRAIN_STEPS} steps (app/train.py, 1 x 4 views 518x392): "
                "the part head's cross-attention through attention_train, the kernel's "
                "forward with the plain version's backward")
        if kernel == "flash_attention_hiera" and "flash_attention_hiera_video" in launches:
            out[-1]["launches_sam2_video"] = launches["flash_attention_hiera_video"]
        if kernel in ("flash_attention", "flash_attention_fused", "qk_prep") and \
                "parallel_all-gather" in launches:
            out[-1]["launches_parallel"] = {route: launches[f"parallel_{route}"][kernel]
                                            for route in PARALLEL_LAUNCHES}
            out[-1]["launches_parallel_from"] = (
                "one full-width 8 x 518 forward on a one-rank NCCL mesh per global route "
                "(parallel/attention.py)")
        if kernel in ("flash_attention", "flash_attention_fused") and "modules" in launches:
            out[-1]["launches_modules"] = {label: counts[kernel]
                                           for label, counts in launches["modules"].items()}
            out[-1]["launches_modules_from"] = (
                "the modules phase: one call of each full-width SwiGLU block, and one 8 x 518 "
                "forward through IGGTProcessor with RuntimeConfig(use_flash_attention=False)")
        if kernel == "conv3x3" and "conv3x3_vggt" in launches:
            out[-1]["launches_vggt"] = launches["conv3x3_vggt"]
            out[-1]["max_abs_err_is"] = "largest gap over the largest float64 value"
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
                size=(640, 480), sky: bool = False) -> str:
    """Synthetic seeded views (``size`` = (W, H)): smooth random colour fields
    plus noise; with ``gt`` also ground truth as the demo reads it, per view
    a 16-bit depth PNG in millimetres (a smooth surface at 1-5 m) under
    ``depth/`` and an npz with a camera-to-world ``pose`` (a random rotation
    and translation) and pinhole ``intrinsics`` under ``cam/``; with ``sky``
    the top 20% of every view is a smooth daylight-blue band without noise,
    which `utils/sky.py::segment_sky_heuristic` takes for sky."""
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
        if sky:
            band = int(0.2 * H)
            t = np.linspace(0.0, 1.0, band, dtype=np.float32)[:, None, None]
            img[:band] = np.round(np.array([110, 160, 232], np.float32)
                                  + t * np.array([40, 30, 10], np.float32)).astype(np.uint8)
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
    """Warm-up, then one request with the launch counts set to 0 just before
    and read just after, and its peak memory; returns (its results, counts,
    peak GiB, wall s)."""
    import torch

    proc.process_scene(scene, out_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    results = proc.process_scene(scene, out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return results, counts, peak, wall


def run_requests(launches_out: dict, extra: dict, phases=("batch_eval",)) -> bool:
    """The three requests through `IGGTProcessor.process_scene` (the 3-view
    scene with seeded ground truth), then the two fast modes at 8 views
    518x518 on the same weights and images: `RuntimeConfig(fused_ln=True)` and
    `head_dtype="bfloat16"`, with the bare forwards of all three timed in
    turns.  The last request's backfill inputs go through the nn1 kernel once
    more for its rechecks per query (``extra["nn1_request_backfill"]``).  With
    "batch_eval" in ``phases``, `run_batch_eval` runs on this processor."""
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
                ok &= forward_fingerprint(proc, x, label, extra)
                ok &= run_mask_sky(proc, tmp, S, (W, H))
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
        if "batch_eval" in phases:
            ok &= run_batch_eval(proc, tmp, launches_out)
        ok &= run_merged_request(proc, scene, x, tmp, base_preds, launches_out)
        ok &= run_long_sequence(proc.model)
        ok &= run_track_forward(proc, x)
    return ok


FINGERPRINT_KEYS = ("depth", "world_points", "part_feat")


def forward_fingerprint(proc, x, label: str, extra: dict) -> bool:
    """SHA-256 of the bytes of the exact forward's depth, world_points and
    part_feat (in that order), for two forwards of the same images: they must
    be equal.  The digest goes into the log (and ``extra``), so that a later
    run whose exact path reads other bytes on the same weights and images
    shows at once."""
    import hashlib

    import torch

    digests = []
    with torch.inference_mode():
        for _ in range(2):
            out = proc.model(x)
            whole, parts = hashlib.sha256(), {}
            for k in FINGERPRINT_KEYS:
                b = out[k].contiguous().cpu().numpy().tobytes()
                whole.update(b)
                parts[k] = hashlib.sha256(b).hexdigest()[:16]
            digests.append((whole.hexdigest(), parts))
            del out
    ok = digests[0] == digests[1]
    extra["fingerprint"] = digests[0][0]
    log(f"[requests]   exact-forward fingerprint ({label}, seed {SEED}; sha256 of "
        f"{' + '.join(FINGERPRINT_KEYS)}): {digests[0][0]} "
        f"({', '.join(f'{k} {v}' for k, v in digests[0][1].items())}); second forward "
        f"{'equal' if ok else 'DIFFERS: ' + digests[1][0]}")
    return ok


def glb_point_count(path: str) -> int:
    """POSITION count of a GLB's first mesh (the point cloud)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    length, kind = struct.unpack_from("<II", data, 12)
    if kind != 0x4E4F534A:   # "JSON"
        raise ValueError(f"{path}: no JSON chunk first")
    doc = json.loads(data[20:20 + length])
    return doc["accessors"][doc["meshes"][0]["primitives"][0]["attributes"]["POSITION"]]["count"]


def run_mask_sky(proc, tmp: str, S: int, size) -> bool:
    """The demo's --mask_sky on an S-view scene with a smooth blue band along
    the top (`write_scene(sky=True)`): a request without the flag, one with
    it (which writes sky_masks/), and a second one with it, which must read
    the masks back and segment nothing.  The GLB's confidence filter keeps
    the points at or above the conf_threshold percentile (the JAX package's
    rule), a fixed share: so with the flag the rgb GLB must hold no sky
    pixel's point and as many points as that rule leaves from the masked
    confidence, while without it sky points are kept."""
    from iggt_official_tpu_torch.config import RuntimeConfig
    from iggt_official_tpu_torch.utils import sky

    W, H = size
    scene = write_scene(tmp, S, SEED + 20, sky=True)
    runs, walls, problems = {}, {}, []
    for flag in (False, True):
        proc.runtime = RuntimeConfig(image_size=(W, H), mask_sky=flag)
        out_dir = os.path.join(tmp, f"out_sky_{flag}")
        got = {}
        walls[flag] = wall_s(lambda: got.update(proc.process_scene(scene, out_dir)))
        runs[flag] = (got["predictions"], out_dir)
    mask_dir = os.path.join(scene, "sky_masks")
    written = sorted(os.listdir(mask_dir)) if os.path.isdir(mask_dir) else []
    if len(written) != S:
        problems.append(f"sky_masks/ holds {written}")
    calls = []
    segment = sky.segment_sky_heuristic
    sky.segment_sky_heuristic = lambda image: calls.append(1) or segment(image)
    try:
        again = wall_s(lambda: proc.process_scene(scene, os.path.join(tmp, "out_sky_again")))
    finally:
        sky.segment_sky_heuristic = segment
    if calls:
        problems.append(f"the second --mask_sky request segmented {len(calls)} views again")
    keep = sky.load_or_compute_sky_masks(scene, (H, W))
    share = 1.0 - float(keep.mean())
    counts = {}
    for flag, (preds, out_dir) in runs.items():
        conf = preds["world_points_conf"] * (keep if flag else 1.0)
        kept = conf >= np.percentile(conf, proc.runtime.conf_threshold * 100)
        glb = glb_point_count(os.path.join(out_dir, "scene_rgb.glb"))
        counts[flag] = (glb, int((kept & (keep == 0)).sum()))
        if glb != int(kept.sum()):
            problems.append(f"mask_sky={flag}: GLB holds {glb} points, the rule keeps "
                            f"{int(kept.sum())}")
    if counts[True][1] != 0 or counts[False][1] == 0 or not 0 < share < 0.3:
        problems.append(f"sky points kept (without, with the flag) "
                        f"{counts[False][1]}, {counts[True][1]}; sky share {share:.3f}")
    log(f"[requests] --mask_sky, {S} views {W}x{H} with a sky band: sky share "
        f"{share:.4f}; rgb GLB points without / with the flag {counts[False][0]} / "
        f"{counts[True][0]} (a fixed percentile of confidence), of them sky pixels "
        f"{counts[False][1]} / {counts[True][1]}; sky_masks/ written ({len(written)} files) "
        f"and read back by the next request ({len(calls)} views segmented again); requests "
        f"{walls[False]:.3f} / {walls[True]:.3f} / {again:.3f} s; "
        f"{'ok' if not problems else problems}")
    return not problems


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

# ---------------------------------------------------------------------------
# phase 7: SAM2 (Hiera-L image path, the automatic mask generator) and the
# demo's --mask_sky request

HIERA_CASES = (
    # (label, windows B', query tokens Nq, keys Nk, heads H, calls per
    # set_image) of `sam2_hiera_l` at 1024 px, head dim 72 everywhere; the
    # q-pool blocks attend 2x2-pooled queries over their window's keys
    ("blocks 0-1, window 8", 1024, 64, 64, 2, 2),
    ("block 2, q-pool, window 8", 1024, 16, 64, 4, 1),
    ("blocks 3-7, window 4", 1024, 16, 16, 4, 5),
    ("block 8, q-pool, window 4", 1024, 4, 16, 8, 1),
    ("blocks 9-43 windowed, window 16", 16, 256, 256, 8, 32),
    ("blocks 23, 33, 43, global", 1, 4096, 4096, 8, 3),
    ("block 44, q-pool, window 16", 16, 64, 256, 16, 1),
    ("blocks 45-47, window 8", 16, 64, 64, 16, 3),
)
HIERA_D = 72
HIERA_ITERS = 50
HIERA_MAIN_CASE = "blocks 23, 33, 43, global"
# the other presets' head dims: Hiera-B+ 112 / 2 = 56, Hiera-T and -S 96 / 1
HIERA_PRESETS = {"t": "sam2_hiera_t", "s": "sam2_hiera_s", "b+": "sam2_hiera_b_plus"}
HIERA_PRESET_KERNEL = {56: "flash_attention_hiera_d56", 96: "flash_attention_hiera_d96"}


def hiera_cases(cfg, image_size: int = 1024):
    """Hiera's attention calls in one `set_image` at ``image_size`` px, by
    shape: {(B', Nq, Nk, H, D): [label, calls]}, as `sam2.hiera.Hiera` builds
    its blocks (the q-pool block at a stage boundary keeps the previous
    stage's window, pools 2x2 queries, and has the new stage's width and
    heads; windows pad the grid to a whole number of windows)."""
    h = cfg.hiera
    stage_ends = [sum(h.stages[: i + 1]) - 1 for i in range(len(h.stages))]
    q_pool_blocks = [e + 1 for e in stage_ends[:-1]][: h.q_pool]
    grid = image_size // 4
    dim, heads, stage = h.embed_dim, h.num_heads, 1
    out = {}
    for i in range(sum(h.stages)):
        window = 0 if h.global_att_blocks and i in h.global_att_blocks else h.window_spec[stage - 1]
        if i - 1 in stage_ends:
            dim, heads, stage = int(dim * h.dim_mul), int(heads * h.head_mul), stage + 1
        pool = i in q_pool_blocks
        if window:
            B, Nk = (-(-grid // window)) ** 2, window * window
            Nq = (window // 2) ** 2 if pool else Nk
        else:
            B, Nk = 1, grid * grid
            Nq = (grid // 2) ** 2 if pool else Nk
        key = (B, Nq, Nk, heads, dim // heads)
        what = ("global" if not window else f"window {window}") + (", q-pool" if pool else "")
        entry = out.setdefault(key, [what, 0])
        entry[1] += 1
        if pool:
            grid //= 2
    return out


def hiera_preset_cases():
    """{D: cases} for the presets other than L at 1024 px, cases in
    `check_hiera_kernels`' form with the calls per `set_image` of each
    preset ({preset: calls}): D = 96 (T and S share their eight shapes),
    D = 56 (B+)."""
    from iggt_official_tpu_torch.sam2 import config as sam2_config

    by_d = {}
    for preset, factory in HIERA_PRESETS.items():
        for (B, Nq, Nk, H, D), (label, calls) in hiera_cases(
                getattr(sam2_config, factory)("2.1")).items():
            entry = by_d.setdefault(D, {}).setdefault((B, Nq, Nk, H), [label, {}])
            entry[1][preset] = calls
    return {D: tuple((label, B, Nq, Nk, H, calls)
                     for (B, Nq, Nk, H), (label, calls) in shapes.items())
            for D, shapes in sorted(by_d.items())}


def sdpa_backend(q, k, v) -> str:
    """The SDPA backend that PyTorch's dispatcher picks for (q, k, v)."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v)).name


def check_hiera_kernels(D: int = HIERA_D, cases=HIERA_CASES,
                        kernel: str = "flash_attention_hiera"):
    """The fp32 flash kernel at each of Hiera's attention shapes at head dim
    ``D`` (72: Hiera-L's, `HIERA_CASES`; 56 and 96: `hiera_preset_cases`):
    q, k, v as the strided views of one packed qkv that `MultiScaleAttention`
    hands over (the pooled q of a q-pool block a new contiguous tensor),
    against `flash_attention_plain` within FP32_ABS, max|ref| beside the
    limit.  Planted faults of the kernel (`flash_attention.HIERA_FAULTS`)
    must each exceed the limit: the softmax scale of the panels' padded head
    dim (1/sqrt(64) at D = 56, 1/sqrt(96) at D = 72; D = 96 pads nothing),
    V's last 8 head-dim columns dropped, the last key tile dropped (where
    Nk > 64) or one key past Nk admitted.  Time per call
    against the bound and SDPA on the same fp32 tensors (with the backend the
    dispatcher picks), read twice: CUDA events over HIERA_ITERS back-to-back
    wrapper calls (host work included where it sets the pace) and the
    replay of HIERA_ITERS calls captured in one CUDA graph (no host work
    between launches).  The calls per `set_image` are filled in by
    `run_sam2`, which counts them."""
    import torch
    import torch.nn.functional as F

    from iggt_official_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + D)
    results = []
    for label, B, Nq, Nk, H, calls in cases:
        qkv = torch.randn((B, Nk, 3, H, D), generator=gen, device=dev)
        q, k, v = qkv.unbind(2)
        if Nq != Nk:   # 2x2 max-pool of the window's queries, as the q-pool blocks do
            side = int(round(Nk ** 0.5))
            q = F.max_pool2d(q.reshape(B, side, side, H * D).permute(0, 3, 1, 2), 2)
            q = q.permute(0, 2, 3, 1).reshape(B, Nq, H, D).contiguous()

        def run_kernel():
            return fa.flash_attention(q, k, v)

        def run_plain():
            return fa.flash_attention_plain(q, k, v)

        qp, kp, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def run_library():
            return F.scaled_dot_product_attention(qp, kp, vt)

        skip = {"last key tile dropped" if Nk <= KEY_TILE else "one key past Nk admitted"}
        if D % 32 == 0:
            skip.add("softmax scale of the padded head dim")
        faults = {name: (lambda bit=name: fa._launch(q, k, v, fault=bit))
                  for name in fa.HIERA_FAULTS if name not in skip}
        out = run_kernel()
        torch.cuda.synchronize()
        ref = run_plain()
        ref_max = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all().item())
        fault_errs = {name: (fn() - ref).abs().max().item() for name, fn in faults.items()}
        caught = all(e > FP32_ABS for e in fault_errs.values())
        ms = time_ms(run_kernel, iters=HIERA_ITERS)
        plain_ms = time_ms(run_plain, iters=3, warmup=1)
        library_ms = time_ms(run_library, iters=HIERA_ITERS)
        kernel_graph_ms = graph_ms(run_kernel, HIERA_ITERS)
        library_graph_ms = graph_ms(run_library, HIERA_ITERS)
        backend = sdpa_backend(qp, kp, vt)
        bound_ms, bound_by, fma_ms = attention_bound_ms(B, Nq, Nk, H, D, "float32")
        ok = finite and err <= FP32_ABS and caught
        log(f"[sam2] flash_attention D={D} {label:32s} q {(B, Nq, H, D)} k/v {(B, Nk, H, D)} "
            f"x{calls} max_abs_err={err:.3e} (limit {FP32_ABS:.0e}, max|ref| {ref_max:.3e}) "
            f"{'ok' if ok else 'FAIL'} | ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
            f"{100 * bound_ms / ms:.1f}% of the bound; fp32 FMA figure {fma_ms:.4f}) "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA fp32: {backend}) | "
            f"CUDA graph of {HIERA_ITERS} calls, per call: kernel {kernel_graph_ms:.4f} ms, "
            f"SDPA {library_graph_ms:.4f} ms")
        log(f"[sam2]   planted faults: "
            + ", ".join(f"{name} err {e:.3e} ({e / FP32_ABS:.1f}x limit)"
                        for name, e in fault_errs.items())
            + (" -- all caught" if caught else " -- NOT ALL CAUGHT"))
        results.append(dict(
            kernel=kernel, label=label, shape=[B, Nq, Nk, H, D],
            dtype="float32", key_bias=False, calls_per_set_image=calls, max_abs_err=err,
            limit=FP32_ABS, max_abs_ref=ref_max, fault_errs=fault_errs, ok=ok, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, library_backend=backend,
            graph_ms=kernel_graph_ms, library_graph_ms=library_graph_ms,
            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms))
        del qkv, q, k, v, out, ref
    torch.cuda.empty_cache()
    return results


SAM2_TOL = 1e-3          # card (kernels) vs CPU (plain versions), and kernel vs plain
                         # attention inside the full-width encoder: fp32, summation
                         # order only (TF32 off), relative to max|ref|
SAM2_IMAGE = (960, 1280)  # (H, W) of the full-width request's image
SAM2_SET_IMAGE_RUNS = 3
SAM2_OBJ_BIAS = 8.0


def sam2_image(seed: int = SEED, hw=SAM2_IMAGE) -> np.ndarray:
    """A seeded RGB uint8 image: a smooth colour field with flat rectangles
    and ellipses (objects for the mask generator), light noise."""
    from PIL import Image

    H, W = hw
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(40, 215, (4, 5, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((W, H), Image.BICUBIC), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(6):
        cy, cx = rng.uniform(0.15, 0.85) * H, rng.uniform(0.15, 0.85) * W
        ry, rx = rng.uniform(0.06, 0.18) * H, rng.uniform(0.06, 0.18) * W
        colour = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            inside = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img[inside] = colour
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


def sam2_heads(model, feats, prompt):
    """Multimask logits, IoUs and object score of one prompt on features
    ``feats`` (forward_image's dict), as the predictor runs them."""
    from iggt_official_tpu_torch.sam2.base import high_res_features

    out = model.forward_sam_heads(feats["backbone_fpn"][-1], prompt, None,
                                  high_res_features(feats, model.cfg), True)
    return out[0], out[2], out[6]


def check_sam2_agreement() -> bool:
    """`SAM2Config().scaled(embed_dim=72)` (head dim 72 at every stage, so the
    card runs the D = 72 kernel) with the same seeded weights on the card and
    on the CPU: backbone_fpn, and the decoder's multimask logits, IoUs and
    object score for a point and for a box prompt, within SAM2_TOL."""
    import torch

    from iggt_official_tpu_torch.sam2.build import build_sam2
    from iggt_official_tpu_torch.sam2.config import SAM2Config

    cfg = SAM2Config().scaled(embed_dim=72)
    cpu = build_sam2(cfg, device="cpu", seed=SEED)
    card = build_sam2(cfg, device="cuda", seed=SEED)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    prompts = {"point": {"point_coords": torch.tensor([[[40.0, 21.0]]]),
                         "point_labels": torch.tensor([[1]], dtype=torch.int32)},
               "box": {"point_coords": torch.tensor([[[8.0, 10.0], [50.0, 44.0]]]),
                       "point_labels": torch.tensor([[2, 3]], dtype=torch.int32)}}
    from iggt_official_tpu_torch.ops import flash_attention as fa

    errs = {}
    with torch.inference_mode():
        zero_counts()
        feats = {d: m.forward_image(x.to(d)) for d, m in (("cpu", cpu), ("cuda", card))}
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        for i, (ref, out) in enumerate(zip(feats["cpu"]["backbone_fpn"],
                                           feats["cuda"]["backbone_fpn"])):
            errs[f"backbone_fpn[{i}]"] = rel_err(ref, out)
        for name, prompt in prompts.items():
            ref = sam2_heads(cpu, feats["cpu"], prompt)
            out = sam2_heads(card, feats["cuda"], {k: v.cuda() for k, v in prompt.items()})
            for key, a, b in zip(("logits", "ious", "object score"), ref, out):
                errs[f"{name} {key}"] = rel_err(a, b)
    ok = all(e <= SAM2_TOL for e in errs.values()) and launches == sum(cfg.hiera.stages)
    log(f"[sam2] scaled SAM2 (embed 72, head dim 72) card vs CPU, same weights: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (limit {SAM2_TOL:.0e} of max|ref|); flash launches {launches} "
        f"(want {sum(cfg.hiera.stages)}) {'ok' if ok else 'FAIL'}")
    return ok


def counted_set_image(pred, image):
    """One `set_image` with the launch counts set to 0 just before it: (wall
    s, the counts after it, flash launches by attention shape (B', Nq, Nk,
    H)): each of Hiera's calls reads the wrapper's count before and after."""
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.sam2 import hiera

    per_shape = collections.Counter()

    def counted_attention(q, k, v):
        before = fa.flash_attention.launches
        out = fa.attention(q, k, v)
        per_shape[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])] += (
            fa.flash_attention.launches - before)
        return out

    hiera.attention = counted_attention
    try:
        zero_counts()
        wall = wall_s(lambda: pred.set_image(image))
        launches = read_counts()
    finally:
        hiera.attention = fa.attention
    return wall, launches, per_shape


def per_image_ms(rows, calls) -> str:
    """The Hiera rows' times summed over one `set_image`: each row's ms times
    its launches there (``calls(row)``), for the kernel (events, graph), the
    bound, the plain version and SDPA (events, graph)."""
    keys = ("ms", "graph_ms", "bound_ms", "plain_ms", "library_ms", "library_graph_ms")
    tot = {k: sum(r[k] * calls(r) for r in rows) for k in keys}
    return (f"per set_image (launches x ms): kernel {tot['ms']:.3f} (graph "
            f"{tot['graph_ms']:.3f}), bound {tot['bound_ms']:.3f}, plain {tot['plain_ms']:.3f}, "
            f"SDPA {tot['library_ms']:.3f} (graph {tot['library_graph_ms']:.3f})")


def plain_backbone_errors(pred, image):
    """`set_image` again with Hiera's attention on `flash_attention_plain`:
    (wall s, backbone_fpn's relative errors of the kernel's against it)."""
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.sam2 import hiera

    kernel_fpn = [f.clone() for f in pred._features["backbone_fpn"]]
    hiera.attention = lambda q, k, v: fa.flash_attention_plain(q, k, v)
    try:
        plain_s = wall_s(lambda: pred.set_image(image))
        errs = [rel_err(a, b) for a, b in zip(pred._features["backbone_fpn"], kernel_fpn)]
    finally:
        hiera.attention = fa.attention
    return plain_s, errs


def run_sam2_presets(launches_out: dict, preset_results=()) -> bool:
    """`set_image` of the full-width Hiera-T, -S and -B+ image predictors
    (random weights from the seed, 1024 px) on the seeded image: flash
    launches per `set_image` (the sum of the preset's stages: 12, 16, 24),
    split by attention shape, which must be `hiera_cases`'; the split fills
    ``preset_results``' calls per `set_image`, the counts the D = 56 (B+)
    and D = 96 (T + S) rows' launches; backbone_fpn against the same model
    with Hiera's attention on the plain version within SAM2_TOL."""
    import torch

    from iggt_official_tpu_torch.sam2 import config as sam2_config
    from iggt_official_tpu_torch.sam2.build import build_sam2_image_predictor

    image = sam2_image()
    ok = True
    for preset, factory in HIERA_PRESETS.items():
        cfg = getattr(sam2_config, factory)("2.1")
        pred = build_sam2_image_predictor(cfg, device="cuda", seed=SEED)
        pred.set_image(image)                 # warm-up
        wall, launches, per_shape = counted_set_image(pred, image)
        want = {k[:4]: v[1] for k, v in hiera_cases(cfg).items()}
        D = cfg.hiera.embed_dim // cfg.hiera.num_heads
        kernel = HIERA_PRESET_KERNEL[D]
        for r in preset_results:
            if r["kernel"] == kernel:
                B, Nq, Nk, H, _ = r["shape"]
                r["calls_per_set_image"][preset] = per_shape.get((B, Nq, Nk, H), 0)
        launches_out[kernel] = launches_out.get(kernel, 0) + launches["flash_attention"]
        plain_s, errs = plain_backbone_errors(pred, image)
        problems = []
        if dict(per_shape) != want:
            problems.append(f"launches by shape {dict(per_shape)}, want {want}")
        if launches["flash_attention"] != sum(cfg.hiera.stages) or launches[
                "flash_attention_fused"]:
            problems.append(f"launches {launches}, want flash {sum(cfg.hiera.stages)}")
        if max(errs) > SAM2_TOL:
            problems.append(f"kernel vs plain attention backbone_fpn {errs}")
        ok &= not problems
        rows = [r for r in preset_results if r["kernel"] == kernel]
        log(f"[sam2] {factory}(\"2.1\") (head dim {D}) set_image {wall:.4f} s, flash "
            f"launches {launches['flash_attention']} (want {sum(cfg.hiera.stages)}; by "
            "(B', Nq, Nk, H): " + ", ".join(f"{k} x{v}" for k, v in sorted(per_shape.items()))
            + f"); with plain attention {plain_s:.4f} s, backbone_fpn kernel vs plain "
            + ", ".join(f"{e:.2e}" for e in errs)
            + f" (limit {SAM2_TOL:.0e} of max|ref|); "
            + per_image_ms(rows, lambda r: r["calls_per_set_image"][preset])
            + f"; {'ok' if not problems else problems}")
        del pred
        torch.cuda.empty_cache()
    return ok


def run_sam2(launches_out: dict, hiera_results=()) -> bool:
    """The full-width SAM2 image path on the card: `build_sam2_image_predictor(
    sam2_hiera_l("2.1"), device="cuda", seed=SEED)` on a seeded 1280 x 960
    image: `set_image` (median of SAM2_SET_IMAGE_RUNS, 48 flash launches
    counted on the first, and split by attention shape (B', Nq, Nk, H): each
    of Hiera's calls reads the wrapper's count before and after, and the
    split must be HIERA_CASES'; it goes into ``hiera_results``' calls per
    `set_image`), `predict` with a point and with a box, the
    automatic mask generator with its defaults and once with both
    thresholds at 0 (so NMS, boxes and RLE run on every mask; random weights
    score no object, so for this run the object-score head's output bias is
    raised by SAM2_OBJ_BIAS and the masks are not the empty NO_OBJ_SCORE
    ones), peak memory;
    then `set_image` with Hiera's attention on `flash_attention_plain` on the
    card, whose backbone_fpn must agree with the kernel's within SAM2_TOL."""
    import torch

    from iggt_official_tpu_torch.sam2.amg import SAM2AutomaticMaskGenerator, rle_to_mask
    from iggt_official_tpu_torch.sam2.build import build_sam2_image_predictor
    from iggt_official_tpu_torch.sam2.config import sam2_hiera_l

    cfg = sam2_hiera_l("2.1")
    t0 = time.time()
    pred = build_sam2_image_predictor(cfg, device="cuda", seed=SEED)
    if {k[:4]: v[1] for k, v in hiera_cases(cfg).items()} != {
            (B, Nq, Nk, H): n for _, B, Nq, Nk, H, n in HIERA_CASES}:
        log("[sam2] HIERA_CASES differ from hiera_cases(sam2_hiera_l)")
        return False
    n_params = sum(p.numel() for p in pred.model.parameters())
    log(f"[sam2] full-width sam2_hiera_l(\"2.1\"): {n_params / 1e6:.1f} M parameters "
        f"(fp32), built in {time.time() - t0:.1f} s; image {SAM2_IMAGE[1]}x{SAM2_IMAGE[0]}, "
        f"model resolution {cfg.image_size}")
    image = sam2_image()
    problems = []
    pred.set_image(image)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, launches, per_shape = counted_set_image(pred, image)
    walls = [walls]
    want_split = {(B, Nq, Nk, H): calls for _, B, Nq, Nk, H, calls in HIERA_CASES}
    if dict(per_shape) != want_split:
        problems.append(f"set_image launches by shape {dict(per_shape)}, want {want_split}")
    for r in hiera_results:
        B, Nq, Nk, H, _ = r["shape"]
        r["calls_per_set_image"] = per_shape.get((B, Nq, Nk, H), 0)
    walls += [wall_s(lambda: pred.set_image(image)) for _ in range(SAM2_SET_IMAGE_RUNS - 1)]
    want = sum(c[-1] for c in HIERA_CASES)
    if launches["flash_attention"] != want or launches["flash_attention_fused"]:
        problems.append(f"set_image launches {launches}, want flash {want}")
    launches_out["flash_attention_hiera"] = launches["flash_attention"]
    feats = pred._features["backbone_fpn"]
    shapes = [tuple(f.shape) for f in feats]
    if not all(bool(torch.isfinite(f).all()) for f in feats):
        problems.append("non-finite backbone features")

    H, W = SAM2_IMAGE
    point = (np.array([[0.5 * W, 0.5 * H]]), np.array([1]))
    box = np.array([0.25 * W, 0.25 * H, 0.7 * W, 0.8 * H])
    t = {}
    res = {}
    t["predict point"] = wall_s(lambda: res.__setitem__("point", pred.predict(*point)))
    t["predict box"] = wall_s(lambda: res.__setitem__("box", pred.predict(box=box)))
    for name, (masks, ious, low) in res.items():
        if (masks.shape != (3, H, W) or masks.dtype != bool or ious.shape != (3,)
                or not np.isfinite(ious).all() or not np.isfinite(low).all()):
            problems.append(f"predict {name}: masks {masks.shape} {masks.dtype}, ious {ious}")
    amg_counts = {}
    obj_bias = pred.model.sam_mask_decoder.pred_obj_score_head.layers[-1].bias
    for label, kw in (("defaults", {}),
                      ("thresholds 0", dict(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                                            output_mode="uncompressed_rle"))):
        amg = SAM2AutomaticMaskGenerator(pred, **kw)
        out = []
        if kw:
            obj_bias += SAM2_OBJ_BIAS
        try:
            t[f"AMG {label}"] = wall_s(lambda: out.extend(amg.generate(image)))
        finally:
            if kw:
                obj_bias -= SAM2_OBJ_BIAS
        amg_counts[label] = f"{len(out)} ({sum(r['area'] > 0 for r in out)} non-empty)"
        for r in out[:50]:
            seg = r["segmentation"]
            area = int(seg.sum()) if isinstance(seg, np.ndarray) else int(rle_to_mask(seg).sum())
            if area != r["area"]:
                problems.append(f"AMG {label}: area {r['area']} vs its mask's {area}")
                break
    if not any(r["area"] > 0 for r in out):
        problems.append("the AMG with thresholds 0 kept no non-empty mask")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    plain_s, errs = plain_backbone_errors(pred, image)
    if max(errs) > SAM2_TOL:
        problems.append(f"kernel vs plain attention backbone_fpn {errs}")
    ok = not problems
    log(f"[sam2] set_image {float(np.median(walls)):.4f} s (median of {len(walls)}: "
        + ", ".join(f"{w:.4f}" for w in walls) + f"); flash launches per set_image "
        f"{launches['flash_attention']} (want {want}; by (B', Nq, Nk, H): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(per_shape.items()))
        + f"); {per_image_ms(hiera_results, lambda r: r['calls_per_set_image'])}; "
        f"backbone_fpn {shapes}; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
        + f"; AMG masks: defaults {amg_counts['defaults']}, thresholds 0 "
        f"{amg_counts['thresholds 0']}; peak {peak:.2f} GiB allocated")
    log(f"[sam2] set_image with Hiera's attention on flash_attention_plain: {plain_s:.4f} s; "
        f"backbone_fpn kernel vs plain " + ", ".join(f"{e:.2e}" for e in errs)
        + f" (limit {SAM2_TOL:.0e} of max|ref|); {'ok' if ok else problems}")
    del pred
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 8: SAM2 video propagation at full width

VIDEO_FRAMES = 25
VIDEO_SIZE = 1024
VIDEO_POINTS = ((0.5, 0.5), (0.25, 0.3))   # each object's click, as fractions of (W, H)
VIDEO_PLAIN_FRAMES = 4
VIDEO_STREAM_TOL = (1e-4, 2e-4)             # rtol / atol of batch against streaming masks


def prompt_video(pred, state, frames) -> None:
    """A clean session: no cached features, no prompts; then one positive
    click per object on frame 0."""
    state["cached_features"].clear()
    pred.reset_state(state)
    H, W = frames[0].shape[:2]
    for obj, (fx, fy) in enumerate(VIDEO_POINTS, start=1):
        pred.add_new_points_or_box(state, frame_idx=0, obj_id=obj,
                                   points=np.array([[fx * W, fy * H]]), labels=np.array([1]))


def run_video(pred, state, frames, batch: bool, **kw):
    """Prompt, then propagate; (wall s, masks (T, B, H, W) on the card)."""
    import torch

    out = []

    def go():
        prompt_video(pred, state, frames)
        propagate = pred.propagate_in_video_batch if batch else pred.propagate_in_video
        out.extend(m for _, _, m in propagate(state, **kw))

    wall = wall_s(go)
    return wall, torch.stack(out)


class StepTimer:
    """CUDA-event times of the video steps, summed by part: the image encoder
    (forward_image), the memory attention, the SAM heads and the memory
    encoder, wrapped on one model instance."""

    PARTS = {"backbone": "forward_image", "heads": "forward_sam_heads",
             "memory encoder": "encode_new_memory"}

    def __init__(self, model):
        import torch

        self.model, self.events, self.handles = model, [], []
        for part, name in self.PARTS.items():
            setattr(model, name, self._wrap(getattr(model, name), part))
        starts = []

        def pre(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            starts.append(e)

        def post(*_):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(("memory attention", starts.pop(), e))

        self.handles = [model.memory_attention.register_forward_pre_hook(pre),
                        model.memory_attention.register_forward_hook(post)]

    def _wrap(self, fn, part):
        import torch

        def timed(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.events.append((part, a, b))
            return out
        return timed

    def totals_ms(self):
        import torch

        torch.cuda.synchronize()
        out = collections.defaultdict(float)
        for part, a, b in self.events:
            out[part] += a.elapsed_time(b)
        return dict(out)

    def close(self):
        for name in self.PARTS.values():
            delattr(self.model, name)
        for h in self.handles:
            h.remove()


def check_video_agreement() -> bool:
    """`SAM2Config().scaled(embed_dim=72)` video predictor on the card (the
    D = 72 flash kernel in every Hiera block) and on the CPU, same weights:
    5 seeded 48x64 frames, two objects clicked on frame 0, the masks of
    `propagate_in_video` and `propagate_in_video_batch` within SAM2_TOL of
    max|ref|."""
    import torch

    from iggt_official_tpu_torch.sam2.build import build_sam2_video_predictor
    from iggt_official_tpu_torch.sam2.config import SAM2Config

    cfg = SAM2Config().scaled(embed_dim=72)
    cpu = build_sam2_video_predictor(cfg, device="cpu", seed=SEED)
    card = build_sam2_video_predictor(cfg, device="cuda", seed=SEED)
    card.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 255, (48, 64, 3), dtype=np.uint8) for _ in range(5)]
    errs = {}
    for batch in (False, True):
        masks = {}
        for dev, pred in (("cpu", cpu), ("cuda", card)):
            state = pred.init_state(frames)
            masks[dev] = run_video(pred, state, frames, batch)[1]
        errs["batch" if batch else "streaming"] = rel_err(masks["cpu"], masks["cuda"])
    ok = all(e <= SAM2_TOL for e in errs.values())
    log(f"[sam2_video] scaled SAM2 (embed 72) video, card vs CPU, same weights, 5 frames, "
        f"2 objects: masks " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (limit {SAM2_TOL:.0e} of max|ref|) {'ok' if ok else 'FAIL'}")
    return ok


def run_sam2_video(launches_out: dict) -> bool:
    """The slice's full-width path: `build_sam2_video_predictor(sam2_hiera_l(
    "2.1"), device="cuda", seed=SEED)` on VIDEO_FRAMES seeded VIDEO_SIZE^2
    frames from the benchmark's own `load_frames`, two objects clicked on
    frame 0.  `propagate_in_video` and `propagate_in_video_batch` in turns
    (streaming, batch, batch, streaming after a warm-up of each): masks of
    the batch loop within VIDEO_STREAM_TOL of streaming's, 48 flash launches
    per encoded frame (counted on the first timed streaming run, counts set
    to 0 just before it), frames/s of each path, the per-frame split of a
    streaming run (CUDA events), peak memory; then VIDEO_PLAIN_FRAMES frames
    with Hiera's attention on the plain version, masks within SAM2_TOL of
    the kernel's; then the benchmark entry point in its own process."""
    import torch

    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.sam2 import hiera
    from iggt_official_tpu_torch.sam2.benchmark import load_frames
    from iggt_official_tpu_torch.sam2.build import build_sam2_video_predictor
    from iggt_official_tpu_torch.sam2.config import sam2_hiera_l

    cfg = sam2_hiera_l("2.1")
    pred = build_sam2_video_predictor(cfg, device="cuda", seed=SEED)
    frames = load_frames(None, VIDEO_FRAMES, VIDEO_SIZE)
    state = pred.init_state(frames)
    problems = []
    for batch in (False, True):                         # warm-up
        run_video(pred, state, frames, batch)
    torch.cuda.reset_peak_memory_stats()
    walls = {"streaming": [], "batch": []}
    masks = {}
    for i, batch in enumerate((False, True, True, False)):
        name = "batch" if batch else "streaming"
        if i == 0:
            zero_counts()
        wall, m = run_video(pred, state, frames, batch)
        if i == 0:
            launches = read_counts()
        walls[name].append(wall)
        masks.setdefault(name, m)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = sum(cfg.hiera.stages) * VIDEO_FRAMES
    if launches["flash_attention"] != want or launches["flash_attention_fused"]:
        problems.append(f"launches {launches}, want flash {want}")
    launches_out["flash_attention_hiera_video"] = launches["flash_attention"]
    T, B = masks["streaming"].shape[:2]
    if (T, B) != (VIDEO_FRAMES, len(VIDEO_POINTS)) or masks["batch"].shape != masks[
            "streaming"].shape:
        problems.append(f"masks {tuple(masks['streaming'].shape)} / "
                        f"{tuple(masks['batch'].shape)}")
    if not bool(torch.isfinite(masks["streaming"]).all()):
        problems.append("non-finite masks")
    rtol, atol = VIDEO_STREAM_TOL
    diff = (masks["batch"] - masks["streaming"]).abs()
    over = (diff > atol + rtol * masks["streaming"].abs()).sum().item()
    if over:
        problems.append(f"batch vs streaming: {over} mask logits past rtol {rtol} / atol {atol}")
    fg = (masks["streaming"] > 0).float().mean().item()

    timer = StepTimer(pred.model)
    try:
        run_video(pred, state, frames, False)
        parts = timer.totals_ms()
    finally:
        timer.close()

    kw = {"max_frame_num_to_track": VIDEO_PLAIN_FRAMES - 1}
    kernel_masks = run_video(pred, state, frames, False, **kw)[1]
    hiera.attention = lambda q, k, v: fa.flash_attention_plain(q, k, v)
    try:
        plain_masks = run_video(pred, state, frames, False, **kw)[1]
    finally:
        hiera.attention = fa.attention
    plain_err = rel_err(plain_masks, kernel_masks)
    if plain_err > SAM2_TOL:
        problems.append(f"kernel vs plain attention masks {plain_err:.3e}")
    fps = {k: VIDEO_FRAMES / float(np.median(v)) for k, v in walls.items()}
    ok = not problems
    log(f"[sam2_video] sam2_hiera_l(\"2.1\") video predictor, {VIDEO_FRAMES} frames "
        f"{VIDEO_SIZE}x{VIDEO_SIZE}, model resolution {cfg.image_size}, {B} objects: "
        + ", ".join(f"{k} {fps[k]:.2f} frames/s (runs " + ", ".join(f"{w:.3f}" for w in v)
                    + " s)" for k, v in walls.items())
        + f"; flash launches in one streaming run {launches['flash_attention']} (want {want}: "
        f"48 per encoded frame); batch vs streaming masks max |diff| {diff.max().item():.3e} "
        f"(rtol {rtol} / atol {atol}); foreground share {fg:.4f}; peak {peak:.2f} GiB "
        f"allocated; {'ok' if ok else problems}")
    log(f"[sam2_video] per-frame split of one streaming run (CUDA events, ms per frame): "
        + ", ".join(f"{k} {v / VIDEO_FRAMES:.3f}" for k, v in parts.items())
        + f"; {VIDEO_PLAIN_FRAMES} frames with Hiera's attention on flash_attention_plain: "
        f"masks kernel vs plain {plain_err:.2e} (limit {SAM2_TOL:.0e} of max|ref|)")
    del pred, state, masks
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "iggt_official_tpu_torch.sam2.benchmark", "--preset", "l",
           "--image_size", str(VIDEO_SIZE), "--size", str(VIDEO_SIZE)]
    t = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("FPS", "Total Time"))]
    if proc.returncode != 0 or len(lines) != 2:
        ok = False
        log(f"[sam2_video] benchmark exit {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"[sam2_video] python -m iggt_official_tpu_torch.sam2.benchmark --preset l "
        f"--image_size {VIDEO_SIZE} --size {VIDEO_SIZE} ({time.time() - t:.1f} s with its "
        f"start-up): " + " | ".join(lines))
    return ok


# ---------------------------------------------------------------------------
# phase 9: batch scene evaluation with its gate

BATCH_SCENES = ((3, True), (8, False))       # (views, with ground truth)
BATCH_SIZE = (504, 336)                      # (W, H)


def npz_bytes_equal(a_path: str, b_path: str) -> list:
    """The keys of two npz files whose arrays differ in dtype, shape or bytes."""
    with np.load(a_path) as a, np.load(b_path) as b:
        if sorted(a.files) != sorted(b.files):
            return ["key sets"]
        return [k for k in a.files if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                or a[k].tobytes() != b[k].tobytes()]


def run_batch_eval(proc, tmp: str, launches_out: dict) -> bool:
    """`app/batch_eval.run_scenes` on the requests phase's processor over two
    written scenes (BATCH_SCENES), after each scene through a serial
    `process_scene`: every scene's predictions.npz byte-equal to its serial
    run's, the launch counts of the batch run (set to 0 just before it)
    equal to the sum of the serial runs', summary.json written; then the
    gate against the serial outputs as goldens (must pass) and against a
    golden whose depth is scaled by 1.02 (must fail)."""
    from iggt_official_tpu_torch.app import batch_eval
    from iggt_official_tpu_torch.config import RuntimeConfig
    from iggt_official_tpu_torch.eval.gate import run_gate

    proc.runtime = RuntimeConfig(image_size=BATCH_SIZE)
    root = os.path.join(tmp, "batch_scenes")
    dirs = [write_scene(root, S, SEED + 20 + S, gt=gt) for S, gt in BATCH_SCENES]
    scenes = batch_eval.list_scenes(root)
    serial_root = os.path.join(tmp, "batch_serial")
    want = collections.Counter()
    serial_s = 0.0
    for scene in scenes:
        zero_counts()
        serial_s += wall_s(lambda: proc.process_scene(
            scene, os.path.join(serial_root, os.path.basename(scene))))
        want.update(read_counts())
    out_root = os.path.join(tmp, "batch_out")
    zero_counts()
    got = {}
    batch_s = wall_s(lambda: got.update(zip(("summary", "kept"), batch_eval.run_scenes(
        proc, scenes, out_root, keep_predictions=True))))
    counts = read_counts()
    problems = []
    for scene in scenes:
        name = os.path.basename(scene)
        bad = npz_bytes_equal(os.path.join(out_root, name, "predictions.npz"),
                              os.path.join(serial_root, name, "predictions.npz"))
        if bad:
            problems.append(f"{name}: predictions differ from serial process_scene in {bad}")
    if counts != dict(want):
        problems.append(f"launches {counts}, want the serial sum {dict(want)}")
    summary = got["summary"]
    if not os.path.exists(os.path.join(out_root, "summary.json")) or summary["num_views"] != sum(
            S for S, _ in BATCH_SCENES) or "absrel" not in summary["metrics"].get("depth", {}):
        problems.append(f"summary {summary}")
    table, passed = run_gate(got["kept"], serial_root)
    bad_root = os.path.join(tmp, "batch_golden_x1.02")
    name = os.path.basename(dirs[0])
    os.makedirs(os.path.join(bad_root, name))
    with np.load(os.path.join(serial_root, name, "predictions.npz")) as g:
        golden = {k: g[k] for k in g.files}
    golden["depth"] = golden["depth"] * np.float32(1.02)
    np.savez(os.path.join(bad_root, name, "predictions.npz"), **golden)
    bad_table, bad_passed = run_gate({name: got["kept"][name]}, bad_root)
    if not passed or bad_passed:
        problems.append(f"gate: self-goldens pass {passed}, depth x1.02 pass {bad_passed}")
    launches_out["batch_eval"] = counts
    views = summary["num_views"]
    ok = not problems
    log(f"[batch_eval] {len(scenes)} scenes ({views} views at {BATCH_SIZE[0]}x{BATCH_SIZE[1]}): batch loop "
        f"{batch_s:.3f} s ({views / batch_s:.2f} views/s end to end, summary "
        f"{summary['views_per_sec_end_to_end']:.2f}), serial process_scene {serial_s:.3f} s "
        f"({views / serial_s:.2f} views/s); launches {counts} (serial sum {dict(want)}); "
        f"predictions byte-equal to serial: {not any('differ' in p for p in problems)}; "
        f"gate against self-goldens {'PASS' if passed else 'FAIL'}, against depth x1.02 "
        f"{'PASS' if bad_passed else 'FAIL'}; {'ok' if ok else problems}")
    for line in (table + "\n" + bad_table).splitlines():
        log(f"[batch_eval]   {line}")
    return ok


# ---------------------------------------------------------------------------
# phase 11: train

TRAIN_SCALED = dict(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56,
                    patch_embed="dinov2_vitl14_reg")
TRAIN_SCALED_SHAPE = (1, 2, 56, 70)           # B, S, H, W of the card-vs-CPU step
# card vs CPU, per tensor: max |err| <= tol * max(max|g|, floor * G), G the
# largest |g| of the CPU's step, and the global relative L2 error of all the
# gradients; the loss terms and grad_norm relative.  Readings on an NVIDIA
# H100 80GB HBM3 at 700 W: fp32 worst 6.8e-3 of max|g| (six depth-head
# tensors: cuDNN's fp32 convolutions sum in another order, TF32 off), global
# L2 2.1e-6, losses 5.7e-7; bf16 worst 1.5e-2, global L2 1.8e-2, losses
# 3.2e-3 (the camera term: the card's and the CPU's bf16 matmuls round
# differently).  The bf16 loss terms are held to 1e-3, or where the bf16
# trunk itself moves a term by more (its CPU step against the fp32 trunk's,
# same weights and batch: the camera term 5.0e-3, the total 2.8e-3,
# grad_norm 3.4e-3), to that move: the two devices' bf16 roundings may not
# differ by more than bf16 rounding moves the loss.
TRAIN_GRAD_TOL = {"float32": (2e-2, 1e-5), "bfloat16": (0.1, 1e-3)}
TRAIN_GRAD_L2 = {"float32": 1e-4, "bfloat16": 0.05}
# each tensor whose max|g| is above 1e-5 G: relative L2 error.  bf16: the
# CPU test's limit against the JAX package, where it reads up to 0.111 (the
# card against the CPU: 1.9e-2); fp32: 30x the card's reading of 3.3e-4.  A
# zeroed tensor reads 1, a halved one 0.5.
TRAIN_TENSOR_L2 = {"float32": 1e-2, "bfloat16": 0.25}
TRAIN_LOSS_TOL = 1e-3
TRAIN_FRAMES, TRAIN_FRAME_SIZE = 24, (640, 480)   # the loaders' min_frames, (W, H)
TRAIN_RESOLUTION = (518, 392)
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_CURVE_STEPS, TRAIN_WARMUP = 8, 10, 10, 2
TRAIN_PROFILE_STEP = 4
# the part head's cross-attention in the cell: B*S, the 28 x 37 patch grid, heads, head dim
TRAIN_PART_ATTENTION = (4, (TRAIN_RESOLUTION[1] // 14) * (TRAIN_RESOLUTION[0] // 14), 8, 32)
CKPT_BYTES_PER_PARAM = 12                      # fp32 weights and both moments
FULL_PARAMS = 1.216e9                          # ModelConfig()'s IGGT
TRAIN_BUCKETS = (("attention einsum (bmm)", ("aten::bmm",)),
                 ("attention softmax", ("softmax",)),
                 ("convolution", ("conv", "cudnn")),
                 ("matmul (linear layers)", ("aten::mm", "aten::addmm", "aten::linear")),
                 ("optimizer (foreach)", ("_foreach",)))


def check_train_guard() -> bool:
    """Each kernel wrapper, given CUDA inputs that require grad with grad mode
    on, raises (and launches nothing)."""
    import torch

    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(1, 128, 16, 64, device="cuda", dtype=torch.bfloat16, generator=gen)
               for _ in range(3))
    cos = torch.ones(1, 128, 64, device="cuda")
    norm = tuple(torch.ones(64, device="cuda") for _ in range(4))
    x = torch.randn(128, 1024, device="cuda", dtype=torch.bfloat16, generator=gen)
    w, b = torch.ones(1024, device="cuda"), torch.zeros(1024, device="cuda")
    calls = {"flash_attention": lambda q: fa.flash_attention(q, k, v),
             "flash_attention_fused": lambda q: fa.flash_attention_fused(q, k, v, cos, cos, norm),
             "qk_prep": lambda q: fa.qk_prep(q, k, cos, cos, norm),
             "fused_layernorm": lambda x: fused_layernorm(x, w, b)}
    ok = True
    zero_counts()
    for name, fn in calls.items():
        arg = (x if name == "fused_layernorm" else q).clone().requires_grad_(True)
        try:
            fn(arg)
            log(f"[train] guard FAIL: {name} accepted a CUDA input that requires grad")
            ok = False
        except ValueError as exc:
            log(f"[train] guard ok: {name} raised: {str(exc)[:96]}...")
    launched = read_counts()
    if any(launched.values()):
        log(f"[train] guard FAIL: launches {launched}")
        ok = False
    return ok & check_attention_train()


def check_attention_train() -> bool:
    """`attention_train` at the training cell's part-head shape, on inputs
    that require grad: one flash launch, the value within the fp32 kernel
    limit of the plain version's, and the gradient of q, k and v equal to the
    plain version's autograd (its backward recomputes that version)."""
    import torch

    from iggt_official_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    shape = TRAIN_PART_ATTENTION
    qkv = [torch.randn(shape, device="cuda", generator=gen) for _ in range(3)]
    g = torch.randn(shape, device="cuda", generator=gen)
    ours = [t.clone().requires_grad_(True) for t in qkv]
    ref = [t.clone().requires_grad_(True) for t in qkv]
    zero_counts()
    out = fa.attention_train(*ours)
    launched = read_counts()
    want = fa.flash_attention_plain(*ref)
    ref_max = want.abs().max().item()
    err = (out - want).abs().max().item()
    limit = error_limit("float32", ref_max)
    out.backward(g)
    want.backward(g)
    gerr = max(((a.grad - b.grad).abs().max() / b.grad.abs().max()).item()
               for a, b in zip(ours, ref))
    ok = (launched["flash_attention"] == 1 and sum(launched.values()) == 1
          and err <= limit and gerr <= 1e-6)
    log(f"[train] attention_train {tuple(shape)} fp32, inputs requiring grad: "
        f"{'ok' if ok else 'FAIL'}: launches {launched}; value max_abs_err {err:.3e} "
        f"(limit {limit:.3e}); q/k/v gradients against the plain version's autograd, max "
        f"rel {gerr:.3e} (limit 1e-6)")
    return ok


def train_batch(seed: int, shape) -> dict:
    """A seeded batch with all four losses' targets (numpy)."""
    B, S, H, W = shape
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32),
            "pose_enc": rng.normal(0, 1, (B, S, 9)).astype(np.float32),
            "depth": rng.uniform(0.5, 2, (B, S, H, W, 1)).astype(np.float32),
            "world_points": rng.normal(0, 1, (B, S, H, W, 3)).astype(np.float32),
            "valid_mask": (rng.random((B, S, H, W)) < 0.8).astype(np.float32),
            "instance_ids": rng.integers(-1, 4, (B, S, H, W)).astype(np.int32)}


def one_train_step(model, batch: dict, device: str, attn_fn=None):
    """``make_train_step`` once on ``model`` (a copy on ``device``): (metrics,
    {name: gradient on the CPU, zeros for None})."""
    import copy

    import torch

    from iggt_official_tpu_torch.layers.blocks import sdpa_plain
    from iggt_official_tpu_torch.train.loop import to_device
    from iggt_official_tpu_torch.train.step import make_optimizer, make_train_step

    m = copy.deepcopy(model).to(device)
    opt = make_optimizer(m, layer_decay=0.9, num_layers=TRAIN_SCALED["depth"])
    _, metrics = make_train_step(m, opt, attn_fn=attn_fn or sdpa_plain)(
        to_device(batch, torch.device(device)))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
             for n, p in m.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def grad_problems(ref: dict, out: dict, trunk: str):
    """Tensors of ``out`` outside the card-vs-CPU limits against ``ref``:
    (failing names, worst error as a share of its limit, global relative L2)."""
    import torch

    tol, floor = TRAIN_GRAD_TOL[trunk]
    G = max(g.abs().max().item() for g in ref.values())
    bad, worst = [], 0.0
    for n, r in ref.items():
        limit = max(r.abs().max().item(), floor * G)
        err = (out[n] - r).abs().max().item()
        worst = max(worst, err / limit / tol)
        if err > tol * limit:
            bad.append(n)
    r = torch.cat([g.double().flatten() for g in ref.values()])
    o = torch.cat([out[n].double().flatten() for n in ref])
    l2 = ((o - r).norm() / r.norm()).item()
    if l2 > TRAIN_GRAD_L2[trunk]:
        bad.append(f"global relative L2 {l2:.3e} > {TRAIN_GRAD_L2[trunk]}")
    # each tensor's relative L2 error where max|g| is above 1e-5 G (the
    # max-abs limit passes a zeroed or halved tensor below its floor)
    tensor_l2 = 0.0
    for n, r in ref.items():
        if r.abs().max().item() > 1e-5 * G:
            e = ((out[n].double() - r).norm() / r.double().norm()).item()
            tensor_l2 = max(tensor_l2, e)
            if e > TRAIN_TENSOR_L2[trunk] and n not in bad:
                bad.append(n)
    return bad, worst, l2, tensor_l2


def name_pattern(name: str) -> str:
    import re

    return re.sub(r"\.\d+\.", ".N.", name)


def check_train_agreement():
    """One training step of a scaled IGGT (DINOv2 patch embed) on the card and
    on the CPU, same weights and batch, fp32 and bf16 trunks: loss terms
    within TRAIN_LOSS_TOL (bf16: or the bf16 trunk's own move of the term on
    the CPU), every gradient within TRAIN_GRAD_TOL and TRAIN_GRAD_L2, and the
    flash kernel launched once per part-head view chunk (`attention_train`),
    nothing else; then, for each trunk, the planted fault, the trunk's
    attention output detached (what the kernels' missing grad_fn did), must
    fail the gradient check and name the qkv weights.  Returns (ok, name
    patterns whose CPU gradient is zero)."""
    import dataclasses

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.layers.blocks import sdpa_plain
    from iggt_official_tpu_torch.models.vggt import _view_chunks, build_model
    import torch

    def detached(q, k, v):
        return sdpa_plain(q, k, v).detach()

    log(f"[train] card vs CPU: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} in this check "
        "(torch's default, which the training CLI keeps, runs the card's convolutions in TF32)")
    ok, zero, cpu = True, set(), {}
    batch = train_batch(SEED + 20, TRAIN_SCALED_SHAPE)
    for trunk in ("float32", "bfloat16"):
        cfg = dataclasses.replace(ModelConfig().scaled(**TRAIN_SCALED), trunk_dtype=trunk)
        chunks = len(_view_chunks(TRAIN_SCALED_SHAPE[1], cfg.part.frames_chunk_size))
        want = {k: (chunks if k == "flash_attention" else 0) for k in read_counts()}
        model = build_model(cfg, device="cpu", seed=SEED, train=True)
        t0 = time.perf_counter()
        ref_m, ref_g = one_train_step(model, batch, "cpu")
        cpu[trunk] = ref_m
        t1 = time.perf_counter()
        zero_counts()
        out_m, out_g = one_train_step(model, batch, "cuda")
        launched = read_counts()
        if trunk == "float32":
            limits = {k: TRAIN_LOSS_TOL for k in ref_m}
        else:   # the bf16 trunk's own move of each term on the CPU
            limits = {k: max(TRAIN_LOSS_TOL, abs(v - cpu["float32"][k]) / abs(cpu["float32"][k]))
                      for k, v in ref_m.items()}
        loss_errs = {k: abs(out_m[k] - ref_m[k]) / max(abs(ref_m[k]), 1e-12) for k in ref_m}
        loss_bad = [k for k in ref_m if loss_errs[k] > limits[k]]
        bad, worst, l2, tensor_l2 = grad_problems(ref_g, out_g, trunk)
        good = not loss_bad and not bad and launched == want
        ok &= good
        log(f"[train] {trunk} trunk, card vs CPU: {'ok' if good else 'FAIL'}: loss terms and "
            f"grad_norm, rel err (limit): "
            + ", ".join(f"{k} {loss_errs[k]:.3e} ({limits[k]:.2e})" for k in ref_m)
            + f"; gradients: worst {worst:.4f} of the per-tensor limit (tol, floor "
            f"{TRAIN_GRAD_TOL[trunk]}), global rel L2 {l2:.3e} (limit "
            f"{TRAIN_GRAD_L2[trunk]:.0e}), worst per-tensor rel L2 {tensor_l2:.3e} (limit "
            f"{TRAIN_TENSOR_L2[trunk]}), "
            f"{len(bad)} outside; kernel launches {launched} (want {want}); CPU step "
            f"{t1 - t0:.1f} s, card step {time.perf_counter() - t1:.1f} s")
        log(f"[train]   CPU {json.dumps({k: round(v, 6) for k, v in ref_m.items()})}")
        log(f"[train]   card {json.dumps({k: round(v, 6) for k, v in out_m.items()})}")
        for n in bad[:8]:
            log(f"[train]   outside: {n}")
        if trunk == "float32":
            zero = {name_pattern(n) for n, g in ref_g.items() if not g.any()}
            log(f"[train]   zero gradient on the CPU: {sorted(zero)}")
        _, fault_g = one_train_step(model, batch, "cuda", attn_fn=detached)
        fbad, fworst, fl2, ftensor_l2 = grad_problems(ref_g, fault_g, trunk)
        qkv = [n for n in fbad if n.startswith("aggregator.") and ".attn.qkv." in n]
        caught = bool(qkv)
        ok &= caught
        log(f"[train] {trunk} trunk, planted fault (trunk attention output detached): "
            f"{'caught' if caught else 'NOT CAUGHT'}: {len(fbad)} tensors outside, "
            f"{len(qkv)} of them qkv weights of the trunk, e.g. {qkv[:3]}; worst "
            f"{fworst:.1f} of the per-tensor limit, global rel L2 {fl2:.3e}, worst "
            f"per-tensor rel L2 {ftensor_l2:.3e}")
        del model
    return ok, zero


def write_train_sequence(root: str, seed: int = SEED, size=TRAIN_FRAME_SIZE) -> str:
    """A Dl3dv-layout sequence of TRAIN_FRAMES seeded frames of ``size`` (W,
    H) under ``root/scans/seq0/``: dense/rgb PNGs (smooth colour fields plus noise),
    dense/depth npy (a smooth surface at 1.5-4.5 m), dense/cam npz (a camera
    sliding along x and turning about y, pinhole intrinsics) and
    auto_masks.json, per frame the COCO RLE (the port's `data/rle.py`) of a
    seeded Voronoi partition's even cells."""
    from PIL import Image

    from iggt_official_tpu_torch.data import rle

    W, H = size
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, "scans", "seq0", "dense")
    for sub in ("rgb", "depth", "cam"):
        os.makedirs(os.path.join(seq, sub))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    sites = rng.uniform(0, 1, (12, 2)).astype(np.float32)
    masklets = []
    for i in range(TRAIN_FRAMES):
        coarse = rng.uniform(0, 255, (6, 8, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((W, H), Image.BICUBIC), np.float32)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(seq, "rgb", f"frame_{i:04d}.png"))
        depth = (3.0 + np.sin(yy / H * 3 + 0.1 * i) + 0.5 * np.cos(xx / W * 4)).astype(np.float32)
        np.save(os.path.join(seq, "depth", f"frame_{i:04d}.npy"), depth)
        a = 0.02 * i
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = [0.05 * i, 0.0, 0.0]
        K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
        np.savez(os.path.join(seq, "cam", f"frame_{i:04d}.npz"), pose=pose, intrinsic=K)
        s = sites + 0.01 * i
        cell = np.argmin((yy[None] / H - s[:, :1, None]) ** 2
                         + (xx[None] / W - s[:, 1:, None]) ** 2, axis=0)
        masklets.append(rle.encode(cell % 2 == 0))
    with open(os.path.join(root, "scans", "seq0", "auto_masks.json"), "w") as f:
        json.dump({"masklet": masklets}, f)
    return root


def profile_buckets(events):
    """Device time (ms) of a profiled step by bucket, from the self device
    time of the CPU ops that launched the kernels; the sum over the kernels
    themselves (the two totals should agree); and the rest bucket's largest
    ops and the largest kernels, as (ms, count, name)."""
    import torch

    rest = "elementwise, reductions, copies (the rest)"
    buckets = {name: 0.0 for name, _ in TRAIN_BUCKETS}
    buckets[rest] = 0.0
    kernels, rest_ops, top = 0.0, [], []
    for e in events:
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += us / 1e3
            top.append((us / 1e3, e.count, e.key))
            continue
        name = next((n for n, pats in TRAIN_BUCKETS if any(p in e.key for p in pats)), rest)
        buckets[name] += us / 1e3
        if name == rest:
            rest_ops.append((us / 1e3, e.count, e.key))
    return buckets, kernels, sorted(rest_ops, reverse=True)[:8], sorted(top, reverse=True)[:8]


def reckoned_memory_gb(n_params: int) -> dict:
    """The training cell's memory reckoned from the shapes (not measured)."""
    h, w = TRAIN_RESOLUTION[1] // 14, TRAIN_RESOLUTION[0] // 14
    P, S, heads = h * w + 5, 4, 16
    dino = 24 * S * heads * (h * w + 5) ** 2 * (4 + 2) / 1e9   # softmax out fp32 + probs bf16
    recompute = heads * (S * P) ** 2 * (2 + 4 + 4 + 2) / 1e9   # one global block's logits
    return {"params+grads+moments (16 B/param)": 16 * n_params / 1e9,
            "DINOv2 attention saved for backward": dino,
            "one global block's recompute": recompute,
            "heads' activations (coarse)": 10.0}


def run_train_cell(zero_patterns, launches_out: dict, data: dict) -> bool:
    """The full-width training cell through `app/train.py::main` (see the
    module note, phase 11), under torch's default TF32 settings, which the
    training CLI keeps (cuDNN convolutions in TF32, matmuls in fp32)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        return _run_train_cell(zero_patterns, launches_out, data)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _run_train_cell(zero_patterns, launches_out: dict, data: dict) -> bool:
    import gc
    import itertools
    import shutil
    import statistics

    import torch

    from iggt_official_tpu_torch.app.train import main as train_main
    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.data.loader import get_data_loader
    from iggt_official_tpu_torch.models.vggt import _view_chunks
    from iggt_official_tpu_torch.train.loop import train
    from iggt_official_tpu_torch.train.step import make_schedule
    from iggt_official_tpu_torch.utils.checkpoint import load_training_checkpoint

    ok = True
    log(f"[train] cell under torch's defaults: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    with tempfile.TemporaryDirectory(prefix="iggt_train_") as tmp:
        root = write_train_sequence(os.path.join(tmp, "dl3dv"))
        expr = f"Dl3dv({root!r}, resolution={TRAIN_RESOLUTION}, seed={SEED})"
        ckpt = os.path.join(tmp, "ckpt")
        free = shutil.disk_usage(tmp).free
        need = 2 * CKPT_BYTES_PER_PARAM * FULL_PARAMS * 1.05
        log(f"[train] free disk under {tmp}: {free / 1e9:.1f} GB; two checkpoints need "
            f"~{need / 1e9:.1f} GB")
        if free < need:
            log("[train] FAIL: not enough free disk for the two checkpoints of the cell")
            return False
        common = ["--dataset", expr, "--batch_size", "4", "--seq_min_len", "4",
                  "--seq_max_len", "4", "--warmup_steps", str(TRAIN_WARMUP),
                  "--checkpoint_dir", ckpt, "--checkpoint_every", "1000", "--log_every", "1",
                  "--device", "cuda", "--seed", str(SEED)]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        state = train_main(common + ["--steps", str(TRAIN_STEPS), "--profile_step",
                                     str(TRAIN_PROFILE_STEP)])
        run_s = time.perf_counter() - t0
        launched = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in state.model.parameters())
        hist = state.history
        timed = [h for h in hist[1:] if h["step"] != TRAIN_PROFILE_STEP]
        step_s = statistics.median(h["wall_s"] for h in timed)
        wait = sum(h["data_s"] for h in timed) / sum(h["wall_s"] for h in timed)
        reck = reckoned_memory_gb(n_params)
        log(f"[train] cell: IGGT {n_params / 1e9:.3f} B parameters, 1 x 4 views at "
            f"{TRAIN_RESOLUTION[0]}x{TRAIN_RESOLUTION[1]}, {TRAIN_STEPS} steps in {run_s:.1f} s "
            "(model init, data, profiled step and checkpoint included)")
        log(f"[train] step wall (median of steps 2-{TRAIN_STEPS} without the profiled one, "
            f"after a device sync) {step_s:.3f} s = {4 / step_s:.2f} images/s; loader wait "
            f"{100 * wait:.1f}% of those steps")
        log(f"[train] peak memory (max_memory_allocated) {peak:.2f} GiB; reckoned "
            f"{sum(reck.values()):.1f} GB: " + ", ".join(f"{k} {v:.1f}" for k, v in reck.items()))
        for h in hist:
            log("[train] step " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                                              for k, v in h.items()}))
        chunks = len(_view_chunks(4, ModelConfig().part.frames_chunk_size))
        want = {k: (TRAIN_STEPS * chunks if k == "flash_attention" else 0) for k in launched}
        launches_out["flash_attention_train"] = launched["flash_attention"]
        log(f"[train] kernel launches over the {TRAIN_STEPS} steps: {launched} (want {want}: "
            "the part head's cross-attention through attention_train, one launch per view "
            "chunk and step; the trunk through plain attention)")
        if launched != want:
            log("[train] FAIL: the training steps' kernel launches differ")
            ok = False
        if not all(np.isfinite(v) for h in hist for k, v in h.items() if k.startswith("loss")):
            log("[train] FAIL: a loss is not finite")
            ok = False
        nonfinite, zero = [], []
        for n, p in state.model.named_parameters():
            g = p.grad
            if g is not None and not torch.isfinite(g).all():
                nonfinite.append(n)
            if (g is None or not g.any()) and name_pattern(n) not in zero_patterns:
                zero.append(n)
        log(f"[train] last step's gradients: {len(nonfinite)} non-finite, {len(zero)} zero "
            f"outside the CPU's zero set {sorted(zero_patterns)}")
        if nonfinite or zero:
            log(f"[train] FAIL: gradients {nonfinite[:4]} {zero[:4]}")
            ok = False
        if state.profile is not None:
            buckets, kernels, rest_ops, top = profile_buckets(state.profile)
            total = sum(buckets.values())
            log(f"[train] profiled step {TRAIN_PROFILE_STEP}: device time {total:.1f} ms by "
                f"the ops that launched it ({kernels:.1f} ms summed over the kernels), "
                f"{100 * total / 1e3 / step_s:.1f}% of the unprofiled step's wall; step wall "
                f"{hist[TRAIN_PROFILE_STEP]['wall_s'] * 1e3:.1f} ms under the profiler")
            for name, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
                log(f"[train]   {name:44s} {ms:9.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%")
            for ms, count, key in rest_ops:
                log(f"[train]   rest: {ms:9.2f} ms  x{count:<6d} {key[:100]}")
            for ms, count, key in top:
                log(f"[train]   top kernel: {ms:9.2f} ms  x{count:<6d} {key[:100]}")
        for c in state.checkpoints:
            log(f"[train] checkpoint {os.path.basename(c['path'])}: {c['bytes'] / 1e9:.2f} GB "
                f"in {c['seconds']:.1f} s")
        # the checkpoint reloads byte-equal
        t0 = time.perf_counter()
        saved = load_training_checkpoint(state.checkpoints[-1]["path"])
        opt = state.optimizer.state_dict()
        same = saved["step"] == TRAIN_STEPS and saved["optimizer"]["count"] == opt["count"]
        for k, v in state.model.state_dict().items():
            same &= torch.equal(saved["model"][k], v.cpu())
        for part in ("mu", "nu"):
            for k, v in opt[part].items():
                same &= torch.equal(saved["optimizer"][part][k], v.cpu())
        log(f"[train] checkpoint reload: {'byte-equal' if same else 'DIFFERS'} "
            f"({time.perf_counter() - t0:.1f} s)")
        ok &= bool(same)
        del saved, state, opt
        gc.collect()
        torch.cuda.empty_cache()

        # resume to step 10
        state = train_main(common + ["--steps", str(TRAIN_RESUME_STEPS)])
        first = state.history[0] if state.history else {}
        want_lr = make_schedule(1e-4, TRAIN_WARMUP, TRAIN_RESUME_STEPS)(TRAIN_STEPS)
        resumed = (first.get("step") == TRAIN_STEPS and first.get("lr") == want_lr
                   and state.step == TRAIN_RESUME_STEPS)
        log(f"[train] resume: {'ok' if resumed else 'FAIL'}: first step {first.get('step')} "
            f"at lr {first.get('lr')} (schedule {want_lr}), finished at {state.step}; "
            + "; ".join(f"checkpoint {os.path.basename(c['path'])} {c['seconds']:.1f} s"
                        for c in state.checkpoints))
        ok &= resumed
        del state
        shutil.rmtree(ckpt)
        gc.collect()
        torch.cuda.empty_cache()

        # the loss falls on one fixed batch
        batch = next(get_data_loader(expr, seq_min_len=4, seq_max_len=4, batch_size=4))
        state = train(ModelConfig(), itertools.repeat(batch), TRAIN_CURVE_STEPS,
                      init_batch=batch, device="cuda", warmup_steps=TRAIN_WARMUP,
                      num_layers=24, log_every=10 ** 6, rng_seed=SEED)
        curve = [h["loss/total"] for h in state.history]
        falls = curve[-1] < curve[0]
        log(f"[train] fixed-batch curve ({TRAIN_CURVE_STEPS} steps): "
            f"{'falls' if falls else 'DOES NOT FALL'}: " + ", ".join(f"{v:.4f}" for v in curve))
        ok &= falls
        ok &= run_converted_steps(state, data["converted"], data["tmp"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def run_train(launches_out: dict, data: dict) -> bool:
    ok = check_train_guard()
    agree, zero = check_train_agreement()
    ok &= agree
    ok &= run_train_cell(zero, launches_out, data)
    return ok


CONVERTED_STEPS = (("converted COLMAP scene (SceneDirDataset)", 2), ("MvsSynth EXR scene", 1))


def run_converted_steps(state, data_root: str, exr_root: str) -> bool:
    """Steps on the data phase's scenes with the fixed-batch run's model and
    optimizer: CONVERTED_STEPS' counts, 1 x 4 views at TRAIN_RESOLUTION
    through `get_data_loader`.  The scenes have no instance_ids, so the part
    loss is skipped (as the JAX step skips it); the part head still runs its
    cross-attention through the flash kernel, once per step."""
    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.data.loader import get_data_loader
    from iggt_official_tpu_torch.data.scene_dataset import SceneDirDataset
    from iggt_official_tpu_torch.models.vggt import _view_chunks
    from iggt_official_tpu_torch.train.loop import to_device
    from iggt_official_tpu_torch.train.step import make_train_step

    # convert_colmap_scene keeps the frames' extension: PNG here
    converted = type("ConvertedColmapScene", (SceneDirDataset,), {"color_ext": "*.png"})(
        data_root, dset="scans", resolution=TRAIN_RESOLUTION, seed=SEED)
    mvs, _ = exr_datasets(exr_root)
    step_fn = make_train_step(state.model, state.optimizer)
    chunks = len(_view_chunks(4, ModelConfig().part.frames_chunk_size))
    smi = nvidia_smi_line()
    ok, rows = True, []
    for (label, steps), ds in zip(CONVERTED_STEPS, (converted, mvs)):
        loader = get_data_loader(ds, seq_min_len=4, seq_max_len=4, batch_size=4)
        for k in range(steps):
            t0 = time.perf_counter()
            batch = to_device(next(loader), torch.device("cuda"))
            torch.cuda.synchronize()
            data_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            _, metrics = step_fn(batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launched = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            metrics = {m: float(v) for m, v in metrics.items()}
            want = {n: (chunks if n == "flash_attention" else 0) for n in launched}
            good = (all(np.isfinite(v) for v in metrics.values()) and "loss/part" not in metrics
                    and launched == want and tuple(batch["images"].shape[:2]) == (1, 4))
            log(f"[train] {label} step {k}: images {tuple(batch['images'].shape)}, step "
                f"{step_s:.3f} s, batch {data_s:.3f} s, peak {peak:.2f} GiB ({smi}); "
                + ", ".join(f"{m} {v:.6g}" for m, v in metrics.items())
                + f"; launches {launched}: {'ok' if good else 'FAIL'}")
            ok &= good
            rows.append(step_s)
    log(f"[train] converted-scene steps: {', '.join(f'{s:.3f}' for s in rows)} s "
        f"({'ok' if ok else 'FAIL'}: finite losses and grad_norm, no part loss, "
        f"{chunks} flash launch per step and no other)")
    return ok


# ---------------------------------------------------------------------------
# phase 10: data (the converters, the EXR loaders, the 2-D mask sets, configs)

COLMAP_FRAMES, COLMAP_SIZE = 24, (960, 540)     # DL3DV-10K's 960P frames, (W, H)
COLMAP_POINTS = 20_000
COLMAP_DENSE_SIZE = (480, 270)                  # the geometric depth bins, upsampled 2x
EXR_FRAMES, EXR_SIZE = 4, (1920, 1080)          # MVS-Synth's GTAV_1080
EXR_ENCODINGS = (("HALF", "ZIP"), ("FLOAT", "ZIPS"), ("FLOAT", "NONE"), ("HALF", "ZIP"))
SA1B_ROWS, SA1B_SIZE, SA1B_MASKS = 4, (2250, 1500), 60   # (W, H): shorter side 1500
SA1B_IMAGE_SIZE = 1024
ENTITY_IMAGES, ENTITY_POLYGONS = 2, 20
EXR_PIXEL = {"HALF": (1, "<f2"), "FLOAT": (2, "<f4")}
EXR_COMPRESSION = {"NONE": (0, 1), "ZIPS": (2, 1), "ZIP": (3, 16)}   # (code, scanlines per chunk)


def _exr_attr(name: str, kind: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + kind.encode() + b"\0" + len(value).to_bytes(4, "little") + value


def _exr_zip(raw: bytes) -> bytes:
    """OpenEXR's ZIP / ZIPS chunk: the bytes split into even and odd halves,
    each byte replaced by its difference from the one before plus 128, then
    zlib; a chunk that would not shrink is stored as it is."""
    import zlib

    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
    t[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    z = zlib.compress(t.astype(np.uint8).tobytes())
    return z if len(z) < len(raw) else raw


def write_exr(path: str, planes: dict, pixel: str = "FLOAT", compression: str = "ZIP") -> None:
    """A minimal single-part scanline OpenEXR writer, this script's own (the
    port has none): ``planes`` {channel: (H, W) array}, all of one pixel type
    (HALF or FLOAT), compression NONE, ZIPS or ZIP, the chunks in increasing
    y.  Attributes in OpenEXR's (alphabetical) order."""
    import struct

    ptype, dtype = EXR_PIXEL[pixel]
    code, lines = EXR_COMPRESSION[compression]
    names = sorted(planes)
    H, W = planes[names[0]].shape
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", ptype, 0, 1, 1)
                      for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2)
              + _exr_attr("channels", "chlist", chlist)
              + _exr_attr("compression", "compression", bytes([code]))
              + _exr_attr("dataWindow", "box2i", box)
              + _exr_attr("displayWindow", "box2i", box)
              + _exr_attr("lineOrder", "lineOrder", b"\0")
              + _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _exr_attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
              + _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    chunks = []
    for y in range(0, H, lines):
        rows = [np.ascontiguousarray(planes[n][y:y + lines], dtype).view(np.uint8)
                for n in names]
        raw = np.concatenate([r.reshape(r.shape[0], -1) for r in rows], axis=1).tobytes()
        data = raw if compression == "NONE" else _exr_zip(raw)
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    offsets, pos = [], len(header) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(offsets)}Q", *offsets) + b"".join(chunks))


def smooth_image(rng, W: int, H: int) -> np.ndarray:
    """uint8 (H, W, 3): a bicubic-upsampled 6 x 8 colour field plus noise."""
    from PIL import Image

    coarse = rng.uniform(0, 255, (6, 8, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((W, H), Image.BICUBIC), np.float32)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def capture_poses(n: int) -> list:
    """Camera-to-world poses of a camera sliding along x, turning about y."""
    poses = []
    for i in range(n):
        a = 0.02 * i
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = [0.05 * i, 0.0, 0.0]
        poses.append(pose)
    return poses


def write_colmap_capture(scene: str, seed: int = SEED) -> dict:
    """A DL3DV-style capture under ``scene``: ``images_8/frame_XXXXX.png``
    (COLMAP_FRAMES seeded frames), the sparse model in ``colmap/sparse/0``
    (one PINHOLE camera; COLMAP_POINTS points3D on a surface 2-6 m away, each
    seen in 2-6 of the frames it projects into, plus unmatched keypoints),
    written by the port's `data/colmap.py`, and the geometric depth bins in
    ``colmap/dense/stereo/depth_maps`` at COLMAP_DENSE_SIZE, written by
    `preprocess/dense.py::write_colmap_array` (a few invalid and too-far
    pixels).  Returns the model and the dense depths."""
    from PIL import Image

    from iggt_official_tpu_torch.data.colmap import Camera, Image as ColmapImage, Point3D
    from iggt_official_tpu_torch.data.colmap import rotmat2qvec, write_model
    from iggt_official_tpu_torch.preprocess.dense import write_colmap_array

    W, H = COLMAP_SIZE
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    cam = Camera(1, "PINHOLE", W, H, np.array([f, f, W / 2, H / 2]))
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    poses = capture_poses(COLMAP_FRAMES)
    xyz = np.stack([rng.uniform(-1.5, 2.6, COLMAP_POINTS), rng.uniform(-0.9, 0.9, COLMAP_POINTS),
                    rng.uniform(2.0, 6.0, COLMAP_POINTS)], 1)
    visible = np.zeros((COLMAP_POINTS, COLMAP_FRAMES), bool)
    uvs = np.zeros((COLMAP_POINTS, COLMAP_FRAMES, 2))
    for i, pose in enumerate(poses):
        c = (xyz - pose[:3, 3]) @ pose[:3, :3]          # world -> camera
        uv = (c @ K.T)[:, :2] / c[:, 2:]
        visible[:, i] = (c[:, 2] > 0.1) & (uv >= 0).all(1) & (uv < [W, H]).all(1)
        uvs[:, i] = uv
    # each point keeps 2-6 of the frames it projects into, drawn from the seed
    keys = np.where(visible, rng.random(visible.shape), np.inf)
    rank = np.argsort(np.argsort(keys, axis=1), axis=1)
    keep = visible & (rank < rng.integers(2, 7, COLMAP_POINTS)[:, None])
    obs = {i: (uvs[keep[:, i], i], np.nonzero(keep[:, i])[0] + 1) for i in range(COLMAP_FRAMES)}
    # point p's track: (image id, index of its observation in that image)
    slot = np.cumsum(keep, axis=0) - 1
    tracks = [[(i + 1, int(slot[p, i])) for i in np.nonzero(keep[p])[0]]
              for p in range(COLMAP_POINTS)]
    images = {}
    os.makedirs(os.path.join(scene, "images_8"))
    for i, pose in enumerate(poses):
        name = f"frame_{i + 1:05d}.png"
        Image.fromarray(smooth_image(rng, W, H)).save(os.path.join(scene, "images_8", name))
        xys, ids = obs[i]
        extra = rng.uniform(0, [W, H], (50, 2))           # unmatched keypoints
        xys = np.concatenate([xys, extra])
        ids = np.concatenate([ids.astype(np.int64), -np.ones(50, np.int64)])
        R = pose[:3, :3].T
        images[i + 1] = ColmapImage(i + 1, rotmat2qvec(R), -R @ pose[:3, 3], 1, name, xys, ids)
    points = {p + 1: Point3D(p + 1, xyz[p], rng.integers(0, 256, 3), float(rng.uniform(0, 2)),
                             np.array([t[0] for t in tracks[p]]),
                             np.array([t[1] for t in tracks[p]]))
              for p in range(COLMAP_POINTS) if tracks[p]}
    model = os.path.join(scene, "colmap", "sparse", "0")
    write_model({1: cam}, images, points, model, ext=".bin")
    write_model({1: cam}, images, points, model, ext=".txt")
    dense = os.path.join(scene, "colmap", "dense", "stereo", "depth_maps")
    os.makedirs(dense)
    w, h = COLMAP_DENSE_SIZE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depths = {}
    for i in range(COLMAP_FRAMES):
        d = (4.0 + np.sin(yy / h * 3 + 0.1 * i) + 0.5 * np.cos(xx / w * 4)).astype(np.float32)
        d[rng.integers(0, h, 40), rng.integers(0, w, 40)] = 0.0
        d[rng.integers(0, h, 10), rng.integers(0, w, 10)] = -1.0
        d[rng.integers(0, h, 10), rng.integers(0, w, 10)] = 900.0
        name = images[i + 1].name
        write_colmap_array(d, os.path.join(dense, name + ".geometric.bin"))
        depths[name] = d
    return {"cameras": {1: cam}, "images": images, "points": points, "dense": depths,
            "model": model}


def models_equal(a, b) -> bool:
    """Two (cameras, images, points) triples hold the same values."""
    def same(x, y):
        return all(np.array_equal(np.asarray(u), np.asarray(v)) if isinstance(u, np.ndarray)
                   or isinstance(v, np.ndarray) else u == v for u, v in zip(x, y))

    return all(a[k].keys() == b[k].keys() and all(same(a[k][i], b[k][i]) for i in a[k])
               for k in range(3))


def check_colmap_capture(tmp: str, times: dict) -> tuple:
    """The COLMAP / DL3DV path: capture -> `dl3dv.process_scene` ->
    `convert_colmap_scene` -> a half-size copy through `edit_resolution`.
    Returns (ok, the converted scene's root)."""
    import shutil

    from PIL import Image

    from iggt_official_tpu_torch.data import colmap
    from iggt_official_tpu_torch.data.imread import imread_unchanged
    from iggt_official_tpu_torch.preprocess import convert_colmap_scene
    from iggt_official_tpu_torch.preprocess.dl3dv import process_scene, scale_colmap_cameras
    from iggt_official_tpu_torch.preprocess.edit_resolution import edit_scene_resolution

    ok = True
    scene = os.path.join(tmp, "dl3dv", "scene0")
    t0 = time.perf_counter()
    cap = write_colmap_capture(scene)
    times["write COLMAP capture (frames, model .bin + .txt, dense bins)"] = time.perf_counter() - t0
    want = (cap["cameras"], cap["images"], cap["points"])
    n_obs = sum(len(im.point3D_ids) for im in cap["images"].values())
    t0 = time.perf_counter()
    read_bin = colmap.read_model(cap["model"], ".bin")
    read_txt = colmap.read_model(cap["model"], ".txt")
    times["read the model (.bin and .txt)"] = time.perf_counter() - t0
    again = os.path.join(tmp, "dl3dv", "rewrite")
    colmap.write_model(*read_bin, again, ext=".bin")
    rewrite_equal = all(
        open(os.path.join(cap["model"], f), "rb").read() == open(os.path.join(again, f), "rb").read()
        for f in ("cameras.bin", "images.bin", "points3D.bin"))
    bin_equal, txt_equal = models_equal(want, read_bin), models_equal(want, read_txt)
    log(f"[data] COLMAP model: {len(cap['points'])} points3D, {n_obs} 2-D observations over "
        f"{COLMAP_FRAMES} images {COLMAP_SIZE[0]}x{COLMAP_SIZE[1]}; read back equal: .bin "
        f"{bin_equal}, .txt {txt_equal}; .bin rewritten byte-equal {rewrite_equal}")
    ok &= bin_equal and txt_equal and rewrite_equal

    t0 = time.perf_counter()
    n = process_scene(scene)
    times["dl3dv.process_scene (dense bins -> npy)"] = time.perf_counter() - t0
    W, H = COLMAP_SIZE
    npy_ok = n == COLMAP_FRAMES
    depth_maps = {}
    for name, d in cap["dense"].items():
        got = np.load(os.path.join(scene, "depths", name.replace(".png", ".npy")))
        up = np.repeat(np.repeat(d, 2, 0), 2, 1)          # nearest, 2x in each axis
        ref = np.where(up <= 0, 0.0, np.clip(up, 0.0, 500.0)).astype(np.float32)
        npy_ok &= got.shape == (H, W) and got.dtype == np.float32 and np.array_equal(got, ref)
        depth_maps[name] = got
    log(f"[data] dl3dv.process_scene: {n} depth npy at {W}x{H} from {COLMAP_DENSE_SIZE[0]}x"
        f"{COLMAP_DENSE_SIZE[1]} bins, each equal to the nearest 2x upsample clamped to "
        f"[0, 500] with invalid pixels 0: {npy_ok}")
    ok &= npy_ok

    root = os.path.join(tmp, "converted")
    t0 = time.perf_counter()
    n = convert_colmap_scene(cap["model"], os.path.join(scene, "images_8"),
                             os.path.join(root, "scans"), "seq0", depth_maps=depth_maps)
    times["convert_colmap_scene (color, depth PNG, cam npz)"] = time.perf_counter() - t0
    seq = os.path.join(root, "scans", "seq0")
    conv_ok = n == COLMAP_FRAMES
    pose_err = 0.0
    for i, im in enumerate(sorted(cap["images"].values(), key=lambda im: im.name)):
        png = imread_unchanged(os.path.join(seq, "depth", f"{i:06d}.png"))
        mm = np.clip(depth_maps[im.name] * 1000, 0, 65535).astype(np.uint16)
        cam = np.load(os.path.join(seq, "cam", f"{i:06d}.npz"))
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = colmap.qvec2rotmat(im.qvec), im.tvec
        pose_err = max(pose_err, float(np.abs(cam["pose"] - np.linalg.inv(w2c)).max()))
        K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]], np.float32)
        color_equal = (np.asarray(Image.open(os.path.join(seq, "color", f"{i:06d}.png")))
                       == np.asarray(Image.open(os.path.join(scene, "images_8", im.name)))).all()
        conv_ok &= (png.dtype == np.uint16 and np.array_equal(png, mm)
                    and np.array_equal(cam["intrinsics"], K) and bool(color_equal))
    conv_ok &= pose_err <= 1e-6
    log(f"[data] convert_colmap_scene: {n} frames; depth PNGs equal to "
        f"clip(d * 1000, 0, 65535) as uint16, intrinsics and colour equal, poses the inverse "
        f"of the written world-to-camera within {pose_err:.3g} (limit 1e-6): {conv_ok}")
    ok &= conv_ok

    half = os.path.join(tmp, "dl3dv", "scene0_half")
    shutil.copytree(scene, half)
    for name in os.listdir(os.path.join(half, "images_8")):
        p = os.path.join(half, "images_8", name)
        Image.open(p).resize((W // 2, H // 2), Image.BILINEAR).save(p)
    t0 = time.perf_counter()
    edited = edit_scene_resolution(half)
    times["edit_resolution (half size)"] = time.perf_counter() - t0
    got = colmap.read_cameras_binary(os.path.join(half, "colmap", "sparse", "0", "cameras.bin"))
    ratio = scale_colmap_cameras(cap["cameras"], W // 2, H // 2)
    p = cap["cameras"][1].params
    rule = np.array([p[0] * 0.5, p[1] * 0.5, p[2] * 0.5, p[3] * 0.5])
    edit_ok = (edited and not edit_scene_resolution(half)
               and (got[1].width, got[1].height) == (W // 2, H // 2)
               and np.array_equal(got[1].params, ratio[1].params)
               and np.array_equal(got[1].params, rule))
    log(f"[data] edit_resolution to {W // 2}x{H // 2} on a copy: params {got[1].params.tolist()} "
        f"equal to the ratio rule (scale_colmap_cameras and fx, cx by w'/w, fy, cy by h'/h), "
        f"a second call skipped: {edit_ok}")
    ok &= bool(edit_ok)
    return ok, root


def exr_depth(rng, W: int, H: int, i: int) -> np.ndarray:
    """A depth field 2-80 m with a few infinite (sky) and zero pixels."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d = (20 + 15 * np.sin(yy / H * 3 + 0.3 * i) + 10 * np.cos(xx / W * 5)
         + rng.uniform(0, 0.5, (H, W))).astype(np.float32)
    d[:H // 40] = np.inf
    d[rng.integers(0, H, 100), rng.integers(0, W, 100)] = 0.0
    return d


def write_exr_scenes(tmp: str, seed: int = SEED):
    """EXR_FRAMES frames at EXR_SIZE in MvsSynth's layout
    (``mvs/scans/seq0/{color,depth,cam}``) and in MegaDepth's
    (``megadepth/scans/0000/dense0/{rgb,depth}``, the npz cameras in rgb/),
    the depths in EXR_ENCODINGS' pixel types and compressions, cycled.
    Returns the written depths as the files hold them (HALF rounded)."""
    from PIL import Image

    W, H = EXR_SIZE
    rng = np.random.default_rng(seed + 1)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    held = {"mvs": [], "megadepth": []}
    layouts = {"mvs": ("mvs/scans/seq0/color", "mvs/scans/seq0/depth", "mvs/scans/seq0/cam"),
               "megadepth": ("megadepth/scans/0000/dense0/rgb",
                             "megadepth/scans/0000/dense0/depth",
                             "megadepth/scans/0000/dense0/rgb")}
    for kind, dirs in layouts.items():
        for d in dirs:
            os.makedirs(os.path.join(tmp, d), exist_ok=True)
        for i, pose in enumerate(capture_poses(EXR_FRAMES)):
            Image.fromarray(smooth_image(rng, W, H)).save(
                os.path.join(tmp, dirs[0], f"{i:05d}.jpg"), quality=95)
            pixel, comp = EXR_ENCODINGS[i % len(EXR_ENCODINGS)]
            d = exr_depth(rng, W, H, i)
            write_exr(os.path.join(tmp, dirs[1], f"{i:05d}.exr"), {"Y": d}, pixel, comp)
            held[kind].append(d.astype(EXR_PIXEL[pixel][1]).astype(np.float32))
            key = "pose" if kind == "mvs" else "cam2world"
            np.savez(os.path.join(tmp, dirs[2], f"{i:05d}.npz"),
                     **{key: pose.astype(np.float32), "intrinsics": K})
    return held


def exr_datasets(tmp: str):
    """The registered MvsSynth and MegaDepth loaders over write_exr_scenes'
    files at TRAIN_RESOLUTION, their 24-frame minimum lowered to the
    EXR_FRAMES written."""
    from iggt_official_tpu_torch.data.datasets import MegaDepth, MvsSynth

    short = {"min_frames": EXR_FRAMES}
    mvs = type("MvsSynth", (MvsSynth,), short)(os.path.join(tmp, "mvs"), dset="scans",
                                                 resolution=TRAIN_RESOLUTION, seed=SEED)
    mega = type("MegaDepth", (MegaDepth,), short)(os.path.join(tmp, "megadepth"),
                                                   dset="scans", resolution=TRAIN_RESOLUTION,
                                                   seed=SEED)
    return mvs, mega


def check_exr_scenes(tmp: str, times: dict) -> bool:
    from iggt_official_tpu_torch.data.base import threshold_depth_map
    from iggt_official_tpu_torch.data.imread import imread_unchanged

    t0 = time.perf_counter()
    held = write_exr_scenes(tmp)
    times[f"write {2 * EXR_FRAMES} EXR frames {EXR_SIZE[0]}x{EXR_SIZE[1]} (+ JPEG, npz)"] = \
        time.perf_counter() - t0
    ok = True
    for ds, want in zip(exr_datasets(tmp), (held["mvs"], held["megadepth"])):
        label = ds.dataset_label
        t0 = time.perf_counter()
        raws = [imread_unchanged(p) for p in ds.all_depth_paths]
        times[f"{label}: read {len(raws)} EXR depths"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        views = ds[(0, 0, EXR_FRAMES)]
        times[f"{label}: load {len(views)} views (EXR read, threshold, crop)"] = \
            time.perf_counter() - t0
        raw_ok = len(raws) == EXR_FRAMES and all(
            r.dtype == np.float32 and r.shape == w.shape and np.array_equal(r, w)
            for r, w in zip(raws, want))
        thr_ok = True
        for i, w in enumerate(want):
            w = w.copy()
            w[~np.isfinite(w)] = 0
            thr_ok &= np.array_equal(ds._load_depth_for(i),
                                     threshold_depth_map(w, ds.depth_percentile, -1))
        shapes_ok = all(v["img"].shape[:2] == (TRAIN_RESOLUTION[1], TRAIN_RESOLUTION[0])
                        and np.isfinite(v["depthmap"]).all() for v in views)
        log(f"[data] {label}: {len(raws)} EXR depths "
            + ", ".join(f"{p}/{c}" for p, c in EXR_ENCODINGS[:EXR_FRAMES])
            + f" at {EXR_SIZE[0]}x{EXR_SIZE[1]} read equal to the written arrays (HALF after "
            f"its float32 conversion): {raw_ok}; the loader's depth equal to its threshold of "
            f"them: {thr_ok}; {len(views)} views at {TRAIN_RESOLUTION}, finite: {shapes_ok}")
        ok &= raw_ok and thr_ok and shapes_ok
    return ok


def ellipse_mask(rng, W: int, H: int) -> np.ndarray:
    cy, cx = rng.uniform(0, H), rng.uniform(0, W)
    ry, rx = rng.uniform(H / 80, H / 4), rng.uniform(W / 80, W / 4)
    y0, y1 = max(0, int(cy - ry) - 1), min(H, int(cy + ry) + 2)
    x0, x1 = max(0, int(cx - rx) - 1), min(W, int(cx + rx) + 2)
    yy, xx = np.ogrid[y0:y1, x0:x1]
    m = np.zeros((H, W), bool)
    m[y0:y1, x0:x1] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return m


def write_sa1b_shard(path: str, seed: int = SEED) -> list:
    """SA1B_ROWS rows of (key, COCO-JSON annotations, base64 JPEG) at
    SA1B_SIZE, SA1B_MASKS ellipse masks each as compressed COCO RLE (the
    port's `data/rle.py`).  Returns [(key, json text, base64, masks)]."""
    import base64
    import io

    from PIL import Image

    from iggt_official_tpu_torch.data import rle

    W, H = SA1B_SIZE
    rng = np.random.default_rng(seed + 2)
    rows = []
    with open(path, "w") as f:
        for i in range(SA1B_ROWS):
            buf = io.BytesIO()
            Image.fromarray(smooth_image(rng, W, H)).save(buf, format="JPEG", quality=90)
            b64 = base64.b64encode(buf.getvalue()).decode("ascii")
            masks, annos = [], []
            for k in range(SA1B_MASKS):
                m = ellipse_mask(rng, W, H)
                ys, xs = np.nonzero(m)
                j = int(rng.integers(0, len(ys)))
                annos.append({"id": k, "segmentation": rle.encode(m), "area": int(m.sum()),
                              "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                                       int(ys.max() - ys.min() + 1)],
                              "point_coords": [[float(xs[j]), float(ys[j])]], "iscrowd": 0})
                masks.append(m)
            text = json.dumps({"image": {"image_id": i, "height": H, "width": W},
                               "annotations": annos})
            f.write(f"sa1b_{i}\t{text}\t{b64}\n")
            rows.append((f"sa1b_{i}", text, b64, masks))
    return rows


def write_entityseg(root: str, seed: int = SEED) -> list:
    """ENTITY_IMAGES JPEGs at SA1B_SIZE and a COCO JSON of ENTITY_POLYGONS
    rectangle polygons each (integer corners, so each mask is known:
    corners included).  Returns each image's list of masks."""
    from PIL import Image

    W, H = SA1B_SIZE
    rng = np.random.default_rng(seed + 3)
    os.makedirs(os.path.join(root, "images"))
    coco, masks = {"images": [], "annotations": []}, []
    for i in range(ENTITY_IMAGES):
        Image.fromarray(smooth_image(rng, W, H)).save(
            os.path.join(root, "images", f"{i:04d}.jpg"), quality=90)
        coco["images"].append({"id": i + 1, "file_name": f"{i:04d}.jpg", "height": H, "width": W})
        ms = []
        for k in range(ENTITY_POLYGONS):
            x0, y0 = int(rng.integers(0, W * 9 // 10)), int(rng.integers(0, H * 9 // 10))
            x1, y1 = x0 + int(rng.integers(2, W // 10)), y0 + int(rng.integers(2, H // 10))
            poly = [float(v) for v in (x0, y0, x1, y0, x1, y1, x0, y1)]
            coco["annotations"].append({"id": len(coco["annotations"]) + 1, "image_id": i + 1,
                                        "segmentation": [poly], "iscrowd": 0})
            m = np.zeros((H, W), bool)
            m[y0:y1 + 1, x0:x1 + 1] = True
            ms.append(m)
        masks.append(ms)
    with open(os.path.join(root, "entityseg.json"), "w") as f:
        json.dump(coco, f)
    return masks


def check_mask_sets(tmp: str, times: dict) -> bool:
    """An SA-1B shard through `TSVFile` and `SA1BDataset`, an EntitySeg set
    through `EntityImage`."""
    from iggt_official_tpu_torch.data import rle
    from iggt_official_tpu_torch.data.seg2d import EntityImage, decode_segmentation
    from iggt_official_tpu_torch.data.tsv import SA1BDataset, TSVFile, img_from_base64

    ok = True
    root = os.path.join(tmp, "sa1b")
    os.makedirs(root)
    t0 = time.perf_counter()
    rows = write_sa1b_shard(os.path.join(root, "sa_000000_0.tsv"))
    times[f"write the SA-1B shard ({SA1B_ROWS} rows)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tsv = TSVFile(os.path.join(root, "sa_000000_0.tsv"))
    order = [3, 0, 2, 1][:SA1B_ROWS]
    seek_ok = tsv.num_rows() == SA1B_ROWS and all(
        tsv.seek(i) == list(rows[i][:3]) for i in order)
    W, H = SA1B_SIZE
    dec_ok = True
    for key, text, b64, masks in rows:
        annos = json.loads(text)["annotations"]
        dec_ok &= img_from_base64(b64).size == (W, H)
        for a, m in zip(annos, masks):
            got = decode_segmentation(a["segmentation"], H, W)
            dec_ok &= np.array_equal(got, rle.decode(a["segmentation"]) > 0) and \
                np.array_equal(got, m)
    times["TSV seeks and mask decodes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = SA1BDataset(root, image_size=SA1B_IMAGE_SIZE, seed=SEED)
    item = ds[0]
    times[f"SA1BDataset sample at {SA1B_IMAGE_SIZE}"] = time.perf_counter() - t0
    S, n = SA1B_IMAGE_SIZE, len(item["gt_masks"])
    shapes = {"image": ((S, S, 3), np.float32), "sam_image": ((S, S, 3), np.float32),
              "padding_mask": ((S, S), np.bool_), "gt_masks": ((n, S, S), np.bool_),
              "gt_boxes": ((n, 4), np.float32), "point_coords": ((n, 4), np.float32)}
    sample_ok = len(ds) == SA1B_ROWS and 0 < n <= SA1B_MASKS and all(
        item[k].shape == s and item[k].dtype == dt for k, (s, dt) in shapes.items())
    log(f"[data] SA-1B shard: {SA1B_ROWS} rows of a {W}x{H} JPEG and {SA1B_MASKS} RLE masks; "
        f"rows seek back equal {seek_ok}; masks decode equal to the written masks and to "
        f"rle.decode {dec_ok}; SA1BDataset at {S}: {n} instances, shapes "
        + ", ".join(f"{k} {tuple(item[k].shape)}" for k in shapes) + f" as stated: {sample_ok}")
    ok &= seek_ok and dec_ok and sample_ok

    eroot = os.path.join(tmp, "entityseg")
    t0 = time.perf_counter()
    emasks = write_entityseg(eroot)
    ds = EntityImage(os.path.join(eroot, "images"), os.path.join(eroot, "entityseg.json"),
                     resolution=SA1B_IMAGE_SIZE, seed=SEED)
    poly_ok = len(ds) == ENTITY_IMAGES
    for image_id, ms in zip(ds.ids, emasks):
        for a, m in zip(ds.anns_by_image[image_id], ms):
            poly_ok &= np.array_equal(decode_segmentation(a["segmentation"], H, W), m)
    item = ds[0]
    ids = np.unique(item["instance_ids"])
    ent_ok = (poly_ok and item["img"].shape == (S, S, 3) and item["instance_ids"].shape == (S, S)
              and ids.min() >= 0 and ids.max() <= ENTITY_POLYGONS and len(ids) > 1)
    times["EntitySeg write, polygon decodes, one sample"] = time.perf_counter() - t0
    log(f"[data] EntitySeg: {ENTITY_IMAGES} images {W}x{H}, {ENTITY_POLYGONS} polygons each, "
        f"each decoding to its rectangle {poly_ok}; EntityImage at {S}: img "
        f"{item['img'].shape}, instance_ids {item['instance_ids'].shape} with {len(ids) - 1} "
        f"instances: {ent_ok}")
    return ok and ent_ok


CONFIG_TEXTS = {
    "base.yaml": "# base\nMODEL:\n  DEPTH: 24\n  DIM: 1024\n  HEADS: [16, 16]\n"
                 "SOLVER:\n  LR: 1.0e-4\n  STEPS: [1000, 2000]\n  AMP: true\n"
                 "DATA:\n  NAME: 'dl3dv'\n  ROOT: ~\n",
    "exp.yaml": "_BASE_: base.yaml\nMODEL:\n  DEPTH: 12\nDATA:\n  ROOT: \"/data/x\"\n"
                "  SETS:\n  - Dl3dv\n  - MvsSynth\n",
    "a.yaml": "model.depth: 4\nmodel.dim: 64\nlr: 0.1\ndata: {name: sa1b, size: 1024}\n",
    "b.yaml": "model.depth: 8\nflags: [yes, off]\n",
}
CONFIG_WANT = (
    {"MODEL": {"DEPTH": 12, "DIM": 1024, "HEADS": [16, 16]},
     "SOLVER": {"LR": 1.0e-4, "STEPS": [1000, 2000], "AMP": True},
     "DATA": {"NAME": "dl3dv", "ROOT": "/data/x", "SETS": ["Dl3dv", "MvsSynth"]}},
    {"model": {"depth": 16, "dim": 64}, "lr": 0.1, "data": {"name": "sa1b", "size": 1024},
     "flags": [True, False], "seed": 7},
)


def check_configs(tmp: str, times: dict) -> bool:
    """A `_BASE_` chain through `CfgNode.load_yaml_with_base`, two dot-keyed
    files plus overrides through `load_opt_from_config_files`, on the
    port's YAML subset reader (PyYAML is not a dependency of the port)."""
    from iggt_official_tpu_torch.utils.arguments import load_config_dict_to_opt
    from iggt_official_tpu_torch.utils.arguments import load_opt_from_config_files
    from iggt_official_tpu_torch.utils.config_io import CfgNode

    root = os.path.join(tmp, "configs")
    os.makedirs(root)
    for name, text in CONFIG_TEXTS.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    t0 = time.perf_counter()
    cfg = CfgNode.load_yaml_with_base(os.path.join(root, "exp.yaml")).to_dict()
    opt = load_opt_from_config_files([os.path.join(root, "a.yaml"), os.path.join(root, "b.yaml")])
    load_config_dict_to_opt(opt, {"model.depth": 16, "seed": 7})
    times["config loads"] = time.perf_counter() - t0
    ok = cfg == CONFIG_WANT[0] and opt == CONFIG_WANT[1]
    log(f"[data] configs: _BASE_ chain {cfg}; dot-keyed files + overrides {opt}; equal to the "
        f"literal dicts: {ok}")
    return ok


def run_data(tmp: str) -> tuple:
    """Phase 10 in ``tmp``; returns (ok, the converted COLMAP scene's root)."""
    times = {}
    t0 = time.perf_counter()
    ok, converted = check_colmap_capture(tmp, times)
    ok &= check_exr_scenes(tmp, times)
    ok &= check_mask_sets(tmp, times)
    ok &= check_configs(tmp, times)
    total = time.perf_counter() - t0
    for k, v in times.items():
        log(f"[data]   host {v:8.3f} s  {k}")
    log(f"[data] phase {total:.1f} s of host time: {'ok' if ok else 'FAIL'}")
    return ok, converted


# ---------------------------------------------------------------------------
# phase 12: parallel -- the mesh paths (parallel/*): a one-rank NCCL world at
# full width on the card, the CLI's one-rank run, and multi-process gloo
# worlds on the CPU

# launches per forward of the full-width 8 x 518 forward on a one-rank mesh:
# all-gather route: 24 frame blocks fused, 24 global blocks prep-only + flash
# (K/V gathered), 24 DINOv2 blocks + the part head flash; the ring route
# attends in plain torch
PARALLEL_LAUNCHES = {"all-gather": {"flash_attention_fused": 24, "qk_prep": 24,
                                    "flash_attention": 49, "nn1": 0, "fused_ln": 0},
                     "ring": {"flash_attention_fused": 24, "qk_prep": 0,
                              "flash_attention": 25, "nn1": 0, "fused_ln": 0}}
PARALLEL_OUTPUTS = ("depth", "world_points", "pose_enc", "part_feat")
PARALLEL_TRAIN_STEPS = 3
# grad_norm of the training cell's first step, FSDP against unsharded: the
# card's step is not bit-reproducible (cuDNN and atomics sum in no fixed
# order); on an H100 80GB HBM3 at 700 W two unsharded runs read up to 2.5e-3
# apart (their gradients 1.1e-2 apart in global L2) and FSDP 4.5e-5 to
# 1.9e-3 from one.  The loss terms come from the forward, which is bit-equal.
PARALLEL_GRAD_NORM_TOL = 1e-2


def run_parallel(launches_out: dict, extra: dict) -> bool:
    """(a) the full-width forward on a one-rank NCCL mesh, all-gather and ring,
    against the unsharded forward; (b) the training cell's steps through
    `train(..., mesh, fsdp=True)` against the unsharded loop, with a
    checkpoint read by the one-card loader; (c) `app/train.py --n_data 1
    --fsdp`, which opens its own one-rank world; (d) the gloo worlds of
    `tests/torch_parallel_worker.py` on this machine's CPU against the
    one-process port."""
    import torch.distributed as dist

    from iggt_official_tpu_torch.parallel.init import DistributedEnv, initialize
    from iggt_official_tpu_torch.parallel.mesh import make_mesh

    ok = True
    # (d) runs on the CPU in a thread of its own once (b)'s timed steps are
    # done, beside (b)'s checkpoint check and (c)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    gloo = []

    def gloo_start():
        if not gloo:
            gloo.append(pool.submit(parallel_gloo_worlds))

    try:
        with tempfile.TemporaryDirectory(prefix="iggt_parallel_") as tmp:
            t0 = time.perf_counter()
            initialize(DistributedEnv(None, 1, 0), "cuda")
            try:
                backend = str(dist.get_backend())
                mesh = make_mesh(device_type="cuda")
                log(f"[parallel] one-rank world: backend {backend}, mesh {mesh.shape}")
                if backend != "nccl":
                    log("[parallel] FAIL: the card's world is not NCCL")
                    ok = False
                ok &= parallel_forward(mesh, tmp, launches_out)
                ok &= parallel_train(mesh, tmp, gloo_start)
            finally:
                dist.destroy_process_group()
            log(f"[parallel] (a) + (b) {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            ok &= parallel_cli(tmp)
            log(f"[parallel] (c) {time.perf_counter() - t0:.1f} s")
        gloo_start()
        t0 = time.perf_counter()
        ok &= gloo[0].result()
        log(f"[parallel] (d) finished {time.perf_counter() - t0:.1f} s after (c)")
    finally:
        pool.shutdown(wait=True)
    return ok


def parallel_forward(mesh, tmp: str, launches_out: dict) -> bool:
    import torch

    from iggt_official_tpu_torch.app.demo import scene_image_paths
    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.models.vggt import build_model
    from iggt_official_tpu_torch.parallel.attention import make_mesh_attention_fns
    from iggt_official_tpu_torch.utils.images import load_and_preprocess_images

    scene = write_scene(tmp, 8, SEED + 2)          # the 8 views 518x518 request's scene
    images = load_and_preprocess_images(scene_image_paths(scene), mode="resize",
                                        resize_target_size=(518, 518))
    x = torch.from_numpy(images[None]).cuda()
    model = build_model(ModelConfig(), device="cuda", seed=SEED)
    ok = True
    with torch.inference_mode():
        ref = model(x)
        ref_s = float(np.median([wall_s(lambda: model(x)) for _ in range(3)]))
        log(f"[parallel] (a) full-width IGGT, 8 views 518x518, bf16 trunk: unsharded forward "
            f"{ref_s:.4f} s (median of 3)")
        for route, ring in (("all-gather", False), ("ring", True)):
            frame_fn, global_fn = make_mesh_attention_fns(mesh, ring=ring)

            def fwd():
                return model(x, attn_fn=frame_fn, global_attn_fn=global_fn, seq=mesh.seq)

            zero_counts()
            out = fwd()
            torch.cuda.synchronize()
            counts = read_counts()
            secs = float(np.median([wall_s(fwd) for _ in range(1 if ring else 3)]))
            errs = {k: rel_err(ref[k], out[k]) for k in PARALLEL_OUTPUTS}
            good = (counts == PARALLEL_LAUNCHES[route]
                    and all(e <= AGREEMENT_TOL["bfloat16"] for e in errs.values())
                    and all(bool(torch.isfinite(out[k]).all()) for k in PARALLEL_OUTPUTS))
            ok &= good
            launches_out[f"parallel_{route}"] = counts
            log(f"[parallel] (a) {route} route: {'ok' if good else 'FAIL'}: launches per "
                f"forward {counts} (want {PARALLEL_LAUNCHES[route]}); max rel err against "
                f"the unsharded forward " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (limit {AGREEMENT_TOL['bfloat16']}, the bf16 trunk's); forward {secs:.4f} s "
                f"({'one run' if ring else 'median of 3'})")
    del model, ref, out
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return ok


def parallel_train(mesh, tmp: str, gloo_start=None) -> bool:
    """The training cell's batch (1 x 4 views 518x392 of the synthetic Dl3dv
    sequence).  One step unsharded and one on the one-rank mesh with FSDP:
    gradients within the bf16 trunk's global L2 limit.  Then
    PARALLEL_TRAIN_STEPS steps through `train()` unsharded and through
    `train(..., mesh, fsdp=True)` (step time, peak memory); the FSDP step's
    loss terms within TRAIN_LOSS_TOL and grad_norm within
    PARALLEL_GRAD_NORM_TOL, or twice the spread of the two unsharded first
    steps where that is larger; the FSDP run's checkpoint read
    by the one-card loader into a one-card IGGT (strict) with the trained
    weights and moments.  ``gloo_start()`` is called once the timed steps are
    done."""
    import gc
    import itertools
    import shutil

    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.data.loader import get_data_loader
    from iggt_official_tpu_torch.models.vggt import build_model
    from iggt_official_tpu_torch.parallel.mesh import local_tensor, parallelize
    from iggt_official_tpu_torch.train.loop import to_device, train
    from iggt_official_tpu_torch.train.step import make_optimizer, make_train_step
    from iggt_official_tpu_torch.utils.checkpoint import load_training_checkpoint

    root = write_train_sequence(os.path.join(tmp, "dl3dv"))
    expr = f"Dl3dv({root!r}, resolution={TRAIN_RESOLUTION}, seed={SEED})"
    batch = next(get_data_loader(expr, seq_min_len=4, seq_max_len=4, batch_size=4,
                                 num_prefetch=0))
    ckpt = os.path.join(tmp, "ckpt")
    need = CKPT_BYTES_PER_PARAM * FULL_PARAMS * 1.05
    if shutil.disk_usage(tmp).free < need:
        log(f"[parallel] (b) FAIL: {tmp} has less than the {need / 1e9:.1f} GB a checkpoint "
            "needs")
        return False

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def one_step(fsdp: bool):
        model = build_model(ModelConfig(), device="cuda", seed=SEED, train=True)
        kw = {}
        if fsdp:
            parallelize(model, mesh, fsdp=True)
            kw = {"mesh": mesh, "fsdp": True}
        opt = make_optimizer(model, layer_decay=0.9, num_layers=24,
                             warmup_steps=TRAIN_WARMUP, total_steps=PARALLEL_TRAIN_STEPS)
        _, metrics = make_train_step(model, opt, **kw)(to_device(batch, torch.device("cuda")))
        grads = {n: local_tensor(p.grad).detach().float().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        sharded = sum(hasattr(p, "to_local") for p in model.parameters())
        del model, opt
        free()
        return {k: float(v) for k, v in metrics.items()}, grads, sharded

    def l2(a, b):
        num = sum(float((a[n].double() - r.double()).pow(2).sum()) for n, r in b.items())
        return (num / sum(float(r.double().pow(2).sum()) for r in b.values())) ** 0.5

    t0 = time.perf_counter()
    m1, g1, _ = one_step(False)
    mf, gf, sharded = one_step(True)
    ok = sharded > 0 and sorted(gf) == sorted(g1)
    fsdp_l2 = l2(gf, g1)
    ok &= fsdp_l2 <= TRAIN_GRAD_L2["bfloat16"]
    log(f"[parallel] (b) step 1 gradients, FSDP against unsharded: global relative L2 "
        f"{fsdp_l2:.3e} (limit {TRAIN_GRAD_L2['bfloat16']}, the bf16 trunk's; two unsharded "
        f"runs read ~1.1e-2 apart on an H100); {sharded} parameters sharded (DTensor); "
        f"{time.perf_counter() - t0:.1f} s")
    del g1, gf

    histories = {}
    for label, kw in (("unsharded", {}), ("fsdp", {"mesh": mesh, "fsdp": True,
                                                   "checkpoint_dir": ckpt,
                                                   "checkpoint_every": PARALLEL_TRAIN_STEPS})):
        free()
        torch.cuda.reset_peak_memory_stats()
        state = train(ModelConfig(), itertools.repeat(batch), PARALLEL_TRAIN_STEPS,
                      device="cuda", rng_seed=SEED, warmup_steps=TRAIN_WARMUP, log_every=10,
                      print_fn=lambda s: None, **kw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        hist = state.history
        step_s = float(np.median([h["wall_s"] for h in hist[1:]]))
        log(f"[parallel] (b) train() {label}: {PARALLEL_TRAIN_STEPS} steps, median of steps "
            f"2-{PARALLEL_TRAIN_STEPS} {step_s:.3f} s ({4 / step_s:.2f} images/s), peak memory "
            f"{peak:.2f} GiB; losses " + ", ".join(f"{h['loss/total']:.6f}" for h in hist)
            + "".join(f"; checkpoint {c['bytes'] / 1e9:.2f} GB in {c['seconds']:.1f} s"
                      for c in state.checkpoints))
        ok &= all(np.isfinite(h["loss/total"]) for h in hist)
        histories[label] = hist
        if label == "fsdp":
            weights = {n: local_tensor(p).detach() for n, p in state.model.named_parameters()}
            moments = {n: t.shape for n, t in state.optimizer.state_dict()["mu"].items()}
        del state
    # step 1's metrics: the one-step FSDP run against the one-step unsharded
    # run, within 1e-3 or twice the spread of the two unsharded step-1 readings
    m2 = histories["unsharded"][0]
    for k, v in m1.items():
        tol = PARALLEL_GRAD_NORM_TOL if k == "grad_norm" else TRAIN_LOSS_TOL
        limit = max(tol * abs(v), 2 * abs(m2[k] - v))
        good = abs(mf[k] - v) <= limit
        ok &= good
        log(f"[parallel] (b) step 1 {k}: unsharded {v:.6f} / {m2[k]:.6f}, FSDP {mf[k]:.6f} "
            f"{'ok' if good else 'FAIL'} (limit {limit:.3e}: {tol} rel or twice the unsharded "
            "runs' spread)")
    if gloo_start is not None:
        gloo_start()
    t0 = time.perf_counter()
    path = os.path.join(ckpt, f"step_{PARALLEL_TRAIN_STEPS:08d}.pt")
    saved = load_training_checkpoint(path)
    one_card = build_model(ModelConfig(), device="meta")
    one_card.load_state_dict(saved["model"], strict=True, assign=True)
    same = all(torch.equal(saved["model"][n].to(w.device), w) for n, w in weights.items())
    mom = {n: t.shape for n, t in saved["optimizer"]["mu"].items()} == moments
    good = same and mom and saved["step"] == PARALLEL_TRAIN_STEPS
    ok &= good
    log(f"[parallel] (b) the FSDP checkpoint through the one-card loader, strict load into a "
        f"one-card IGGT: {'ok' if good else 'FAIL'} (weights equal to the FSDP run's {same}, "
        f"moments {mom}, step {saved['step']}) in {time.perf_counter() - t0:.1f} s")
    del saved, one_card, weights
    free()
    return ok


def parallel_cli(tmp: str) -> bool:
    """`app/train.py --n_data 1 --fsdp` for two steps on the training cell's
    sequence: the CLI opens (and closes) its own one-rank NCCL world."""
    import gc

    import torch
    import torch.distributed as dist

    from iggt_official_tpu_torch.app.train import main as train_main

    root = os.path.join(tmp, "dl3dv")
    expr = f"Dl3dv({root!r}, resolution={TRAIN_RESOLUTION}, seed={SEED})"
    state = train_main(["--dataset", expr, "--batch_size", "4", "--seq_min_len", "4",
                        "--seq_max_len", "4", "--warmup_steps", "1", "--log_every", "1",
                        "--device", "cuda", "--seed", str(SEED), "--steps", "2",
                        "--n_data", "1", "--fsdp"])
    losses = [h["loss/total"] for h in state.history]
    plan = getattr(state.model, "parallel_plan", None)
    ok = (state.step == 2 and all(np.isfinite(losses)) and plan is not None and plan.fsdp
          and not dist.is_initialized())
    log(f"[parallel] (c) app/train.py --n_data 1 --fsdp: {'ok' if ok else 'FAIL'}: steps "
        f"{state.step}, losses {losses}, mesh {plan.mesh.shape if plan else None}, world "
        f"closed after {not dist.is_initialized()}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def parallel_gloo_worlds() -> bool:
    """The gloo worlds of the CPU tests on this machine's torch, without their
    planted faults and the FSDP world's loop (the CPU tests run those; (b)
    checks the checkpoint at full width): 2 data x 2 seq (all-gather and ring
    forward, a step), 2 x 2 x 2 with tensor parallelism (a step, a step of
    `train()` from an unseeded loader whose batch every rank of a data group
    must share, a block with indivisible heads, the ring over 2 x 4 with its
    gradients), 4 x 1 with FSDP (a step), each against the port in one
    process."""
    import torch

    from tests import torch_parallel_worker as worker

    with tempfile.TemporaryDirectory(prefix="iggt_gloo_") as tmp:
        t0 = time.perf_counter()
        paths = worker.write_inputs(tmp)
        worlds = worker.run_worlds(tmp, paths, full=False, side_by_side=True)
        t_worlds = time.perf_counter() - t0
        ref = worker.one_process_reference(paths)
    problems = worker.world_problems(worlds, ref, full=False)
    for p in problems:
        log(f"[parallel] (d) FAIL: {p}")
    readings = []
    for world, key in (("data_seq", "step_main"), ("tp", "step_main"), ("fsdp", "step_fsdp")):
        _, grads, _ = worker.step_outputs(worlds[world])
        glob, per = worker.grad_l2(grads, ref[key]["grads"])
        readings.append(f"{world} gradient global L2 {glob:.2e}, worst tensor {max(per.values()):.2e}")
    shared = worker.loader_digests(worlds["tp"], "trained")
    readings.append("unseeded loader's step: " + ", ".join(
        f"data group {d} trained on {len(set(v))} batch(es) over {len(v)} ranks"
        for d, v in sorted(shared.items())))
    log(f"[parallel] (d) gloo worlds on torch {torch.__version__} ({os.cpu_count()} CPUs): "
        f"{'ok' if not problems else 'FAIL'} in {t_worlds:.1f} s of worlds; " + "; ".join(readings))
    return not problems


# ---------------------------------------------------------------------------
# phase 13: the JAX package's last modules (SwiGLU blocks, GeoProjector,
# RuntimeConfig.use_flash_attention=False)

MODULES_VIEWS, MODULES_SIZE = 8, 518     # the 8 views 518x518 request's forward
MODULE_BLOCKS = (
    # (label, qk-norm and RoPE, over all views (global), the wrapper launched once)
    ("frame swiglu block", True, False, "flash_attention_fused"),
    ("global swiglu block", True, True, "flash_attention_fused"),
    ("DINOv2-style swiglu block", False, False, "flash_attention"),
)
GEO_CPU_VIEWS = 2              # views of the GeoProjector the CPU side runs
GEO_TOL = 1e-5                 # fp32, TF32 off: card and CPU differ in summation order
# use_flash_attention=False: the part head's cross-attention keeps the
# dispatcher (the JAX package's CrossAttention has no attn_fn from the model)
NO_FLASH_LAUNCHES = {"flash_attention_fused": 0, "flash_attention": 1, "qk_prep": 0,
                     "nn1": 0, "fused_ln": 0}


def run_modules(launches_out: dict) -> bool:
    import torch

    counts = launches_out.setdefault("modules", {})
    ok = swiglu_blocks(counts)
    ok &= geo_projector()
    with tempfile.TemporaryDirectory(prefix="iggt_modules_") as tmp:
        ok &= forward_without_flash(tmp, counts)
    torch.cuda.empty_cache()
    return ok


def swiglu_blocks(counts_out: dict) -> bool:
    """Each `MODULE_BLOCKS` block (seeded weights, no LayerScale, bf16) through
    the kernel dispatcher against `sdpa_plain` on the card; the frame and
    DINOv2 blocks on view 0 against a CPU copy, where w12's halves swapped
    must fail."""
    import copy

    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.layers.blocks import Block, sdpa_plain
    from iggt_official_tpu_torch.layers.rope import compute_rope_2d, make_patch_positions
    from iggt_official_tpu_torch.ops.flash_attention import attention
    from iggt_official_tpu_torch.utils.init import init_params

    agg = ModelConfig().aggregator
    tol = AGREEMENT_TOL["bfloat16"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grid = MODULES_SIZE // agg.patch_size
    V, P = MODULES_VIEWS, agg.patch_start_idx + grid * grid
    ok = True
    for label, qk_rope, over_views, kernel in MODULE_BLOCKS:
        shape = (1, V * P, agg.embed_dim) if over_views else (V, P, agg.embed_dim)
        with torch.device("cuda"):
            blk = Block(agg.embed_dim, agg.num_heads, qk_norm=qk_rope, ffn_layer="swiglu",
                        dtype=torch.bfloat16, ln_eps=1e-5 if qk_rope else 1e-6,
                        attn_fn=attention)
        init_params(blk, gen)
        blk.eval().requires_grad_(False)
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

        def rope_for(views, device):
            if not qk_rope:
                return None
            pos = make_patch_positions(grid, grid, views, agg.patch_start_idx, device=device)
            rope = compute_rope_2d(pos, agg.embed_dim // agg.num_heads, agg.rope_freq)
            return rope.map(lambda t: t.reshape(1 if over_views else views, -1, t.shape[-1]))

        rope = rope_for(V, "cuda")
        with torch.inference_mode():
            zero_counts()
            out = blk(x, rope)
            torch.cuda.synchronize()
            counts = read_counts()
            plain = blk(x, rope, attn_fn=sdpa_plain)
            err = rel_err(plain, out)
            kernel_s = wall_s(lambda: blk(x, rope))
            plain_s = wall_s(lambda: blk(x, rope, attn_fn=sdpa_plain))
        want = {k: int(k == kernel) for k in counts}
        good = counts == want and err <= tol and bool(torch.isfinite(out).all())
        counts_out[label] = counts
        line = (f"[modules] {label} {tuple(shape)} bf16: launches {counts} (want {want}); "
                f"against sdpa_plain on the card max rel err {err:.3e} (limit {tol}, the bf16 "
                f"trunk's); block {kernel_s * 1e3:.2f} ms through the kernel, "
                f"{plain_s * 1e3:.2f} ms through sdpa_plain")
        if not over_views:
            cpu = copy.deepcopy(blk).cpu()
            cpu_rope = rope_for(1, "cpu")
            with torch.inference_mode():
                ref = cpu(x[:1].cpu(), cpu_rope, attn_fn=sdpa_plain)
                rope0 = rope_for(1, "cuda")
                cpu_err = rel_err(ref, blk(x[:1], rope0))
                good &= cpu_err <= tol
                line += f"; view 0 against the CPU {cpu_err:.3e}"
                if qk_rope:
                    w, b = blk.mlp.w12.weight, blk.mlp.w12.bias
                    h = w.shape[0] // 2
                    saved = w.clone(), b.clone()
                    w.copy_(torch.cat([w[h:], w[:h]]))
                    b.copy_(torch.cat([b[h:], b[:h]]))
                    fault_err = rel_err(ref, blk(x[:1], rope0))
                    w.copy_(saved[0])
                    b.copy_(saved[1])
                    good &= fault_err > tol
                    line += f"; planted fault (w12's halves swapped) {fault_err:.3e}, must fail"
        ok &= good
        log(line if good else line.replace("[modules] ", "[modules] FAIL ", 1))
        del blk, x, out, plain
        torch.cuda.empty_cache()
    return ok


def geo_projector() -> bool:
    """`GeoProjector(2048)` (seeded weights) on four seeded bf16 token maps of
    the 8x518 forward's shape, TF32 off, against the CPU on the first
    `GEO_CPU_VIEWS` views; the level-0 ConvTranspose kernel left unflipped
    must fail."""
    import copy

    import torch

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.heads.adaptor import GeoProjector
    from iggt_official_tpu_torch.utils.init import init_params

    cfg = ModelConfig()
    psi = cfg.aggregator.patch_start_idx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    with torch.device("cuda"):
        proj = GeoProjector(cfg.part.dim_in, cfg.patch_size,
                            intermediate_layer_idx=cfg.part.intermediate_layer_idx,
                            out_channels=cfg.part.out_channels)
    init_params(proj, gen)
    for p in proj.parameters():     # biases and the norm away from 0 and 1
        if p.ndim == 1:
            p.data.add_(0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
    g = MODULES_SIZE // cfg.patch_size
    P, V, hw = psi + g * g, MODULES_VIEWS, (MODULES_SIZE, MODULES_SIZE)
    tokens = [None] * cfg.aggregator.depth
    for i in proj.intermediate_layer_idx:
        tokens[i] = torch.randn((1, V, P, cfg.part.dim_in), generator=gen,
                                device="cuda").to(torch.bfloat16)
    cpu = copy.deepcopy(proj).cpu()
    with torch.inference_mode():
        out = proj(tokens, hw, psi)
        secs = wall_s(lambda: proj(tokens, hw, psi))
        n = GEO_CPU_VIEWS
        ref = cpu([None if t is None else t[:, :n].cpu() for t in tokens], hw, psi)
        errs = {k: rel_err(ref[k], out[k][:n]) for k in ref}
        w = proj.resize_layers[0].weight
        w.copy_(w.flip(2, 3))
        fault = rel_err(ref["res2"], proj(tokens, hw, psi)["res2"][:n])
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    c = proj.resize_layers[3].out_channels
    good = (all(e <= GEO_TOL for e in errs.values()) and fault > GEO_TOL
            and shapes == {"res2": (V, 4 * g, 4 * g, c), "res3": (V, 2 * g, 2 * g, c),
                           "res4": (V, g, g, c), "res5": (V, (g + 1) // 2, (g + 1) // 2, c)}
            and all(bool(torch.isfinite(v).all()) for v in out.values()))
    log(f"[modules] {'' if good else 'FAIL '}GeoProjector({cfg.part.dim_in}) on 4 x "
        f"(1, {V}, {P}, {cfg.part.dim_in}) bf16 tokens, fp32, TF32 off: {shapes}; against the "
        f"CPU on views 0-{n - 1} max rel err " + ", ".join(f"{k} {e:.3e}" for k, e in
                                                        errs.items())
        + f" (limit {GEO_TOL}); planted fault (level-0 ConvTranspose unflipped) res2 "
        f"{fault:.3e}, must fail; {secs * 1e3:.2f} ms on the card")
    return good


def forward_without_flash(tmp: str, counts_out: dict) -> bool:
    """The 8x518 scene's forward through `IGGTProcessor` by default and with
    `RuntimeConfig(use_flash_attention=False)`, in turns after a warm-up of
    each: launch counts, `sdpa_plain` calls, outputs within the bf16 trunk's
    limit of the default forward's, wall times."""
    import torch

    from iggt_official_tpu_torch.app import demo
    from iggt_official_tpu_torch.config import RuntimeConfig

    scene = write_scene(tmp, MODULES_VIEWS, SEED + 2)   # the 8 views 518x518 request's scene
    proc = demo.IGGTProcessor(device="cuda", seed=SEED)
    hw = (MODULES_SIZE, MODULES_SIZE)
    runtimes = {"default": RuntimeConfig(image_size=hw),
                "use_flash_attention=False": RuntimeConfig(image_size=hw,
                                                           use_flash_attention=False)}
    agg = proc.cfg.aggregator
    n_plain = 2 * agg.depth + agg.vit.depth       # DINOv2, frame and global blocks
    want = {"default": {"flash_attention_fused": 2 * agg.depth,
                        "flash_attention": agg.vit.depth + 1, "qk_prep": 0, "nn1": 0,
                        "fused_ln": 0},
            "use_flash_attention=False": NO_FLASH_LAUNCHES}
    plain_calls = []
    sdpa_plain = demo.sdpa_plain

    def counted(q, k, v):
        plain_calls.append(q.shape)
        return sdpa_plain(q, k, v)

    demo.sdpa_plain = counted
    try:
        outs, counts, calls, walls = {}, {}, {}, {k: [] for k in runtimes}
        for label, runtime in runtimes.items():
            proc.runtime = runtime
            zero_counts()
            del plain_calls[:]
            outs[label] = proc._run_inference(scene)
            torch.cuda.synchronize()
            counts[label], calls[label] = read_counts(), len(plain_calls)
        for label in list(runtimes) + list(runtimes)[::-1]:
            proc.runtime = runtimes[label]
            walls[label].append(wall_s(lambda: proc._run_inference(scene)))
    finally:
        demo.sdpa_plain = sdpa_plain
    ref, out = outs["default"], outs["use_flash_attention=False"]
    errs = {k: rel_err(ref[k], out[k]) for k in OUTPUTS}
    good = (counts == want and calls == {"default": 0, "use_flash_attention=False": n_plain}
            and all(e <= AGREEMENT_TOL["bfloat16"] for e in errs.values())
            and all(bool(torch.isfinite(out[k]).all()) for k in OUTPUTS))
    counts_out.update({f"{k} 8x518 forward": v for k, v in counts.items()})
    log(f"[modules] {'' if good else 'FAIL '}IGGTProcessor {MODULES_VIEWS} views "
        f"{MODULES_SIZE}x{MODULES_SIZE} forward "
        f"(_run_inference): launches {counts} (want {want}); sdpa_plain calls {calls}; "
        f"use_flash_attention=False against the default, max rel err "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (limit {AGREEMENT_TOL['bfloat16']}, the bf16 trunk's); wall s in turns "
        + json.dumps({k: [round(t, 4) for t in v] for k, v in walls.items()})
        + f" on {nvidia_smi_line()}")
    del proc, outs
    return good


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


def main(phases=("device", "build", "kernels", "conv3x3", "agreement", "postproc", "requests",
                 "batch_eval", "modules", "sam2", "sam2_video", "data", "train",
                 "parallel")) -> int:
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
    launches, extra = {}, {}
    if "conv3x3" in phases:
        conv = check_conv3x3()
        results += conv
        ok &= all(r["ok"] for r in conv)
        forwards = run_conv3x3_forwards()
        ok &= all(f["ok"] for f in forwards.values())
        launches["conv3x3"] = forwards["iggt"]["launches"]
        launches["conv3x3_vggt"] = forwards["vggt"]["launches"]
    if "agreement" in phases:
        ok &= check_agreement()
        ok &= check_postproc_agreement()
    if "postproc" in phases:
        ok &= run_postproc(launches)
    if "requests" in phases:
        ok &= run_requests(launches, extra, phases)
    elif "batch_eval" in phases:                 # alone, on a processor of its own
        from iggt_official_tpu_torch.app.demo import IGGTProcessor

        with tempfile.TemporaryDirectory() as tmp:
            ok &= run_batch_eval(IGGTProcessor(device="cuda", seed=SEED), tmp, launches)
    if "modules" in phases:
        t0 = time.perf_counter()
        ok &= run_modules(launches)
        log(f"[modules] phase {time.perf_counter() - t0:.1f} s of wall time")
    if "sam2" in phases:
        hiera = check_hiera_kernels()
        presets = [r for D, cases in hiera_preset_cases().items()
                   for r in check_hiera_kernels(D, cases, HIERA_PRESET_KERNEL[D])]
        results += hiera + presets
        ok &= all(r["ok"] for r in hiera + presets)
        ok &= check_sam2_agreement()
        ok &= run_sam2(launches, hiera)
        ok &= run_sam2_presets(launches, presets)
    if "sam2_video" in phases:
        ok &= check_video_agreement()
        ok &= run_sam2_video(launches)
    with tempfile.TemporaryDirectory(prefix="iggt_data_") as tmp:
        if "data" in phases or "train" in phases:
            # the train phase steps on this phase's scenes, so it runs it too
            t0 = time.perf_counter()
            data_ok, converted = run_data(tmp)
            log(f"[data] phase {time.perf_counter() - t0:.1f} s of wall time")
            ok &= data_ok
        if "train" in phases:
            t0 = time.perf_counter()
            ok &= run_train(launches, {"tmp": tmp, "converted": converted})
            log(f"[train] phase {time.perf_counter() - t0:.1f} s of wall time")
    if "parallel" in phases:
        t0 = time.perf_counter()
        ok &= run_parallel(launches, extra)
        log(f"[parallel] phase {time.perf_counter() - t0:.1f} s of wall time")

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
