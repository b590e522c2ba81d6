#!/usr/bin/env python3
"""Time the flash-attention kernels of one checkout of this repository.

    python3 scripts/flash_ab.py TREE TAG

TREE is the root of a checkout (this one, or an older commit unpacked with
`git archive` into a directory that `.gitignore` lists), TAG a label for the
output.  Needs a CUDA card.  For every flash case of the tree's
`chip_smoke.KERNEL_CASES` (plus the fused global-block case and the fp32
fused frame and global cases, which older trees lack) it prints the time of one wrapper call from CUDA events over 20
calls after warm-up (`chip_smoke.time_ms`) and the device time of the
`flash_kernel*` kernels per call from `torch.profiler`; then the host time of
one wrapper call at a tiny shape (1, 16, 1, D), where the device is idle, and
of the ctypes call into the library alone.  The last line is
`AB <TAG> {json}`.  To compare two commits, run both in one call on one card,
in turns: parent, change, change, parent.
"""

import json
import math
import os
import sys
import time


def main(tree: str, tag: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from iggt_official_tpu_torch.layers.rope import (
        compute_rope_2d, make_patch_positions, pack_rope_tables,
    )
    from iggt_official_tpu_torch.ops import cuda_build
    from iggt_official_tpu_torch.ops import flash_attention as fa

    cuda_build.build("flash_attention")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = list(chip_smoke.KERNEL_CASES)
    for label, shape, dtype_name in (
            ("global block q/k prep, 8 views 518px", (1, 10992, 16, 64), "bfloat16"),
            ("frame block q/k prep, fp32 trunk, 8 views 518px", (8, 1374, 16, 64), "float32"),
            ("global block q/k prep, fp32 trunk, 8 views 518px", (1, 10992, 16, 64),
             "float32")):
        if not any(case[0] == label for case in cases):
            cases.append((label, "flash_attention_fused", shape, dtype_name, False))
    grid = {1374: (37, 37, 1), 869: (24, 36, 1), 10992: (37, 37, 8)}
    out = {}
    for label, kernel, (B, N, H, D), dtype_name, with_bias in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = torch.randn((B, N, 3, H, D), generator=gen, device=dev).to(dtype).unbind(2)
        bias = torch.randn((B, N), generator=gen, device=dev) if with_bias else None
        if kernel == "flash_attention_fused":
            h, w, views = grid[N]
            pos = make_patch_positions(h, w, B * views, N // views - h * w,
                                       device=dev).reshape(B, N, 2)
            cos, sin = pack_rope_tables(compute_rope_2d(pos, D))
            norm = tuple(torch.randn((D,), generator=gen, device=dev) for _ in range(4))

            def fn():
                return fa.flash_attention_fused(q, k, v, cos, sin, norm, bias)
        else:
            def fn():
                return fa.flash_attention(q, k, v, bias)
        ms = chip_smoke.time_ms(fn, iters=20, warmup=3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                        if "flash_kernel" in e.key)
        out[label] = {"ms": round(ms, 4), "device_ms": round(device_us / 10 / 1e3, 4)}

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        return round(dt, 2)

    q, k, v = torch.randn((1, 16, 3, 1, 64), device=dev).to(torch.bfloat16).unbind(2)
    out["host us per wrapper call (1, 16, 1, 64)"] = host_us(lambda: fa.flash_attention(q, k, v))
    lib = fa._kernel()
    o = torch.empty_like(q)
    args = [1, 64, 0, 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
            None, None, 0, 0, None, None, None, None]
    if len(lib.iggt_flash_attention.argtypes) >= 35:     # with the prepped q/k scratch pointers
        args += [None, None]
    args += [1, 1, 16, 16, *(t.stride(i) for t in (q, k, v) for i in range(3)),
             1 / math.sqrt(64), 1e-5]
    if len(lib.iggt_flash_attention.argtypes) == 36:     # with the planted-fault code
        args += [0]
    args += [torch.cuda.current_stream().cuda_stream]
    out["host us per ctypes call"] = host_us(lambda: lib.iggt_flash_attention(*args))
    print(f"AB {tag} " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
