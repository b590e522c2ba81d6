#!/usr/bin/env python3
"""Peak device memory of the track head's DPT feature extractor, by module.

    python3 scripts/track_memory_probe.py

Runs `TrackHead(TrackHeadConfig()).feature_extractor` (fp32, seeded weights)
on 24 random bf16 token maps of 8 views at 518x518 px, once with cuDNN and
once without, and prints after each top-level module the memory allocated
and the peak so far (`torch.cuda.max_memory_allocated`).  Needs one CUDA
card.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iggt_official_tpu_torch.config import TrackHeadConfig  # noqa: E402
from iggt_official_tpu_torch.heads.track.track_head import TrackHead  # noqa: E402
from iggt_official_tpu_torch.utils.init import init_params  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("track_memory_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    head = TrackHead(TrackHeadConfig()).to(dev).eval()
    init_params(head, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = [torch.randn((1, 8, 1374, 2048), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(24)]
    marks = []

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks.append((name, torch.cuda.memory_allocated() / 2 ** 30,
                          torch.cuda.max_memory_allocated() / 2 ** 30))
        return hook

    fe = head.feature_extractor
    for name, mod in fe.named_modules():
        if name and name.count(".") <= 1:
            mod.register_forward_hook(mark(name))
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        marks.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        with torch.inference_mode():
            out = fe(tokens, (518, 518), 5)
            torch.cuda.synchronize()
        print(f"cudnn {cudnn}: allocated before {base:.2f} GiB, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, output {tuple(out.shape)}")
        for name, alloc, peak in marks:
            print(f"  after {name:28s} allocated {alloc:.2f} GiB, peak so far {peak:.2f} GiB")
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
