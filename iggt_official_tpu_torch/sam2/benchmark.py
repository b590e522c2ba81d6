"""SAM2 video-propagation throughput benchmark (counterpart of
`iggt_official_tpu/sam2/benchmark.py`, `sam2/benchmark.py:43-86`): warm-up,
then timed propagation of one point-prompted object over a frame stack,
reporting total time and FPS.  Frames are seeded noise unless a directory
of images is given.

    python -m iggt_official_tpu_torch.sam2.benchmark [--frames N] [--size S]
        [--image_size R] [--preset t|s|b+|l] [--streaming] [--device cpu]

Runs on the card unless ``--device cpu``; random weights from the seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import time
from typing import List, Optional

import numpy as np
import torch


def load_frames(video_dir: Optional[str], num_frames: int, size: int) -> List[np.ndarray]:
    if video_dir:
        from PIL import Image

        paths = sorted(glob.glob(f"{video_dir}/*"))[:num_frames]
        return [np.asarray(Image.open(p).convert("RGB")) for p in paths]
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (size, size, 3), dtype=np.uint8) for _ in range(num_frames)]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--video_dir", default=None)
    parser.add_argument("--frames", type=int, default=25)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--image_size", type=int, default=512,
                        help="model resolution (1024 = full SAM2)")
    parser.add_argument("--tiny", action="store_true", help="use the tiny test config")
    parser.add_argument("--preset", default="l", choices=["t", "s", "b+", "l"],
                        help="hiera size preset (sam2.1 generation)")
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--streaming", action="store_true",
                        help="per-frame streaming loop instead of the ring-buffer batch loop")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> float:
    """Run the benchmark; prints the total time and FPS, returns the FPS."""
    args = parse_args(argv)
    from iggt_official_tpu_torch.sam2.build import build_sam2_video_predictor
    from iggt_official_tpu_torch.sam2.config import (sam2_hiera_b_plus, sam2_hiera_l,
                                                     sam2_hiera_s, sam2_hiera_t)

    cfg = {"t": sam2_hiera_t, "s": sam2_hiera_s, "b+": sam2_hiera_b_plus,
           "l": sam2_hiera_l}[args.preset]()
    if args.tiny:
        cfg = cfg.scaled(image_size=args.image_size)
    else:
        cfg = dataclasses.replace(cfg, image_size=args.image_size)
    predictor = build_sam2_video_predictor(cfg, device=args.device)
    frames = load_frames(args.video_dir, args.frames, args.size)
    state = predictor.init_state(frames)
    point = np.array([[frames[0].shape[1] / 2, frames[0].shape[0] / 2]])

    def prompt():
        predictor.add_new_points_or_box(state, frame_idx=0, obj_id=1, points=point,
                                        labels=np.array([1]))

    propagate = (predictor.propagate_in_video if args.streaming
                 else predictor.propagate_in_video_batch)
    prompt()
    for i, _ in enumerate(propagate(state)):     # warm-up
        if args.streaming and i >= args.warmup:
            break
    predictor.reset_state(state)
    prompt()
    _sync(predictor.device)
    t0 = time.perf_counter()
    count = 0
    for _, _, masks in propagate(state):
        # finish this frame's work with a small fetch, not the whole mask
        masks[..., ::64, ::64].cpu()
        count += 1
    dt = time.perf_counter() - t0
    print(f"Total Time: {dt:.2f}s over {count} frames")
    print(f"FPS: {count / dt:.2f}")
    return count / dt


if __name__ == "__main__":
    main()
