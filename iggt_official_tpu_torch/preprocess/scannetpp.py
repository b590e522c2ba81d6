"""ScanNet++ semantic-annotation copy.

Counterpart of `iggt_official_tpu/preprocess/scannetpp.py`, copied.
Parity target: `dataset_preprocess/preprocess_scannetpp_sem.py:13-160` —
copy per-frame ``obj_ids`` semantic annotations into a processed scene
directory, only for frames that exist there, with a thread pool.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple


def get_image_frames(images_dir: str) -> List[str]:
    """Frame stems present in a scene's images directory."""
    exts = (".jpg", ".jpeg", ".png")
    return sorted(
        os.path.splitext(f)[0]
        for f in os.listdir(images_dir)
        if f.lower().endswith(exts)
    )


def copy_semantic_annotations(
    processed_dir: str,
    obj_ids_dir: str,
    scene: str,
    max_workers: int = 8,
) -> Tuple[int, List[str]]:
    """Copy ``<obj_ids_dir>/<scene>/<frame>.png`` next to each processed
    frame; returns (#copied, failed frame names)."""
    scene_dir = os.path.join(processed_dir, scene)
    images_dir = os.path.join(scene_dir, "images")
    src_dir = os.path.join(obj_ids_dir, scene)
    dst_dir = os.path.join(scene_dir, "obj_ids")
    os.makedirs(dst_dir, exist_ok=True)
    frames = get_image_frames(images_dir)

    def copy_one(frame: str):
        src = os.path.join(src_dir, frame + ".png")
        if not os.path.isfile(src):
            return frame, False
        try:
            shutil.copy2(src, os.path.join(dst_dir, frame + ".png"))
            return frame, True
        except OSError:
            return frame, False

    failed: List[str] = []
    ok = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for frame, success in pool.map(copy_one, frames):
            if success:
                ok += 1
            else:
                failed.append(frame)
    return ok, failed


def copy_all_scenes(
    processed_dir: str, obj_ids_dir: str, max_workers: int = 8
) -> Dict[str, int]:
    out = {}
    for scene in sorted(os.listdir(processed_dir)):
        if os.path.isdir(os.path.join(processed_dir, scene, "images")):
            ok, _ = copy_semantic_annotations(
                processed_dir, obj_ids_dir, scene, max_workers
            )
            out[scene] = ok
    return out
