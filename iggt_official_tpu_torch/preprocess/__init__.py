"""Offline dataset preprocessing.

Behavioural parity: `dataset_preprocess/` — the reference converts raw
captures (COLMAP reconstructions, ARKitScenes, ScanNet++, Habitat renders)
into the common processed layout its loaders read
(`<split>/<seq>/{color,depth,cam}/`).  `convert_colmap_scene` covers the
COLMAP-based pipelines (Re10K/DL3DV/MegaDepth-style) on top of the
port's model readers (`data/colmap.py`).  Counterpart of
`iggt_official_tpu/preprocess/`, copied; no converter imports cv2, PyYAML or
scipy at module level.
"""

from iggt_official_tpu_torch.preprocess.colmap_scene import convert_colmap_scene

__all__ = ["convert_colmap_scene"]
