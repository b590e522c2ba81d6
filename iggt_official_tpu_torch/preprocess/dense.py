"""COLMAP dense (MVS) array IO.

Counterpart of `iggt_official_tpu/preprocess/dense.py`, copied.
Format parity: `dataset_preprocess/read_write_dense.py:40-80` (COLMAP
`src/mvs/mat.h`): an ASCII ``width&height&channels&`` header followed by
column-major float32 data.
"""

from __future__ import annotations

import numpy as np


def read_colmap_array(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"truncated COLMAP array header in {path}")
            header += byte
        width, height, channels = (
            int(t) for t in header.split(b"&")[:3]
        )
        data = np.fromfile(f, np.float32)
    arr = data.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_colmap_array(array: np.ndarray, path: str) -> None:
    array = np.asarray(array, np.float32)
    if array.ndim == 2:
        height, width, channels = *array.shape, 1
    elif array.ndim == 3:
        height, width, channels = array.shape
    else:
        raise ValueError(f"expected 2D/3D array, got {array.shape}")
    with open(path, "wb") as f:
        f.write(f"{width}&{height}&{channels}&".encode())
        np.transpose(
            array.reshape(height, width, channels), (1, 0, 2)
        ).flatten(order="F").astype(np.float32).tofile(f)
