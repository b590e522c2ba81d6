"""First-party COCO run-length-encoding codec (pycocotools.mask replacement).

Counterpart of `iggt_official_tpu/data/rle.py`, copied: the reference decodes
SAM2 masklet pseudo-GT with `pycocotools.mask.decode`.  COCO RLE stores
column-major run lengths; the "compressed" form packs them as 5-bit
LEB128-style chunks offset by 48 with delta coding from the third count on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np


def _decode_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: List[int]) -> str:
    out: List[str] = []
    for idx, c in enumerate(counts):
        x = int(c)
        if idx > 2:
            x -= int(counts[idx - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            if chunk & 0x10:
                more = x != -1
            else:
                more = x != 0
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def decode(rle: Dict[str, Any]) -> np.ndarray:
    """COCO RLE dict -> (H, W) uint8 mask (column-major runs)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    idx = 0
    val = 0
    for run in counts:
        if val:
            flat[idx : idx + run] = 1
        idx += run
        val ^= 1
    return flat.reshape(w, h).transpose()


def encode(mask: np.ndarray, compress: bool = True) -> Dict[str, Any]:
    """(H, W) mask -> COCO RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).transpose().reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {
        "size": [h, w],
        "counts": _encode_counts(counts) if compress else counts,
    }


def area(rle: Dict[str, Any]) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_counts(counts)
    return int(sum(counts[1::2]))
