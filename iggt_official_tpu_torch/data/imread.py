"""cv2-free image reads for the data layer, byte-equal to OpenCV's.

The JAX package reads depth PNGs and sky masks with ``cv2.imread``; the
card machine has no OpenCV, so the port decodes with PIL and lays the
result out as cv2 does:

- `imread_unchanged` (``IMREAD_UNCHANGED``): a single-channel PNG keeps its
  depth (uint8 or uint16); colour comes back in cv2's channel order, BGR or
  BGRA;
- `imread_anydepth` (``IMREAD_ANYCOLOR | IMREAD_ANYDEPTH``): the same
  without an alpha channel;
- `imread_grayscale` (``IMREAD_GRAYSCALE``): for JPEGs (the sky masks)
  PIL's draft mode has libjpeg decode straight to luma, as cv2 does, byte
  for byte; a greyscale PNG is read as it is; a colour PNG goes through
  PIL's RGB -> L, which can differ from cv2's by one level.

Formats PIL cannot read the way cv2 does are refused: EXR raises an
ImportError that names cv2, and a PNG mode without a cv2 layout here raises
ValueError.
"""

from __future__ import annotations

import numpy as np
import PIL.Image


def _exr_error(path: str) -> ImportError:
    return ImportError(f"{path}: reading EXR needs OpenCV (cv2), which this port does not "
                       "use; convert the depth maps to .npy (depth_mode 'npy')")


def _decode(path: str, alpha: bool) -> np.ndarray:
    if path.lower().endswith(".exr"):
        raise _exr_error(path)
    with PIL.Image.open(path) as im:
        mode = im.mode
        if mode in ("L", "I;16", "I;16L", "I;16B", "I"):
            a = np.asarray(im)
            if mode == "I":   # older Pillow opens 16-bit greyscale PNGs as int32
                a = a.astype(np.uint16)
            return np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("="))
        if mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
            mode = im.mode
        if mode == "RGBA" and not alpha:
            im, mode = im.convert("RGB"), "RGB"
        if mode in ("RGB", "RGBA"):
            a = np.asarray(im)
            order = [2, 1, 0, 3] if mode == "RGBA" else [2, 1, 0]
            return np.ascontiguousarray(a[..., order])
    raise ValueError(f"{path}: image mode {mode} has no cv2 layout here")


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``."""
    return _decode(path, alpha=True)


def imread_anydepth(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)``."""
    return _decode(path, alpha=False)


def imread_grayscale(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (uint8, H x W)."""
    if path.lower().endswith(".exr"):
        raise _exr_error(path)
    with PIL.Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("L", im.size)
        if im.mode != "L":
            im = im.convert("L")
        return np.asarray(im).copy()
