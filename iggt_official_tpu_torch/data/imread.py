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

EXR depth (`read_exr`) is read by a reader of single-part scanline OpenEXR
files: compression NONE, ZIPS or ZIP (zlib over the format's byte
interleave and delta predictor), channels HALF or FLOAT; it returns what
``cv2.imread(path, IMREAD_UNCHANGED)`` returns for such a file, float32,
one ``Y`` channel as (H, W), ``R G B [A]`` as (H, W, 3 or 4) in cv2's BGR(A)
order.  Any other compression, a tiled, deep or multi-part file, another
channel type or set raises ValueError naming what it found.  A PNG mode
without a cv2 layout here raises ValueError too, and a greyscale read of an
EXR raises.
"""

from __future__ import annotations

import zlib

import numpy as np
import PIL.Image

EXR_MAGIC = b"\x76\x2f\x31\x01"
EXR_COMPRESSIONS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A", "DWAA",
                    "DWAB")
_EXR_LINES = {"NONE": 1, "ZIPS": 1, "ZIP": 16}          # scanlines per chunk
_EXR_TYPES = {1: ("HALF", np.dtype("<f2")), 2: ("FLOAT", np.dtype("<f4"))}
_EXR_FLAGS = {0x200: "a tiled file", 0x800: "deep data", 0x1000: "a multi-part file"}
_EXR_LONG_NAMES = 0x400


def _exr_header(data: bytes, path: str):
    """(attributes {name: (type, bytes)}, offset of the offset table)."""
    if data[:4] != EXR_MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file (magic {data[:4].hex(' ')})")
    version = int.from_bytes(data[4:8], "little")
    if version & 0xFF != 2:
        raise ValueError(f"{path}: OpenEXR version {version & 0xFF}, not 2")
    for bit, what in _EXR_FLAGS.items():
        if version & bit:
            raise ValueError(f"{path}: {what} (only single-part scanline files are read)")
    if version & ~0xFF & ~_EXR_LONG_NAMES:
        raise ValueError(f"{path}: unknown version flags {version:#x}")
    attrs, pos = {}, 8
    while True:
        end = data.find(b"\0", pos)
        if end < 0:
            raise ValueError(f"{path}: truncated header")
        name = data[pos:end].decode("latin-1")
        pos = end + 1
        if not name:
            return attrs, pos
        end = data.find(b"\0", pos)
        if end < 0 or end + 5 > len(data):
            raise ValueError(f"{path}: truncated header at attribute {name!r}")
        kind = data[pos:end].decode("latin-1")
        size = int.from_bytes(data[end + 1:end + 5], "little", signed=True)
        pos = end + 5
        if size < 0 or pos + size > len(data):
            raise ValueError(f"{path}: truncated header at attribute {name!r}")
        attrs[name] = (kind, data[pos:pos + size])
        pos += size


def _exr_channels(raw: bytes, path: str):
    """[(name, pixel type name, dtype)] in the file's order."""
    out, pos = [], 0
    while raw[pos:pos + 1] not in (b"\0", b""):
        end = raw.find(b"\0", pos)
        name = raw[pos:end].decode("latin-1")
        ptype, _plinear, xs, ys = np.frombuffer(raw[end + 1:end + 17], "<i4")
        ptype = int(ptype)
        if ptype not in _EXR_TYPES:
            raise ValueError(f"{path}: channel {name!r} has pixel type "
                             f"{('UINT' if ptype == 0 else ptype)} (HALF and FLOAT are read)")
        if (xs, ys) != (1, 1):
            raise ValueError(f"{path}: channel {name!r} is subsampled ({xs}, {ys})")
        out.append((name, *_EXR_TYPES[ptype]))
        pos = end + 17
    return out


def _exr_unzip(chunk: bytes, size: int, path: str) -> np.ndarray:
    """zlib, then undo the delta predictor and the two-half byte interleave."""
    t = np.frombuffer(zlib.decompress(chunk), np.uint8)
    if t.size != size:
        raise ValueError(f"{path}: a ZIP chunk inflates to {t.size} bytes, not {size}")
    d = t.copy()
    d[1:] -= 128                        # uint8: wraps modulo 256
    t = np.cumsum(d, dtype=np.uint8)    # t[i] = t[i-1] + d[i] - 128
    out = np.empty(size, np.uint8)
    half = (size + 1) // 2
    out[0::2], out[1::2] = t[:half], t[half:]
    return out


def read_exr(path: str, alpha: bool = True) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)`` of a single-part scanline
    OpenEXR file (``alpha=False``: ``IMREAD_ANYCOLOR | IMREAD_ANYDEPTH``)."""
    with open(path, "rb") as f:
        data = f.read()
    attrs, pos = _exr_header(data, path)
    for need in ("channels", "compression", "dataWindow"):
        if need not in attrs:
            raise ValueError(f"{path}: the header has no {need!r} attribute")
    if "tiles" in attrs:
        raise ValueError(f"{path}: a tiled file (only scanline files are read)")
    code = attrs["compression"][1][0]
    name = EXR_COMPRESSIONS[code] if code < len(EXR_COMPRESSIONS) else f"#{code}"
    if name not in _EXR_LINES:
        raise ValueError(f"{path}: compression {name} (NONE, ZIPS and ZIP are read)")
    lines = _EXR_LINES[name]
    chans = _exr_channels(attrs["channels"][1], path)
    x0, y0, x1, y1 = (int(v) for v in np.frombuffer(attrs["dataWindow"][1], "<i4"))
    W, H = x1 - x0 + 1, y1 - y0 + 1
    if W <= 0 or H <= 0:
        raise ValueError(f"{path}: empty data window {(x0, y0, x1, y1)}")
    line_bytes = W * sum(dt.itemsize for _, _, dt in chans)
    n_chunks = -(-H // lines)
    if pos + 8 * n_chunks > len(data):
        raise ValueError(f"{path}: truncated offset table ({n_chunks} chunks, "
                         f"{len(data) - pos} bytes left)")
    offsets = np.frombuffer(data, "<u8", n_chunks, pos)
    planes = {c: np.empty((H, W), dt) for c, _, dt in chans}
    seen = np.zeros(n_chunks, bool)
    for off in offsets.tolist():
        if off + 8 > len(data):
            raise ValueError(f"{path}: chunk offset {off} past the end of the file")
        y, size = (int(v) for v in np.frombuffer(data, "<i4", 2, off))
        row = y - y0
        if row < 0 or row >= H or row % lines or seen[row // lines]:
            raise ValueError(f"{path}: chunk at offset {off} has a bad y {y}")
        seen[row // lines] = True
        chunk = data[off + 8:off + 8 + size]
        if len(chunk) != size:
            raise ValueError(f"{path}: chunk at offset {off} is truncated")
        n = min(lines, H - row)
        want = n * line_bytes
        if name != "NONE" and size < want:
            raw = _exr_unzip(chunk, want, path)
        elif size == want:
            raw = np.frombuffer(chunk, np.uint8)
        else:
            raise ValueError(f"{path}: chunk at offset {off} holds {size} bytes, not {want}")
        raw = raw.reshape(n, line_bytes)
        col = 0
        for c, _, dt in chans:
            w = W * dt.itemsize
            planes[c][row:row + n] = raw[:, col:col + w].copy().view(dt)
            col += w
    names = sorted(planes)
    if names == ["Y"]:
        return planes["Y"].astype(np.float32)
    if names in (["B", "G", "R"], ["A", "B", "G", "R"]):
        order = ["B", "G", "R"] + (["A"] if alpha and "A" in planes else [])
        return np.stack([planes[c].astype(np.float32) for c in order], axis=-1)
    raise ValueError(f"{path}: channels {names} (read: Y, or R G B with an optional A)")


def _decode(path: str, alpha: bool) -> np.ndarray:
    if path.lower().endswith(".exr"):
        return read_exr(path, alpha)
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
        raise ValueError(f"{path}: a greyscale read of an EXR file is not supported")
    with PIL.Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("L", im.size)
        if im.mode != "L":
            im = im.convert("L")
        return np.asarray(im).copy()
