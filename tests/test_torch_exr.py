"""The port's OpenEXR reader (`iggt_official_tpu_torch/data/imread.py::read_exr`).

No oracle exists here: the sandbox's OpenCV has no EXR codec (the JAX
package's loaders read EXR with ``cv2.imread``) and imageio has no EXR
plugin.  The oracle is a known-answer file, a 3x2 single-channel HALF image
without compression whose bytes are spelled out below from the OpenEXR
layout, and a known-answer ZIP chunk whose byte interleave and delta
predictor are worked out by hand.  `chip_smoke.write_exr` (the card script's
own writer) must write the known-answer file byte for byte; its ZIP and ZIPS
encodings of the same and larger arrays must read back equal.  Planted
faults (a PIZ header, the tiled flag, a truncated offset table, and others)
must raise, naming what they found.
"""

import os
import struct
import zlib

import numpy as np
import pytest

import chip_smoke
from iggt_official_tpu_torch.data import imread
from iggt_official_tpu_torch.data.base import threshold_depth_map
from iggt_official_tpu_torch.data.datasets import MvsSynth

KNOWN_VALUES = np.array([[1.0, 2.0, 0.5], [-1.5, 65504.0, 0.0]], np.float32)
KNOWN_FILE = bytes.fromhex(
    "76 2f 31 01"                                      # magic 20000630
    "02 00 00 00"                                      # version 2, no flags: scanline, one part
    + b"channels\0chlist\0".hex() + "13 00 00 00"     # chlist, 19 bytes:
    "59 00"                                            #   "Y"
    "01 00 00 00"                                      #   pixel type 1 = HALF
    "00 00 00 00"                                      #   pLinear 0, three reserved bytes
    "01 00 00 00 01 00 00 00"                          #   x and y sampling 1
    "00"                                               #   end of the list
    + b"compression\0compression\0".hex() + "01 00 00 00" "00"      # NONE
    + b"dataWindow\0box2i\0".hex() + "10 00 00 00"
    "00 00 00 00 00 00 00 00 02 00 00 00 01 00 00 00"  # (0, 0) - (2, 1): 3 x 2
    + b"displayWindow\0box2i\0".hex() + "10 00 00 00"
    "00 00 00 00 00 00 00 00 02 00 00 00 01 00 00 00"
    + b"lineOrder\0lineOrder\0".hex() + "01 00 00 00" "00"          # INCREASING_Y
    + b"pixelAspectRatio\0float\0".hex() + "04 00 00 00" "00 00 80 3f"
    + b"screenWindowCenter\0v2f\0".hex() + "08 00 00 00" "00 00 00 00 00 00 00 00"
    + b"screenWindowWidth\0float\0".hex() + "04 00 00 00" "00 00 80 3f"
    "00"                                               # end of the header (277 bytes)
    "25 01 00 00 00 00 00 00"                          # offset table: line 0 at 293,
    "33 01 00 00 00 00 00 00"                          #   line 1 at 307
    "00 00 00 00" "06 00 00 00" "00 3c 00 40 00 38"    # y 0, 6 bytes: 1.0 2.0 0.5
    "01 00 00 00" "06 00 00 00" "00 be ff 7b 00 00"    # y 1, 6 bytes: -1.5 65504 0
)
# line 0's 6 bytes split into even (00 00 00) and odd (3c 40 38) halves, each
# byte then replaced by (byte - previous + 128) mod 256
KNOWN_PREDICTED = bytes.fromhex("00 80 80 bc 84 78")


def write(tmp_path, name, data):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def test_known_answer_file(tmp_path):
    assert len(KNOWN_FILE) == 321
    got = imread.read_exr(write(tmp_path, "k.exr", KNOWN_FILE))
    assert got.dtype == np.float32 and got.shape == (2, 3)
    assert got.tobytes() == KNOWN_VALUES.tobytes()
    for fn in (imread.imread_unchanged, imread.imread_anydepth):
        np.testing.assert_array_equal(fn(str(tmp_path / "k.exr")), KNOWN_VALUES)
    chip_smoke.write_exr(str(tmp_path / "w.exr"), {"Y": KNOWN_VALUES}, "HALF", "NONE")
    assert (tmp_path / "w.exr").read_bytes() == KNOWN_FILE


def test_known_answer_zip_chunk():
    line0 = KNOWN_FILE[-28 + 8:-14]
    assert line0 == bytes.fromhex("00 3c 00 40 00 38")
    got = imread._exr_unzip(zlib.compress(KNOWN_PREDICTED), 6, "chunk")
    assert got.tobytes() == line0


@pytest.mark.parametrize("pixel,compression", [("HALF", "ZIPS"), ("HALF", "ZIP"),
                                               ("FLOAT", "NONE"), ("FLOAT", "ZIPS"),
                                               ("FLOAT", "ZIP")])
def test_encodings_read_back_equal(tmp_path, pixel, compression):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    depth = (10 + np.sin(yy / 9) + np.cos(xx / 7)).astype(np.float32)   # compresses
    depth[3, :5] = [np.inf, 0, -2, 1e-3, 7e4 if pixel == "FLOAT" else 6e4]
    noise = rng.normal(0, 1, (37, 53)).astype(np.float32)                 # barely compresses
    dtype = chip_smoke.EXR_PIXEL[pixel][1]
    for name, a in (("known", KNOWN_VALUES), ("depth", depth), ("noise", noise)):
        p = str(tmp_path / f"{name}.exr")
        chip_smoke.write_exr(p, {"Y": a}, pixel, compression)
        want = a.astype(dtype).astype(np.float32)
        got = imread.read_exr(p)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), name
    planes = {c: rng.uniform(0, 1, (9, 20)).astype(np.float32) for c in "RGBA"}
    p = str(tmp_path / "rgba.exr")
    chip_smoke.write_exr(p, planes, pixel, compression)
    want = {c: planes[c].astype(dtype).astype(np.float32) for c in planes}
    bgra = imread.imread_unchanged(p)
    assert bgra.shape == (9, 20, 4)
    for i, c in enumerate("BGRA"):
        np.testing.assert_array_equal(bgra[..., i], want[c])
    assert imread.imread_anydepth(p).shape == (9, 20, 3)
    del planes["A"]
    chip_smoke.write_exr(p, planes, pixel, compression)
    np.testing.assert_array_equal(imread.read_exr(p)[..., 2], want["R"])


def test_chunks_in_any_order(tmp_path):
    """The offset table, not the file order, places each chunk (a
    DECREASING_Y file stores the last lines first)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 9, (40, 7)).astype(np.float32)
    p = str(tmp_path / "a.exr")
    chip_smoke.write_exr(p, {"Y": a}, "FLOAT", "ZIP")
    data = bytearray(open(p, "rb").read())
    head = data.index(b"\0", data.index(b"screenWindowWidth") + 30)
    n = 3                                           # 40 lines in chunks of 16
    offsets = list(struct.unpack_from(f"<{n}Q", data, head + 1))
    ends = offsets[1:] + [len(data)]
    chunks = [bytes(data[o:e]) for o, e in zip(offsets, ends)]
    body, new = b"", []
    for c in reversed(chunks):
        new.append(head + 1 + 8 * n + len(body))
        body += c
    out = bytes(data[:head + 1]) + struct.pack(f"<{n}Q", *reversed(new)) + body
    np.testing.assert_array_equal(imread.read_exr(write(tmp_path, "r.exr", out)), a)


def fault(tmp_path, name, data, match):
    with pytest.raises(ValueError, match=match):
        imread.read_exr(write(tmp_path, name, bytes(data)))


def test_planted_faults_raise(tmp_path):
    k = bytearray(KNOWN_FILE)
    comp = k.index(b"compression\0compression\0") + len(b"compression\0compression\0") + 4
    for code, name in ((4, "PIZ"), (1, "RLE"), (5, "PXR24"), (7, "B44A"), (9, "DWAB"), (42, "#42")):
        bad = bytearray(k)
        bad[comp] = code
        fault(tmp_path, "c.exr", bad, f"compression {name}")
    tiled = bytearray(k)
    tiled[5] |= 0x02                                     # version flag 0x200
    fault(tmp_path, "t.exr", tiled, "tiled")
    multi = bytearray(k)
    multi[5] |= 0x10                                     # version flag 0x1000
    fault(tmp_path, "m.exr", multi, "multi-part")
    deep = bytearray(k)
    deep[5] |= 0x08
    fault(tmp_path, "d.exr", deep, "deep")
    fault(tmp_path, "o.exr", k[:277 + 12], "truncated offset table")
    fault(tmp_path, "x.exr", k[:-3], "truncated")
    fault(tmp_path, "magic.exr", b"\x76\x2f\x31\x02" + k[4:], "not an OpenEXR file")
    uint = bytearray(k)
    uint[k.index(b"Y\0") + 2] = 0                        # pixel type 0 = UINT
    fault(tmp_path, "u.exr", uint, "UINT")
    z = bytearray(k)
    z[k.index(b"Y\0")] = ord("Z")
    fault(tmp_path, "z.exr", z, r"channels \['Z'\]")
    with pytest.raises(ValueError, match="greyscale"):
        imread.imread_grayscale(write(tmp_path, "k.exr", KNOWN_FILE))


def test_mvs_synth_loader_reads_exr(tmp_path):
    """A registered EXR-depth loader (MvsSynth's layout) reads each frame's
    depth as written (HALF after its conversion), then thresholds it."""
    import PIL.Image

    rng = np.random.default_rng(2)
    W, H, n = 48, 36, 4
    seq = tmp_path / "mvs" / "scans" / "seq0"
    for sub in ("color", "depth", "cam"):
        os.makedirs(seq / sub)
    written = []
    for i in range(n):
        PIL.Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
            seq / "color" / f"{i:04d}.jpg")
        d = rng.uniform(1, 30, (H, W)).astype(np.float32)
        d[0, :3] = np.inf
        pixel, comp = chip_smoke.EXR_ENCODINGS[i]
        chip_smoke.write_exr(str(seq / "depth" / f"{i:04d}.exr"), {"Y": d}, pixel, comp)
        written.append(d.astype(chip_smoke.EXR_PIXEL[pixel][1]).astype(np.float32))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.1 * i, 0, 0]
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
        np.savez(seq / "cam" / f"{i:04d}.npz", pose=pose, intrinsics=K)
    ds = type("MvsSynth", (MvsSynth,), {"min_frames": n})(str(tmp_path / "mvs"), dset="scans",
                                                            resolution=(32, 24), seed=0)
    assert len(ds) == n
    for i, w in enumerate(written):
        np.testing.assert_array_equal(imread.imread_unchanged(ds.all_depth_paths[i]), w)
        w = w.copy()
        w[~np.isfinite(w)] = 0
        np.testing.assert_array_equal(ds._load_depth_for(i), threshold_depth_map(w, 99, -1))
    views = ds[(0, 0, 2)]
    assert len(views) == 2 and views[0]["depthmap"].shape == (24, 32)
