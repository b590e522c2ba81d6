"""COLMAP sparse-model IO (cameras / images / points3D, binary + text).

Counterpart of `iggt_official_tpu/data/colmap.py`, copied (numpy and
`struct` only).
Behavioural parity: `dataset_preprocess/read_write_model.py:1-579` (itself
the standard COLMAP scripts): the camera-model table, quaternion helpers,
and read/write of cameras.bin/.txt, images.bin/.txt, points3D.bin/.txt.
Used by the offline preprocessing pipelines (e.g. `preprocess_*` scripts,
`re10k.py`'s `read_images_binary` import).
"""

from __future__ import annotations

import collections
import os
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"]
)
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"]
)
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read_next_bytes(fid, num_bytes, format_char_sequence, endian="<"):
    data = fid.read(num_bytes)
    return struct.unpack(endian + format_char_sequence, data)


def _write_next_bytes(fid, data, format_char_sequence, endian="<"):
    if isinstance(data, (list, tuple)):
        fid.write(struct.pack(endian + format_char_sequence, *data))
    else:
        fid.write(struct.pack(endian + format_char_sequence, data))


# ---------------------------------------------------------------------------
# cameras


def read_cameras_binary(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read_next_bytes(
                f, 8 * model.num_params, "d" * model.num_params
            )
            cameras[cam_id] = Camera(
                cam_id, model.model_name, width, height, np.array(params)
            )
    return cameras


def write_cameras_binary(cameras: Dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        _write_next_bytes(f, len(cameras), "Q")
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            _write_next_bytes(
                f, [cam.id, model.model_id, cam.width, cam.height], "iiQQ"
            )
            _write_next_bytes(
                f, [float(p) for p in cam.params], "d" * model.num_params
            )


def read_cameras_text(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cameras[int(elems[0])] = Camera(
                int(elems[0]), elems[1], int(elems[2]), int(elems[3]),
                np.array(tuple(map(float, elems[4:]))),
            )
    return cameras


def write_cameras_text(cameras: Dict[int, Camera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list\n")
        for cam in cameras.values():
            params = " ".join(map(str, cam.params))
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


# ---------------------------------------------------------------------------
# images


def read_images_text(path) -> Dict[int, Image]:
    """Two lines per image: header (id qw qx qy qz tx ty tz cam name) then
    the 2D-point track triplets (x y point3D_id)*."""
    images = {}
    with open(path) as f:
        lines = iter(f)
        pairs = []
        for ln in lines:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            # header found; the NEXT line is its (possibly empty) track
            pairs.append((ln, next(lines, "").strip()))
    for header, track in pairs:
        elems = header.split()
        image_id = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        t = track.split()
        if t:
            xys = np.column_stack(
                [tuple(map(float, t[0::3])), tuple(map(float, t[1::3]))]
            )
            p3d = np.array(tuple(map(int, t[2::3])), dtype=np.int64)
        else:
            xys = np.zeros((0, 2))
            p3d = np.zeros((0,), dtype=np.int64)
        images[image_id] = Image(
            image_id, qvec, tvec, camera_id, name, xys, p3d
        )
    return images


def write_images_text(images: Dict[int, Image], path) -> None:
    with open(path, "w") as f:
        f.write("# Image list\n")
        for img in images.values():
            q = " ".join(repr(float(v)) for v in img.qvec)
            t = " ".join(repr(float(v)) for v in img.tvec)
            f.write(f"{img.id} {q} {t} {img.camera_id} {img.name}\n")
            f.write(
                " ".join(
                    f"{float(xy[0])!r} {float(xy[1])!r} {int(pid)}"
                    for xy, pid in zip(img.xys, img.point3D_ids)
                )
                + "\n"
            )


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            char = f.read(1)
            while char != b"\x00":
                name += char
                char = f.read(1)
            num_points = _read_next_bytes(f, 8, "Q")[0]
            data = _read_next_bytes(
                f, 24 * num_points, "ddq" * num_points
            )
            xys = np.column_stack(
                [tuple(map(float, data[0::3])), tuple(map(float, data[1::3]))]
            ) if num_points else np.zeros((0, 2))
            p3d = np.array(tuple(map(int, data[2::3])), dtype=np.int64)
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                xys, p3d,
            )
    return images


def write_images_binary(images: Dict[int, Image], path) -> None:
    with open(path, "wb") as f:
        _write_next_bytes(f, len(images), "Q")
        for img in images.values():
            _write_next_bytes(f, img.id, "i")
            _write_next_bytes(f, [float(v) for v in img.qvec], "dddd")
            _write_next_bytes(f, [float(v) for v in img.tvec], "ddd")
            _write_next_bytes(f, img.camera_id, "i")
            f.write(img.name.encode("utf-8") + b"\x00")
            _write_next_bytes(f, len(img.point3D_ids), "Q")
            for xy, pid in zip(img.xys, img.point3D_ids):
                _write_next_bytes(
                    f, [float(xy[0]), float(xy[1]), int(pid)], "ddq"
                )


# ---------------------------------------------------------------------------
# points3D


def read_points3D_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        num = _read_next_bytes(f, 8, "Q")[0]
        for _ in range(num):
            props = _read_next_bytes(f, 43, "QdddBBBd")
            pid = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            error = props[7]
            track_len = _read_next_bytes(f, 8, "Q")[0]
            track = _read_next_bytes(f, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                np.array(tuple(map(int, track[0::2]))),
                np.array(tuple(map(int, track[1::2]))),
            )
    return points


def write_points3D_binary(points: Dict[int, Point3D], path) -> None:
    with open(path, "wb") as f:
        _write_next_bytes(f, len(points), "Q")
        for pt in points.values():
            _write_next_bytes(f, pt.id, "Q")
            _write_next_bytes(f, [float(v) for v in pt.xyz], "ddd")
            _write_next_bytes(f, [int(v) for v in pt.rgb], "BBB")
            _write_next_bytes(f, float(pt.error), "d")
            _write_next_bytes(f, len(pt.image_ids), "Q")
            for iid, p2d in zip(pt.image_ids, pt.point2D_idxs):
                _write_next_bytes(f, [int(iid), int(p2d)], "ii")


def read_points3D_text(path) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            xyz = np.array(tuple(map(float, elems[1:4])))
            rgb = np.array(tuple(map(int, elems[4:7])))
            error = float(elems[7])
            track = elems[8:]
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                np.array(tuple(map(int, track[0::2])), dtype=np.int64),
                np.array(tuple(map(int, track[1::2])), dtype=np.int64),
            )
    return points


def write_points3D_text(points: Dict[int, Point3D], path) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list\n")
        for pt in points.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(
                f"{int(i)} {int(p)}"
                for i, p in zip(pt.image_ids, pt.point2D_idxs)
            )
            f.write(f"{pt.id} {xyz} {rgb} {float(pt.error)!r} {track}\n")


def read_model(path, ext: str = ".bin"):
    """Read (cameras, images, points3D) from a sparse model dir."""
    if ext == ".bin":
        cameras = read_cameras_binary(os.path.join(path, "cameras.bin"))
        images = read_images_binary(os.path.join(path, "images.bin"))
        points = read_points3D_binary(os.path.join(path, "points3D.bin"))
    else:
        cameras = read_cameras_text(os.path.join(path, "cameras.txt"))
        images = read_images_text(os.path.join(path, "images.txt"))
        points = read_points3D_text(os.path.join(path, "points3D.txt"))
    return cameras, images, points


def write_model(cameras, images, points, path, ext: str = ".bin"):
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3D_binary(points, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3D_text(points, os.path.join(path, "points3D.txt"))
