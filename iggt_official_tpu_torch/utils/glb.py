"""First-party binary glTF 2.0 (.glb) export of point clouds + camera markers.

Copy of `iggt_official_tpu/utils/glb.py` (pure numpy), with the camera
colours from the port's own `gist_rainbow` table (`utils/colormaps.py`) in
place of matplotlib's; the files it writes are byte-identical to the JAX
package's (the glTF ``generator`` string included).

Behavioural parity: `visual_util.py:38-312` (`predictions_to_glb`) — build a
scene with a colored point cloud from predicted world points (or unprojected
depth), percentile confidence filtering, camera frustum markers per view,
alignment to the first camera and OpenCV->OpenGL conversion — without the
reference's trimesh/onnxruntime dependencies: the GLB container is written
directly (12-byte header + JSON chunk + BIN chunk, POINTS primitive with
POSITION/COLOR_0, TRIANGLES primitives for the frusta).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from iggt_official_tpu_torch.utils.colormaps import get_cmap

_COMPONENT_FLOAT = 5126
_COMPONENT_UBYTE = 5121
_COMPONENT_UINT = 5125


def _align4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * (-len(b) % 4)


class _GlbBuilder:
    def __init__(self) -> None:
        self.buffer = bytearray()
        self.buffer_views: List[Dict] = []
        self.accessors: List[Dict] = []
        self.meshes: List[Dict] = []
        self.nodes: List[Dict] = []

    def _add_view(self, data: bytes, target: Optional[int] = None) -> int:
        offset = len(self.buffer)
        self.buffer.extend(_align4(data))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def _add_accessor(
        self, view: int, component: int, count: int, type_: str,
        minimum=None, maximum=None, normalized: bool = False,
    ) -> int:
        acc: Dict = {
            "bufferView": view,
            "componentType": component,
            "count": count,
            "type": type_,
        }
        if normalized:
            acc["normalized"] = True
        if minimum is not None:
            acc["min"] = minimum
        if maximum is not None:
            acc["max"] = maximum
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_pointcloud(self, points: np.ndarray, colors: np.ndarray) -> None:
        """points (M, 3) float32; colors (M, 3) uint8."""
        points = np.ascontiguousarray(points, np.float32)
        colors = np.ascontiguousarray(colors, np.uint8)
        pv = self._add_view(points.tobytes(), target=34962)
        pa = self._add_accessor(
            pv, _COMPONENT_FLOAT, len(points), "VEC3",
            minimum=points.min(0).tolist(), maximum=points.max(0).tolist(),
        )
        cv = self._add_view(colors.tobytes(), target=34962)
        ca = self._add_accessor(
            cv, _COMPONENT_UBYTE, len(colors), "VEC3", normalized=True
        )
        self.meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pa, "COLOR_0": ca},
                        "mode": 0,  # POINTS
                    }
                ]
            }
        )
        self.nodes.append({"mesh": len(self.meshes) - 1})

    def add_triangles(
        self, vertices: np.ndarray, faces: np.ndarray, colors: np.ndarray
    ) -> None:
        """vertices (V, 3) f32, faces (F, 3) uint32, colors (V, 3) uint8."""
        vertices = np.ascontiguousarray(vertices, np.float32)
        faces = np.ascontiguousarray(faces, np.uint32)
        colors = np.ascontiguousarray(colors, np.uint8)
        vv = self._add_view(vertices.tobytes(), target=34962)
        va = self._add_accessor(
            vv, _COMPONENT_FLOAT, len(vertices), "VEC3",
            minimum=vertices.min(0).tolist(), maximum=vertices.max(0).tolist(),
        )
        cv = self._add_view(colors.tobytes(), target=34962)
        ca = self._add_accessor(
            cv, _COMPONENT_UBYTE, len(colors), "VEC3", normalized=True
        )
        iv = self._add_view(faces.tobytes(), target=34963)
        ia = self._add_accessor(iv, _COMPONENT_UINT, faces.size, "SCALAR")
        self.meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": va, "COLOR_0": ca},
                        "indices": ia,
                        "mode": 4,  # TRIANGLES
                    }
                ]
            }
        )
        self.nodes.append({"mesh": len(self.meshes) - 1})

    def write(self, path: str) -> None:
        gltf = {
            "asset": {"version": "2.0", "generator": "iggt_official_tpu"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "buffers": [{"byteLength": len(self.buffer)}],
            "bufferViews": self.buffer_views,
            "accessors": self.accessors,
        }
        json_chunk = _align4(json.dumps(gltf).encode(), pad=b" ")
        bin_chunk = _align4(bytes(self.buffer))
        total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))
            f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
            f.write(json_chunk)
            f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
            f.write(bin_chunk)


def camera_frustum_mesh(
    c2w: np.ndarray, color: np.ndarray, scale: float = 0.05
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Small pyramid marker for one camera-to-world pose (4, 4)."""
    local = np.array(
        [
            [0.0, 0.0, 0.0],
            [-1.0, -0.75, 1.5],
            [1.0, -0.75, 1.5],
            [1.0, 0.75, 1.5],
            [-1.0, 0.75, 1.5],
        ],
        np.float32,
    ) * scale
    verts = local @ c2w[:3, :3].T + c2w[:3, 3]
    faces = np.array(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4]],
        np.uint32,
    )
    colors = np.tile(np.asarray(color, np.uint8), (len(verts), 1))
    return verts.astype(np.float32), faces, colors


_OPENGL = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def predictions_to_glb(
    world_points: np.ndarray,
    colors: np.ndarray,
    conf: Optional[np.ndarray] = None,
    extrinsics: Optional[np.ndarray] = None,
    conf_threshold: float = 0.3,
    max_points: int = 1_000_000,
    align_to_first_camera: bool = True,
    path: Optional[str] = None,
) -> _GlbBuilder:
    """Build (and optionally write) the scene GLB.

    world_points (..., 3); colors (..., 3) float [0,1] or uint8; conf (...)
    optional confidence filtered at the `conf_threshold` PERCENTILE
    (matching `visual_util.py:175-182`); extrinsics (S, 3, 4) OpenCV w2c.
    """
    pts = np.asarray(world_points, np.float32).reshape(-1, 3)
    cols = np.asarray(colors)
    if cols.dtype != np.uint8:
        cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    cols = cols.reshape(-1, 3)

    keep = np.isfinite(pts).all(axis=1)
    if conf is not None:
        confv = np.asarray(conf).reshape(-1)
        if conf_threshold > 0:
            cut = np.percentile(confv, conf_threshold * 100)
            keep &= confv >= cut
    pts, cols = pts[keep], cols[keep]

    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    cams_c2w = None
    if extrinsics is not None:
        ext = np.asarray(extrinsics, np.float32)
        cams_c2w = np.tile(np.eye(4, dtype=np.float32), (len(ext), 1, 1))
        for i, e in enumerate(ext):
            R, t = e[:3, :3], e[:3, 3]
            cams_c2w[i, :3, :3] = R.T
            cams_c2w[i, :3, 3] = -R.T @ t

    # align to first camera + OpenGL convention (`visual_util.py:291-312`)
    if align_to_first_camera and cams_c2w is not None:
        w2c0 = np.linalg.inv(cams_c2w[0])
        transform = _OPENGL @ w2c0
    else:
        transform = _OPENGL

    pts = pts @ transform[:3, :3].T + transform[:3, 3]

    builder = _GlbBuilder()
    if len(pts):
        builder.add_pointcloud(pts, cols)
    if cams_c2w is not None:
        scene_scale = float(np.percentile(np.abs(pts), 95)) if len(pts) else 1.0
        cmap = get_cmap("gist_rainbow")
        for i, c2w in enumerate(cams_c2w):
            c2w_gl = transform @ c2w
            color = np.array(cmap(i / max(len(cams_c2w) - 1, 1))[:3]) * 255
            v, f, c = camera_frustum_mesh(
                c2w_gl, color.astype(np.uint8), scale=0.03 * max(scene_scale, 1e-3)
            )
            builder.add_triangles(v, f, c)
    if path is not None:
        builder.write(path)
    return builder
