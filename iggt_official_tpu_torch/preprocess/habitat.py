"""Habitat multiview-crop generation: projection math + equirect remapping.

Parity targets: `dataset_preprocess/habitat/habitat_renderer/projections.py`
(equirectangular/perspective/rotated projections, ray grids),
`projections_conversions.py` (jittered remapping) and
`multiview_crop_generator.py` (crop extraction + distance->depth).  The
habitat-sim environment-map renderer itself is an external dependency —
`render_environment_map` raises with guidance when habitat-sim is absent;
everything else operates on any provided equirectangular color/distance
maps.

Counterpart of `iggt_official_tpu/preprocess/habitat.py`, copied, with
``cv2.remap`` (``BORDER_WRAP``) written in numpy (`remap_wrap`): the port
does not use OpenCV.  The numpy remap is byte-equal to OpenCV 5.0's for
float32 maps: nearest rounds each coordinate half to even; linear, on
uint8, uint16, int16 and float32 images, takes the floor and the fp32
fractions, blends along x then y with fused multiply-adds
(``p0 + a * (p1 - p0)``), and rounds integer images half to even with
saturation (OpenCV 5.0 does not round the coordinates to 1/32 steps there:
a remap in such steps differs from it by up to 5 levels on uint8); linear on
float64 images rounds the coordinates to 1/32 steps and sums the four
neighbours with the bilinear weights in float64, as OpenCV 5.0 does there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from iggt_official_tpu_torch.data.cropping import (
    colmap_to_opencv_intrinsics,
    opencv_to_colmap_intrinsics,
)


class EquirectangularProjection:
    """u along longitude (2pi/width), v along latitude (pi/height); +X
    right, +Y down, +Z forward, top-left pixel centre at (0.5, 0.5)."""

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width
        self.u_scaling = (2 * np.pi) / width
        self.v_scaling = np.pi / height

    def unproject(self, u, v):
        longitude = self.u_scaling * u - np.pi
        minus_latitude = self.v_scaling * v - np.pi / 2
        cos_lat = np.cos(minus_latitude)
        return np.stack(
            [
                np.sin(longitude) * cos_lat,
                np.sin(minus_latitude),
                np.cos(longitude) * cos_lat,
            ],
            axis=-1,
        )

    def project(self, rays):
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        longitude = np.arctan2(rays[..., 0], rays[..., 2])
        minus_latitude = np.arcsin(np.clip(rays[..., 1], -1, 1))
        u = (longitude + np.pi) / self.u_scaling
        v = (minus_latitude + np.pi / 2) / self.v_scaling
        return u, v


class PerspectiveProjection:
    def __init__(self, K: np.ndarray, height: int, width: int):
        self.K = np.asarray(K, np.float64)
        self.Kinv = np.linalg.inv(self.K)
        self.height, self.width = height, width

    def project(self, rays):
        uvh = np.einsum("ik,...k->...i", self.K, rays)
        uv = uvh[..., :2] / uvh[..., 2, None]
        return uv[..., 0], uv[..., 1]

    def unproject(self, u, v):
        uvh = np.stack([u, v, np.ones_like(u)], axis=-1)
        return np.einsum("ik,...k->...i", self.Kinv, uvh)


class RotatedProjection:
    """Wrap a projection with a rotation into its base frame."""

    def __init__(self, base, R_to_base: Optional[np.ndarray]):
        self.base_projection = base
        self.R_to_base_projection = R_to_base

    height = property(lambda self: self.base_projection.height)
    width = property(lambda self: self.base_projection.width)

    def project(self, rays):
        if self.R_to_base_projection is not None:
            rays = np.einsum(
                "ik,...k->...i", self.R_to_base_projection, rays
            )
        return self.base_projection.project(rays)

    def unproject(self, u, v):
        rays = self.base_projection.unproject(u, v)
        if self.R_to_base_projection is not None:
            rays = np.einsum(
                "ik,...k->...i", self.R_to_base_projection.T, rays
            )
        return rays


def get_projection_rays(projection, noise_level: float = 0.0):
    """(H, W, 3) ray map through every pixel centre, optionally jittered
    to mitigate resampling aliasing."""
    grid_u, grid_v = np.meshgrid(
        0.5 + np.arange(projection.width), 0.5 + np.arange(projection.height)
    )
    if noise_level > 0:
        grid_u = grid_u + noise_level * np.random.uniform(
            -0.5, 0.5, grid_u.shape
        )
        grid_v = grid_v + noise_level * np.random.uniform(
            -0.5, 0.5, grid_v.shape
        )
    return projection.unproject(grid_u, grid_v)


def compute_camera_intrinsics(
    height: int, width: int, hfov_deg: float
) -> Tuple[float, float, float]:
    f = width / 2 / np.tan(np.radians(hfov_deg) / 2)
    return f, width / 2, height / 2


_REMAP_DTYPES = (np.uint8, np.uint16, np.int16, np.float32, np.float64)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fp32 ``a * b + c`` rounded once: the fp32 product is exact in fp64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap_wrap(
    img: np.ndarray, map_u: np.ndarray, map_v: np.ndarray, nearest: bool = False
) -> np.ndarray:
    """``cv2.remap(img, map_u, map_v, INTER_NEAREST or INTER_LINEAR,
    borderMode=BORDER_WRAP)`` for float32 maps and an (H, W) or (H, W, C)
    image of uint8, uint16, int16, float32 or float64."""
    img = np.asarray(img)
    if img.dtype.type not in _REMAP_DTYPES:
        raise TypeError(f"remap_wrap: image dtype {img.dtype} is not one of "
                        f"{[np.dtype(t).name for t in _REMAP_DTYPES]}")
    H, W = img.shape[:2]
    map_u = np.asarray(map_u, np.float32)
    map_v = np.asarray(map_v, np.float32)
    if nearest:
        x = np.mod(np.rint(map_u).astype(np.int64), W)
        y = np.mod(np.rint(map_v).astype(np.int64), H)
        return img[y, x]
    if img.dtype == np.float64:
        return _remap_linear_fixed(img, map_u, map_v)
    fu, fv = np.floor(map_u), np.floor(map_v)
    a, b = map_u - fu, map_v - fv
    x0, y0 = fu.astype(np.int64), fv.astype(np.int64)
    x = (np.mod(x0, W), np.mod(x0 + 1, W))
    y = (np.mod(y0, H), np.mod(y0 + 1, H))
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    p = [[img[y[i], x[j]].astype(np.float32) for j in (0, 1)] for i in (0, 1)]
    v0 = _fma(a, p[0][1] - p[0][0], p[0][0])
    v1 = _fma(a, p[1][1] - p[1][0], p[1][0])
    out = _fma(b, v1 - v0, v0)
    if img.dtype == np.float32:
        return out
    info = np.iinfo(img.dtype)
    return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)


def _remap_linear_fixed(img: np.ndarray, map_u: np.ndarray, map_v: np.ndarray) -> np.ndarray:
    """Linear remap with the coordinates rounded (half to even) to 1/32
    steps and the four weights, exact in binary, summed in float64 in the
    order (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    H, W = img.shape[:2]
    X = np.rint(map_u * np.float32(32)).astype(np.int64)
    Y = np.rint(map_v * np.float32(32)).astype(np.int64)
    a, b = (X & 31) / 32.0, (Y & 31) / 32.0
    x0, y0 = X >> 5, Y >> 5
    x = (np.mod(x0, W), np.mod(x0 + 1, W))
    y = (np.mod(y0, H), np.mod(y0 + 1, H))
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    w = (((1 - a) * (1 - b), a * (1 - b)), ((1 - a) * b, a * b))
    out = img[y[0], x[0]] * w[0][0]
    for i, j in ((0, 1), (1, 0), (1, 1)):
        out = out + img[y[i], x[j]] * w[i][j]
    return out


class RemapProjection:
    """Resample an input-projection image onto an output projection,
    optionally averaging several jittered resamplings (anti-aliasing)."""

    def __init__(
        self,
        input_projection,
        output_projection,
        pixel_jittering_iterations: int = 0,
        jittering_noise_level: float = 0.0,
    ):
        self.output_rays = get_projection_rays(output_projection)
        maps = [input_projection.project(self.output_rays)]
        for _ in range(pixel_jittering_iterations):
            rays = get_projection_rays(
                output_projection, jittering_noise_level
            )
            maps.append(input_projection.project(rays))
        self.maps = [
            (np.asarray(u, np.float32), np.asarray(v, np.float32))
            for u, v in maps
        ]

    def convert(
        self, img: np.ndarray, nearest: bool = False, single_map: bool = False
    ) -> np.ndarray:
        out = []
        for map_u, map_v in self.maps:
            out.append(remap_wrap(img, map_u, map_v, nearest=nearest))
            if single_map:
                break
        if len(out) == 1:
            return out[0]
        return np.asarray(np.mean(out, axis=0), dtype=img.dtype)


def compute_pointmap(
    envmap_rays: np.ndarray, distancemap: np.ndarray, position
) -> np.ndarray:
    """World points from an equirect distance map
    (`multiview_crop_generator.py:44-47`)."""
    return envmap_rays * distancemap[:, :, None] + np.asarray(position)


def extract_cropped_camera(
    envmap_projection,
    crop_projection,
    color_image: np.ndarray,
    distancemap: np.ndarray,
    pointmap: Optional[np.ndarray] = None,
    pixel_jittering_iterations: int = 5,
    jittering_noise_level: float = 1.0,
):
    """Extract a perspective crop from an equirect render; returns
    (color, depthmap, pointmap) with the distance map converted to
    planar depth (`multiview_crop_generator.py:55-72`)."""
    remapper = RemapProjection(
        envmap_projection, crop_projection,
        pixel_jittering_iterations, jittering_noise_level,
    )
    color = remapper.convert(color_image)
    distance = remapper.convert(distancemap, nearest=True, single_map=True)
    depth = (
        distance / np.linalg.norm(remapper.output_rays, axis=-1)
    ).astype(distance.dtype)
    points = (
        None
        if pointmap is None
        else remapper.convert(pointmap, nearest=True, single_map=True)
    )
    return color, depth, points


def perspective_projection_to_dict(persp_projection, position) -> dict:
    return dict(
        camera_intrinsics=colmap_to_opencv_intrinsics(
            persp_projection.base_projection.K
        ).tolist(),
        size=(
            persp_projection.base_projection.width,
            persp_projection.base_projection.height,
        ),
        R_cam2world=persp_projection.R_to_base_projection.T.tolist(),
        t_cam2world=list(position),
    )


def dict_to_perspective_projection(camera_params: dict):
    K = opencv_to_colmap_intrinsics(
        np.asarray(camera_params["camera_intrinsics"])
    )
    w, h = camera_params["size"]
    R = np.asarray(camera_params["R_cam2world"])
    proj = RotatedProjection(PerspectiveProjection(K, h, w), R.T)
    return proj, camera_params["t_cam2world"]


def render_environment_map(*args, **kwargs):  # pragma: no cover
    try:
        import habitat_sim  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "equirectangular rendering needs habitat-sim; the projection/"
            "cropping math in this module works on any pre-rendered "
            "equirect maps"
        ) from e
    raise NotImplementedError(
        "habitat-sim renderer not bundled; see the upstream "
        "habitat_sim_envmaps_renderer for the simulator flow"
    )
