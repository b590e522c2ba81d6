"""Sky segmentation for GLB export filtering (copy of
`iggt_official_tpu/utils/sky.py`; its connected components are the port's
native host CCL, `ops/connected_components.py::connected_components_host`).

Behavioural parity: `visual_util.py:112-159` — when ``mask_sky`` is on, the
GLB exporter multiplies the per-pixel world-point confidence by a binary
keep-mask (non-sky = 1) per view, loading cached masks from
``{target_dir}/sky_masks/{image}`` when present and computing + caching
them otherwise.

The reference runs an ONNX skyseg model (downloaded from HF,
`visual_util.py:127-132`); this build has no onnxruntime, so the default
segmenter is a first-party heuristic: sky pixels are bright, low-texture,
blue-tinted regions connected to the top image border (connectivity via
the native connected components).  A callable with the
same (H, W, 3) uint8 -> (H, W) keep-mask contract can be passed in to use
a learned model instead.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import PIL.Image

from iggt_official_tpu_torch.ops.connected_components import connected_components_host


def segment_sky_heuristic(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 keep-mask (255 = keep, 0 = sky).

    Sky = smooth regions connected to the top quarter of the image that
    match one of four photometric profiles:
      - daylight: bright and at least as blue as red (daylight sky is
        never warmer than neutral, indoor lighting almost always is);
      - overcast/blown-white: all channels near saturation, not warm;
      - sunset/sunrise (round 4): warm but monotone r >= g >= b grading
        with enough chroma, bright-ish — distinguished from warm indoor
        walls by the vertical-extent filter below;
      - night (round 4): globally dark image (median < 0.30), very
        smooth, dark, cool-tinted (night skies keep a blue cast; dark
        indoor surfaces are neutral/warm);
      - moonless light-polluted night (round 5): warm sodium glow has no
        blue cast to key on, so the gate is photometric-absolute — the
        top quarter glows at a measured 0.15-0.18 median brightness in
        otherwise dark frames (interiors land outside the caps).
    Top-connected components whose mass extends into the bottom fifth of
    the frame are rejected (sky sits above the skyline; walls/ceilings
    run floor-to-ceiling) — this is what keeps the sunset branch from
    swallowing warm bright walls — EXCEPT components that dominate the
    top quarter (> 60% coverage, round 5): those are sky-dominant
    low-horizon / upward-tilt frames where real sky legitimately reaches
    the frame bottom (the blanket rejection zeroed their whole mask,
    ADVICE r4).  Thresholds were set against the hand-annotated goldens
    + deterministic photometric (sunset/night/overcast/warm-night) and
    geometric (sky-dominant reframe) variants in
    ``benchmarks/measure_sky.py`` (recall / false-positive rates per
    variant are recorded in ``benchmarks/sky_deltas.json``).

    Remaining failure modes vs the reference's trained skyseg model
    (`visual_util.py:112-159`, unavailable here — zero egress): warm
    bright walls that stop above the bottom fifth can false-positive
    under sunset light (measured 2.2% mean FP on the sunset variants);
    sky bands separated from the top border by thick occluders (wide
    wires/beams across the frame) stay unmasked — top-connectivity is
    load-bearing for precision, so this is accepted in the conservative
    direction (unmasked sky keeps points; measured: the sky-dominant
    reframe of the wire-heavy demo1 frame recalls 0.20 while all other
    reframes recall 0.86-0.99); and the dominance exemption itself is a
    measured trade — an upward-tilted shot of a smooth, bright, slightly
    cool wall filling the top quarter AND running to the floor would now
    be kept as sky (pre-r5 it was extent-rejected), a geometry the
    golden negatives do not contain and one that is ambiguous without
    semantics even for the reference's trained model.
    `load_or_compute_sky_masks` accepts any callable with the same
    contract for a learned replacement.
    """
    img = np.asarray(image, np.float32) / 255.0
    h, w = img.shape[:2]
    r, g, b = img[..., 0], img[..., 1], img[..., 2]

    brightness = img.mean(-1)
    gy = np.abs(np.diff(brightness, axis=0, prepend=brightness[:1]))
    gx = np.abs(np.diff(brightness, axis=1, prepend=brightness[:, :1]))
    grad = gx + gy
    smooth = grad < 0.03

    cool = b - r  # daylight sky: >= ~0 (blue/grey/blown-white), walls: < 0
    chroma = img.max(-1) - img.min(-1)
    candidate = (brightness > 0.60) & (cool > 0.015) & smooth
    # blown-out / white-overcast sky: all channels near saturation and
    # not warm-tinted
    candidate |= (
        (brightness > 0.85)
        & (np.minimum(np.minimum(r, g), b) > 0.80)
        & (cool > -0.005)
        & smooth
    )
    # sunset/sunrise: warm monotone grading with real chroma (graded skies
    # are orange/pink; white indoor walls under warm light stay
    # near-neutral).  Gated on a bright top quarter — at golden hour the
    # sky IS the light source (measured top-quarter median brightness:
    # outdoor sunset 0.73-0.76 vs warm indoor 0.31-0.46); the extent
    # filter below carries the remaining wall rejection.
    if np.median(brightness[: max(1, h // 4)]) > 0.55:
        candidate |= (
            (brightness > 0.40)
            & (r >= g - 0.02)
            & (g >= b - 0.02)
            & (chroma > 0.10)
            & smooth
        )
    # night: only in globally dark frames — dark, very smooth, blue-cast,
    # and only in the top 60% of the frame (dark ground chains to the sky
    # through the connected-component stage otherwise, and the extent
    # filter would then reject the whole merged component)
    if np.median(brightness) < 0.30:
        night = (
            (brightness > 0.01)
            & (brightness < 0.35)
            & (cool > 0.05)
            & (grad < 0.025)
        )
        night[int(0.6 * h):] = False
        candidate |= night
        # moonless light-polluted night (round 5): sodium glow is WARM, so
        # there is no blue cast to key on — but the polluted sky still
        # out-glows both the unlit ground and dark interiors (it is the
        # light source).  Gate on (a) an absolute glow floor — measured
        # top-quarter medians: outdoor polluted skies 0.15-0.18 vs dark
        # indoor ceilings 0.04-0.07 on the golden variants, threshold
        # 0.10 splits them with ~2x slack either side — and (b) the top
        # quarter out-glowing the frame median OR the bottom quarter
        # (ground); the OR admits sky-dominant upward-tilt frames where
        # sky IS the frame median.  Wall-sized components that sneak
        # through fall to the dominance/extent stage below.
        top_med = float(np.median(brightness[: max(1, h // 4)]))
        bot_med = float(np.median(brightness[int(0.75 * h):]))
        glob_med = float(np.median(brightness))
        # absolute caps (measured on the golden variants): polluted-sky
        # glow sits at top 0.15-0.18 in frames with global median
        # 0.03-0.15; DIM INTERIORS (demo9: global 0.26, ceiling 0.34)
        # land above both caps — without them the branch false-fires on
        # dusk-dark rooms, +0.22 FP on the demo9 negative
        if glob_med < 0.20 and 0.10 < top_med < 0.30 and (
            top_med > 1.6 * glob_med
            or top_med > 1.4 * max(bot_med, 0.02)
        ):
            warm_night = (
                (brightness > 0.5 * top_med)
                & (brightness < 0.45)
                & (chroma < 0.15)
                & (grad < 0.03)
            )
            warm_night[int(0.6 * h):] = False
            candidate |= warm_night

    # close 1-2 px gaps (wires, antennas) so sky stays one component and
    # the thin-structure shadows don't punch holes in the mask
    closed = candidate
    for _ in range(2):  # dilate
        e = closed.copy()
        e[1:] |= closed[:-1]
        e[:-1] |= closed[1:]
        e[:, 1:] |= closed[:, :-1]
        e[:, :-1] |= closed[:, 1:]
        closed = e
    for _ in range(2):  # erode
        e = closed.copy()
        e[1:] &= closed[:-1]
        e[:-1] &= closed[1:]
        e[:, 1:] &= closed[:, :-1]
        e[:, :-1] &= closed[:, 1:]
        closed = e
    candidate = closed

    labels, _ = connected_components_host(candidate[None])
    labels = labels[0]
    top_labels = np.unique(labels[: max(1, h // 4)])
    top_labels = top_labels[top_labels > 0]
    # vertical-extent filter: sky sits above the skyline; components whose
    # mass reaches into the bottom fifth are walls/ceilings, not sky.
    # Exemption (round 5, ADVICE r4): a component that DOMINATES the top
    # quarter (covers > 60% of it) is a sky-dominant frame — low horizon,
    # upward-tilted camera — where real sky legitimately reaches the
    # frame bottom; rejecting it zeroed the whole mask on such shots.
    bottom = labels[int(0.8 * h):]
    top_q = labels[: max(1, h // 4)]
    keep_labels = []
    for lab in top_labels:
        mass = int((labels == lab).sum())
        below = int((bottom == lab).sum())
        dominates_top = int((top_q == lab).sum()) > 0.6 * top_q.size
        if below <= 0.02 * mass or dominates_top:
            keep_labels.append(lab)
    sky = np.isin(labels, np.asarray(keep_labels, labels.dtype))
    return np.where(sky, 0, 255).astype(np.uint8)


def load_or_compute_sky_masks(
    target_dir: str,
    out_hw: Sequence[int],
    segmenter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> np.ndarray:
    """Per-view binary keep-masks (S, H, W) float32 for the scene at
    ``target_dir`` (reads `images/`, caches to `sky_masks/`,
    `visual_util.py:133-158` semantics: cached mask > 0.1 -> keep)."""
    H, W = out_hw
    segmenter = segmenter or segment_sky_heuristic
    image_dir = os.path.join(target_dir, "images")
    mask_dir = os.path.join(target_dir, "sky_masks")
    names = sorted(os.listdir(image_dir))
    masks = []
    for name in names:
        mask_path = os.path.join(mask_dir, name)
        if os.path.exists(mask_path):
            mask = np.asarray(PIL.Image.open(mask_path).convert("L"))
        else:
            img = np.asarray(
                PIL.Image.open(os.path.join(image_dir, name)).convert("RGB")
            )
            mask = segmenter(img)
            os.makedirs(mask_dir, exist_ok=True)
            PIL.Image.fromarray(mask).save(mask_path)
        if mask.shape != (H, W):
            mask = np.asarray(
                PIL.Image.fromarray(mask).resize(
                    (W, H), PIL.Image.Resampling.BILINEAR
                )
            )
        masks.append(mask)
    return (np.stack(masks).astype(np.float32) / 255.0 > 0.1).astype(
        np.float32
    )
