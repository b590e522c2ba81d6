"""Video frame ingestion for the SAM2 video predictor (counterpart of
`iggt_official_tpu/sam2/video_io.py`, `sam2/utils/misc.py:98-305`).

JPEG folders decode with PIL (the JAX package decodes with cv2, which the
card's machine lacks); MP4 files decode through a lazy ``import cv2``, as in
the JAX package, and raise ImportError where cv2 is missing.  Frames are
resized and normalized by `SAM2Transforms` on the host and uploaded to the
predictor's device: all at once (`ArrayFrameSource`), or in fixed-size
chunks that a decode thread fills while the session runs
(`AsyncJpegFrameSource`), each chunk uploaded on its first ``get``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_JPEG_EXTS = (".jpg", ".jpeg", ".JPG", ".JPEG")


def list_jpeg_frames(folder: str) -> List[str]:
    """`<frame_index>.jpg` listing (`misc.py:237-245`): numeric sort when all
    stems are ints, lexical otherwise."""
    names = [n for n in os.listdir(folder) if n.endswith(_JPEG_EXTS)]
    if not names:
        raise RuntimeError(f"no images found in {folder}")
    try:
        names.sort(key=lambda p: int(os.path.splitext(p)[0]))
    except ValueError:
        names.sort()
    return [os.path.join(folder, n) for n in names]


def decode_image(path: str) -> np.ndarray:
    """An image file as RGB HWC uint8 (PIL)."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except OSError as exc:
        raise RuntimeError(f"failed to decode {path}") from exc


def decode_video_frames(path: str) -> List[np.ndarray]:
    """MP4 decode through cv2 (`misc.py:274-305` uses decord; same contract:
    RGB HWC uint8 frames)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"failed to open video {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return frames


class ArrayFrameSource:
    """Pre-decoded frames, uploaded to the device as one stack."""

    def __init__(self, frames: Sequence[np.ndarray], transforms, device: torch.device):
        self.orig_hw: Tuple[int, int] = tuple(np.asarray(frames[0]).shape[:2])
        self.num_frames = len(frames)
        self._stack = torch.from_numpy(transforms.forward_batch(list(frames))).to(device)

    def get(self, idx: int) -> torch.Tensor:
        return self._stack[idx]


class AsyncJpegFrameSource:
    """Background-decode frame source (`AsyncVideoFrameLoader`, `misc.py:98-165`).

    A daemon thread decodes and transforms frames in order into host chunks;
    ``get`` waits for the chunk that holds the frame and uploads it on first
    use.  A failure in the thread is raised on the caller."""

    def __init__(self, img_paths: List[str], transforms, device: torch.device,
                 chunk: int = 16):
        self.paths = img_paths
        self.num_frames = len(img_paths)
        self.device = device
        self._transforms = transforms
        self._chunk = chunk
        n_chunks = -(-self.num_frames // chunk)
        self._host: List[Optional[np.ndarray]] = [None] * n_chunks
        self._device: List[Optional[torch.Tensor]] = [None] * n_chunks
        self._ready = [threading.Event() for _ in range(n_chunks)]
        self._exception: Optional[BaseException] = None
        # frame 0 synchronously: orig_hw is needed now (`misc.py:125-128`)
        self._first = decode_image(img_paths[0])
        self.orig_hw = tuple(self._first.shape[:2])
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            buf, ci = [], 0
            for i, p in enumerate(self.paths):
                buf.append(self._first if i == 0 else decode_image(p))
                if len(buf) == self._chunk or i == self.num_frames - 1:
                    self._host[ci] = self._transforms.forward_batch(buf)
                    self._ready[ci].set()
                    buf, ci = [], ci + 1
            self._first = None
        except BaseException as e:  # raised again on the caller's side
            self._exception = e
            for ev in self._ready:
                ev.set()

    def get(self, idx: int) -> torch.Tensor:
        ci = idx // self._chunk
        self._ready[ci].wait()
        if self._exception is not None:
            raise RuntimeError("Failure in frame loading thread") from self._exception
        if self._device[ci] is None:
            self._device[ci] = torch.from_numpy(self._host[ci]).to(self.device)
            self._host[ci] = None
        return self._device[ci][idx - ci * self._chunk]


def load_frame_source(video: Union[str, Sequence[np.ndarray]], transforms,
                      device: torch.device, async_loading_frames: bool = False,
                      chunk: int = 16):
    """`load_video_frames` dispatch (`misc.py:166-204`): a sequence of frames,
    a JPEG folder or an MP4 file -> a frame source with (num_frames,
    orig_hw, get(idx))."""
    if isinstance(video, str):
        if os.path.isdir(video):
            paths = list_jpeg_frames(video)
            if async_loading_frames:
                return AsyncJpegFrameSource(paths, transforms, device, chunk=chunk)
            return ArrayFrameSource([decode_image(p) for p in paths], transforms, device)
        if os.path.splitext(video)[-1] in (".mp4", ".MP4"):
            return ArrayFrameSource(decode_video_frames(video), transforms, device)
        raise NotImplementedError("Only MP4 video and JPEG folder are supported at this moment")
    return ArrayFrameSource(video, transforms, device)
