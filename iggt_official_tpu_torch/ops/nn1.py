"""Exact 1-nearest-neighbour search: a hand-written Hopper kernel and its
plain version.

Counterpart of `iggt_official_tpu/ops/nn1_pallas.py::nn1_pallas`.  For each
query row, the index of the nearest reference row by exact fp32 squared
distance, summed over the feature axis in order with no FMA; ties go to the
smallest reference index.  The clustering pipeline calls it for the 1-NN
noise reassignment and the full-density backfill (`ops/cluster.py`).

`nn1` launches the CUDA kernel (`csrc/nn1.cu`) for CUDA tensors, or raises,
and takes `nn1_plain` only for CPU tensors.  It counts its launches in
`nn1.launches`.  Kernel and plain version round every operation the same way,
so they return equal indices, not merely close ones.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from iggt_official_tpu_torch.ops import cuda_build

KERNEL_DIM = 8  # the part features' width; the kernel holds a row in registers


def _check(query: torch.Tensor, ref: torch.Tensor) -> None:
    if query.dim() != 2 or ref.dim() != 2 or query.shape[1] != ref.shape[1]:
        raise ValueError(f"query (Q, D) and ref (R, D) expected, got "
                         f"{tuple(query.shape)} and {tuple(ref.shape)}")
    if ref.shape[0] == 0:
        raise ValueError("nn1 needs at least one reference row")
    if query.device != ref.device:
        raise ValueError("query and ref must be on one device")


def nn1_plain(query: torch.Tensor, ref: torch.Tensor, block_q: int = 4096) -> torch.Tensor:
    """Index (Q,) int64 of the nearest ``ref`` row per ``query`` row.

    Blocked over queries; per block, d = d + (q_a - r_a)^2 for a = 0..D-1 in
    order, each operation rounded on its own, then the first arg-min (the
    smallest index among equal distances)."""
    _check(query, ref)
    q = query.to(torch.float32)
    r = ref.to(torch.float32)
    out = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
    for s in range(0, q.shape[0], block_q):
        qb = q[s:s + block_q]
        d = None
        for a in range(q.shape[1]):
            diff = qb[:, a:a + 1] - r[:, a]
            diff.mul_(diff)
            d = diff if d is None else d.add_(diff)
        out[s:s + block_q] = torch.argmin(d, dim=1)
    return out


@functools.cache
def _kernel():
    lib = cuda_build.load("nn1")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.iggt_nn1.argtypes = [p, p, p, ll, ll, p]
    lib.iggt_nn1.restype = ctypes.c_int
    lib.iggt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iggt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    if not query.is_cuda:
        raise ValueError("the nn1 kernel takes CUDA tensors")
    if query.shape[1] != KERNEL_DIM:
        raise ValueError(f"the nn1 kernel takes rows of {KERNEL_DIM} features, "
                         f"got {query.shape[1]}")
    query, ref = _aligned(query), _aligned(ref)
    out = torch.empty(query.shape[0], dtype=torch.int64, device=query.device)
    lib = _kernel()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.iggt_nn1(query.data_ptr(), ref.data_ptr(), out.data_ptr(),
                           query.shape[0], ref.shape[0], stream)
    if err != 0:
        raise RuntimeError("nn1 kernel failed to launch: "
                           + lib.iggt_cuda_error_string(err).decode())
    return out


def nn1(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Index (Q,) int64 of the nearest ``ref`` row per ``query`` row, exact
    fp32, ties to the smallest index.  CUDA tensors launch the kernel; CPU
    tensors take `nn1_plain`."""
    _check(query, ref)
    if query.device.type == "cpu":
        return nn1_plain(query, ref)
    if query.shape[0] == 0:
        return torch.empty(0, dtype=torch.int64, device=query.device)
    out = _launch(query, ref)
    nn1.launches += 1
    return out


nn1.launches = 0
