"""Exact 1-nearest-neighbour search and bucket top-k: hand-written Hopper
kernels and their plain versions.

Counterpart of `iggt_official_tpu/ops/nn1_pallas.py::nn1_pallas`.  For each
query row, the index of the nearest reference row by exact fp32 squared
distance, summed over the feature axis in order with no FMA; ties go to the
smallest reference index.  The clustering pipeline calls it for the 1-NN
noise reassignment and the full-density backfill (`ops/cluster.py`).

`nn1` launches the CUDA kernels (`csrc/nn1.cu`) for CUDA tensors, or raises,
and takes `nn1_plain` only for CPU tensors.  It counts its calls on the card
in `nn1.launches`: each is one launch of the split kernel and one of the
filter kernel.  The kernel filters the pairs on the tensor cores (TF32 with
a hi/lo split) and runs the exact chain on every pair whose approximate
distance lies within the recheck window of the least exact distance found
(`filter_constants`, derived in `csrc/nn1.cu`), so kernel and plain version
return equal indices, not merely close ones.

`bucket_topk` is the counterpart of `nn1_pallas.py::bucket_topk_pallas`: per
query, the nearest reference of each bucket (reference index mod ``nb``) by
the same exact distances, then the exact top-k over the ``nb`` bucket minima
(approximate k-NN with exact distances).  Like its JAX counterpart it has no
caller in the package.  CUDA tensors launch the `bucket_min` kernel of
`csrc/nn1.cu` through `bucket_minima_kernel`, which counts every launch in
`bucket_minima_kernel.launches`; CPU tensors take `bucket_topk_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from iggt_official_tpu_torch.ops import cuda_build

KERNEL_DIM = 8  # the part features' width: one TF32 k8 step, one 32-byte row

# The recheck window of the nn1 kernel (derivation in csrc/nn1.cu): a pair is
# rechecked with the exact chain unless |q|^2 + |r|^2 - 2 q.r, as the kernel
# computes it, exceeds T = bound * (1 + C_CHAIN * U) + A_q with
# A_q = KAPPA * U * (|q|^2 + max |r|^2) + FLOOR.  The derived error of the
# approximation is 102.5 U (|q|^2 + max |r|^2) and the chain's relative error
# 10.02 U; KAPPA and C_CHAIN are more than twice those.
U = 2.0 ** -24
KAPPA = 256
C_CHAIN = 32
FLOOR = 2.0 ** -100
FAULTS = {"window zero": (0, 0, 0.0, 3), "one TF32 pass": (KAPPA, C_CHAIN, FLOOR, 1)}


def _check(query: torch.Tensor, ref: torch.Tensor) -> None:
    if query.dim() != 2 or ref.dim() != 2 or query.shape[1] != ref.shape[1]:
        raise ValueError(f"query (Q, D) and ref (R, D) expected, got "
                         f"{tuple(query.shape)} and {tuple(ref.shape)}")
    if ref.shape[0] == 0:
        raise ValueError("nn1 needs at least one reference row")
    if query.device != ref.device:
        raise ValueError("query and ref must be on one device")


def _sq_dist_block(qb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(len(qb), R) fp32 squared distances, summed over the features in order
    with every operation rounded on its own (the kernels' chain)."""
    d = None
    for a in range(qb.shape[1]):
        diff = qb[:, a:a + 1] - r[:, a]
        diff.mul_(diff)
        d = diff if d is None else d.add_(diff)
    return d


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
        out[s:s + block_q] = torch.argmin(_sq_dist_block(q[s:s + block_q], r), dim=1)
    return out


def filter_constants(kappa: float = KAPPA, c: float = C_CHAIN,
                     floor: float = FLOOR) -> Tuple[float, float, float]:
    """(kappa * U, 1 + c * U, floor): the window as the kernel takes it,
    each exact in fp32."""
    return kappa * U, 1.0 + c * U, floor


def _filter_args(fault=None) -> Tuple[float, float, float, int]:
    """What `_launch` hands the kernel: the window and the number of TF32
    passes; a planted fault (`FAULTS`) replaces them."""
    kappa, c, floor, passes = FAULTS[fault] if fault else (KAPPA, C_CHAIN, FLOOR, 3)
    return (*filter_constants(kappa, c, floor), passes)


@functools.cache
def _kernel():
    lib = cuda_build.load("nn1")
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.iggt_nn1.argtypes = [p, p, p, ll, ll, p, f, f, f, ctypes.c_int, p, p, p]
    lib.iggt_nn1.restype = ctypes.c_int
    lib.iggt_nn1_scratch_bytes.argtypes = [ll]
    lib.iggt_nn1_scratch_bytes.restype = ll
    lib.iggt_bucket_min.argtypes = [p, p, p, p, ll, ll, ctypes.c_int, p,
                                    ctypes.POINTER(ctypes.c_int)]
    lib.iggt_bucket_min.restype = ctypes.c_int
    lib.iggt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iggt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(query: torch.Tensor, ref: torch.Tensor, fault=None,
            rechecks: torch.Tensor = None, probe: torch.Tensor = None) -> torch.Tensor:
    """The kernels on CUDA tensors.  Private arguments for the card checks:
    ``fault`` plants a fault (`FAULTS`), ``rechecks`` (one int64 on the card)
    receives the number of exact chains computed, ``probe`` ((256, 64) fp32 on
    the card) the a~ = |r|^2 - 2 q.r of the first 256 queries and 64
    references."""
    if not query.is_cuda:
        raise ValueError("the nn1 kernel takes CUDA tensors")
    if query.shape[1] != KERNEL_DIM:
        raise ValueError(f"the nn1 kernel takes rows of {KERNEL_DIM} features, "
                         f"got {query.shape[1]}")
    query, ref = _aligned(query), _aligned(ref)
    out = torch.empty(query.shape[0], dtype=torch.int64, device=query.device)
    lib = _kernel()
    scratch = torch.empty(lib.iggt_nn1_scratch_bytes(ref.shape[0]), dtype=torch.uint8,
                          device=query.device)
    ku, onepcu, floor, passes = _filter_args(fault)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.iggt_nn1(query.data_ptr(), ref.data_ptr(), out.data_ptr(),
                           query.shape[0], ref.shape[0], scratch.data_ptr(), ku, onepcu,
                           floor, passes, None if rechecks is None else rechecks.data_ptr(),
                           None if probe is None else probe.data_ptr(), stream)
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


def bucket_minima_plain(query: torch.Tensor, ref: torch.Tensor, nb: int = 1024,
                        block_q: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query and bucket b < nb, the least squared distance over the
    references b, b + nb, ... and the smallest index attaining it: (Q, nb)
    fp32 and (Q, nb) int64.  An empty bucket holds +inf and index b.  Blocked
    over queries, about 512 MiB of distances per block unless ``block_q``."""
    _check(query, ref)
    q, r = query.to(torch.float32), ref.to(torch.float32)
    Q, R = q.shape[0], r.shape[0]
    rows = -(-R // nb)
    block_q = block_q or max(1, (1 << 27) // (rows * nb))
    lane = torch.arange(nb, device=q.device)
    bd = torch.empty((Q, nb), dtype=torch.float32, device=q.device)
    bi = torch.empty((Q, nb), dtype=torch.int64, device=q.device)
    for s in range(0, Q, block_q):
        d = _sq_dist_block(q[s:s + block_q], r)
        n = d.shape[0]
        if rows * nb > R:
            d = torch.cat([d, d.new_full((n, rows * nb - R), float("inf"))], dim=1)
        m, j = d.view(n, rows, nb).min(dim=1)  # the first (smallest) row on ties
        bd[s:s + n] = m
        bi[s:s + n] = j * nb + lane
    return bd, bi


def topk_over_buckets(bd: torch.Tensor, bi: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k least bucket minima per query, ascending, ties by bucket position
    (a stable sort, as `lax.top_k` breaks ties): (distances (Q, k) fp32, the
    correctly rounded sqrt of the clamped squared distances -- taken in fp64,
    since torch's fp32 sqrt on the CPU is not always correctly rounded;
    indices (Q, k) int64)."""
    order = torch.sort(bd, dim=1, stable=True).indices[:, :k]
    d2 = torch.gather(bd, 1, order).clamp(min=0.0)
    return torch.sqrt(d2.double()).float(), torch.gather(bi, 1, order)


def bucket_topk_plain(query: torch.Tensor, ref: torch.Tensor, k: int,
                      nb: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """`bucket_topk` computed tensor-wise (the CPU path and the kernel's
    yardstick)."""
    return topk_over_buckets(*bucket_minima_plain(query, ref, nb), k)


def bucket_minima_kernel(query: torch.Tensor, ref: torch.Tensor,
                         nb: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """`bucket_minima_plain` on the card through the `bucket_min` kernel;
    counts each kernel launch (one per 1,048,560 queries) in
    `bucket_minima_kernel.launches`."""
    _check(query, ref)
    if not query.is_cuda:
        raise ValueError("the bucket_min kernel takes CUDA tensors")
    if query.shape[1] != KERNEL_DIM:
        raise ValueError(f"the bucket_min kernel takes rows of {KERNEL_DIM} features, "
                         f"got {query.shape[1]}")
    query, ref = _aligned(query), _aligned(ref)
    Q = query.shape[0]
    bd = torch.empty((Q, nb), dtype=torch.float32, device=query.device)
    bi = torch.empty((Q, nb), dtype=torch.int64, device=query.device)
    if Q == 0:
        return bd, bi
    lib = _kernel()
    launched = ctypes.c_int(0)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.iggt_bucket_min(query.data_ptr(), ref.data_ptr(), bd.data_ptr(),
                                  bi.data_ptr(), Q, ref.shape[0], nb, stream,
                                  ctypes.byref(launched))
    bucket_minima_kernel.launches += launched.value
    if err != 0:
        raise RuntimeError("bucket_min kernel failed to launch: "
                           + lib.iggt_cuda_error_string(err).decode())
    return bd, bi


bucket_minima_kernel.launches = 0


def bucket_topk(query: torch.Tensor, ref: torch.Tensor, k: int,
                nb: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate k nearest ``ref`` rows per ``query`` row through per-bucket
    minima (bucket = reference index mod ``nb``), with exact fp32 distances:
    (dist (Q, k) ascending, idx (Q, k) int64).  A true neighbour is missed only
    when a closer one shares its bucket.  CUDA tensors launch the kernel; CPU
    tensors take `bucket_topk_plain`."""
    _check(query, ref)
    if not 0 < k <= nb:
        raise ValueError(f"k must be in [1, nb = {nb}], got {k}")
    if query.device.type == "cpu":
        return bucket_topk_plain(query, ref, k, nb)
    return topk_over_buckets(*bucket_minima_kernel(query, ref, nb), k)
