"""k-NN over world points and features: Morton-window smoothing and exact
brute-force kNN.

Counterpart of `iggt_official_tpu/ops/knn.py`:

- `knn_smooth_features` averages each point's k nearest neighbours' features
  (self excluded) over all views' points as one cloud.  The candidates are the
  2 * window points adjacent along each of three rotated Morton (Z-order)
  curves; the exact k nearest among them are kept.  It matches the JAX
  function's tie orders: a stable argsort of the Morton codes (many points
  share a 30-bit code at 1-2M points), and a stable sort of the candidates'
  distances, whose first k are the lowest-position ones among equal
  distances, as `lax.top_k` takes them.
- `brute_knn` is exact kNN in query blocks: |q|^2 + |r|^2 - 2 q.r with a
  full-fp32 `torch.matmul` (TF32 off), then top-k.  This is the product the
  JAX package leaves to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _morton_codes(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Interleave-bit Z-order codes for (M, 3) points, int64 (30 bits used,
    the same values and order as the JAX package's uint32 codes)."""
    p = points.to(torch.float32)
    lo = p.min(dim=0).values
    hi = p.max(dim=0).values
    scale = (2 ** bits - 1) / (hi - lo).clamp_min(1e-12)
    q = ((p - lo) * scale).clamp(0, 2 ** bits - 1).to(torch.int64)

    def spread(x):  # spread 10 bits to every 3rd bit
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


# fixed rotations diversifying the space-filling curves (arbitrary but
# deterministic well-spread orthonormal frames)
_ROTATIONS = np.stack([
    np.eye(3, dtype=np.float32),
    np.array(  # 45 deg about z then 45 deg about x
        [[0.7071, -0.7071, 0.0],
         [0.5, 0.5, -0.7071],
         [0.5, 0.5, 0.7071]], np.float32),
    np.array(  # 45 deg about y then 45 deg about z
        [[0.5, -0.7071, 0.5],
         [0.5, 0.7071, 0.5],
         [-0.7071, 0.0, 0.7071]], np.float32),
])


def _candidates(pts: torch.Tensor, window: int) -> torch.Tensor:
    """(M, 3 * 2 * window) int64 global ids of each point's Morton-window
    neighbours (self excluded), -1 where the window runs off the curve."""
    M = pts.shape[0]
    dev = pts.device
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    rows = torch.arange(M, device=dev)[:, None]
    pos = rows + offsets[None, :]              # position in a sorted order
    valid = (pos >= 0) & (pos < M)
    pos.clamp_(0, M - 1)
    cand = []
    for rot in _ROTATIONS:
        order = torch.argsort(_morton_codes(pts @ torch.from_numpy(rot).to(dev).T),
                              stable=True)     # sorted position -> global id
        ids = torch.where(valid, order[pos], -1)
        gathered = torch.empty_like(ids)
        gathered[order] = ids                  # rows back to global ids
        cand.append(gathered)
    return torch.cat(cand, dim=1)


def knn_smooth_features(points: torch.Tensor, features: torch.Tensor, k: int = 20,
                        window: int = 32, block: int = 65536) -> torch.Tensor:
    """Average each point's k nearest neighbours' features.

    points (..., 3), features (..., F); the leading dims are flattened into
    one cloud.  Neighbour candidates are the union over 3 rotated Morton
    orderings of the 2 * window points adjacent in each (duplicates masked),
    of which the exact k nearest are kept.  The candidate phase runs in
    ``block``-point chunks to bound its transients."""
    shape = features.shape
    pts = points.reshape(-1, 3).to(torch.float32)
    fts = features.reshape(-1, shape[-1]).to(torch.float32)
    M = pts.shape[0]
    cand = _candidates(pts, window)
    out = torch.empty_like(fts)
    for s in range(0, M, block):
        cand_sorted = torch.sort(cand[s:s + block], dim=1).values
        dup = torch.zeros_like(cand_sorted, dtype=torch.bool)
        dup[:, 1:] = cand_sorted[:, 1:] == cand_sorted[:, :-1]
        ok = (cand_sorted >= 0) & ~dup
        safe = cand_sorted.clamp(0, M - 1)
        diff = pts[safe] - pts[s:s + block, None, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        d2 = torch.where(ok, d2, torch.inf)
        nbr = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        out[s:s + block] = fts[torch.gather(safe, 1, nbr)].mean(dim=1)
    return out.reshape(shape)


def query_block_for(n_ref: int, block: int = 4096) -> int:
    """The query-block size `brute_knn` uses: ``block``, shrunk (to a power
    of two, >= 256) so the (block, R) fp32 distance block stays under
    ~512 MiB."""
    max_block = max(256, int((512 * 2 ** 20) // max(n_ref * 4, 1)))
    if block > max_block:
        block = max(256, 1 << (max_block.bit_length() - 1))
    return block


def brute_knn(ref: torch.Tensor, query: torch.Tensor, k: int,
              block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of ``query`` rows among ``ref`` rows, on their device.

    Returns (dist (Q, k) fp32, idx (Q, k) int64), ascending, self included
    when query is ref."""
    ref = ref.to(torch.float32)
    query = query.to(torch.float32)
    ref_sq = (ref * ref).sum(dim=1)
    block = query_block_for(ref.shape[0], block)
    dist = torch.empty((query.shape[0], k), dtype=torch.float32, device=ref.device)
    idx = torch.empty((query.shape[0], k), dtype=torch.int64, device=ref.device)
    for s in range(0, query.shape[0], block):
        q = query[s:s + block]
        d = (q * q).sum(dim=1, keepdim=True) + ref_sq[None, :] - 2.0 * (q @ ref.T)
        val, idx[s:s + block] = torch.topk(d, k, dim=1, largest=False, sorted=True)
        dist[s:s + block] = val.clamp_min(0.0).sqrt()
    return dist, idx
