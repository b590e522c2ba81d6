"""Mutual-reachability MST on the tensor's device (rank Boruvka).

Counterpart of `iggt_official_tpu/ops/cluster_device.py`.  The HDBSCAN stage
(`ops/cluster.py`) consumes the MST of the mutual-reachability kNN graph of
the <= 150k-point subsample; here the (K, k) kNN arrays stay on the card and
only the <= K-1 MST edges come back to the host.

Edges get a rank: their position in the ascending (weight, flat edge index)
order, from one stable sort.  The rank is a total order, so each round's
per-component minimum edge is one int64 scatter-min, the min-edge graph has
no cycles apart from mutual pairs, and the result is deterministic.  Per
round the forward direction (edges grouped by source node in the (K, k)
layout) reduces densely, the reverse direction is one scatter-min keyed by
the destination's component, and the union is pointer jumping over the (K,)
component array.  Rounds stop when no component has an outgoing edge, at
most ceil(log2 K) of them (18 at K = 150k).

The tie order is native `mst_knn`'s (weight ties broken by flat kNN index),
so with identical kNN inputs the edge SET equals the host kernel's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_BIG = torch.iinfo(torch.int64).max


def _boruvka_rank(knn_dist: torch.Tensor, knn_idx: torch.Tensor, min_samples: int):
    """(K, k) kNN arrays -> MST edges of the mutual-reachability graph.

    Returns (a, b (n,) int64, w (n,) fp32, core (K,) fp32), the forest's
    edges in (weight, flat edge index) order.  The kNN arrays are ascending
    with self at column 0 (unit weights), so the core distance is column
    min_samples - 1; it is infinite when the kNN holds fewer columns (fewer
    than min_samples points in all), as the host's core distance is."""
    K, k = knn_dist.shape
    E = K * k
    dev = knn_dist.device
    dist = knn_dist.to(torch.float32)
    core = (dist[:, min_samples - 1] if min_samples <= k
            else torch.full((K,), torch.inf, device=dev))

    node = torch.arange(K, device=dev)
    dst = knn_idx.to(torch.int64)
    w = torch.maximum(dist, torch.maximum(core[:, None], core[dst]))
    valid = (dst != node[:, None]) & torch.isfinite(w)
    w = torch.where(valid, w, torch.inf)

    # rank = position in the ascending (w, eid) order; invalid edges sort to
    # the tail and are excluded by rank >= n_valid
    perm = torch.sort(w.reshape(-1), stable=True).indices  # sorted pos -> eid
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(E, device=dev)
    n_valid = int(valid.sum())
    rank2d = torch.where(rank < n_valid, rank, _BIG).reshape(K, k)

    src_of_rank = perm // k
    dst_of_rank = dst.reshape(-1)[perm]

    max_rounds = max(1, math.ceil(math.log2(max(K, 2))))
    comp = node
    keep = torch.zeros(E, dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        comp_dst = comp[dst]
        r_act = torch.where(comp[:, None] != comp_dst, rank2d, _BIG)
        best = torch.full((K,), _BIG, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, comp, r_act.min(dim=1).values, "amin")
        best.scatter_reduce_(0, comp_dst.reshape(-1), r_act.reshape(-1), "amin")
        has = best < _BIG
        if not bool(has.any()):
            break
        keep[best[has]] = True

        # union: component -> its winner edge's opposite side
        r_star = torch.where(has, best, 0)
        cu = comp[src_of_rank[r_star]]
        cv = comp[dst_of_rank[r_star]]
        parent = torch.where(has, torch.where(cu == node, cv, cu), node)
        # mutual pairs (a <-> b picked the same edge): the smaller id is root
        parent = torch.where((parent[parent] == node) & (node < parent), node, parent)
        for _ in range(max_rounds):
            parent = parent[parent]
        comp = parent[comp]

    kept = torch.nonzero(keep).squeeze(1)  # ascending rank = (w, eid) order
    return (src_of_rank[kept], dst_of_rank[kept], w.reshape(-1)[perm[kept]], core)


def mreach_mst_device(knn_dist: torch.Tensor, knn_idx: torch.Tensor, min_samples: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Mutual-reachability MST edges from kNN arrays on any device.

    Returns host (edge_a (n,) int64, edge_b (n,) int64, edge_d (n,) float64,
    core (K,) float64) for `ops/cluster.py::_labels_from_edges`."""
    a, b, w, core = _boruvka_rank(knn_dist, knn_idx, min_samples)
    return (a.cpu().numpy(), b.cpu().numpy(), w.cpu().numpy().astype(np.float64),
            core.cpu().numpy().astype(np.float64))
