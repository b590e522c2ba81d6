"""Density clustering of instance features -> multi-view instance masks.

Counterpart of `iggt_official_tpu/ops/cluster.py` (reference semantics
`iggt/utils/misc.py:81-170`): all views' (N, H, W, C = 8) features are
clustered jointly by a weighted HDBSCAN (weighted core distances ->
mutual-reachability kNN graph -> MST -> single linkage -> condensed tree ->
excess-of-mass selection with the Malzer-Baum `cluster_selection_epsilon`,
`allow_single_cluster=False`), noise pixels are reassigned to their nearest
clustered pixel, and the masks are coloured with a jet colormap whose colours
are consistent across views.  Above 150k pixels a uniform subsample is
clustered with density-scaled parameters, every pixel is 1-NN backfilled to
it, and a full-density refinement restores the merges thinning severs.

Two paths, chosen by where the features live:

- `_cluster_mv_device` (features a CUDA tensor, any size; ``exact`` clusters
  every pixel instead of a subsample): exact brute-force core kNN and the
  rank-Boruvka MST on the tensor's device, the 1-NN steps through the `nn1`
  kernel, and the refinement's seed mask on the device.  On CPU tensors the
  same function runs with the plain `nn1` (the tests hold it to the JAX
  package).
- `_cluster_mv_host` (numpy or a CPU tensor): the native C++ library
  (`native/postproc.cpp`) throughout, as the JAX package runs on a CPU.

The labelling stage and the refinement's full-density phases run on the
host in both paths, through the native library.

A caller may pass a ``trace`` dict to `cluster_features_to_masks_mv` (and the
functions below it): each stage then synchronizes the device at its end and
adds its wall seconds under its name (core kNN, MST, labels, noise
reassignment, backfill, refinement), with the noise share before
reassignment under "noise share".  Traced, the backfill no longer overlaps
the refinement's MST candidate scan.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from iggt_official_tpu_torch import native
from iggt_official_tpu_torch.utils.colormaps import jet

BUDGET = 150_000  # subsample size of the default (non-exact) path


def trace_stage(trace: Optional[Dict[str, float]], name: str, t0: float, device=None) -> float:
    """Add the seconds since ``t0`` to ``trace[name]`` (after synchronizing
    a CUDA ``device``) and return the next stage's start; no-op untraced."""
    if trace is None:
        return t0
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    trace[name] = trace.get(name, 0.0) + t - t0
    return t


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _nn1(ref: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index of the nearest ``ref`` point per query (native KD-tree)."""
    return native.nearest_neighbor(ref, query)


def _knn(points: np.ndarray, k: int):
    """(dist, idx) of the k nearest points, self included (native)."""
    return native.knn_query(points, k)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def weighted_dbscan(points: np.ndarray, weights: np.ndarray, eps: float,
                    min_samples: int) -> np.ndarray:
    """DBSCAN over weighted points (cells), through the native KD-tree: a point
    is core iff the total weight within eps (itself included) is >=
    min_samples; core points within eps merge; a non-core point joins the
    cluster of its nearest core point within eps.  Labels (K,), -1 = noise."""
    return native.weighted_dbscan(points, weights, eps, min_samples)


def _weighted_core_distances(points: np.ndarray, weights: np.ndarray, min_samples: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell core distance treating a cell of weight m as m coincident
    points: the smallest radius whose cumulative weight >= min_samples.

    Returns (core (K,), knn_dist (K, k), knn_idx (K, k)); the kNN arrays
    are reused for the mutual-reachability graph."""
    K = points.shape[0]
    # wide enough for the reachability graph too: missing kNN edges can only
    # inflate MST merge heights (over-splitting), so keep >= 64
    k = min(K, max(64, min_samples + 1))
    dist, idx = _knn(points, k)
    while True:
        cumw = np.cumsum(weights[idx], axis=1)
        short = cumw[:, -1] < min_samples
        if not short.any() or k >= K:
            break
        k = min(K, k * 4)
        dist, idx = _knn(points, k)
    # first column of idx is the point itself (distance 0)
    pos = np.argmax(cumw >= min_samples, axis=1)
    core = dist[np.arange(K), pos]
    core[cumw[:, -1] < min_samples] = np.inf  # total weight < min_samples
    return core, dist, idx


def _mreach_mst(core: np.ndarray, knn_dist: np.ndarray, knn_idx: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mutual-reachability kNN graph -> MST edges (a, b, d) (native Boruvka)."""
    return native.mst_knn(knn_dist, knn_idx, core)


def _weighted_single_linkage(weights: np.ndarray, edge_a: np.ndarray,
                             edge_b: np.ndarray, edge_d: np.ndarray) -> np.ndarray:
    """Single-linkage dendrogram over precomputed MST edges.

    Returns linkage Z (K-1, 4): [left, right, distance, weighted size],
    node ids like scipy (leaves 0..K-1, merge i -> K+i).  Disconnected
    components are joined by +inf edges."""
    K = weights.shape[0]
    edges = list(zip(edge_d, edge_a, edge_b))

    # join remaining components (and isolated/inf-core cells) at +inf
    uf = _UnionFind(K)
    for _, a, b in edges:
        uf.union(int(a), int(b))
    rep = sorted({uf.find(i) for i in range(K)})
    for other in rep[1:]:
        edges.append((np.inf, rep[0], other))

    edges.sort(key=lambda e: e[0])
    Z = np.zeros((K - 1, 4))
    uf2 = _UnionFind(2 * K - 1)
    comp_node = np.arange(K)  # union-find root -> current dendrogram node
    sizes = np.concatenate([weights.astype(np.float64), np.zeros(K - 1)])
    nxt = K
    for dist_e, a, b in edges:
        ra, rb = uf2.find(int(a)), uf2.find(int(b))
        if ra == rb:
            continue
        na, nb = comp_node[ra], comp_node[rb]
        Z[nxt - K] = (na, nb, dist_e, sizes[na] + sizes[nb])
        sizes[nxt] = sizes[na] + sizes[nb]
        uf2.union(ra, rb)
        comp_node[uf2.find(ra)] = nxt
        nxt += 1
    assert nxt == 2 * K - 1, "MST did not span all cells"
    return Z


def _labels_from_edges(edge_a, edge_b, edge_d, weights, core, eps: float,
                       min_cluster_size: int, allow_single_cluster: bool) -> np.ndarray:
    """MST edges -> HDBSCAN labels through the native port of
    `_labels_from_mst` (the tested Python spec).

    Edges are canonicalized to (d, min(a,b), max(a,b)) order first, so the
    labels are a function of the edge SET: the host and device MST builders
    emit the same set in different orders."""
    edge_a, edge_b, edge_d = (np.asarray(e) for e in (edge_a, edge_b, edge_d))
    order = np.lexsort((np.maximum(edge_a, edge_b), np.minimum(edge_a, edge_b), edge_d))
    return native.hdbscan_mst_labels(edge_a[order], edge_b[order], edge_d[order], weights,
                                     core, float(eps), float(min_cluster_size),
                                     allow_single_cluster)


def weighted_hdbscan(points, weights: np.ndarray, eps: float, min_samples: int,
                     min_cluster_size: int, allow_single_cluster: bool = False,
                     return_mst: bool = False, trace: Optional[Dict[str, float]] = None):
    """HDBSCAN(cluster_selection_epsilon=eps) over weighted points.

    Returns labels (K,), -1 = noise.  ``points`` is numpy or a tensor.  For
    a tensor (unit weights only) the core kNN (exact brute force) and the MST
    run on its device and only the MST edges come back; the labelling is
    shared with the numpy path.

    ``return_mst=True`` returns ``(labels, (edge_a, edge_b, edge_d),
    (knn_dist, knn_idx))``: the MST gates the refinement's cluster pairs
    (`_mst_candidate_pairs`), and the kNN arrays (tensors on the device path,
    numpy on the host path) give its boundary seeds."""
    K = points.shape[0]
    if K == 1:
        labels = (np.zeros(1, np.int64) if weights[0] >= min_cluster_size
                  else np.full(1, -1, np.int64))
        empty = np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
        return (labels, empty, None) if return_mst else labels

    if isinstance(points, torch.Tensor):
        if not bool(np.all(weights == 1)):
            raise ValueError("weighted_hdbscan on a tensor takes unit weights only")
        from iggt_official_tpu_torch.ops.cluster_device import mreach_mst_device
        from iggt_official_tpu_torch.ops.knn import brute_knn

        t0 = time.perf_counter()
        k = min(K, max(64, min_samples + 1))
        knn = brute_knn(points, points, k)
        t0 = trace_stage(trace, "core kNN", t0, points.device)
        edge_a, edge_b, edge_d, core = mreach_mst_device(*knn, min_samples)
        t0 = trace_stage(trace, "MST", t0)
    else:
        t0 = time.perf_counter()
        points = _to_numpy(points)
        core, knn_dist, knn_idx = _weighted_core_distances(points, weights, min_samples)
        knn = (knn_dist, knn_idx)
        t0 = trace_stage(trace, "core kNN", t0)
        edge_a, edge_b, edge_d = _mreach_mst(core, knn_dist, knn_idx)
        t0 = trace_stage(trace, "MST", t0)
    labels = _labels_from_edges(edge_a, edge_b, edge_d, weights, core, eps,
                                min_cluster_size, allow_single_cluster)
    trace_stage(trace, "labels", t0)
    if return_mst:
        return labels, (edge_a, edge_b, edge_d), knn
    return labels


def _labels_from_mst(edge_a: np.ndarray, edge_b: np.ndarray, edge_d: np.ndarray,
                     weights: np.ndarray, core: np.ndarray, eps: float,
                     min_cluster_size: int, allow_single_cluster: bool = False
                     ) -> np.ndarray:
    """Pure-Python HDBSCAN labelling from mutual-reachability MST edges
    (the spec of native `hdbscan_mst_labels`)."""
    K = weights.shape[0]
    Z = _weighted_single_linkage(weights, edge_a, edge_b, edge_d)

    # --- condensed tree (top-down), weighted min_cluster_size ---------
    n_nodes = 2 * K - 1
    left = Z[:, 0].astype(np.int64)
    right = Z[:, 1].astype(np.int64)
    zdist = Z[:, 2]
    wsize = np.concatenate([weights.astype(np.float64), Z[:, 3]])

    def lam(d):
        if d <= 0:
            return np.inf
        if not np.isfinite(d):
            return 0.0
        return 1.0 / d

    def fall_out(roots, cl, lam_out):
        sub = list(roots)
        while sub:
            s = sub.pop()
            if s < K:
                fall_point.append(s)
                fall_cluster.append(cl)
                fall_lam.append(lam_out)
            else:
                sub.append(left[s - K])
                sub.append(right[s - K])

    parent_c: list = [-1]
    lam_birth: list = [0.0]
    fall_point: list = []
    fall_cluster: list = []
    fall_lam: list = []
    # stack of (dendrogram node, condensed cluster id)
    stack = [(n_nodes - 1, 0)]
    while stack:
        node, cl = stack.pop()
        if node < K:
            # a leaf of a cluster that fully dissolves dies at its core distance
            fall_point.append(node)
            fall_cluster.append(cl)
            fall_lam.append(lam(max(core[node], 0.0)))
            continue
        i = node - K
        l, r, d = left[i], right[i], zdist[i]
        ld = lam(d)
        big_l, big_r = wsize[l] >= min_cluster_size, wsize[r] >= min_cluster_size
        if big_l and big_r:
            for child in (l, r):
                parent_c.append(cl)
                lam_birth.append(ld)
                stack.append((child, len(parent_c) - 1))
        elif big_l or big_r:
            big, small = (l, r) if big_l else (r, l)
            fall_out([small], cl, ld)  # the small side falls out of `cl`
            stack.append((big, cl))
        else:
            fall_out([l, r], cl, ld)   # both sides below min_cluster_size

    parent_arr = np.asarray(parent_c)
    birth = np.asarray(lam_birth)
    fp = np.asarray(fall_point)
    fc = np.asarray(fall_cluster)
    fl = np.asarray(fall_lam)
    n_cl = len(parent_c)

    # --- stability ----------------------------------------------------
    stab = np.zeros(n_cl)
    w_f = weights[fp].astype(np.float64)
    # infinite leave-lambdas (duplicate points) are capped at the max finite
    # lambda in the tree to keep stabilities comparable
    finite_max = np.max(fl[np.isfinite(fl)]) if np.isfinite(fl).any() else 1.0
    fl_use = np.where(np.isfinite(fl), fl, finite_max)
    np.add.at(stab, fc, w_f * (fl_use - birth[fc]))
    # child clusters contribute (their birth - parent birth) * their mass
    total_mass = np.zeros(n_cl)
    np.add.at(total_mass, fc, w_f)
    for c in range(n_cl - 1, 0, -1):
        total_mass[parent_arr[c]] += total_mass[c]
    for c in range(1, n_cl):
        p = parent_arr[c]
        stab[p] += total_mass[c] * (birth[c] - birth[p])

    # --- excess-of-mass selection ------------------------------------
    children: list = [[] for _ in range(n_cl)]
    for c in range(1, n_cl):
        children[parent_arr[c]].append(c)

    def descendants(c):
        sub = list(children[c])
        while sub:
            s = sub.pop()
            yield s
            sub.extend(children[s])

    selected = np.zeros(n_cl, bool)
    subtree_stab = np.zeros(n_cl)
    for c in range(n_cl - 1, -1, -1):
        if not children[c]:
            selected[c] = True
            subtree_stab[c] = stab[c]
            continue
        child_sum = sum(subtree_stab[ch] for ch in children[c])
        if stab[c] > child_sum and (c != 0 or allow_single_cluster):
            selected[c] = True
            for s in descendants(c):
                selected[s] = False
            subtree_stab[c] = stab[c]
        else:
            subtree_stab[c] = child_sum
    if not allow_single_cluster:
        selected[0] = False

    # --- cluster_selection_epsilon (Malzer-Baum 2019) -----------------
    # A selected cluster whose birth distance (1/birth-lambda) < eps is
    # replaced by its first ancestor with birth distance >= eps.
    if eps and eps > 0:
        for c in np.flatnonzero(selected):
            birth_dist = np.inf if birth[c] == 0 else 1.0 / birth[c]
            if birth_dist >= eps:
                continue
            anc = c
            while anc != 0:
                p = parent_arr[anc]
                p_birth_dist = np.inf if birth[p] == 0 else 1.0 / birth[p]
                anc = p
                if p_birth_dist >= eps:
                    break
            if anc == 0 and not allow_single_cluster:
                # the epsilon merge would reach the root: take the highest
                # non-root ancestor instead
                anc = c
                while parent_arr[anc] != 0:
                    anc = parent_arr[anc]
            selected[c] = False
            selected[anc] = True
        for c in np.flatnonzero(selected):
            for s in descendants(c):
                selected[s] = False

    # --- labels: nearest selected ancestor (parents precede children) --
    sel_anc = np.full(n_cl, -1, np.int64)
    for c in range(n_cl):
        if selected[c]:
            sel_anc[c] = c
        elif parent_arr[c] >= 0:
            sel_anc[c] = sel_anc[parent_arr[c]]
    labels = np.full(K, -1, np.int64)
    labels[fp] = sel_anc[fc]
    kept = np.unique(labels[labels >= 0])
    remap = np.full(n_cl, -1, np.int64)
    remap[kept] = np.arange(len(kept))
    labels[labels >= 0] = remap[labels[labels >= 0]]
    return labels


def _seed_mask_from_knn(knn, labels: np.ndarray, in_pair: np.ndarray,
                        thresh: float) -> np.ndarray:
    """(K,) mask of subsample points with a candidate-pair cross-cluster
    neighbour within ``thresh``, from the clustering's own kNN arrays; on
    their device when they are tensors (only the mask comes back)."""
    dist, idx = knn
    if isinstance(dist, torch.Tensor):
        lab = torch.as_tensor(labels, device=dist.device)
        pair = torch.as_tensor(in_pair, device=dist.device)
        nbr = lab[idx]
        near = (nbr != lab[:, None]) & (dist <= thresh) & pair[lab[:, None], nbr]
        return near.any(dim=1).cpu().numpy()
    nbr_lab = labels[idx]
    near = (nbr_lab != labels[:, None]) & (dist <= thresh)
    near &= in_pair[labels[:, None], nbr_lab]
    return near.any(axis=1)


def _mst_candidate_pairs(mst, labels: np.ndarray, thresh: float):
    """Cluster pairs whose thinned-graph dendrogram merge height is
    <= ``thresh``: connected components of the MST restricted to edges
    <= thresh; every cross-label pair co-resident in a component merges at
    or below thresh.  ``thresh = margin * eps`` with margin = 2, an
    empirical slack (thinning inflates merge heights only in expectation)."""
    edge_a, edge_b, edge_d = mst
    sel = np.asarray(edge_d) <= thresh
    if not sel.any():
        return set()
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    K = labels.shape[0]
    graph = coo_matrix((np.ones(int(sel.sum()), np.int8),
                        (np.asarray(edge_a)[sel], np.asarray(edge_b)[sel])), shape=(K, K))
    _, comp = connected_components(graph, directed=False)
    pairs = set()
    # unique (component, label) rows: components holding > 1 label give
    # all their cross pairs
    keep = labels >= 0
    rows = np.unique(np.stack([comp[keep], labels[keep]], axis=1), axis=0)
    comp_u, lab_u = rows[:, 0], rows[:, 1]
    starts = np.flatnonzero(np.r_[True, np.diff(comp_u) != 0])
    bounds = np.r_[starts, len(comp_u)]
    for i in range(len(starts)):
        labs = lab_u[bounds[i]:bounds[i + 1]]
        for x in range(len(labs)):
            for y in range(x + 1, len(labs)):
                pairs.add((int(labs[x]), int(labs[y])))
    return pairs


def _pair_matrix(pairs, n: int) -> np.ndarray:
    in_pair = np.zeros((n, n), bool)
    for a, b in pairs:
        in_pair[a, b] = in_pair[b, a] = True
    return in_pair


def _boundary_merge_full_density(flat, pts, labels: np.ndarray, j_all, eps: float,
                                 min_samples: int, min_cluster_size: int = 0,
                                 margin: float = 2.0, cap: int = 250_000, mst=None,
                                 knn=None) -> np.ndarray:
    """Full-density merge refinement for subsampled clustering.

    Node thinning inflates minimax (bottleneck) distances, so a cluster pair
    the full-density algorithm merges under ``cluster_selection_epsilon``
    can stay split in the thinned graph.  For every cluster pair whose
    thinned separation is below ``margin * eps``, this pass takes the
    full-resolution points (through the 1-NN backfill map ``j_all``) near
    the pair's boundary, builds their mutual-reachability kNN graph with the
    unscaled ``min_samples``, and unions the pair if its two sides connect
    by edges of reachability <= eps (one-sided: it only restores merges the
    exact algorithm makes).  Connectivity endpoints must be >= 90% purely
    labelled in their local kNN.  Part 2 replays the condensed-tree
    viability decision of small clusters (`_small_cluster_viability_merges`).

    flat: (M, C) full features (numpy or tensor); pts: (K, C) subsample;
    labels: (K,) subsample labels (noise already reassigned); j_all: (M,)
    1-NN map full -> subsample, or a zero-arg callable returning it (the
    card path keeps the backfill kernel in flight meanwhile); ``mst``/``knn``
    from `weighted_hdbscan(return_mst=True)`.  Returns the (K,) labels,
    relabelled when merges happen."""
    uniq = np.unique(labels)
    uniq = uniq[uniq >= 0]
    if len(uniq) < 2 or min_samples + 1 > pts.shape[0]:
        return labels
    n_lab = int(uniq.max()) + 1

    # --- candidate pairs and boundary seeds -------------------------------
    if mst is not None:
        pairs = _mst_candidate_pairs(mst, labels, margin * eps)
        if not pairs:
            return labels
    if mst is not None and knn is not None:
        seed_mask = _seed_mask_from_knn(knn, labels, _pair_matrix(pairs, n_lab),
                                        margin * eps)
        if not seed_mask.any():
            return labels
    else:
        # direct callers: cross-cluster proximity probe
        pts = _to_numpy(pts)
        dist, idx = _refine_knn_self(pts, min(64, pts.shape[0]))
        nbr_lab = labels[idx]
        near = (nbr_lab != labels[:, None]) & (dist <= margin * eps)
        if mst is not None:
            near &= _pair_matrix(pairs, n_lab)[labels[:, None], nbr_lab]
        seed_mask = near.any(axis=1)
        if not seed_mask.any():
            return labels
        if mst is None:
            pairs = set()
            rows, cols = np.nonzero(near)
            for r, c in zip(rows.tolist(), cols.tolist()):
                a, b = int(labels[r]), int(nbr_lab[r, c])
                pairs.add((min(a, b), max(a, b)))

    # --- host-side from here: the features and a lazily built kNN tree ----
    flat = np.ascontiguousarray(_to_numpy(flat), np.float32)
    tree_box: list = []

    def flat_tree():
        if not tree_box:
            tree_box.append(native.KnnTree(flat))
        return tree_box[0]

    lab_uf = _UnionFind(n_lab)

    # --- part 1: sub-eps connectivity at full density ---------------------
    j_all = j_all() if callable(j_all) else np.asarray(j_all)
    sel = np.flatnonzero(seed_mask[j_all])
    if sel.size > cap:
        sel = np.random.default_rng(0).choice(sel, cap, replace=False)
    if sel.size >= min_samples + 1:
        sub = flat[sel]
        sub_lab = labels[j_all[sel]]
        k_local = min(min_samples + 1, sub.shape[0])
        d_loc, i_loc = _refine_knn_self(sub, k_local)
        core = d_loc[:, min(min_samples, k_local) - 1]
        n = sub.shape[0]
        src = np.repeat(np.arange(n, dtype=np.int32), k_local)
        dst = i_loc.reshape(-1).astype(np.int32)
        mreach = np.maximum(d_loc.reshape(-1), np.maximum(core[src], core[dst]))
        ok = (mreach <= eps) & (src != dst)
        if ok.any():
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components

            graph = coo_matrix((np.ones(int(ok.sum()), np.int8), (src[ok], dst[ok])),
                               shape=(n, n))
            _, comp = connected_components(graph, directed=False)
            # endpoint certification: a point certifies for its label iff
            # >= 90% of its local kNN share it (backfill labels near
            # boundaries are not trustworthy)
            cert = (sub_lab[i_loc] == sub_lab[:, None]).mean(axis=1) >= 0.9
            for a, b in pairs:
                in_a = np.unique(comp[(sub_lab == a) & cert])
                in_b = np.unique(comp[(sub_lab == b) & cert])
                if np.intersect1d(in_a, in_b, assume_unique=True).size:
                    lab_uf.union(a, b)

    # --- part 2: condensed-node viability of small clusters ---------------
    try:
        _small_cluster_viability_merges(flat, labels, j_all, pairs, lab_uf, eps,
                                        min_samples, min_cluster_size,
                                        flat_tree=flat_tree)
    finally:
        if tree_box:
            tree_box[0].close()

    roots = np.array([lab_uf.find(int(u)) for u in uniq])
    if np.all(roots == uniq):
        return labels
    remap = np.full(n_lab, -1, np.int64)
    remap[uniq] = roots
    kept = np.unique(roots)  # compact to 0..n-1 like the labelling stage
    compact = np.full(int(kept.max()) + 1, -1, np.int64)
    compact[kept] = np.arange(len(kept))
    out = labels.copy()
    pos = labels >= 0
    out[pos] = compact[remap[labels[pos]]]
    return out


def _refine_knn_self(x, k: int):
    """Self-kNN of the refinement's boundary subsets (native, host)."""
    return native.knn_query(np.asarray(x, np.float32), k)


def _knn_query_vs(ref, query: np.ndarray, k: int, tree=None):
    """(dist, idx) of the k nearest ``ref`` rows per query row, exact (a
    missed local-graph edge can flip part 2's verdicts).  ``tree`` is a
    `native.KnnTree` over ``ref`` reused across queries."""
    if tree is not None:
        return tree.query(np.asarray(query, np.float32), k)
    return native.knn_query_vs(np.asarray(ref, np.float32), np.asarray(query, np.float32), k)


def _small_cluster_viability_merges(flat, labels: np.ndarray, j_all: np.ndarray, pairs,
                                    lab_uf: _UnionFind, eps: float, min_samples: int,
                                    min_cluster_size: int, small_cap_ratio: int = 8,
                                    flat_tree=None) -> None:
    """Full-density condensed-node viability test for small clusters.

    When a small blob meets a big cluster in the dendrogram, the exact
    algorithm keeps it only if the blob-side subtree reaches
    ``min_cluster_size`` mass below the merge height.  For every candidate
    pair with a small side this replays that decision over the kNN
    mutual-reachability graph of the blob's full-resolution one-hop
    neighbourhood (unscaled min_samples cores): viable first keeps the
    split, touching the big cluster's (>= 90% pure) interior first folds the
    blob.  Merges are recorded into ``lab_uf``."""
    if not min_cluster_size:
        return
    full_labels = labels[j_all]
    sizes = np.bincount(full_labels[full_labels >= 0], minlength=int(labels.max()) + 1)
    k = min_samples + 1
    if k > full_labels.shape[0]:
        return
    for a, b in sorted(pairs):
        s, big = (a, b) if sizes[a] <= sizes[b] else (b, a)
        if lab_uf.find(s) == lab_uf.find(big):
            continue
        if sizes[s] < min_cluster_size:
            # below the full-density min_cluster_size the condensed tree can
            # never select it: the split is a thinning artifact
            lab_uf.union(s, big)
            continue
        if not sizes[s] < small_cap_ratio * min_cluster_size or sizes[s] > 20_000:
            continue
        s_idx = np.flatnonzero(full_labels == s)
        tree = flat_tree() if callable(flat_tree) else flat_tree
        d_s, i_s = _knn_query_vs(flat, np.asarray(flat[s_idx], np.float32), k, tree=tree)
        if not (full_labels[i_s] == big).any():
            continue

        # one-hop neighbourhood, capped by keeping the closest non-blob
        # neighbours (dropping far ones can only keep the split)
        nbr_cap = max(4 * s_idx.size, 30_000)
        nbr = i_s.reshape(-1)
        nbr_d = d_s.reshape(-1)
        outside = ~np.isin(nbr, s_idx)
        nbr, nbr_d = nbr[outside], nbr_d[outside]
        uniq_n, inv = np.unique(nbr, return_inverse=True)
        if uniq_n.size > nbr_cap:
            min_d = np.full(uniq_n.size, np.inf)
            np.minimum.at(min_d, inv, nbr_d)
            uniq_n = uniq_n[np.argsort(min_d, kind="stable")[:nbr_cap]]
        d_new, i_new = _knn_query_vs(flat, np.asarray(flat[uniq_n], np.float32), k,
                                     tree=tree)
        cat = np.concatenate([s_idx, uniq_n])
        order = np.argsort(cat, kind="stable")
        L_ids = cat[order]
        dL = np.concatenate([d_s, d_new])[order]
        iL = np.concatenate([i_s, i_new])[order]
        coreL = dL[:, min_samples - 1]
        lab_L = full_labels[L_ids]
        # both memberships certified by full-density neighbour purity
        is_s = (lab_L == s) & ((full_labels[iL] == s).mean(axis=1) >= 0.9)
        is_big_int = (lab_L == big) & ((full_labels[iL] == big).mean(axis=1) >= 0.9)
        if not is_big_int.any() or not is_s.any():
            continue

        # local mreach edges (within the neighbourhood)
        nL = L_ids.shape[0]
        loc = np.full(int(full_labels.shape[0]), -1, np.int32)
        loc[L_ids] = np.arange(nL, dtype=np.int32)
        src = np.repeat(np.arange(nL, dtype=np.int32), k)
        dst = loc[iL.reshape(-1)]
        w = np.maximum(dL.reshape(-1), coreL[src])
        ok = dst >= 0
        w = np.where(ok, np.maximum(w, coreL[np.where(ok, dst, 0)]), np.inf)
        ok &= (src != dst) & np.isfinite(w)
        if _grow_until_viable_or_touch(nL, src[ok], dst[ok], w[ok], is_s, is_big_int,
                                       min_cluster_size):
            lab_uf.union(s, big)


def _grow_until_viable_or_touch(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                                is_s: np.ndarray, is_big: np.ndarray,
                                min_cluster_size: int) -> bool:
    """Single-linkage event sweep (exact Kruskal): True = fold the blob (an
    s-seeded component touches the big interior before any reaches
    ``min_cluster_size`` mass), False = keep the split.  When both events
    land on one edge, touch wins."""
    finite = np.isfinite(w)
    src, dst, w = src[finite], dst[finite], w[finite]
    if w.size == 0:
        return False
    order = np.argsort(w, kind="stable")
    parent = list(range(n))
    mass = [1] * n
    has_s = is_s.tolist()
    has_big = is_big.tolist()

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(src[order].tolist(), dst[order].tolist()):
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if mass[ra] < mass[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        mass[ra] += mass[rb]
        hs = has_s[ra] or has_s[rb]
        hb = has_big[ra] or has_big[rb]
        has_s[ra], has_big[ra] = hs, hb
        if hs and hb:
            return True                     # touch first: fold
        if hs and mass[ra] >= min_cluster_size:
            return False                    # viable first: keep
    return False


def _subsample(M: int, budget: int, min_samples: int, min_cluster_size: int):
    """The uniform subsample and its density-scaled parameters (ms, mcs);
    None when M fits the budget."""
    if M <= budget:
        return None, min_samples, min_cluster_size
    rate = budget / M
    sample_idx = np.random.default_rng(0).choice(M, budget, replace=False)
    return (sample_idx, max(2, int(round(min_samples * rate))),
            max(2, int(round(min_cluster_size * rate))))


def _cluster_mv_device(flat_dev: torch.Tensor, n: int, h: int, w: int, eps: float,
                       min_samples: int, min_cluster_size: int, budget: int,
                       trace: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Multi-view clustering with the features on their device.

    The subsample gather, core kNN and MST, the 1-NN noise reassignment and
    backfill (`nn1`) and the refinement's seed mask run where ``flat_dev``
    lives; the labels, the MST edges and the final assignment come to the
    host.  ``budget >= M`` clusters every pixel (the exact path).  Semantics
    mirror `_cluster_mv_host` line for line."""
    from iggt_official_tpu_torch.ops.nn1 import nn1

    M = flat_dev.shape[0]
    sample_idx, ms, mcs = _subsample(M, budget, min_samples, min_cluster_size)
    pts_dev = (flat_dev if sample_idx is None
               else flat_dev[torch.as_tensor(sample_idx, device=flat_dev.device)])
    weights = np.ones(pts_dev.shape[0], np.float64)
    labels, mst, knn = weighted_hdbscan(pts_dev, weights, eps, ms, mcs, return_mst=True,
                                        trace=trace)

    # noise -> 1-NN clustered pixel (`misc.py:135-148`)
    dev = flat_dev.device
    t0 = time.perf_counter()
    noise = labels == -1
    if trace is not None:
        trace["noise share"] = float(noise.mean())
    if noise.all():
        labels[:] = 0
    elif noise.any():
        j = nn1(pts_dev[torch.as_tensor(np.flatnonzero(noise), device=dev)],
                pts_dev[torch.as_tensor(np.flatnonzero(~noise), device=dev)])
        labels[noise] = labels[~noise][j.cpu().numpy()]
    t0 = trace_stage(trace, "noise reassignment", t0)

    if sample_idx is None:
        return labels.reshape(n, h, w)
    # the backfill kernel runs while the host scans the MST for candidate
    # pairs; the seed mask queues behind it on the same stream, and its
    # result is read where first needed
    j_dev = nn1(flat_dev, pts_dev)
    t0 = trace_stage(trace, "backfill", t0, dev)
    memo = {}

    def j_fn():
        if "j" not in memo:
            j = j_dev.cpu().numpy()
            j[sample_idx] = np.arange(pts_dev.shape[0])
            memo["j"] = j
        return memo["j"]

    labels = _boundary_merge_full_density(flat_dev, pts_dev, labels, j_fn, eps,
                                          min_samples, min_cluster_size, mst=mst, knn=knn)
    labels = labels[j_fn()].reshape(n, h, w)
    trace_stage(trace, "refinement", t0)
    return labels


def _cluster_mv_host(flat: np.ndarray, n: int, h: int, w: int, eps: float,
                     min_samples: int, min_cluster_size: int, budget: int,
                     exact: bool) -> np.ndarray:
    """Host multi-view clustering (the spec `_cluster_mv_device` mirrors)."""
    M = flat.shape[0]
    if exact:
        sample_idx, ms, mcs = None, min_samples, min_cluster_size
    else:
        sample_idx, ms, mcs = _subsample(M, budget, min_samples, min_cluster_size)
    pts = flat if sample_idx is None else flat[sample_idx]
    weights = np.ones(pts.shape[0], np.float64)
    labels, mst, knn = weighted_hdbscan(pts, weights, eps, ms, mcs, return_mst=True)

    # noise -> 1-NN clustered pixel (`misc.py:135-148`)
    noise = labels == -1
    if noise.all():
        labels[:] = 0
    elif noise.any():
        labels[noise] = labels[~noise][_nn1(pts[~noise], pts[noise])]

    if sample_idx is None:
        return labels.reshape(n, h, w)
    j_all = np.empty(M, np.int64)
    j_all[sample_idx] = np.arange(pts.shape[0])
    rest = np.ones(M, bool)
    rest[sample_idx] = False
    j_all[rest] = _nn1(pts, flat[rest])
    labels = _boundary_merge_full_density(flat, pts, labels, j_all, eps, min_samples,
                                          min_cluster_size, mst=mst, knn=knn)
    return labels[j_all].reshape(n, h, w)


def cluster_features_to_masks_mv(feature_map, apply_colormap: bool = False,
                                 eps: float = 0.06, min_samples: int = 100,
                                 min_cluster_size: int = 500, exact: bool = False,
                                 trace: Optional[Dict[str, float]] = None
                                 ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Joint multi-view clustering (`misc.py:81-170` semantics).

    ``feature_map`` (N, H, W, C), numpy or a tensor.  A CUDA tensor takes
    the device path; numpy or a CPU tensor the host path.  ``exact=True``
    clusters every pixel (no subsample).  Returns masks (N, H, W) int64,
    -1 = noise, and with ``apply_colormap`` also their (N, H, W, 3) uint8
    colours.  ``trace``: the device path's stage times (module docstring)."""
    n, h, w, c = feature_map.shape
    M = n * h * w
    if isinstance(feature_map, torch.Tensor) and feature_map.is_cuda:
        masks = _cluster_mv_device(feature_map.reshape(-1, c).to(torch.float32), n, h, w,
                                   eps, min_samples, min_cluster_size,
                                   M if exact else BUDGET, trace)
    else:
        flat = _to_numpy(feature_map).reshape(-1, c).astype(np.float32)
        masks = _cluster_mv_host(flat, n, h, w, eps, min_samples, min_cluster_size,
                                 BUDGET, exact)
    if not apply_colormap:
        return masks
    return masks, colorize_masks(masks)


def colorize_masks(masks: np.ndarray) -> np.ndarray:
    """Jet colours, consistent across views (`misc.py:151-170`); -1 is black."""
    unique = np.unique(masks)
    unique = unique[unique != -1]
    n_colors = len(unique)
    ts = (np.arange(n_colors) / (n_colors - 1) if n_colors > 1
          else np.full(max(n_colors, 1), 0.5))
    colors = (jet(ts) * 255).astype(np.uint8)
    # dense LUT over the label range; -1 (noise) renders black
    lut = np.zeros((int(unique.max()) + 2 if n_colors else 2, 3), np.uint8)
    lut[unique + 1] = colors[:n_colors]
    return lut[masks + 1]


def cluster_features_to_masks(feature_map, method: str = "dbscan", apply_colormap: bool = False,
                              n_clusters: int = 5, eps: float = 0.06, min_samples: int = 100,
                              min_cluster_size: int = 500
                              ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Per-view clustering (`misc.py:174-269`): each view's (H, W, C) features
    on their own, "dbscan" through `cluster_features_to_masks_mv` (the
    weighted HDBSCAN of one view), "kmeans" through scikit-learn's
    MiniBatchKMeans (imported in that branch only).  Masks (N, H, W) int64,
    and with ``apply_colormap`` their colours."""
    feature_map = _to_numpy(feature_map)
    n, h, w, c = feature_map.shape
    masks = np.zeros((n, h, w), np.int64)
    for i in range(n):
        if method == "kmeans":
            from sklearn.cluster import MiniBatchKMeans

            flat = feature_map[i].reshape(-1, c).astype(np.float32)
            labels = MiniBatchKMeans(n_clusters=n_clusters, n_init="auto").fit_predict(flat)
        elif method == "dbscan":
            labels = cluster_features_to_masks_mv(
                feature_map[i:i + 1], eps=eps, min_samples=min_samples,
                min_cluster_size=min_cluster_size).reshape(-1)
        else:
            raise ValueError(f"unknown method {method}")
        masks[i] = labels.reshape(h, w)
    if not apply_colormap:
        return masks
    return masks, colorize_masks(masks)
