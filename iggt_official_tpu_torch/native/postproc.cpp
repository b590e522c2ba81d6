// Native host-side post-processing kernels.
//
// The reference's single first-party native component is a CUDA
// connected-components kernel (`sam2/csrc/connected_components.cu`), and its
// clustering stage leans on cuml's GPU HDBSCAN (`iggt/utils/misc.py:19-22`).
// On TPU the irregular post-processing runs host-side; these C++ kernels are
// that host runtime: a batched two-pass union-find CCL (same label semantics
// as the XLA kernel in ops/connected_components.py: label = min linear pixel
// index of the component + 1, background 0, per-pixel areas) and a weighted
// DBSCAN over quantized feature cells (KD-tree radius search + union-find),
// matching ops/cluster.py::weighted_dbscan exactly.
//
// The PyTorch port keeps this file as a copy of the JAX package's
// native/postproc.cpp, code unchanged (the clustering tests hold the two
// packages' host paths to equal masks).  The port's native/__init__.py builds
// it with g++ at first use and loads it via ctypes — no pybind11 dependency.
// The port calls the kNN, 1-NN, MST, HDBSCAN-labelling and weighted-DBSCAN
// entry points.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <thread>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Union-find with min-root attachment (root is the smallest member index, so
// final labels are order-independent and match the XLA min-label kernel).
// ---------------------------------------------------------------------------
struct MinUnionFind {
  std::vector<int64_t> parent;
  explicit MinUnionFind(int64_t n) : parent(n) {
    std::iota(parent.begin(), parent.end(), 0);
  }
  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra;
    else parent[ra] = rb;
  }
};

// ---------------------------------------------------------------------------
// KD-tree for radius / 1-NN queries in low-dim float space (d <= 16).
// ---------------------------------------------------------------------------
struct KDTree {
  const float* pts;
  int64_t n, d;
  std::vector<int64_t> idx;     // point index per tree slot
  std::vector<int32_t> axis;    // split axis per internal node slot
  // The tree is stored implicitly over idx[lo, hi) ranges: node = median.

  KDTree(const float* pts_, int64_t n_, int64_t d_) : pts(pts_), n(n_), d(d_) {
    idx.resize(n);
    axis.assign(n, 0);
    std::iota(idx.begin(), idx.end(), 0);
    if (n) build(0, n);
  }

  void build(int64_t lo, int64_t hi) {
    if (hi - lo <= 1) return;
    // split on the widest dimension of this range
    int best_ax = 0;
    float best_spread = -1.f;
    for (int a = 0; a < d; ++a) {
      float mn = 1e30f, mx = -1e30f;
      for (int64_t i = lo; i < hi; ++i) {
        float v = pts[idx[i] * d + a];
        mn = std::min(mn, v);
        mx = std::max(mx, v);
      }
      if (mx - mn > best_spread) { best_spread = mx - mn; best_ax = a; }
    }
    int64_t mid = lo + (hi - lo) / 2;
    std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                     [&](int64_t a, int64_t b) {
                       return pts[a * d + best_ax] < pts[b * d + best_ax];
                     });
    axis[mid] = best_ax;
    build(lo, mid);
    build(mid + 1, hi);
  }

  float sqdist(int64_t i, const float* q) const {
    float s = 0.f;
    const float* p = pts + i * d;
    for (int a = 0; a < d; ++a) {
      float diff = p[a] - q[a];
      s += diff * diff;
    }
    return s;
  }

  template <typename F>
  void radius_visit(const float* q, float r2, float r, int64_t lo, int64_t hi,
                    F&& visit) const {
    if (hi <= lo) return;
    int64_t mid = lo + (hi - lo) / 2;
    int64_t pi = idx[mid];
    if (sqdist(pi, q) <= r2) visit(pi);
    if (hi - lo == 1) return;
    int a = axis[mid];
    float diff = q[a] - pts[pi * d + a];
    if (diff <= r) radius_visit(q, r2, r, lo, mid, visit);
    if (diff >= -r) radius_visit(q, r2, r, mid + 1, hi, visit);
  }

  void nearest(const float* q, int64_t lo, int64_t hi, int64_t& best,
               float& best_d2) const {
    if (hi <= lo) return;
    int64_t mid = lo + (hi - lo) / 2;
    int64_t pi = idx[mid];
    float d2 = sqdist(pi, q);
    if (d2 < best_d2 || (d2 == best_d2 && pi < best)) { best_d2 = d2; best = pi; }
    if (hi - lo == 1) return;
    int a = axis[mid];
    float diff = q[a] - pts[pi * d + a];
    int64_t first_lo = diff <= 0 ? lo : mid + 1;
    int64_t first_hi = diff <= 0 ? mid : hi;
    int64_t second_lo = diff <= 0 ? mid + 1 : lo;
    int64_t second_hi = diff <= 0 ? hi : mid;
    nearest(q, first_lo, first_hi, best, best_d2);
    if (diff * diff <= best_d2) nearest(q, second_lo, second_hi, best, best_d2);
  }
};

// Worker count for the batch query kernels: IGGT_NATIVE_THREADS, else
// hardware_concurrency (1 on the single-core bench box — identical
// behaviour there; production hosts fan the query loop out over chunks,
// each chunk keeping its own warm-start/carry-over locality).
inline int64_t native_threads() {
  if (const char* env = std::getenv("IGGT_NATIVE_THREADS")) {
    long v = std::strtol(env, nullptr, 10);
    if (v >= 1) return static_cast<int64_t>(v);
  }
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? static_cast<int64_t>(hc) : 1;
}

// Run fn(chunk_begin, chunk_end) over [0, n) on nt threads.
template <class Fn>
void parallel_chunks(int64_t n, int64_t nt, Fn fn) {
  nt = std::min<int64_t>(nt, std::max<int64_t>(n, 1));
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  const int64_t step = (n + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    if (lo >= hi) break;
    workers.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// Bucketed KD-tree for batch exact kNN (ops/cluster.py::_knn host path).
//
// Differences from KDTree above (which serves radius/1-NN queries): points
// are REORDERED into contiguous leaf buckets so the leaf scan is a linear
// pass the compiler vectorizes, and internal nodes store an explicit split
// plane. Serves the 150k x 8-D x k~64 clustering workload on one core.
// ---------------------------------------------------------------------------
struct KNNTree {
  static constexpr int64_t kLeaf = 32;
  int64_t n, d;
  std::vector<float> pts;    // reordered, contiguous (n, d)
  std::vector<int64_t> orig; // reordered slot -> original point id
  struct Node { float split; int32_t axis; };  // axis < 0: leaf
  std::vector<Node> nodes;   // heap-indexed over [lo,hi) median splits

  KNNTree(const float* src, int64_t n_, int64_t d_) : n(n_), d(d_) {
    orig.resize(n);
    std::iota(orig.begin(), orig.end(), 0);
    std::vector<int64_t> perm = orig;
    nodes.resize(64);
    build(src, perm, 0, n, 0);
    pts.resize(n * d);
    for (int64_t i = 0; i < n; ++i) {
      orig[i] = perm[i];
      std::memcpy(&pts[i * d], src + perm[i] * d, d * sizeof(float));
    }
  }

  void build(const float* src, std::vector<int64_t>& perm, int64_t lo,
             int64_t hi, int64_t node_id) {
    if (node_id >= static_cast<int64_t>(nodes.size()))
      nodes.resize(std::max<int64_t>(2 * nodes.size(), node_id + 1));
    if (hi - lo <= kLeaf) {
      nodes[node_id] = {0.f, -1};
      return;
    }
    int best_ax = 0;
    float best_spread = -1.f;
    for (int a = 0; a < d; ++a) {
      float mn = 1e30f, mx = -1e30f;
      for (int64_t i = lo; i < hi; ++i) {
        float v = src[perm[i] * d + a];
        mn = std::min(mn, v);
        mx = std::max(mx, v);
      }
      if (mx - mn > best_spread) { best_spread = mx - mn; best_ax = a; }
    }
    int64_t mid = lo + (hi - lo) / 2;
    std::nth_element(perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
                     [&](int64_t a, int64_t b) {
                       return src[a * d + best_ax] < src[b * d + best_ax];
                     });
    nodes[node_id] = {src[perm[mid] * d + best_ax],
                      static_cast<int32_t>(best_ax)};
    build(src, perm, lo, mid, 2 * node_id + 1);
    build(src, perm, mid, hi, 2 * node_id + 2);
  }

  // bounded max-heap over (d2, reordered slot); heap[0] = worst kept
  struct Cand { float d2; int64_t slot; };
  static void heap_push(Cand* h, int64_t& sz, int64_t cap, Cand c) {
    if (sz < cap) {
      h[sz++] = c;
      int64_t i = sz - 1;
      while (i > 0) {
        int64_t p = (i - 1) / 2;
        if (h[p].d2 >= h[i].d2) break;
        std::swap(h[p], h[i]);
        i = p;
      }
    } else if (c.d2 < h[0].d2) {
      h[0] = c;
      int64_t i = 0;
      for (;;) {
        int64_t l = 2 * i + 1, r = l + 1, m = i;
        if (l < cap && h[l].d2 > h[m].d2) m = l;
        if (r < cap && h[r].d2 > h[m].d2) m = r;
        if (m == i) break;
        std::swap(h[i], h[m]);
        i = m;
      }
    }
  }

  // `bound2`: admissible external prune bound on the k-th squared distance
  // (e.g. the triangle-inequality carry-over from the previous query in a
  // tree-ordered batch); +inf when absent.  Pruning against
  // min(heap-worst, bound2) never discards a true top-k point because
  // bound2 >= the true k-th distance by construction.
  void query(const float* q, int64_t k, Cand* heap, int64_t& hsz, int64_t lo,
             int64_t hi, int64_t node_id, float bound2) const {
    const Node& nd = nodes[node_id];
    if (nd.axis < 0) {
      // two-phase leaf scan: a branch-free distance pass the compiler
      // vectorizes, then heap pushes only for survivors
      float d2buf[kLeaf];
      const int64_t cnt = hi - lo;
      const float* base = &pts[lo * d];
      if (d == 8) {  // the instance-feature width; fixed trip count unrolls
        for (int64_t i = 0; i < cnt; ++i) {
          const float* p = base + i * 8;
          float s = 0.f;
          for (int a = 0; a < 8; ++a) {
            float diff = p[a] - q[a];
            s += diff * diff;
          }
          d2buf[i] = s;
        }
      } else {
        for (int64_t i = 0; i < cnt; ++i) {
          float s = 0.f;
          const float* p = base + i * d;
          for (int a = 0; a < d; ++a) {
            float diff = p[a] - q[a];
            s += diff * diff;
          }
          d2buf[i] = s;
        }
      }
      if (hsz == k) {
        const float worst = heap[0].d2;
        for (int64_t i = 0; i < cnt; ++i)
          if (d2buf[i] < worst) heap_push(heap, hsz, k, {d2buf[i], lo + i});
      } else {
        for (int64_t i = 0; i < cnt; ++i)
          heap_push(heap, hsz, k, {d2buf[i], lo + i});
      }
      return;
    }
    int64_t mid = lo + (hi - lo) / 2;
    float diff = q[nd.axis] - nd.split;
    bool left_first = diff < 0;
    int64_t near_lo = left_first ? lo : mid, near_hi = left_first ? mid : hi;
    int64_t far_lo = left_first ? mid : lo, far_hi = left_first ? hi : mid;
    int64_t near_id = left_first ? 2 * node_id + 1 : 2 * node_id + 2;
    int64_t far_id = left_first ? 2 * node_id + 2 : 2 * node_id + 1;
    query(q, k, heap, hsz, near_lo, near_hi, near_id, bound2);
    float eff = hsz == k ? std::min(heap[0].d2, bound2) : bound2;
    if (diff * diff <= eff)
      query(q, k, heap, hsz, far_lo, far_hi, far_id, bound2);
  }

  // Dedicated 1-NN walk with the same smallest-ORIGINAL-index tie-break as
  // KDTree::nearest, so nn1 and nn1_tree agree bit-for-bit on duplicate /
  // equidistant reference points (the label backfill dispatches between
  // them on batch size).  Prunes with <= so equidistant far subtrees stay
  // reachable; heap-free, so also slightly cheaper than query(k=1).
  void query1(const float* q, Cand& best, int64_t lo, int64_t hi,
              int64_t node_id) const {
    const Node& nd = nodes[node_id];
    if (nd.axis < 0) {
      const int64_t cnt = hi - lo;
      const float* base = &pts[lo * d];
      for (int64_t i = 0; i < cnt; ++i) {
        float s = 0.f;
        const float* p = base + i * d;
        for (int a = 0; a < d; ++a) {
          float diff = p[a] - q[a];
          s += diff * diff;
        }
        const int64_t slot = lo + i;
        if (s < best.d2 ||
            (s == best.d2 && best.slot >= 0 && orig[slot] < orig[best.slot]))
          best = {s, slot};
      }
      return;
    }
    int64_t mid = lo + (hi - lo) / 2;
    float diff = q[nd.axis] - nd.split;
    bool left_first = diff < 0;
    int64_t near_lo = left_first ? lo : mid, near_hi = left_first ? mid : hi;
    int64_t far_lo = left_first ? mid : lo, far_hi = left_first ? hi : mid;
    int64_t near_id = left_first ? 2 * node_id + 1 : 2 * node_id + 2;
    int64_t far_id = left_first ? 2 * node_id + 2 : 2 * node_id + 1;
    query1(q, best, near_lo, near_hi, near_id);
    if (diff * diff <= best.d2)
      query1(q, best, far_lo, far_hi, far_id);
  }
};

}  // namespace

extern "C" {

#define EXPORT __attribute__((visibility("default")))

// Batched 8-connectivity connected components over uint8 masks.
// labels: (b, h, w) int32, min-linear-index + 1 inside mask, 0 outside.
// areas:  (b, h, w) int32, component pixel count, 0 outside.
EXPORT void ccl2d(const uint8_t* mask, int64_t b, int64_t h, int64_t w,
           int32_t* labels, int32_t* areas) {
  const int64_t hw = h * w;
  std::vector<int32_t> count;
  for (int64_t img = 0; img < b; ++img) {
    const uint8_t* m = mask + img * hw;
    int32_t* lab = labels + img * hw;
    int32_t* area = areas + img * hw;
    MinUnionFind uf(hw);
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        int64_t p = y * w + x;
        if (!m[p]) continue;
        // union with already-visited 8-neighbours: W, NW, N, NE
        if (x > 0 && m[p - 1]) uf.unite(p, p - 1);
        if (y > 0) {
          int64_t up = p - w;
          if (x > 0 && m[up - 1]) uf.unite(p, up - 1);
          if (m[up]) uf.unite(p, up);
          if (x + 1 < w && m[up + 1]) uf.unite(p, up + 1);
        }
      }
    }
    count.assign(hw, 0);
    for (int64_t p = 0; p < hw; ++p)
      if (m[p]) ++count[uf.find(p)];
    for (int64_t p = 0; p < hw; ++p) {
      if (m[p]) {
        int64_t r = uf.find(p);
        lab[p] = static_cast<int32_t>(r + 1);
        area[p] = count[r];
      } else {
        lab[p] = 0;
        area[p] = 0;
      }
    }
  }
}

// Weighted DBSCAN over (n, d) float32 points with int64 weights.
// Semantics identical to ops/cluster.py::weighted_dbscan:
//  - core iff sum of weights within eps (incl. self) >= min_samples,
//  - core points within eps union; cluster ids enumerate core-point roots
//    in ascending point order,
//  - non-core points take the label of their nearest core point if within
//    eps, else -1 (noise).
EXPORT void wdbscan(const float* pts, const int64_t* weights, int64_t n, int64_t d,
             float eps, int64_t min_samples, int64_t* labels) {
  if (n == 0) return;
  KDTree tree(pts, n, d);
  const float r2 = eps * eps;

  std::vector<uint8_t> core(n, 0);
  std::vector<std::vector<int64_t>> neigh(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t mass = 0;
    auto& lst = neigh[i];
    tree.radius_visit(pts + i * d, r2, eps, 0, n, [&](int64_t j) {
      mass += weights[j];
      lst.push_back(j);
    });
    core[i] = mass >= min_samples;
  }

  MinUnionFind uf(n);
  for (int64_t i = 0; i < n; ++i) {
    if (!core[i]) continue;
    for (int64_t j : neigh[i])
      if (core[j]) uf.unite(i, j);
  }

  std::fill(labels, labels + n, int64_t(-1));
  std::vector<int64_t> root_label(n, -1);
  int64_t next = 0;
  std::vector<int64_t> core_idx;
  for (int64_t i = 0; i < n; ++i) {
    if (!core[i]) continue;
    int64_t r = uf.find(i);
    if (root_label[r] < 0) root_label[r] = next++;
    labels[i] = root_label[r];
    core_idx.push_back(i);
  }
  if (core_idx.empty()) return;

  // border points -> nearest core point within eps
  std::vector<float> core_pts(core_idx.size() * d);
  for (size_t k = 0; k < core_idx.size(); ++k)
    std::memcpy(&core_pts[k * d], pts + core_idx[k] * d, d * sizeof(float));
  KDTree core_tree(core_pts.data(), static_cast<int64_t>(core_idx.size()), d);
  for (int64_t i = 0; i < n; ++i) {
    if (core[i]) continue;
    int64_t best = -1;
    float best_d2 = 1e30f;
    core_tree.nearest(pts + i * d, 0, core_tree.n, best, best_d2);
    if (best >= 0 && best_d2 <= r2) labels[i] = labels[core_idx[best]];
  }
}

// 1-NN reassignment: for every query, the index of its nearest reference
// point (used for noise -> clustered-cell reassignment and cell folding).
EXPORT void nn1(const float* ref, int64_t n_ref, const float* query, int64_t n_query,
         int64_t d, int64_t* out_idx) {
  if (n_ref == 0) return;
  KDTree tree(ref, n_ref, d);
  for (int64_t i = 0; i < n_query; ++i) {
    int64_t best = -1;
    float best_d2 = 1e30f;
    tree.nearest(query + i * d, 0, n_ref, best, best_d2);
    out_idx[i] = best;
  }
}

// ---------------------------------------------------------------------------
// Weighted-HDBSCAN labelling from a precomputed mutual-reachability MST.
//
// Op-for-op port of ops/cluster.py::{_weighted_single_linkage (dendrogram
// half), weighted_hdbscan (condensed tree + stability + excess-of-mass +
// Malzer-Baum epsilon + labels)} — the Python path is the tested spec and
// stays as the fallback; this kernel removes its ~20 s of interpreter time
// at the demo-scale 150k-sample workload.  Tie behaviour matches because
// both sides stable-sort edges in identical input order.
//
// Inputs: MST edges (a, b, d) in scipy tocoo() order, per-point weights and
// core distances, eps / min_cluster_size / allow_single_cluster.
// Output: labels (K,) int64, -1 = noise.
EXPORT void hdbscan_mst_labels(
    const int64_t* edge_a, const int64_t* edge_b, const double* edge_d,
    int64_t n_edges, const double* weights, const double* core, int64_t K,
    double eps, double min_cluster_size, int32_t allow_single_cluster,
    int64_t* labels) {
  const double INF = std::numeric_limits<double>::infinity();
  struct Edge { double d; int64_t a, b; };
  std::vector<Edge> edges;
  edges.reserve(n_edges + 16);
  for (int64_t i = 0; i < n_edges; ++i)
    edges.push_back({edge_d[i], edge_a[i], edge_b[i]});

  // join disconnected components at +inf (first-arg-wins union-find, reps
  // ascending, all joined to the smallest rep — cluster.py:211-217)
  {
    // cluster.py's _UnionFind attaches rb under ra (first-arg-wins);
    // replicate that exactly with a plain parent array:
    std::vector<int64_t> parent(K);
    std::iota(parent.begin(), parent.end(), 0);
    auto find = [&](int64_t x) {
      int64_t root = x;
      while (parent[root] != root) root = parent[root];
      while (parent[x] != root) { int64_t nx = parent[x]; parent[x] = root; x = nx; }
      return root;
    };
    for (const auto& e : edges) {
      int64_t ra = find(e.a), rb = find(e.b);
      if (ra != rb) parent[rb] = ra;
    }
    std::vector<int64_t> reps;
    for (int64_t i = 0; i < K; ++i) if (find(i) == i) reps.push_back(i);
    std::sort(reps.begin(), reps.end());
    for (size_t i = 1; i < reps.size(); ++i)
      edges.push_back({INF, reps[0], reps[i]});
  }
  std::stable_sort(edges.begin(), edges.end(),
                   [](const Edge& x, const Edge& y) { return x.d < y.d; });

  // --- single-linkage dendrogram (cluster.py:219-235) ----------------
  const int64_t n_nodes = 2 * K - 1;
  std::vector<int64_t> left(K - 1), right(K - 1);
  std::vector<double> zdist(K - 1);
  std::vector<double> wsize(n_nodes);
  for (int64_t i = 0; i < K; ++i) wsize[i] = weights[i];
  {
    std::vector<int64_t> parent(n_nodes);
    std::iota(parent.begin(), parent.end(), 0);
    auto find = [&](int64_t x) {
      int64_t root = x;
      while (parent[root] != root) root = parent[root];
      while (parent[x] != root) { int64_t nx = parent[x]; parent[x] = root; x = nx; }
      return root;
    };
    std::vector<int64_t> comp_node(K);
    std::iota(comp_node.begin(), comp_node.end(), 0);
    int64_t nxt = K;
    for (const auto& e : edges) {
      int64_t ra = find(e.a), rb = find(e.b);
      if (ra == rb) continue;
      int64_t na = comp_node[ra], nb = comp_node[rb];
      left[nxt - K] = na;
      right[nxt - K] = nb;
      zdist[nxt - K] = e.d;
      wsize[nxt] = wsize[na] + wsize[nb];
      parent[rb] = ra;  // first-arg-wins, matching _UnionFind.union
      comp_node[find(ra)] = nxt;
      ++nxt;
    }
    if (nxt != n_nodes) {  // should be unreachable (inf edges span all)
      for (int64_t i = 0; i < K; ++i) labels[i] = -1;
      return;
    }
  }

  auto lam = [&](double d) {
    if (d <= 0) return INF;
    if (!std::isfinite(d)) return 0.0;
    return 1.0 / d;
  };

  // --- condensed tree (cluster.py:289-346), traversal order mirrored --
  std::vector<int64_t> parent_c{-1};
  std::vector<double> lam_birth{0.0};
  std::vector<int64_t> fall_point, fall_cluster;
  std::vector<double> fall_lam;
  fall_point.reserve(K);
  fall_cluster.reserve(K);
  fall_lam.reserve(K);
  std::vector<std::pair<int64_t, int64_t>> stack{{n_nodes - 1, 0}};
  std::vector<int64_t> sub;
  auto spill = [&](int64_t start, int64_t cl, double ld) {
    sub.clear();
    sub.push_back(start);
    while (!sub.empty()) {
      int64_t s = sub.back();
      sub.pop_back();
      if (s < K) {
        fall_point.push_back(s);
        fall_cluster.push_back(cl);
        fall_lam.push_back(ld);
      } else {
        sub.push_back(left[s - K]);
        sub.push_back(right[s - K]);
      }
    }
  };
  while (!stack.empty()) {
    auto [node, cl] = stack.back();
    stack.pop_back();
    if (node < K) {
      fall_point.push_back(node);
      fall_cluster.push_back(cl);
      fall_lam.push_back(lam(std::max(core[node], 0.0)));
      continue;
    }
    int64_t i = node - K;
    int64_t l = left[i], r = right[i];
    double ld = lam(zdist[i]);
    bool big_l = wsize[l] >= min_cluster_size;
    bool big_r = wsize[r] >= min_cluster_size;
    if (big_l && big_r) {
      int64_t cl_l = static_cast<int64_t>(parent_c.size());
      parent_c.push_back(cl);
      lam_birth.push_back(ld);
      int64_t cl_r = static_cast<int64_t>(parent_c.size());
      parent_c.push_back(cl);
      lam_birth.push_back(ld);
      stack.push_back({l, cl_l});
      stack.push_back({r, cl_r});
    } else if (big_l || big_r) {
      int64_t big = big_l ? l : r;
      int64_t small = big_l ? r : l;
      spill(small, cl, ld);
      stack.push_back({big, cl});
    } else {
      // both small: cluster.py:335-345 spills l then r through one stack
      sub.clear();
      sub.push_back(l);
      sub.push_back(r);
      while (!sub.empty()) {
        int64_t s = sub.back();
        sub.pop_back();
        if (s < K) {
          fall_point.push_back(s);
          fall_cluster.push_back(cl);
          fall_lam.push_back(ld);
        } else {
          sub.push_back(left[s - K]);
          sub.push_back(right[s - K]);
        }
      }
    }
  }
  const int64_t n_cl = static_cast<int64_t>(parent_c.size());

  // --- stability (cluster.py:353-371) --------------------------------
  double finite_max = 1.0;
  bool any_finite = false;
  for (double f : fall_lam)
    if (std::isfinite(f)) {
      finite_max = any_finite ? std::max(finite_max, f) : f;
      any_finite = true;
    }
  std::vector<double> stab(n_cl, 0.0), child_mass(n_cl, 0.0);
  for (size_t j = 0; j < fall_point.size(); ++j) {
    double w = weights[fall_point[j]];
    double fl = std::isfinite(fall_lam[j]) ? fall_lam[j] : finite_max;
    stab[fall_cluster[j]] += w * (fl - lam_birth[fall_cluster[j]]);
    child_mass[fall_cluster[j]] += w;
  }
  std::vector<double> total_mass = child_mass;
  for (int64_t c = n_cl - 1; c >= 1; --c) total_mass[parent_c[c]] += total_mass[c];
  for (int64_t c = 1; c < n_cl; ++c) {
    int64_t p = parent_c[c];
    stab[p] += total_mass[c] * (lam_birth[c] - lam_birth[p]);
  }

  // --- excess-of-mass selection (cluster.py:374-398) -----------------
  std::vector<std::vector<int64_t>> children(n_cl);
  for (int64_t c = 1; c < n_cl; ++c) children[parent_c[c]].push_back(c);
  std::vector<uint8_t> selected(n_cl, 0);
  std::vector<double> subtree_stab(n_cl, 0.0);
  for (int64_t c = n_cl - 1; c >= 0; --c) {
    if (children[c].empty()) {
      selected[c] = 1;
      subtree_stab[c] = stab[c];
      continue;
    }
    double child_sum = 0.0;
    for (int64_t ch : children[c]) child_sum += subtree_stab[ch];
    if (stab[c] > child_sum && (c != 0 || allow_single_cluster)) {
      selected[c] = 1;
      sub.assign(children[c].begin(), children[c].end());
      while (!sub.empty()) {
        int64_t s = sub.back();
        sub.pop_back();
        selected[s] = 0;
        sub.insert(sub.end(), children[s].begin(), children[s].end());
      }
      subtree_stab[c] = stab[c];
    } else {
      subtree_stab[c] = child_sum;
    }
  }
  if (!allow_single_cluster) selected[0] = 0;

  // --- cluster_selection_epsilon, Malzer-Baum (cluster.py:401-429) ----
  if (eps > 0) {
    std::vector<int64_t> snapshot;
    for (int64_t c = 0; c < n_cl; ++c) if (selected[c]) snapshot.push_back(c);
    for (int64_t c : snapshot) {
      double birth_dist = lam_birth[c] == 0 ? INF : 1.0 / lam_birth[c];
      if (birth_dist >= eps) continue;
      int64_t anc = c;
      while (anc != 0) {
        int64_t p = parent_c[anc];
        double p_birth = lam_birth[p] == 0 ? INF : 1.0 / lam_birth[p];
        anc = p;
        if (p_birth >= eps) break;
      }
      if (anc == 0 && !allow_single_cluster) {
        anc = c;
        while (parent_c[anc] != 0) anc = parent_c[anc];
      }
      selected[c] = 0;
      selected[anc] = 1;
    }
    snapshot.clear();
    for (int64_t c = 0; c < n_cl; ++c) if (selected[c]) snapshot.push_back(c);
    for (int64_t c : snapshot) {
      sub.assign(children[c].begin(), children[c].end());
      while (!sub.empty()) {
        int64_t s = sub.back();
        sub.pop_back();
        if (selected[s]) selected[s] = 0;
        sub.insert(sub.end(), children[s].begin(), children[s].end());
      }
    }
  }

  // --- labels (cluster.py:432-449) -----------------------------------
  std::vector<int64_t> sel_anc(n_cl, -1);
  for (int64_t c = 0; c < n_cl; ++c) {
    if (selected[c]) sel_anc[c] = c;
    else if (parent_c[c] >= 0) sel_anc[c] = sel_anc[parent_c[c]];
  }
  for (int64_t i = 0; i < K; ++i) labels[i] = -1;
  for (size_t j = 0; j < fall_point.size(); ++j)
    labels[fall_point[j]] = sel_anc[fall_cluster[j]];
  std::vector<uint8_t> used(n_cl, 0);
  for (int64_t i = 0; i < K; ++i)
    if (labels[i] >= 0) used[labels[i]] = 1;
  std::vector<int64_t> remap(n_cl, -1);
  int64_t next_label = 0;
  // kept ids ascending == np.unique order
  for (int64_t c = 0; c < n_cl; ++c)
    if (used[c]) remap[c] = next_label++;
  for (int64_t i = 0; i < K; ++i)
    if (labels[i] >= 0) labels[i] = remap[labels[i]];
}

}  // extern "C"

namespace {

// ---------------------------------------------------------------------------
// Minimum spanning forest of a sparse undirected graph (Boruvka with
// per-round edge compaction).
//
// Replaces scipy.sparse.csgraph.minimum_spanning_tree in
// ops/cluster.py::_mreach_mst: the mutual-reachability kNN graph at the
// 150k-sample clustering scale (~15M edges) costs ~6 s through scipy
// (COO->CSR symmetrization + Prim) and runs here in <1 s single-threaded.
// Ties are broken by original edge index (a total order, which keeps
// Boruvka cycle-free and the result deterministic).  Returns the number of
// forest edges written (K-1 when the graph is connected); `orig(eid, a, b)`
// recovers the ORIGINAL endpoint ids of an edge; edges are emitted in
// per-round discovery order, which the labelling stage re-sorts anyway.
template <class OrigFn>
int64_t boruvka_forest(std::vector<int64_t>& ea, std::vector<int64_t>& eb,
                       std::vector<double>& ew, std::vector<int64_t>& eid,
                       int64_t K, OrigFn orig, int64_t* out_a,
                       int64_t* out_b, double* out_d) {
  std::vector<int64_t> parent(K);
  std::iota(parent.begin(), parent.end(), 0);
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };

  // Threaded rounds (exact-mode graphs reach ~170M edges at 1.69M px):
  // the min-edge scan runs over edge chunks with per-thread best tables
  // merged serially, and the compaction relabels against a read-only
  // root[] snapshot (union-find is only mutated between the parallel
  // phases, so no thread ever races find()'s path halving).
  const int64_t m0 = static_cast<int64_t>(ea.size());
  const int64_t nt =
      std::min<int64_t>(native_threads(), std::max<int64_t>(m0 / 262144, 1));

  std::vector<std::vector<int64_t>> best_t(nt), touched_t(nt);
  for (int64_t t = 0; t < nt; ++t) best_t[t].assign(K, -1);
  std::vector<int64_t> best(K, -1);
  std::vector<int64_t> touched;
  touched.reserve(K);
  std::vector<int64_t> root(K);
  std::vector<int64_t> chunk_lo(nt + 1), chunk_cnt(nt);

  int64_t n_out = 0;
  int64_t m = m0;
  while (m > 0) {
    // min outgoing edge per component (lexicographic (w, original index));
    // endpoints are previous-round roots, so no find() here
    const int64_t step = (m + nt - 1) / nt;
    for (int64_t t = 0; t <= nt; ++t)
      chunk_lo[t] = std::min(m, t * step);
    parallel_chunks(nt, nt, [&](int64_t t_lo, int64_t t_hi) {
      for (int64_t t = t_lo; t < t_hi; ++t) {
        auto& bt = best_t[t];
        auto& tt = touched_t[t];
        tt.clear();
        for (int64_t i = chunk_lo[t]; i < chunk_lo[t + 1]; ++i) {
          for (int64_t r : {ea[i], eb[i]}) {
            int64_t& b = bt[r];
            if (b < 0) {
              b = i;
              tt.push_back(r);
            } else if (ew[i] < ew[b] || (ew[i] == ew[b] && eid[i] < eid[b])) {
              b = i;
            }
          }
        }
      }
    });
    touched.clear();
    for (int64_t t = 0; t < nt; ++t) {
      for (int64_t r : touched_t[t]) {
        int64_t i = best_t[t][r];
        best_t[t][r] = -1;  // reset for the next round
        int64_t& b = best[r];
        if (b < 0) {
          b = i;
          touched.push_back(r);
        } else if (ew[i] < ew[b] || (ew[i] == ew[b] && eid[i] < eid[b])) {
          b = i;
        }
      }
    }
    if (touched.empty()) break;
    for (int64_t r : touched) {
      int64_t e = best[r];
      int64_t ra = find(ea[e]), rb = find(eb[e]);
      if (ra == rb) continue;  // the twin component already merged via e
      parent[rb] = ra;
      orig(eid[e], &out_a[n_out], &out_b[n_out]);
      out_d[n_out] = ew[e];
      ++n_out;
    }
    for (int64_t r : touched) best[r] = -1;
    // compact to inter-component edges, endpoints relabelled to roots:
    // snapshot roots serially (O(K), trivial next to the edge pass), then
    // each thread compacts its own chunk in place; coalesce serially
    for (int64_t i = 0; i < K; ++i) root[i] = find(i);
    parallel_chunks(nt, nt, [&](int64_t t_lo, int64_t t_hi) {
      for (int64_t t = t_lo; t < t_hi; ++t) {
        int64_t w = chunk_lo[t];
        for (int64_t i = chunk_lo[t]; i < chunk_lo[t + 1]; ++i) {
          int64_t ra = root[ea[i]], rb = root[eb[i]];
          if (ra == rb) continue;
          ea[w] = ra;
          eb[w] = rb;
          ew[w] = ew[i];
          eid[w] = eid[i];
          ++w;
        }
        chunk_cnt[t] = w - chunk_lo[t];
      }
    });
    int64_t nm = chunk_cnt[0];
    for (int64_t t = 1; t < nt; ++t) {
      const int64_t lo = chunk_lo[t], cnt = chunk_cnt[t];
      if (nm != lo && cnt > 0) {
        std::memmove(&ea[nm], &ea[lo], cnt * sizeof(int64_t));
        std::memmove(&eb[nm], &eb[lo], cnt * sizeof(int64_t));
        std::memmove(&ew[nm], &ew[lo], cnt * sizeof(double));
        std::memmove(&eid[nm], &eid[lo], cnt * sizeof(int64_t));
      }
      nm += cnt;
    }
    m = nm;
  }
  return n_out;
}

}  // namespace

extern "C" {

// Exact k-nearest-neighbours of every point among `points` (self included,
// like sklearn kneighbors on the fitted set). Rows sorted ascending by
// (distance, original index). Serves ops/cluster.py::_knn on hosts without
// an accelerator (and as the small-input path everywhere).
EXPORT void knn_query(
    const float* points, int64_t n, int64_t d, int64_t k,
    float* out_dist, int64_t* out_idx) {
  const float INF = std::numeric_limits<float>::infinity();
  KNNTree tree(points, n, d);
  // visit queries in TREE order: consecutive queries are spatial
  // neighbours, so the triangle inequality d_k(q') <= d_k(q) + |q - q'|
  // yields a tight admissible prune bound before any node is visited.
  // Each thread owns a contiguous slot chunk (locality preserved within).
  parallel_chunks(n, native_threads(), [&](int64_t c_lo, int64_t c_hi) {
    std::vector<KNNTree::Cand> heap(k);
    std::vector<std::pair<float, int64_t>> row(k);
    float prev_dk = INF;
    const float* prev_q = nullptr;
    for (int64_t slot = c_lo; slot < c_hi; ++slot) {
      const float* qp = &tree.pts[slot * d];
      float bound2 = INF;
      if (prev_q && prev_dk < INF) {
        float s = 0.f;
        for (int a = 0; a < d; ++a) {
          float diff = qp[a] - prev_q[a];
          s += diff * diff;
        }
        float b = prev_dk + std::sqrt(s);
        // small relative slack: the f32 sum/sqrt/square chain can round
        // the carried bound one ulp below the true k-th distance and
        // prune the subtree holding it, breaking the exact contract
        bound2 = b * b * 1.00001f;
      }
      int64_t hsz = 0;
      tree.query(qp, k, heap.data(), hsz, 0, tree.n, 0, bound2);
      for (int64_t i = 0; i < hsz; ++i)
        row[i] = {heap[i].d2, tree.orig[heap[i].slot]};
      std::sort(row.begin(), row.begin() + hsz);
      const int64_t q = tree.orig[slot];
      for (int64_t i = 0; i < hsz; ++i) {
        out_dist[q * k + i] = std::sqrt(row[i].first);
        out_idx[q * k + i] = row[i].second;
      }
      for (int64_t i = hsz; i < k; ++i) {  // k > n padding (callers clamp)
        out_dist[q * k + i] = INF;
        out_idx[q * k + i] = q;
      }
      prev_dk = hsz == k ? std::sqrt(heap[0].d2) : INF;
      prev_q = qp;
    }
  });
}

// Batched 1-NN of `query` points among `ref` points through the bucketed
// tree (replaces the per-point KDTree::nearest path of nn1 for large
// batches — the ops/cluster.py::_nn1 backfill runs 1.5M queries at demo
// scale). Ties resolve to the smallest original ref index like nn1.
EXPORT void nn1_tree(
    const float* ref, int64_t n_ref, const float* query, int64_t n_query,
    int64_t d, int64_t* out_idx) {
  KNNTree tree(ref, n_ref, d);
  parallel_chunks(n_query, native_threads(), [&](int64_t c_lo, int64_t c_hi) {
    int64_t prev_slot = -1;
    for (int64_t q = c_lo; q < c_hi; ++q) {
      const float* qp = query + q * d;
      KNNTree::Cand best{std::numeric_limits<float>::infinity(), -1};
      if (prev_slot >= 0) {
        // warm start: consecutive queries are neighbouring pixels, so the
        // previous answer is a near-optimal prune bound immediately; the
        // tie-break in query1 still replaces it by a smaller original
        // index at equal distance
        float s = 0.f;
        const float* p = &tree.pts[prev_slot * d];
        for (int a = 0; a < d; ++a) {
          float diff = p[a] - qp[a];
          s += diff * diff;
        }
        best = {s, prev_slot};
      }
      tree.query1(qp, best, 0, tree.n, 0);
      prev_slot = best.slot;
      out_idx[q] = best.slot >= 0 ? tree.orig[best.slot] : 0;
    }
  });
}

EXPORT int64_t mst_from_edges(
    const int64_t* src, const int64_t* dst, const double* w, int64_t n_edges,
    int64_t K, int64_t* out_a, int64_t* out_b, double* out_d) {
  std::vector<int64_t> ea(src, src + n_edges), eb(dst, dst + n_edges);
  std::vector<double> ew(w, w + n_edges);
  std::vector<int64_t> eid(n_edges);
  std::iota(eid.begin(), eid.end(), 0);
  return boruvka_forest(
      ea, eb, ew, eid, K,
      [&](int64_t e, int64_t* a, int64_t* b) { *a = src[e]; *b = dst[e]; },
      out_a, out_b, out_d);
}

// Mutual-reachability MST straight from the (K, k) kNN arrays — fuses the
// edge construction (mreach = max(d, core[src], core[dst]), drop self/inf)
// that costs ~5 s of numpy temporaries at 15M edges into the same pass.
EXPORT int64_t mst_knn(
    const double* knn_dist, const int64_t* knn_idx, const double* core,
    int64_t K, int64_t k, int64_t* out_a, int64_t* out_b, double* out_d) {
  const int64_t n = K * k;
  std::vector<int64_t> ea, eb, eid;
  std::vector<double> ew;
  // threaded edge construction: rows are independent; per-thread chunks
  // write into disjoint slices after a counting pass (exact-mode graphs
  // reach ~170M candidate edges at 1.69M px)
  const int64_t nt =
      std::min<int64_t>(native_threads(), std::max<int64_t>(K / 65536, 1));
  const int64_t step = (K + nt - 1) / nt;
  std::vector<int64_t> cnt(nt, 0);
  auto row_edges = [&](int64_t i, auto&& emit) {
    const double ci = core[i];
    for (int64_t j = 0; j < k; ++j) {
      const int64_t dst = knn_idx[i * k + j];
      if (dst == i) continue;
      double w = knn_dist[i * k + j];
      if (w < ci) w = ci;
      const double cd = core[dst];
      if (w < cd) w = cd;
      if (!std::isfinite(w)) continue;
      emit(i, dst, w, i * k + j);
    }
  };
  parallel_chunks(nt, nt, [&](int64_t t_lo, int64_t t_hi) {
    for (int64_t t = t_lo; t < t_hi; ++t) {
      int64_t c = 0;
      const int64_t hi = std::min(K, (t + 1) * step);
      for (int64_t i = t * step; i < hi; ++i)
        row_edges(i, [&](int64_t, int64_t, double, int64_t) { ++c; });
      cnt[t] = c;
    }
  });
  std::vector<int64_t> off(nt + 1, 0);
  for (int64_t t = 0; t < nt; ++t) off[t + 1] = off[t] + cnt[t];
  ea.resize(off[nt]);
  eb.resize(off[nt]);
  ew.resize(off[nt]);
  eid.resize(off[nt]);
  parallel_chunks(nt, nt, [&](int64_t t_lo, int64_t t_hi) {
    for (int64_t t = t_lo; t < t_hi; ++t) {
      int64_t w_at = off[t];
      const int64_t hi = std::min(K, (t + 1) * step);
      for (int64_t i = t * step; i < hi; ++i)
        row_edges(i, [&](int64_t a, int64_t b, double w, int64_t e) {
          ea[w_at] = a;
          eb[w_at] = b;
          ew[w_at] = w;
          eid[w_at] = e;
          ++w_at;
        });
    }
  });
  return boruvka_forest(
      ea, eb, ew, eid, K,
      [&](int64_t e, int64_t* a, int64_t* b) {
        *a = e / k;
        *b = knn_idx[e];
      },
      out_a, out_b, out_d);
}

// ---------------------------------------------------------------------------
// Reusable kNN tree handle: build once over a large reference set, run many
// query batches against it.  Serves the clustering refinement
// (ops/cluster.py::_boundary_merge_full_density), whose per-cluster-pair
// queries hit the SAME full-resolution reference (~1.7M points at demo
// scale) with data-dependent query counts — on the remote-compile XLA
// backend every distinct query shape is a fresh multi-minute compile, so
// the refinement routes here instead: zero device programs, one tree build
// amortized across every pair (round-4 postmortem, VERDICT r4 task 2).

EXPORT void* knn_tree_build(const float* ref, int64_t n, int64_t d) {
  if (n <= 0) return nullptr;
  return new KNNTree(ref, n, d);
}

EXPORT void knn_tree_free(void* handle) {
  delete static_cast<KNNTree*>(handle);
}

// k nearest reference rows per query row, rows sorted ascending by
// (distance, original ref index) — same contract as knn_query but vs an
// external query set.  Consecutive queries warm-start each other's prune
// bound via the triangle inequality (refinement queries arrive in pixel
// order, i.e. spatially coherent).
EXPORT void knn_tree_query(
    void* handle, const float* query, int64_t n_query, int64_t k,
    float* out_dist, int64_t* out_idx) {
  const float INF = std::numeric_limits<float>::infinity();
  const KNNTree& tree = *static_cast<KNNTree*>(handle);
  const int64_t d = tree.d;
  const int64_t kk = std::min<int64_t>(k, tree.n);
  parallel_chunks(n_query, native_threads(), [&](int64_t c_lo, int64_t c_hi) {
    std::vector<KNNTree::Cand> heap(kk);
    std::vector<std::pair<float, int64_t>> row(kk);
    float prev_dk = INF;
    const float* prev_q = nullptr;
    for (int64_t q = c_lo; q < c_hi; ++q) {
      const float* qp = query + q * d;
      float bound2 = INF;
      if (prev_q && prev_dk < INF) {
        float s = 0.f;
        for (int64_t a = 0; a < d; ++a) {
          float diff = qp[a] - prev_q[a];
          s += diff * diff;
        }
        float b = prev_dk + std::sqrt(s);
        // relative slack against f32 rounding of the carried bound (see
        // knn_query) — pruning must stay admissible for the exact
        // contract the refinement's core distances rely on
        bound2 = b * b * 1.00001f;
      }
      int64_t hsz = 0;
      tree.query(qp, kk, heap.data(), hsz, 0, tree.n, 0, bound2);
      for (int64_t i = 0; i < hsz; ++i)
        row[i] = {heap[i].d2, tree.orig[heap[i].slot]};
      std::sort(row.begin(), row.begin() + hsz);
      for (int64_t i = 0; i < hsz; ++i) {
        out_dist[q * k + i] = std::sqrt(row[i].first);
        out_idx[q * k + i] = row[i].second;
      }
      for (int64_t i = hsz; i < k; ++i) {  // k > n_ref padding
        out_dist[q * k + i] = INF;
        out_idx[q * k + i] = hsz ? row[0].second : 0;
      }
      prev_dk = hsz == kk ? std::sqrt(heap[0].d2) : INF;
      prev_q = qp;
    }
  });
}

}  // extern "C"
