"""Native host library of the clustering pipeline: C++ through ctypes.

`postproc.cpp` is a copy of the JAX package's `native/postproc.cpp`
(KD-tree kNN, reusable kNN tree, 1-NN, Boruvka MST over kNN graphs, the
weighted-HDBSCAN labelling).  It is compiled with g++ at first use into
`iggt_official_tpu_torch/build/`, keyed by a hash of the source AND of the
host CPU: the build uses ``-march=native``, so a library built on one
machine must never be loaded on another whose CPU lacks its instructions.

There is no fallback.  A missing compiler or a failed build raises
`NativeBuildError`; the port's clustering always runs this library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "postproc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
         "-fvisibility=hidden")


class NativeBuildError(RuntimeError):
    """The native host library could not be built or loaded."""


def _cpu_key() -> str:
    """The host CPU's model name and instruction-set flags."""
    info = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    info += line
                if line.strip() == "":      # first processor only
                    break
    except OSError:
        info += platform.processor()
    return info


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_key().encode())
    return BUILD_DIR / f"postproc_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile `postproc.cpp` unless a library of this source, these flags
    and this CPU exists.  Returns (library path, compiler output)."""
    so = library_path()
    if so.exists():
        return so, ""
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: the port's native host library "
            f"({SOURCE.name}) is compiled at first use and has no fallback")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed for {SOURCE.name}:\n{out}")
    os.replace(tmp, so)
    return so, out


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, with its signatures set."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    i64 = ctypes.c_int64
    f32 = ctypes.POINTER(ctypes.c_float)
    f64 = ctypes.POINTER(ctypes.c_double)
    pi64 = ctypes.POINTER(i64)
    lib.hdbscan_mst_labels.argtypes = [
        pi64, pi64, f64, i64, f64, f64, i64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, pi64]
    lib.hdbscan_mst_labels.restype = None
    lib.mst_knn.argtypes = [f64, pi64, f64, i64, i64, pi64, pi64, f64]
    lib.mst_knn.restype = i64
    lib.knn_query.argtypes = [f32, i64, i64, i64, f32, pi64]
    lib.knn_query.restype = None
    lib.nn1.argtypes = [f32, i64, f32, i64, i64, pi64]
    lib.nn1.restype = None
    lib.nn1_tree.argtypes = [f32, i64, f32, i64, i64, pi64]
    lib.nn1_tree.restype = None
    lib.knn_tree_build.argtypes = [f32, i64, i64]
    lib.knn_tree_build.restype = ctypes.c_void_p
    lib.knn_tree_free.argtypes = [ctypes.c_void_p]
    lib.knn_tree_free.restype = None
    lib.knn_tree_query.argtypes = [ctypes.c_void_p, f32, i64, i64, f32, pi64]
    lib.knn_tree_query.restype = None
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def hdbscan_mst_labels(edge_a, edge_b, edge_d, weights, core, eps: float,
                       min_cluster_size: float,
                       allow_single_cluster: bool = False) -> np.ndarray:
    """Weighted-HDBSCAN labels (K,) from mutual-reachability MST edges:
    dendrogram, condensed tree, excess-of-mass and epsilon selection."""
    lib = load()
    edge_a = np.ascontiguousarray(edge_a, np.int64)
    edge_b = np.ascontiguousarray(edge_b, np.int64)
    edge_d = np.ascontiguousarray(edge_d, np.float64)
    weights = np.ascontiguousarray(weights, np.float64)
    core = np.ascontiguousarray(core, np.float64)
    K = weights.shape[0]
    labels = np.empty(K, np.int64)
    i64, f64 = ctypes.c_int64, ctypes.c_double
    lib.hdbscan_mst_labels(
        _ptr(edge_a, i64), _ptr(edge_b, i64), _ptr(edge_d, f64),
        int(edge_a.shape[0]), _ptr(weights, f64), _ptr(core, f64), int(K),
        ctypes.c_double(eps), ctypes.c_double(min_cluster_size),
        ctypes.c_int32(1 if allow_single_cluster else 0), _ptr(labels, i64))
    return labels


def mst_knn(knn_dist, knn_idx, core) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mutual-reachability minimum spanning forest (Boruvka) of (K, k) kNN
    arrays and core distances -> (a, b, d) edge arrays."""
    lib = load()
    knn_dist = np.ascontiguousarray(knn_dist, np.float64)
    knn_idx = np.ascontiguousarray(knn_idx, np.int64)
    core = np.ascontiguousarray(core, np.float64)
    K, k = knn_idx.shape
    cap = max(K - 1, 1)
    out_a = np.empty(cap, np.int64)
    out_b = np.empty(cap, np.int64)
    out_d = np.empty(cap, np.float64)
    i64, f64 = ctypes.c_int64, ctypes.c_double
    n = lib.mst_knn(_ptr(knn_dist, f64), _ptr(knn_idx, i64), _ptr(core, f64),
                    int(K), int(k), _ptr(out_a, i64), _ptr(out_b, i64),
                    _ptr(out_d, f64))
    return out_a[:n], out_b[:n], out_d[:n]


def knn_query(points: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN of every point among ``points`` (self included), rows
    ascending by (distance, index) -> (dist f32 (n, k), idx i64 (n, k))."""
    lib = load()
    points = np.ascontiguousarray(points, np.float32)
    n, d = points.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for n={n}")
    dist = np.empty((n, k), np.float32)
    idx = np.empty((n, k), np.int64)
    lib.knn_query(_ptr(points, ctypes.c_float), int(n), int(d), int(k),
                  _ptr(dist, ctypes.c_float), _ptr(idx, ctypes.c_int64))
    return dist, idx


class KnnTree:
    """Exact-kNN tree over a fixed reference set: build once, query many
    batches.  The tree copies the points at build time."""

    def __init__(self, ref: np.ndarray):
        self._lib = load()
        ref = np.ascontiguousarray(ref, np.float32)
        self.n, self.d = ref.shape
        self._handle = self._lib.knn_tree_build(_ptr(ref, ctypes.c_float), self.n, self.d)
        if not self._handle:
            raise RuntimeError("knn_tree_build failed (empty reference?)")

    def query(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(dist f32 (nq, k), idx i64 (nq, k)) of the k nearest reference
        rows per query row, ascending by (distance, ref index)."""
        if self._handle is None:
            raise RuntimeError("KnnTree already closed")
        query = np.ascontiguousarray(query, np.float32)
        nq, d = query.shape
        if d != self.d:
            raise ValueError(f"query dim {d} != ref dim {self.d}")
        dist = np.empty((nq, k), np.float32)
        idx = np.empty((nq, k), np.int64)
        self._lib.knn_tree_query(self._handle, _ptr(query, ctypes.c_float), int(nq),
                                 int(k), _ptr(dist, ctypes.c_float),
                                 _ptr(idx, ctypes.c_int64))
        return dist, idx

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.knn_tree_free(self._handle)
            self._handle = None

    def __enter__(self) -> "KnnTree":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def knn_query_vs(ref: np.ndarray, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot kNN of ``query`` rows among ``ref`` rows."""
    with KnnTree(ref) as tree:
        return tree.query(query, k)


def nearest_neighbor(ref: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index (n_query,) int64 of the nearest ``ref`` row for every
    ``query`` row, ties to the smallest index.  Large batches go through
    the bucketed kNN tree, small ones through the plain KD-tree."""
    lib = load()
    ref = np.ascontiguousarray(ref, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    n_ref, d = ref.shape
    n_query = query.shape[0]
    out = np.empty(n_query, np.int64)
    fn = lib.nn1_tree if n_query >= 4096 else lib.nn1
    fn(_ptr(ref, ctypes.c_float), n_ref, _ptr(query, ctypes.c_float), n_query, d,
       _ptr(out, ctypes.c_int64))
    return out
