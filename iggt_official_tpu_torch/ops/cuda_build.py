"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each source under `iggt_official_tpu_torch/csrc/` exposes a plain C
interface and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

into `iggt_official_tpu_torch/build/`, keyed by a hash of the source and of
the shared headers (`csrc/*.cuh`), so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  The
compiler's register / spill report is kept beside the library.  Nothing is
built while a module is imported: the build runs inside the first call that
launches a kernel (or `build_all`).

The kernels have no backward, as the JAX package's Pallas kernels have no
VJP: `refuse_autograd` is every wrapper's first check, on the CPU too, so a
wrapper never hands autograd an output without a ``grad_fn``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("flash_attention", "nn1", "fused_ln")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile `csrc/<name>.cu` unless a library of this source exists.

    Returns (library path, the compiler's output).  Raises on failure."""
    so = library_path(name)
    log = so.with_suffix(".log")
    if so.exists():
        return so, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    log.write_text(out)
    os.replace(tmp, so)
    return so, out


def build_all() -> Dict[str, str]:
    """Build every kernel source at once (one nvcc per source, in parallel).

    Returns {source name: compiler output}."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: fut.result()[1] for name, fut in futures.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    so, _ = build(name)
    return ctypes.CDLL(str(so))


def refuse_autograd(wrapper: str, tensors: Iterable[Optional[torch.Tensor]]) -> None:
    """Raise ValueError when autograd would record ``wrapper``'s call: grad
    mode on and any of ``tensors`` requiring a gradient.  The kernel's output
    would carry no ``grad_fn`` and cut the gradient without a word; on either
    device the call is refused instead."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"{wrapper}: an input requires grad, and the kernel has no backward "
            "(nor has the JAX package's Pallas kernel a VJP). Train through plain "
            "attention and LayerNorm: pass attn_fn=sdpa_plain "
            "(iggt_official_tpu_torch.layers.blocks) and fused_ln=False, as "
            "iggt_official_tpu_torch.train.step does; run inference under "
            "torch.no_grad() or torch.inference_mode()")
