"""Fused LayerNorm for the trunk's pre-norms: a hand-written Hopper kernel and
its plain version.

Counterpart of `iggt_official_tpu/ops/fused_ln.py::fused_layernorm`: a
LayerNorm over the last axis with fp32 statistics, the two-pass variance
mean((x - mu)^2), rsqrt(var + eps), the affine in fp32 and one cast to
``out_dtype``.  The trunk blocks take it for ``norm1`` / ``norm2`` when the
forward runs with ``fused_ln=True`` (`layers/blocks.py::Block`), reading the
weight and bias of their `LayerNorm` modules, so the state dict is the same
either way.

`fused_layernorm` launches the CUDA kernel (`csrc/fused_ln.cu`) for CUDA
tensors, or raises, and takes `fused_layernorm_plain` only for CPU tensors.
It counts its launches in `fused_layernorm.launches`.  On either device it
refuses inputs that require grad while grad mode is on (the kernel has no
backward; the JAX docstring says as much: the training step keeps the plain
LayerNorm).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from iggt_official_tpu_torch.ops import cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 2048  # the kernel holds a row in registers: 8 chunks of 8 per lane


LANES, VEC = 32, 8  # the kernel's warp width and elements per chunk


def _warp_sum(t: torch.Tensor) -> torch.Tensor:
    """Row sums of (rows, D) fp32 in the kernel's order: chunk c of 8 goes to
    lane c mod 32, each lane adds its elements one by one (chunk by chunk),
    then a butterfly over the lanes (xor 16, 8, 4, 2, 1).  Returns (rows, 1)."""
    rows, D = t.shape
    cpl = -(-D // (LANES * VEC))
    t = torch.nn.functional.pad(t, (0, cpl * LANES * VEC - D)).view(rows, cpl, LANES, VEC)
    s = torch.zeros((rows, LANES), dtype=torch.float32, device=t.device)
    for c in range(cpl):
        for k in range(VEC):
            s = s + t[:, c, :, k]
    lane = torch.arange(LANES, device=t.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return s[:, :1]


def fused_layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-5,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's arithmetic tensor-wise in fp32, in its order: the row sum
    (warp order), / D, centre, the sum of squares (warp order), / D, + eps, a
    correctly rounded rsqrt (through fp64), times rstd, times weight, plus
    bias, one cast.  Every step rounds as the kernel's does, so the two agree
    bit for bit."""
    out_dtype = out_dtype or x.dtype
    shape, D = x.shape, x.shape[-1]
    x = x.reshape(-1, D).float()
    # divide by a tensor: with a Python-number divisor, CUDA multiplies by its
    # reciprocal, which is not the correctly rounded quotient unless D is a
    # power of two
    d = torch.full((1, 1), float(D), device=x.device)
    mu = _warp_sum(x) / d
    xc = x - mu
    var = _warp_sum(xc * xc) / d
    rstd = (1.0 / torch.sqrt((var + eps).double())).float()
    y = xc * rstd * weight.float() + bias.float()
    return y.to(out_dtype).reshape(shape)


@functools.cache
def _kernel():
    lib = cuda_build.load("fused_ln")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.iggt_fused_ln.argtypes = [i, i, p, p, p, p, ll, i, ctypes.c_float, p]
    lib.iggt_fused_ln.restype = ctypes.c_int
    lib.iggt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iggt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
            out_dtype: torch.dtype) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError("the fused LayerNorm kernel takes CUDA tensors")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the fused LayerNorm kernel takes bf16 or fp32, got "
                         f"{x.dtype} -> {out_dtype}")
    D = x.shape[-1]
    if D % 8 or D > MAX_DIM:
        raise ValueError(f"the fused LayerNorm kernel takes a last dim that is a "
                         f"multiple of 8 up to {MAX_DIM}, got {D}")
    if weight.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"weight and bias must be ({D},)")
    xr = _aligned(x.reshape(-1, D))
    w = _aligned(weight.to(device=x.device, dtype=torch.float32))
    b = _aligned(bias.to(device=x.device, dtype=torch.float32))
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.iggt_fused_ln(_DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
                                xr.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                xr.shape[0], D, eps, stream)
    if err != 0:
        raise RuntimeError("fused LayerNorm kernel failed to launch: "
                           + lib.iggt_cuda_error_string(err).decode())
    return out


def fused_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm of ``x`` (..., D) over D, fp32 inside, returned in
    ``out_dtype`` (default x's dtype).  CUDA tensors launch the kernel; CPU
    tensors take `fused_layernorm_plain`."""
    cuda_build.refuse_autograd("fused_layernorm", (x, weight, bias))
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, weight, bias, eps, out_dtype)
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=out_dtype, device=x.device)
    out = _launch(x, weight, bias, eps, out_dtype)
    fused_layernorm.launches += 1
    return out


fused_layernorm.launches = 0
