"""Convolutions on channels-last (N, H, W, C) tensors, torch parameter layout.

Counterpart of `iggt_official_tpu/ops/conv.py`.  The modules keep torch's
own parameters (Conv2d weight (out, in, kh, kw); ConvTranspose2d weight
(in, out, kh, kw); BatchNorm weight / bias / running stats), so the model's
`state_dict()` is the reference checkpoint layout, while the heads keep the
JAX package's NHWC activations.  NHWC -> NCHW is a permuted view (a
channels-last NCHW tensor), so no copy is made around the convolution.

`conv3x3` is a hand-written Hopper kernel (`csrc/conv3x3.cu`) for the 3x3,
stride-1, padding-1 convolution of fp32 NHWC maps: three TF32 passes on the
tensor cores (hi.lo + lo.hi + hi.hi on operands split in fp32), the fp32
level of accuracy that cuDNN reaches with TF32 off on its FMA units only.
The JAX package has no such kernel (XLA convolves there).  `Conv2d` sends a
call to it exactly when `conv3x3_routes` holds: a CUDA input, fp32 compute,
kernel 3, stride 1, padding 1, dilation 1, groups 1, input channels a
multiple of 32 (the kernel's 32-channel TMA chunks), grad mode off and
`torch.backends.cudnn.allow_tf32` off (a caller who allows TF32 asked for
cuDNN's one TF32 pass).  Every other call, the CPU path included, is
`F.conv2d`.  A routed call runs inside the span `ops.conv3x3` and counts in
`conv3x3.launches`; the wrapper launches the kernel for CUDA tensors (or
raises) and takes `conv3x3_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iggt_official_tpu_torch.ops import cuda_build
from iggt_official_tpu_torch.utils.logging import span

CONV3X3_SPAN = "ops.conv3x3"
CONV3X3_CHANNELS = 32   # input channels per TMA chunk: Cin must be a multiple


def conv3x3_routes(device_type: str, dtype: torch.dtype, kernel_size, stride, padding,
                   dilation, groups: int, in_channels: int) -> bool:
    """Whether `Conv2d` sends a call with these attributes (tuples, as
    `nn.Conv2d` keeps them) to `conv3x3`; grad mode and TF32 convolutions are
    read as they stand."""
    return (device_type == "cuda" and dtype == torch.float32 and kernel_size == (3, 3)
            and stride == (1, 1) and padding == (1, 1) and dilation == (1, 1) and groups == 1
            and in_channels % CONV3X3_CHANNELS == 0
            and not torch.is_grad_enabled() and not torch.backends.cudnn.allow_tf32)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 3x3, stride-1, padding-1 convolution of NHWC ``x`` by ``weight``
    (Cout, Cin, 3, 3) through `F.conv2d`, returned NHWC."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias, 1, 1).permute(0, 2, 3, 1)


def split_tf32_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as (hi, lo): hi rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero: `cvt.rna.tf32.f32`), lo = x - hi, exact, so
    hi + lo == x; where the rounding is not finite, hi = x and lo = 0
    (`csrc/sm90.cuh::split_tf32`)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    h = (sign | mag).view(torch.float32)
    fin = torch.isfinite(h)
    return torch.where(fin, h, x), torch.where(fin, x - h, torch.zeros_like(x))


def split_weights_plain(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weight planes: ``weight`` (Cout, Cin, 3, 3) repacked to
    (Cout, 3, 3, Cin), K-major (input channel fastest), and split into its
    TF32 hi and lo parts (`conv3x3_weight_prep`)."""
    return split_tf32_plain(weight.float().permute(0, 2, 3, 1).contiguous())


@functools.cache
def _kernel():
    lib = cuda_build.load("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.iggt_conv3x3.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.iggt_conv3x3.restype = i
    lib.iggt_conv3x3_planes_floats.argtypes = [i, i]
    lib.iggt_conv3x3_planes_floats.restype = ctypes.c_longlong
    lib.iggt_conv3x3_tile.argtypes = [i, i, i, i, i]
    lib.iggt_conv3x3_tile.restype = i
    lib.iggt_cuda_error_string.argtypes = [i]
    lib.iggt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_tile(x: torch.Tensor, out_channels: int) -> Tuple[int, int]:
    """(m64 tiles per consumer warpgroup, output channels per tile) that the
    kernel takes for NHWC ``x`` on its card."""
    N, H, W, _ = x.shape
    code = _kernel().iggt_conv3x3_tile(N, H, W, out_channels, _num_sms(x.device.index or 0))
    return code // 10, 32 * (code % 10)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            tile: Tuple[int, int] = (0, 0), fault: int = 0) -> torch.Tensor:
    """One kernel call.  ``tile`` (m64 tiles per consumer warpgroup, output
    channels per tile) forces a tile shape, and ``fault`` (bit 0: one TF32
    pass; bit 1: one tensor-core chain per A slot, whose truncated sums
    shrink the outputs) plants a fault: both for the card check; (0, 0) and
    0 otherwise."""
    if not x.is_cuda:
        raise ValueError("the conv3x3 kernel takes CUDA tensors")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3 takes x (N, H, W, Cin) and weight (Cout, Cin, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    N, H, W, Cin = x.shape
    Cout = weight.shape[0]
    if weight.shape[1] != Cin or Cin % CONV3X3_CHANNELS:
        raise ValueError(f"conv3x3 takes input channels matching the weight's, a multiple of "
                         f"{CONV3X3_CHANNELS}; got {Cin} and weight {tuple(weight.shape)}")
    if any(t is not None and t.dtype != torch.float32 for t in (x, weight, bias)):
        raise ValueError("the conv3x3 kernel takes fp32 tensors")
    if bias is not None and tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias must be ({Cout},), got {tuple(bias.shape)}")
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        xc = xc.clone()
    w = weight.to(x.device).contiguous()
    b = None if bias is None else bias.to(x.device).contiguous()
    out = torch.empty((N, H, W, Cout), dtype=torch.float32, device=x.device)
    lib = _kernel()
    planes = torch.empty(lib.iggt_conv3x3_planes_floats(Cin, Cout), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.iggt_conv3x3(xc.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                               out.data_ptr(), planes.data_ptr(), N, H, W, Cin, Cout,
                               _num_sms(x.device.index or 0), 10 * tile[0] + tile[1] // 32,
                               fault, stream)
    if err != 0:
        raise RuntimeError("conv3x3 kernel failed to launch: "
                           + lib.iggt_cuda_error_string(err).decode())
    return out


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3, stride-1, padding-1 convolution of NHWC fp32 ``x`` (N, H, W, Cin)
    by ``weight`` (Cout, Cin, 3, 3) plus ``bias``, returned (N, H, W, Cout).
    CUDA tensors launch the kernel; CPU tensors take `conv3x3_plain`."""
    cuda_build.refuse_autograd("conv3x3", (x, weight, bias))
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.numel() == 0:
        return torch.empty((*x.shape[:3], weight.shape[0]), dtype=x.dtype, device=x.device)
    out = _launch(x, weight, bias)
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


class Conv2d(nn.Conv2d):
    """torch Conv2d applied to NHWC input, computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if conv3x3_routes(x.device.type, dt, self.kernel_size, self.stride, self.padding,
                          self.dilation, self.groups, self.in_channels):
            with span(CONV3X3_SPAN):
                return conv3x3(x.to(dt), self.weight.to(dt), bias)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ConvTranspose2d applied to NHWC input, computing in ``dtype``;
    output size (i - 1) * s + k - 2p, as in torch.

    cuDNN runs a transposed convolution as a convolution's data gradient, and
    where the kernel overlaps itself (k > s, the SamProjector's k 4, s 2) its
    default algorithms sum with atomics, so the same input gave other bytes
    from run to run on the card.  The call picks a deterministic algorithm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), bias,
                                   self.stride, self.padding)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """Inference-form BatchNorm2d over the channel (last) axis.

    y = (x - running_mean) * rsqrt(running_var + eps) * weight + bias, in fp32,
    returned in x's dtype.  Keeps BatchNorm2d's state-dict entries.  The
    running statistics are parameters, as in the JAX package (its ``mean`` /
    ``var`` params), so the training step gives them gradients and updates
    them with the optimizer as it does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight
        return ((x.float() - self.running_mean) * inv + self.bias).to(x.dtype)
