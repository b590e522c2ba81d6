"""Flash attention: hand-written Hopper kernels, their plain versions, dispatch.

Counterpart of `iggt_official_tpu/ops/flash_attention.py`.  Both Pallas
kernels of that module map onto `csrc/flash_attention.cu`:

- `flash_attention`: non-causal softmax(Q K^T D^-1/2 + key_bias) V, online
  softmax in fp32, for (B, N, H, D) tensors with D in {32, 64} and dtype in
  {bf16, fp32}, and D in {56, 72, 96} in fp32 (SAM2's Hiera: every head of
  Hiera-B+ is 56 wide, of Hiera-L 72, of Hiera-T and -S 96, in windows of
  16 to 4096 keys, with pooled queries Nq = Nk / 4).  bf16
  runs a wgmma kernel fed by TMA, which reads q/k/v in place through tensor
  maps (`_check_tma`).  fp32 runs three TF32 passes on
  wgmma (hi.hi + hi.lo + lo.hi, which hold 1e-5 where one pass cannot): a
  prep kernel first splits q, k and V^T into hi / lo scratch that the
  wrapper allocates (`iggt_flash_fp32_scratch_floats`), then a wgmma kernel
  fed by TMA attends over it.
- `flash_attention_fused`: the same after the aggregator's q/k prep (fp32
  head-dim LayerNorm with the fast variance, then 2D RoPE from packed
  (B, N, D) tables, one rounding to the compute dtype).  A prep kernel
  preps every q and k row once, into scratch the wrapper allocates (in fp32
  the same kernel that splits them).

- `qk_prep`: the prep kernel alone, q and k rows prepped into new
  contiguous tensors of the input's dtype (bf16 or fp32).  Token merging
  (`ops/token_merge.py`) takes it: the merged global blocks average the
  prepped K rows, so the prep runs before the merge and the attention after.

The wrappers launch the kernels for CUDA tensors (or raise) and take the
plain version only for CPU tensors.  On either device they refuse inputs
that require grad while grad mode is on (`cuda_build.refuse_autograd`): the
kernels have no backward.  `attention_train` is the one route through a
kernel under autograd: `flash_attention`'s forward, and a backward through
the autograd of `flash_attention_plain`, recomputed from the saved q, k, v
(the training step's route for the part head's cross-attention, which the
JAX step sends to its dispatcher).  Each wrapper counts its calls that
launch in a plain integer attribute (`flash_attention.launches`,
`flash_attention_fused.launches`, `qk_prep.launches`; a fused call is one
count for its prep and attention launches).

Dispatch (`attention`) keeps the JAX protocol (`supports_fused_qk_prep`):
calls that carry RoPE tables or qk-norm params go to the fused wrapper, the
rest to the flash wrapper.  The aggregator's frame and global blocks both
take it: with each q/k row prepped once, the fused route costs the same at
any length (the JAX package takes unfused prep past 2048 tokens, for the
TPU's reasons).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from iggt_official_tpu_torch.ops import cuda_build

HEAD_DIMS = (32, 64)
FP32_HEAD_DIMS = (32, 64, 56, 72, 96)   # 56 / 72 / 96: flash_attention in fp32 only
LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the yardstick the kernels are held to)

def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    block_q: int = 1024,
) -> torch.Tensor:
    """Blockwise exact attention, (B, Nq, H, D) x (B, Nk, H, D) -> (B, Nq, H, D).

    Mirrors `sdpa_chunked` of the JAX package: per query block an exact fp32
    softmax over the full key axis, so memory is O(block_q * Nk) rather than
    O(Nq * Nk).  Logits accumulate in fp32; probabilities are cast to V's
    dtype before P.V, which accumulates in fp32; the result has q's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    bias = None if key_bias is None else key_bias.float()[:, None, None, :]
    out = torch.empty_like(q)
    for s in range(0, q.shape[1], block_q):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:s + block_q].float(), kf)
        logits = logits * scale
        if bias is not None:
            logits = logits + bias
        p = torch.softmax(logits, dim=-1).to(v.dtype).float()
        out[:, s:s + block_q] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out


def rotate_half_2d(x: torch.Tensor) -> torch.Tensor:
    """2D-RoPE rotate-half over the last dim, per spatial half:
    concat(-x[q:2q], x[0:q], -x[3q:4q], x[2q:3q]) with q = D/4."""
    a, b, c, d = x.chunk(4, dim=-1)
    return torch.cat([-b, a, -d, c], dim=-1)


def qk_prep_plain(
    x: torch.Tensor,
    gamma: Optional[torch.Tensor],
    beta: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    """fp32 head-dim LayerNorm (fast variance) then 2D RoPE, ONE cast back.

    Mirrors `_qk_prep_xla`.  x: (B, N, H, D); cos/sin: (B, >= N, D) packed
    tables (`layers.rope.pack_rope_tables`), row i for token i, as the
    kernel reads them.  float64 inputs are prepped in float64 (a reference
    for the fp32 sums)."""
    dt = x.dtype
    x = x.to(torch.promote_types(dt, torch.float32))
    if gamma is not None:
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        x = (x - mu) * torch.rsqrt(var + eps) * gamma + beta
    if cos is not None:
        n = x.shape[1]
        x = x * cos[:, :n, None, :] + rotate_half_2d(x) * sin[:, :n, None, :]
    return x.to(dt)


# ---------------------------------------------------------------------------
# kernel binding

@functools.cache
def _kernel():
    lib = cuda_build.load("flash_attention")
    fn = lib.iggt_flash_attention
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = (
        [i, i, i, i]                 # dtype, head_dim, use_norm, use_rope
        + [p, p, p, p]               # q, k, v, o
        + [p]                        # key_bias
        + [p, p, ll, ll]             # cos, sin, rope batch / row strides
        + [p, p, p, p]               # gamma_q, beta_q, gamma_k, beta_k
        + [p, p]                     # prepped q / k scratch
        + [i, i, i, i]               # B, H, Nq, Nk
        + [ll] * 9                   # q, k, v strides (batch, row, head)
        + [f, f, i, p]               # scale, eps, fault, stream
    )
    fn.restype = ctypes.c_int
    prep = lib.iggt_flash_qk_prep
    prep.argtypes = (
        [i, i, i, i]                 # dtype, head_dim, use_norm, use_rope
        + [p, p]                     # q, k
        + [p, p, ll, ll]             # cos, sin, rope batch / row strides
        + [p, p, p, p]               # gamma_q, beta_q, gamma_k, beta_k
        + [p, p]                     # prepped q / k out
        + [i, i, i, i]               # B, H, Nq, Nk
        + [ll] * 6                   # q, k strides (batch, row, head)
        + [f, p]                     # eps, stream
    )
    prep.restype = ctypes.c_int
    lib.iggt_flash_bias_stride.argtypes = [i]
    lib.iggt_flash_bias_stride.restype = ll
    lib.iggt_flash_fp32_scratch_floats.argtypes = [i, i, i, i, i]
    lib.iggt_flash_fp32_scratch_floats.restype = ll
    lib.iggt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.iggt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, row, head) element strides of a (B, N, H, D) tensor; a dim of
    size 1 takes the stride a contiguous tensor would have (it is never
    stepped, and torch may report any stride there)."""
    B, N, H, D = t.shape
    sb, sn, sh, _ = t.stride()
    return (sb if B > 1 else N * H * D, sn if N > 1 else H * D, sh if H > 1 else D)


def _check_tma(t: torch.Tensor, strides: Tuple[int, int, int]) -> None:
    """Raise ValueError unless TMA can read the bf16 (B, N, H, D) tensor ``t``
    in place, through the tensor map (dims D, N, H, B; byte strides
    2 * (row, head, batch)) that `csrc/flash_attention.cu::make_tensor_map`
    encodes: base address and strides multiples of 16 bytes."""
    sb, sn, sh = strides
    if t.data_ptr() % 16 or (sb | sn | sh) % 8:   # 8 bf16 elements = 16 bytes
        raise ValueError(
            f"TMA needs a 16-byte aligned base and strides; got base offset "
            f"{t.data_ptr() % 16}, byte strides (batch, row, head) = "
            f"({2 * sb}, {2 * sn}, {2 * sh})")


def _check_qkv(tensors, names, fp32_dims=HEAD_DIMS):
    """Raise ValueError unless the (B, N, H, D) tensors are CUDA tensors of
    one kernel dtype and device, with a contiguous last dim and D in HEAD_DIMS
    (in ``fp32_dims`` for fp32)."""
    first = tensors[0]
    for name, t in zip(names, tensors):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, N, H, D) with a contiguous last dim")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{', '.join(names)} must share dtype and device")
    if first.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {first.dtype}: the kernel takes bf16 and fp32")
    dims = fp32_dims if first.dtype == torch.float32 else HEAD_DIMS
    if first.shape[-1] not in dims:
        raise ValueError(f"unsupported head dim {first.shape[-1]}: the kernel takes "
                         f"{dims} in {first.dtype}")


def _prep_args(cos, sin, norm, B, N, D, device):
    """The q/k prep's inputs as the kernels read them: fp32 rope tables (B, >= N,
    D) with a contiguous last dim and shared strides, and their (batch, row)
    strides; the four qk-norm params as contiguous fp32 (D,) tensors."""
    rope_sb = rope_sn = 0
    if cos is not None:
        cos = cos.to(device=device, dtype=torch.float32)
        sin = sin.to(device=device, dtype=torch.float32)
        for t in (cos, sin):
            if (t.dim() != 3 or t.shape[0] != B or t.shape[1] < N
                    or t.shape[2] != D or t.stride(-1) != 1):
                raise ValueError("rope tables must be (B, N, D) with a contiguous last dim")
        if cos.stride() != sin.stride():
            raise ValueError("rope cos and sin tables must share strides")
        rope_sb, rope_sn = cos.stride(0), cos.stride(1)
    if norm is not None:
        norm = [t.to(device=device, dtype=torch.float32).contiguous() for t in norm]
        if any(t.shape != (D,) for t in norm):
            raise ValueError("qk-norm params must each be (D,)")
    return cos, sin, rope_sb, rope_sn, norm


# planted faults of the fp32 path, for the card check only (`_launch`'s fault)
FP32_FAULTS = {"one TF32 pass": 1, "V^T without the key permutation": 2}
# and of its Hiera shapes (the panels pad D = 56 to 64 and D = 72 to 96, so
# the padded scale is a fault at those two; windows of 16 keys, under one
# 64-key tile)
HIERA_FAULTS = {"softmax scale of the padded head dim": 8,
                "V without its last 8 head-dim columns": 4,
                "last key tile dropped": 16, "one key past Nk admitted": 32}
_FAULT_BITS = {**FP32_FAULTS, **HIERA_FAULTS}


def _launch(q, k, v, key_bias=None, cos=None, sin=None, norm=None, eps=1e-5, fault=None):
    """Check the inputs, allocate the output and the scratch (the prepped q/k
    in bf16 with the q/k prep, the TF32 split in fp32) and launch the
    kernels.  ``fault`` (a key of `FP32_FAULTS` or `HIERA_FAULTS`, fp32 only)
    plants a fault for the card check; no caller of the port passes it."""
    prep = cos is not None or norm is not None
    _check_qkv((q, k, v), ("q", "k", "v"), HEAD_DIMS if prep else FP32_HEAD_DIMS)
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if k.shape != (B, Nk, H, D) or v.shape != (B, Nk, H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    strides = [_strides(t) for t in (q, k, v)]
    if q.dtype == torch.bfloat16:
        # TMA reads v, and q/k unless the prep kernel copies them to scratch
        for i in (2,) if prep else (0, 1, 2):
            _check_tma((q, k, v)[i], strides[i])
    lib = _kernel()
    if key_bias is not None:
        if key_bias.shape != (B, Nk):
            raise ValueError(f"key_bias must be (B, Nk) = {(B, Nk)}")
        # the kernels read it times log2(e), rows zero-padded to a whole key tile
        padded = torch.zeros((B, lib.iggt_flash_bias_stride(Nk)), dtype=torch.float32,
                             device=q.device)
        padded[:, :Nk] = key_bias.to(device=q.device, dtype=torch.float32) * LOG2E
        key_bias = padded
    cos, sin, rope_sb, rope_sn, norm = _prep_args(cos, sin, norm, B, max(Nq, Nk), D,
                                                  q.device)
    gq, bq, gk, bk = norm if norm is not None else (None,) * 4
    if fault is not None and q.dtype != torch.float32:
        raise ValueError("planted faults apply to the fp32 path only")
    q_prep = k_prep = None
    if q.dtype == torch.float32:
        q_prep = torch.empty(lib.iggt_flash_fp32_scratch_floats(B, H, Nq, Nk, D),
                             dtype=torch.float32, device=q.device)
    elif prep:
        q_prep = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
        k_prep = torch.empty((B, Nk, H, D), dtype=q.dtype, device=q.device)

    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.iggt_flash_attention(
            _DTYPE_CODE[q.dtype], D, int(norm is not None), int(cos is not None),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(key_bias),
            _ptr(cos), _ptr(sin), rope_sb, rope_sn,
            _ptr(gq), _ptr(bq), _ptr(gk), _ptr(bk),
            _ptr(q_prep), _ptr(k_prep),
            B, H, Nq, Nk,
            *strides[0], *strides[1], *strides[2],
            1.0 / math.sqrt(D), eps, _FAULT_BITS[fault] if fault else 0, stream,
        )
    if err != 0:
        raise RuntimeError("flash attention kernel failed to launch: "
                           + lib.iggt_cuda_error_string(err).decode())
    return out


# ---------------------------------------------------------------------------
# wrappers

def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused attention, (B, Nq, H, D) x (B, Nk, H, D) -> (B, Nq, H, D).

    ``key_bias`` (B, Nk) fp32 is added to every query's logits.  CUDA
    tensors launch the kernel; CPU tensors take `flash_attention_plain`."""
    cuda_build.refuse_autograd("flash_attention", (q, k, v, key_bias))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_bias)
    out = _launch(q, k, v, key_bias)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    qk_norm_params: Optional[Sequence[torch.Tensor]] = None,
    key_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Flash attention after the q/k prep (each row prepped once by the prep
    kernel, then attended over by the wgmma kernel).

    q/k/v: (B, N, H, D) in the compute dtype, *before* norm/RoPE.
    rope_cos/rope_sin: (B, N, D) fp32 packed tables.
    qk_norm_params: (gamma_q, beta_q, gamma_k, beta_k), each (D,) fp32."""
    cuda_build.refuse_autograd("flash_attention_fused",
                               (q, k, v, rope_cos, rope_sin, key_bias, *(qk_norm_params or ())))
    if q.device.type == "cpu":
        gq, bq, gk, bk = qk_norm_params if qk_norm_params is not None else (None,) * 4
        q = qk_prep_plain(q, gq, bq, rope_cos, rope_sin, eps)
        k = qk_prep_plain(k, gk, bk, rope_cos, rope_sin, eps)
        return flash_attention_plain(q, k, v, key_bias)
    out = _launch(q, k, v, key_bias, rope_cos, rope_sin, qk_norm_params, eps)
    flash_attention_fused.launches += 1
    return out


flash_attention_fused.launches = 0


def qk_prep(
    q: torch.Tensor,
    k: torch.Tensor,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    qk_norm_params: Optional[Sequence[torch.Tensor]] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q/k prep alone: (prepped q, prepped k), each contiguous (B, N, H, D)
    in the input's dtype (fp32 LayerNorm, then RoPE, one rounding).

    Arguments as `flash_attention_fused`'s.  CUDA tensors launch the prep
    kernel (one launch preps both); CPU tensors take `qk_prep_plain`."""
    cuda_build.refuse_autograd("qk_prep", (q, k, rope_cos, rope_sin, *(qk_norm_params or ())))
    gq, bq, gk, bk = qk_norm_params if qk_norm_params is not None else (None,) * 4
    if q.device.type == "cpu":
        return (qk_prep_plain(q, gq, bq, rope_cos, rope_sin, eps),
                qk_prep_plain(k, gk, bk, rope_cos, rope_sin, eps))
    _check_qkv((q, k), ("q", "k"))
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if k.shape != (B, Nk, H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}")
    if rope_cos is None and qk_norm_params is None:
        raise ValueError("qk_prep needs rope tables or qk-norm params")
    cos, sin, rope_sb, rope_sn, norm = _prep_args(rope_cos, rope_sin, qk_norm_params,
                                                  B, max(Nq, Nk), D, q.device)
    gq, bq, gk, bk = norm if norm is not None else (None,) * 4
    q_out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    k_out = torch.empty((B, Nk, H, D), dtype=q.dtype, device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.iggt_flash_qk_prep(
            _DTYPE_CODE[q.dtype], D, int(norm is not None), int(cos is not None),
            q.data_ptr(), k.data_ptr(),
            _ptr(cos), _ptr(sin), rope_sb, rope_sn,
            _ptr(gq), _ptr(bq), _ptr(gk), _ptr(bk),
            q_out.data_ptr(), k_out.data_ptr(),
            B, H, Nq, Nk, *_strides(q), *_strides(k), eps, stream,
        )
    if err != 0:
        raise RuntimeError("q/k prep kernel failed to launch: "
                           + lib.iggt_cuda_error_string(err).decode())
    qk_prep.launches += 1
    return q_out, k_out


qk_prep.launches = 0


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    qk_norm_params: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Default attention: the fused kernel when the call carries the q/k prep
    (the frame blocks), the flash kernel otherwise (DINOv2 blocks, the part
    head's cross-attention)."""
    if rope_cos is not None or qk_norm_params is not None:
        return flash_attention_fused(q, k, v, rope_cos, rope_sin, qk_norm_params,
                                     key_bias)
    return flash_attention(q, k, v, key_bias)


attention.supports_fused_qk_prep = True


class _PlainBackward(torch.autograd.Function):
    """`flash_attention` forward; the gradient of `flash_attention_plain`."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)      # grad mode is off here: no refusal

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = flash_attention_plain(*qkv)
        return torch.autograd.grad(out, qkv, grad)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention without q/k prep under autograd: the forward through
    `flash_attention` (the kernel for CUDA tensors, one count of its
    ``launches``), the backward through the autograd of
    `flash_attention_plain`, recomputed from q, k, v (no backward kernel: the
    JAX package has none).  The training step's route for the part head's
    cross-attention, where the JAX step applies its dispatcher `attention`,
    which on a TPU sends the level-1x injection (512-2048 tokens) to the
    Pallas flash kernel."""
    return _PlainBackward.apply(q, k, v)
