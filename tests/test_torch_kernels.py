"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port's dependencies are installed (skip the JAX-pinning conftest there):

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Every test needs an NVIDIA Hopper card and skips (inside a fixture) where
there is none.  Tolerances: fp32 1e-5 abs (the kernel multiplies in full
fp32; summation order differs).  bf16 2^-6 * max|ref| abs, i.e. 2 to 4 bf16
ulps of the largest output: both sides keep fp32 logits and round the output
to bf16 once, the kernel its unnormalized probabilities and the plain version
its normalized ones, and the errors seen at the main path's shapes are one
ulp of max|ref|.  The limit scales with the output because attention outputs
shrink as ~sqrt(e / N) with N keys.
"""

import pytest
import torch

from iggt_official_tpu_torch.layers import rope
from iggt_official_tpu_torch.ops import flash_attention as fa

BF16_REL = 2.0 ** -6


def _assert_close(out, ref):
    ref = ref.float()
    atol = 1e-5 if out.dtype == torch.float32 else BF16_REL * ref.abs().max().item()
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(device, dtype, B=2, N=100, H=3, D=64, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device=device).to(dtype)
    bias = torch.randn((B, N), generator=gen, device=device)
    norm = [torch.randn((D,), generator=gen, device=device) for _ in range(4)]
    return (*qkv.unbind(2), bias, norm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_kernel_matches_plain(cuda_device, dtype, D):
    """Ragged N (100 = one full and one partial 64-row tile), a key bias,
    strided q/k/v views of one packed qkv, Nq < Nk and Nq > Nk."""
    q, k, v, bias, _ = _qkv(cuda_device, getattr(torch, dtype), D=D)
    n = fa.flash_attention.launches
    _assert_close(fa.flash_attention(q, k, v, bias), fa.flash_attention_plain(q, k, v, bias))
    _assert_close(fa.flash_attention(q[:, :37], k, v),
                  fa.flash_attention_plain(q[:, :37], k, v))
    _assert_close(fa.flash_attention(q, k[:, :37], v[:, :37], bias[:, :37]),
                  fa.flash_attention_plain(q, k[:, :37], v[:, :37], bias[:, :37]))
    assert fa.flash_attention.launches == n + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
def test_fused_kernel_matches_plain(cuda_device, dtype, D):
    """In-kernel fp32 LayerNorm + 2D RoPE + one rounding, against
    `qk_prep_plain` + `flash_attention_plain`; tables broadcast over batch."""
    q, k, v, bias, norm = _qkv(cuda_device, getattr(torch, dtype), D=D)
    pos = rope.make_patch_positions(9, 11, 1, 1, device=cuda_device).expand(2, -1, -1)
    cos, sin = rope.pack_rope_tables(rope.compute_rope_2d(pos, D))
    n = fa.flash_attention_fused.launches
    out = fa.flash_attention_fused(q, k, v, cos, sin, norm, bias)
    ref = fa.flash_attention_plain(fa.qk_prep_plain(q, norm[0], norm[1], cos, sin),
                                   fa.qk_prep_plain(k, norm[2], norm[3], cos, sin), v, bias)
    _assert_close(out, ref)
    assert fa.flash_attention_fused.launches == n + 1


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
