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
shrink as ~sqrt(e / N) with N keys.  nn1 and bucket top-k: equal indices
and distances (kernel and plain version round every subtraction, square and
addition alike, and both take the smallest index among equal distances; the
nn1 kernel's tensor-core filter only decides which pairs get that chain).
fused LayerNorm: bit for bit (the plain version sums in the kernel's warp
order and rounds every step as the kernel does).  A CUDA tensor launches the
kernel: the tests replace the plain versions with ones that raise.
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


# (Nq, Nk): one key or query, just under / over one and two 64- and 128-row
# tiles, the frame and 3-view global lengths, Nq != Nk both ways
RAGGED = [(1, 1), (63, 63), (65, 65), (129, 129), (1374, 1374), (2607, 2607), (1, 2607),
          (2607, 63), (65, 1374), (1374, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("nq,nk", RAGGED)
def test_bf16_flash_kernel_ragged_lengths(cuda_device, D, nq, nk):
    """The wgmma kernel at ragged lengths (TMA zero-fills rows past N; the
    kernel masks keys past Nk and never stores rows past Nq), with and
    without a key bias."""
    q, _, _, _, _ = _qkv(cuda_device, torch.bfloat16, B=2, N=nq, H=3, D=D, seed=5)
    _, k, v, bias, _ = _qkv(cuda_device, torch.bfloat16, B=2, N=nk, H=3, D=D, seed=6)
    _assert_close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v))
    _assert_close(fa.flash_attention(q, k, v, bias), fa.flash_attention_plain(q, k, v, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64])
def test_bf16_flash_kernel_reads_strided_views_in_place(cuda_device, D):
    """q/k/v as strided views of one packed qkv (row stride 3 H D) give the
    same bits as contiguous copies: the tensor maps read the views in place."""
    q, k, v, bias, _ = _qkv(cuda_device, torch.bfloat16, B=2, N=300, H=4, D=D, seed=7)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, bias)
    assert torch.equal(out, fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                               bias))
    _assert_close(out, fa.flash_attention_plain(q, k, v, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernel_at_the_global_length(cuda_device, dtype):
    """The fused path at N > 2048 (3 views of 5 + 24 x 36 tokens in one
    row, as the global blocks hand it over): prep kernel + flash kernel
    against `qk_prep_plain` + `flash_attention_plain`."""
    q, k, v, _, norm = _qkv(cuda_device, getattr(torch, dtype), B=1, N=2607, H=2, D=64,
                            seed=8)
    pos = rope.make_patch_positions(24, 36, 3, 5, device=cuda_device).reshape(1, 2607, 2)
    cos, sin = rope.pack_rope_tables(rope.compute_rope_2d(pos, 64))
    n = fa.flash_attention_fused.launches
    out = fa.flash_attention_fused(q, k, v, cos, sin, norm)
    ref = fa.flash_attention_plain(fa.qk_prep_plain(q, norm[0], norm[1], cos, sin),
                                   fa.qk_prep_plain(k, norm[2], norm[3], cos, sin), v)
    _assert_close(out, ref)
    assert fa.flash_attention_fused.launches == n + 1


@pytest.mark.cuda
def test_bf16_wrapper_raises_on_strides_tma_cannot_take(cuda_device):
    """A row / head stride of 136 bytes (D = 64 cut from 68) is no multiple of
    16 bytes: the wrapper raises before any launch."""
    x = torch.zeros((1, 8, 2, 68), device=cuda_device, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(x, x, x)
    n = fa.flash_attention_fused.launches
    norm = [torch.ones(64, device=cuda_device)] * 4
    with pytest.raises(ValueError, match="16-byte"):   # v is read through TMA
        fa.flash_attention_fused(x.contiguous(), x.contiguous(), x, qk_norm_params=norm)
    assert fa.flash_attention_fused.launches == n


def test_strides_of_qkv_views_and_contiguous_tensors():
    """Runs on the CPU: the (batch, row, head) element strides the kernels
    get, which the bf16 kernel's tensor maps read as byte strides, for a view
    of a packed qkv, a contiguous tensor, and a size-1 dim (it takes the
    contiguous stride, whatever torch reports there); TMA takes all three."""
    qkv = torch.zeros((2, 100, 3, 4, 64), dtype=torch.bfloat16)
    q, k, _ = qkv.unbind(2)
    assert fa._strides(q) == fa._strides(k) == (100 * 3 * 4 * 64, 3 * 4 * 64, 64)
    c = torch.zeros((2, 100, 4, 32), dtype=torch.bfloat16)
    assert fa._strides(c) == (100 * 4 * 32, 4 * 32, 32)
    one = torch.zeros((1, 100, 4, 64), dtype=torch.bfloat16).as_strided(
        (1, 100, 4, 64), (3, 256, 64, 1))
    assert fa._strides(one) == (100 * 256, 256, 64)
    for t in (q, k, c, one):
        fa._check_tma(t, fa._strides(t))


def test_tma_check_raises_on_what_tma_cannot_read():
    """Runs on the CPU: a head stride of 136 bytes and a base 2 bytes off a
    16-byte boundary."""
    x = torch.zeros((2, 8, 2, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_tma(x, fa._strides(x))
    x = torch.zeros(1 + 2 * 8 * 2 * 64, dtype=torch.bfloat16)[1:].view(2, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_tma(x, fa._strides(x))


@pytest.mark.cuda
def test_nn1_kernel_matches_plain_at_backfill_shape(cuda_device):
    """65,536 queries against the 150,000-point clustering subsample: the
    kernel and the plain version round alike, so the indices are equal."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ref = torch.randn((150_000, 8), generator=gen, device=cuda_device)
    qry = torch.randn((65_536, 8), generator=gen, device=cuda_device)
    n = nn1_mod.nn1.launches
    out = nn1_mod.nn1(qry, ref)
    torch.cuda.synchronize()
    assert nn1_mod.nn1.launches == n + 1
    assert torch.equal(out, nn1_mod.nn1_plain(qry, ref))


@pytest.mark.cuda
def test_nn1_kernel_ties_go_to_the_smallest_index(cuda_device):
    """Duplicated refs (ties) and queries that hit a ref exactly, with a
    ragged last reference tile and a ragged last query block."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ref = torch.randn((2_500, 8), generator=gen, device=cuda_device)
    ref[1_250:1_280] = ref[:30]
    qry = torch.randn((1_000, 8), generator=gen, device=cuda_device)
    qry[:50] = ref[10:60]
    out = nn1_mod.nn1(qry, ref)
    assert torch.equal(out, nn1_mod.nn1_plain(qry, ref))
    assert torch.equal(out[:20].cpu(), torch.arange(10, 30))


def _nn1_equal_to_plain(qry, ref):
    """One wrapper call: equal to the plain version, one launch counted."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    n = nn1_mod.nn1.launches
    out = nn1_mod.nn1(qry, ref)
    torch.cuda.synchronize()
    assert nn1_mod.nn1.launches == n + 1
    assert torch.equal(out, nn1_mod.nn1_plain(qry, ref))
    return out


@pytest.mark.cuda
def test_nn1_kernel_near_ties(cuda_device):
    """4,096 unit queries with 16 references each at q + eps v (eps 1e-4 to
    1e-3) among 150,000: the TF32 filter's rounding reorders the nearest
    ones, the exact recheck must not."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    qry = torch.randn((4_096, 8), generator=gen, device=cuda_device)
    qry /= qry.norm(dim=1, keepdim=True)
    ref = torch.randn((150_000, 8), generator=gen, device=cuda_device)
    ref /= ref.norm(dim=1, keepdim=True)
    v = torch.randn((4_096, 16, 8), generator=gen, device=cuda_device)
    v /= v.norm(dim=2, keepdim=True)
    eps = 1e-4 + 9e-4 * torch.rand((4_096, 16, 1), generator=gen, device=cuda_device)
    where = torch.randperm(150_000, generator=gen, device=cuda_device)[:4_096 * 16]
    ref[where] = (qry[:, None] + eps * v).reshape(-1, 8)
    out = _nn1_equal_to_plain(qry, ref)
    assert torch.isin(out, where).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 63, 65, 129])
@pytest.mark.parametrize("R", [1, 127, 129, 2_500])
def test_nn1_kernel_ragged_sizes(cuda_device, Q, R):
    """Query blocks (256 rows, m64 tiles) and reference stages (256 rows,
    64-row sub-tiles) cut off anywhere."""
    gen = torch.Generator(device=cuda_device).manual_seed(5 + Q + R)
    _nn1_equal_to_plain(torch.randn((Q, 8), generator=gen, device=cuda_device),
                        torch.randn((R, 8), generator=gen, device=cuda_device))


@pytest.mark.cuda
def test_nn1_kernel_duplicates_across_tiles(cuda_device):
    """Copies of a reference in other sub-tiles, stages and thread columns:
    the smallest index wins, however the four threads of a row split them."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    ref = torch.randn((3_000, 8), generator=gen, device=cuda_device)
    src = torch.arange(5, 45, device=cuda_device)
    for shift in (41, 64, 257, 1_003, 2_550):      # other columns, sub-tiles, stages
        ref[src + shift] = ref[src]
    qry = torch.cat([ref[src], torch.randn((200, 8), generator=gen, device=cuda_device)])
    out = _nn1_equal_to_plain(qry, ref)
    assert torch.equal(out[:40], src)


@pytest.mark.cuda
def test_nn1_kernel_rows_past_the_filter_range(cuda_device):
    """NaN-free rows with |x|^2 past 2^60 take the exact chain over every
    reference inside the kernel: a huge query row alone, then a huge
    reference row (every query row then)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ref = torch.randn((2_000, 8), generator=gen, device=cuda_device)
    qry = torch.randn((300, 8), generator=gen, device=cuda_device)
    qry[7] = 2.0 ** 31
    qry[8] = ref[1_500] * 3.0e18
    _nn1_equal_to_plain(qry, ref)
    ref[11] = -(2.0 ** 31)
    _nn1_equal_to_plain(qry, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("io", [("bfloat16", "bfloat16"), ("float32", "float32"),
                                ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("shape", [(1001, 64), (37, 1024), (5, 2048), (3, 7, 264)])
def test_fused_ln_kernel_matches_plain(cuda_device, monkeypatch, io, shape):
    """Ragged row counts (partial last block of 8 rows), D from 64 to 2048 (1
    to 8 chunks per lane), a 3-D input; bit-equal to the plain version."""
    from iggt_official_tpu_torch.ops import fused_ln

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    D = shape[-1]
    x = (3 * torch.randn(shape, generator=gen, device=cuda_device) + 1).to(getattr(torch, io[0]))
    w = 1 + 0.1 * torch.randn((D,), generator=gen, device=cuda_device)
    b = 0.1 * torch.randn((D,), generator=gen, device=cuda_device)
    want = fused_ln.fused_layernorm_plain(x, w, b, 1e-6, getattr(torch, io[1]))

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(fused_ln, "fused_layernorm_plain", no_plain)
    n = fused_ln.fused_layernorm.launches
    out = fused_ln.fused_layernorm(x, w, b, 1e-6, getattr(torch, io[1]))
    torch.cuda.synchronize()
    assert fused_ln.fused_layernorm.launches == n + 1
    assert out.dtype == want.dtype and out.shape == want.shape
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_fused_ln_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm

    w = torch.ones(12, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_layernorm(torch.zeros((4, 12), device=cuda_device), w, w)
    w = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fused_layernorm(torch.zeros((4, 16), device=cuda_device, dtype=torch.float16), w, w)


@pytest.mark.cuda
def test_bucket_topk_kernel_matches_plain(cuda_device, monkeypatch):
    """Ties inside a bucket (the smaller index) and between buckets (the
    lower bucket position), a ragged last row of references, nb = 256."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ref = torch.randn((3_000, 8), generator=gen, device=cuda_device)
    ref[2_560:2_570] = ref[:10]           # 2,560 = 10 * 256: the same buckets
    ref[1_000:1_010] = ref[20:30]
    qry = torch.cat([ref[:40], torch.randn((2_000, 8), generator=gen, device=cuda_device)])
    want = nn1_mod.bucket_topk_plain(qry, ref, 32, 256)
    monkeypatch.setattr(nn1_mod, "bucket_topk_plain", lambda *a: 1 / 0)
    n = nn1_mod.bucket_minima_kernel.launches
    dist, idx = nn1_mod.bucket_topk(qry, ref, 32, 256)
    torch.cuda.synchronize()
    assert nn1_mod.bucket_minima_kernel.launches == n + 1
    assert torch.equal(idx, want[1]) and torch.equal(dist, want[0])
    assert torch.equal(idx[:10, 0].cpu(), torch.arange(10))


@pytest.mark.cuda
def test_bucket_minima_kernel_counts_every_launch(cuda_device):
    """Past 65,535 blocks of 16 queries the C side launches again; each
    launch counts once, and the second launch's queries are right."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    ref = torch.randn((40, 8), generator=gen, device=cuda_device)
    qry = torch.randn((65_535 * 16 + 100, 8), generator=gen, device=cuda_device)
    n = nn1_mod.bucket_minima_kernel.launches
    bd, bi = nn1_mod.bucket_minima_kernel(qry, ref, 8)
    torch.cuda.synchronize()
    assert nn1_mod.bucket_minima_kernel.launches == n + 2
    tail = qry[-5_000:]
    want_d, want_i = nn1_mod.bucket_minima_plain(tail, ref, 8)
    assert torch.equal(bi[-5_000:], want_i) and torch.equal(bd[-5_000:], want_d)
