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
ulp of max|ref|.  The fp32 kernel runs three TF32 passes on split operands
(2^-20 |x||y| per product) and adds each key tile's P.V to O in fp32; its
errors seen are under 3e-6.  The limit scales with the output because attention outputs
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
@pytest.mark.parametrize("nq,nk", RAGGED)
def test_fp32_flash_kernel_ragged_lengths(cuda_device, D, nq, nk):
    """The TF32 kernel at ragged lengths (TMA zero-fills q/k rows past N, the
    prep kernel zero-pads V^T to 64 keys, keys past Nk are masked), with and
    without a key bias, plain and after the q/k prep."""
    q, _, _, _, norm = _qkv(cuda_device, torch.float32, B=2, N=nq, H=3, D=D, seed=9)
    _, k, v, bias, _ = _qkv(cuda_device, torch.float32, B=2, N=nk, H=3, D=D, seed=10)
    _assert_close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v))
    _assert_close(fa.flash_attention(q, k, v, bias), fa.flash_attention_plain(q, k, v, bias))
    n = max(nq, nk)
    pos = rope.make_patch_positions(1, n, 2, 0, device=cuda_device)
    cos, sin = rope.pack_rope_tables(rope.compute_rope_2d(pos, D))
    ref = fa.flash_attention_plain(fa.qk_prep_plain(q, norm[0], norm[1], cos, sin),
                                   fa.qk_prep_plain(k, norm[2], norm[3], cos, sin), v, bias)
    _assert_close(fa.flash_attention_fused(q, k, v, cos, sin, norm, bias), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64])
def test_fp32_flash_kernel_reads_strided_views(cuda_device, D):
    """fp32 q/k/v as strided views of one packed qkv give the same bits as
    contiguous copies (the prep kernel reads them in place)."""
    q, k, v, bias, _ = _qkv(cuda_device, torch.float32, B=2, N=300, H=4, D=D, seed=11)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, bias)
    assert torch.equal(out, fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                               bias))
    _assert_close(out, fa.flash_attention_plain(q, k, v, bias))


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


def _bf16_ulp(x: torch.Tensor, floor: float) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at max(|x|, floor)."""
    exp = torch.floor(torch.log2(x.abs().clamp_min(floor)))
    return torch.exp2(exp - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("nq,nk", [(1, 1), (65, 65), (1374, 1374), (2607, 1601), (63, 129)])
def test_qk_prep_kernel_alone_matches_plain(cuda_device, monkeypatch, dtype, D, nq, nk):
    """The prep kernel launched alone (token merging's route) on strided
    q/k views at ragged lengths, Nq != Nk both ways: contiguous outputs
    within one bf16 ulp of `qk_prep_plain` (both prep in fp32 and round
    once; the spacing counted at |x| >= 1/64, since their fp32 sums differ
    by ~1e-6 and RoPE's two terms can cancel to a result that small), fp32
    within 1e-5; one launch per call, and the plain version is never taken
    on the card."""
    tdt = getattr(torch, dtype)
    q, _, _, _, norm = _qkv(cuda_device, tdt, B=2, N=nq, H=3, D=D, seed=12)
    _, k, _, _, _ = _qkv(cuda_device, tdt, B=2, N=nk, H=3, D=D, seed=13)
    pos = rope.make_patch_positions(1, max(nq, nk), 2, 0, device=cuda_device)
    cos, sin = rope.pack_rope_tables(rope.compute_rope_2d(pos, D))
    ref_q = fa.qk_prep_plain(q, norm[0], norm[1], cos, sin).float()
    ref_k = fa.qk_prep_plain(k, norm[2], norm[3], cos, sin).float()
    monkeypatch.setattr(fa, "qk_prep_plain", _raise)
    n = fa.qk_prep.launches
    out_q, out_k = fa.qk_prep(q, k, cos, sin, norm)
    assert fa.qk_prep.launches == n + 1
    for out, ref in ((out_q, ref_q), (out_k, ref_k)):
        assert out.is_contiguous() and out.dtype == tdt and out.shape == ref.shape
        err = (out.float() - ref).abs()
        if dtype == "bfloat16":
            ulp = _bf16_ulp(torch.maximum(out.float().abs(), ref.abs()), 2.0 ** -6)
            assert bool((err <= ulp).all()), (err / ulp).max().item()
        else:
            assert err.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
def test_key_biased_flash_kernel_at_merged_lengths(cuda_device, dtype, D):
    """The merged global blocks' call: full-length q (prepped, contiguous)
    against merged, contiguous k/v with Nk != Nq and both ragged, and an fp32
    log-size key bias."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    for nq, nk in ((2607, 1601), (1000, 999), (129, 65)):
        q, k, v = (torch.randn((1, n, 4, D), generator=gen, device=cuda_device).to(tdt)
                   for n in (nq, nk, nk))
        sizes = torch.randint(1, 6, (1, nk), generator=gen, device=cuda_device)
        bias = torch.log(sizes.float())
        n = fa.flash_attention.launches
        _assert_close(fa.flash_attention(q, k, v, bias),
                      fa.flash_attention_plain(q, k, v, bias))
        assert fa.flash_attention.launches == n + 1


def _raise(*args, **kwargs):
    raise AssertionError("a plain version was taken on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["bfloat16", "float32"])
def test_merged_forwards_are_equal_bytes(cuda_device, monkeypatch, trunk):
    """A scaled IGGT on the card, 3 views at 112x154 px, merged at r = 40:
    two forwards give equal bytes in every output (the merge sums in a fixed
    order), each launches the kernels of the merged route (per forward: one
    fused call per frame block, one prep-only and one key-biased flash call
    per global block, one flash call per DINOv2 block and for the part head)
    and never a plain version."""
    import dataclasses

    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.models.vggt import build_model

    cfg = dataclasses.replace(
        ModelConfig().scaled(embed_dim=128, depth=2, num_heads=2, vit_depth=1, img_size=112),
        trunk_dtype=trunk)
    model = build_model(cfg, cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x = torch.rand((1, 3, 112, 154, 3), generator=gen, device=cuda_device)
    for name in ("qk_prep_plain", "flash_attention_plain"):
        monkeypatch.setattr(fa, name, _raise)
    counts = []
    outs = []
    with torch.inference_mode():
        for _ in range(2):
            before = (fa.flash_attention_fused.launches, fa.qk_prep.launches,
                      fa.flash_attention.launches)
            outs.append(model(x, global_merge_r=40))
            torch.cuda.synchronize()
            counts.append((fa.flash_attention_fused.launches - before[0],
                           fa.qk_prep.launches - before[1],
                           fa.flash_attention.launches - before[2]))
    assert counts[0] == counts[1] == (2, 2, 2 + 1 + 1)
    for key, value in outs[0].items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, outs[1][key]), key


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
    """One launch of the bucket filter kernel per call, at any Q (here over a
    million queries, 8,193 query tiles); the last queries' minima are right."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    ref = torch.randn((40, 8), generator=gen, device=cuda_device)
    qry = torch.randn((65_535 * 16 + 100, 8), generator=gen, device=cuda_device)
    n = nn1_mod.bucket_minima_kernel.launches
    bd, bi = nn1_mod.bucket_minima_kernel(qry, ref, 8)
    torch.cuda.synchronize()
    assert nn1_mod.bucket_minima_kernel.launches == n + 1
    tail = qry[-5_000:]
    want_d, want_i = nn1_mod.bucket_minima_plain(tail, ref, 8)
    assert torch.equal(bi[-5_000:], want_i) and torch.equal(bd[-5_000:], want_d)


def _bucket_near_ties(device, Q, R, nb, seed):
    """Unit queries, each with 4 references within 1e-4 to 1e-3 of it, exact
    duplicates in a later chunk of the same bucket, and queries on them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qry = torch.randn((Q, 8), generator=gen, device=device)
    qry /= qry.norm(dim=1, keepdim=True)
    ref = torch.randn((R, 8), generator=gen, device=device)
    ref /= ref.norm(dim=1, keepdim=True)
    v = torch.randn((Q, 4, 8), generator=gen, device=device)
    v /= v.norm(dim=2, keepdim=True)
    eps = 1e-4 + 9e-4 * torch.rand((Q, 4, 1), generator=gen, device=device)
    planted = (qry[:, None] + eps * v).reshape(-1, 8)[:R // 2]
    ref[torch.randperm(R, generator=gen, device=device)[:planted.shape[0]]] = planted
    if R > 3 * nb:
        dup = torch.arange(min(nb, 16, Q), device=device)
        ref[2 * nb + dup] = ref[dup]
        qry[:dup.numel()] = ref[dup]
    return qry, ref


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 48, 64, 1000, 1024, 2048])
@pytest.mark.parametrize("Q,R", [(1, 2_731), (1_001, 2_731), (129, 4_100)])
def test_bucket_minima_kernel_near_ties_ragged(cuda_device, Q, R, nb):
    """Any nb > 0 (a partial last 64-bucket group, nb not a multiple of 64,
    one bucket), ragged Q and R, near ties and duplicates across chunks:
    equal indices and distances."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    qry, ref = _bucket_near_ties(cuda_device, Q, R, nb, seed=Q + R + nb)
    bd, bi = nn1_mod.bucket_minima_kernel(qry, ref, nb)
    want_d, want_i = nn1_mod.bucket_minima_plain(qry, ref, nb)
    assert torch.equal(bi, want_i) and torch.equal(bd, want_d)


@pytest.mark.cuda
def test_bucket_minima_kernel_exact_path(cuda_device):
    """Rows beyond the filter's range recheck every pair: a reference with
    |r|^2 > 2^60 puts every query on the exact path, a query with |q|^2 >
    2^60 puts only its own row there.  Equal indices and distances."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ref = torch.randn((2_000, 8), generator=gen, device=cuda_device)
    qry = torch.randn((500, 8), generator=gen, device=cuda_device)
    far_ref = ref.clone()
    far_ref[777, 3] = 3e9
    far_qry = qry.clone()
    far_qry[5, 0] = 3e9
    for q, r in ((qry, far_ref), (far_qry, ref)):
        bd, bi = nn1_mod.bucket_minima_kernel(q, r, 100)
        want_d, want_i = nn1_mod.bucket_minima_plain(q, r, 100)
        assert torch.equal(bi, want_i) and torch.equal(bd, want_d)


@pytest.mark.cuda
def test_bucket_minima_kernel_more_buckets_than_references(cuda_device):
    """nb > R: the empty buckets hold +inf and their own index."""
    from iggt_official_tpu_torch.ops import nn1 as nn1_mod

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    ref = torch.randn((1_000, 8), generator=gen, device=cuda_device)
    qry = torch.randn((300, 8), generator=gen, device=cuda_device)
    bd, bi = nn1_mod.bucket_minima_kernel(qry, ref, 4_096)
    want_d, want_i = nn1_mod.bucket_minima_plain(qry, ref, 4_096)
    assert torch.equal(bi, want_i) and torch.equal(bd, want_d)
    assert torch.isinf(bd[:, 1_000:]).all()
    assert torch.equal(bi[:, 1_000:].cpu(), torch.arange(1_000, 4_096).expand(300, -1))
