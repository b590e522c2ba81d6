"""The 3x3 convolution kernel (`csrc/conv3x3.cu`) and its routing in
`ops/conv.py`.

On the CPU: which `Conv2d` calls `conv3x3_routes` sends to the kernel, and
that every call equals `F.conv2d` there (the CPU path is unchanged); the
weight planes' repack and TF32 split in plain PyTorch; the CPU wrapper; and
the kernel's arithmetic (three TF32 passes on split operands) emulated in
float64, against one pass.

On the card (marked ``cuda``, skipped inside a fixture where there is none):
the kernel against a float64 convolution at every (input channels, output
channels, map) the heads route to it in the benchmark's two cells, and on
ragged tiles, odd widths and one-pixel maps: its error (largest gap over the
largest value) at most twice cuDNN fp32's own on the same inputs, with one
TF32 pass (a planted fault) above that; the outputs' mean shrink toward zero
(`_shrink`) on ReLU'd maps within `SHRINK_LIMIT`, with one tensor-core chain
per A slot (a planted fault: truncated sums piled up) beyond it; two calls
byte-equal; the launch counter; and the launches of one full-width 8-view
518 px IGGT forward.
This file imports no JAX, so it runs on the card alone:

    python -m pytest tests/test_torch_conv3x3.py --noconftest -q
"""

import itertools

import pytest
import torch
import torch.nn.functional as F

from iggt_official_tpu_torch.ops import conv as cv
from iggt_official_tpu_torch.ops.conv import (
    Conv2d, ConvTranspose2d, conv3x3, conv3x3_plain, conv3x3_routes, split_tf32_plain,
    split_weights_plain,
)

# (input channels, output channels, H, W) of every routed head convolution:
# IGGT at 8 views 518 px (patch grid 37), then VGGT at 64 views 504x336
# (patch grid 24 x 36, the DPT heads 8 views a chunk)
HEAD_SHAPES = (
    (256, 256, 148, 148), (256, 256, 74, 74), (256, 256, 37, 37), (256, 256, 19, 19),
    (512, 256, 74, 74), (1024, 256, 37, 37), (1024, 256, 19, 19), (256, 128, 296, 296),
    (128, 32, 518, 518), (256, 64, 148, 148), (64, 256, 148, 148), (128, 42, 296, 296),
    (128, 128, 296, 296), (128, 64, 296, 296), (64, 128, 296, 296),
    (256, 256, 96, 144), (256, 256, 48, 72), (256, 256, 24, 36), (256, 256, 12, 18),
    (512, 256, 48, 72), (1024, 256, 24, 36), (1024, 256, 12, 18), (256, 128, 192, 288),
    (128, 32, 336, 504),
)
# (N, H, W, Cin, Cout, bias): tiles cut by the batch's end, output channels
# not a multiple of 8 or odd, one-pixel and one-column-wide maps
EDGE_SHAPES = (
    (3, 13, 21, 64, 42, True), (2, 7, 5, 32, 5, False), (1, 1, 1, 32, 8, True),
    (5, 9, 33, 96, 130, True), (2, 130, 3, 32, 256, False), (4, 17, 1, 64, 64, True),
)
IGGT_8x518_LAUNCHES = 77   # 20 per DPT head (depth, point), 37 in the part head
# (N, H, W, Cin, Cout) of the shrink check: millions of outputs each, so the
# rounding's own scatter averages out far below the limit
SHRINK_SHAPES = ((2, 74, 74, 256, 256), (1, 296, 296, 128, 64), (2, 37, 37, 1024, 256))
# The tensor cores' fp32 sums truncate toward zero, so every add into a chain
# shrinks it a little: the shrink grows with the chains' length.  On an H100,
# at these shapes: cuDNN fp32 (rounded to nearest) 3e-9 at most; the kernel's
# chains of one tap -7.5e-8; one chain per A slot -5.4e-7 to -5.7e-7 (a
# version that gave the heads' outputs up to 3.4e-5, above fp32's 3e-5).
SHRINK_LIMIT = 2e-7


# ---------------------------------------------------------------------------
# CPU


@pytest.fixture
def tf32_off():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


def test_routing_rule(tf32_off):
    """A call is routed exactly when every condition holds; each one alone
    turning false sends it to F.conv2d."""
    base = dict(device_type="cuda", dtype=torch.float32, kernel_size=(3, 3), stride=(1, 1),
                padding=(1, 1), dilation=(1, 1), groups=1, in_channels=256)
    others = dict(device_type=("cpu", "meta"), dtype=(torch.bfloat16, torch.float16),
                  kernel_size=((1, 1), (7, 7), (3, 1)), stride=((2, 2), (1, 2)),
                  padding=((0, 0), (2, 2), "same"), dilation=((2, 2),), groups=(2, 256),
                  in_channels=(42, 3, 1024 + 16))
    with torch.no_grad():
        assert conv3x3_routes(**base)
        assert conv3x3_routes(**dict(base, in_channels=32))
        for key, values in others.items():
            for v in values:
                assert not conv3x3_routes(**dict(base, **{key: v})), (key, v)
    with torch.enable_grad():
        assert not conv3x3_routes(**base)
    torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        assert not conv3x3_routes(**base)


@pytest.mark.parametrize("grad,tf32", list(itertools.product((False, True), repeat=2)))
def test_routing_by_mode(grad, tf32):
    """Grad mode and TF32 convolutions as the training step (grad on, TF32
    on), SAM2 (TF32 on), IGGTProcessor's inference (both off) leave them."""
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.set_grad_enabled(grad):
            got = conv3x3_routes("cuda", torch.float32, (3, 3), (1, 1), (1, 1), (1, 1), 1, 64)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got == (not grad and not tf32)


CPU_CONVS = (  # (Cin, Cout, kernel, stride, padding, compute dtype)
    (64, 32, 3, 1, 1, torch.float32), (42, 128, 3, 1, 1, torch.float32),
    (64, 64, 3, 2, 1, torch.float32), (64, 16, 1, 1, 0, torch.float32),
    (3, 32, 14, 14, 0, torch.float32), (64, 32, 3, 1, 1, torch.bfloat16),
    (32, 8, 7, 4, 3, torch.float32),
)


@pytest.mark.parametrize("cin,cout,k,stride,pad,dtype", CPU_CONVS)
def test_cpu_conv2d_equals_f_conv2d(tf32_off, cin, cout, k, stride, pad, dtype):
    """On the CPU every Conv2d call is F.conv2d, bit for bit, and launches
    nothing, the routed shape included."""
    gen = torch.Generator().manual_seed(cin * 7 + cout + k)
    x = torch.randn((2, 29, 31, cin), generator=gen)
    m = Conv2d(cin, cout, k, stride=stride, padding=pad, dtype=dtype)
    before = conv3x3.launches
    with torch.no_grad():
        got = m(x)
        want = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), m.weight.to(dtype),
                        m.bias.to(dtype), m.stride, m.padding).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    assert conv3x3.launches == before


def test_cpu_conv_transpose_unrouted(tf32_off):
    m = ConvTranspose2d(32, 32, 4, stride=2, padding=1)
    x = torch.randn((1, 6, 5, 32))
    with torch.no_grad():
        want = F.conv_transpose2d(x.permute(0, 3, 1, 2), m.weight, m.bias, 2, 1)
        assert torch.equal(m(x), want.permute(0, 2, 3, 1))


def _tf32_reference(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to 10 mantissa bits, to nearest, ties away from zero,
    through float64 arithmetic on the magnitude."""
    m, e = torch.frexp(x.double().abs())          # |x| = m 2^e, m in [0.5, 1)
    r = torch.floor(m * 2 ** 11 + 0.5) / 2 ** 11
    return (torch.sign(x.double()) * torch.ldexp(r, e)).float()


def test_split_tf32_plain():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=gen) * torch.exp2(torch.randint(-30, 30, (4096,),
                                                                   generator=gen).float())
    # ties: exactly half an ulp of TF32 above a TF32 value, either sign
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 3 * (1 + 2 ** -11), 0.0, -0.0])
    x = torch.cat([x, ties])
    hi, lo = split_tf32_plain(x)
    assert torch.equal(hi + lo, x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi, _tf32_reference(x))
    assert hi[-5].item() == 1 + 2 ** -10 and hi[-4].item() == -(1 + 2 ** -10)
    big = torch.tensor([torch.finfo(torch.float32).max, float("inf")])
    bhi, blo = split_tf32_plain(big)
    assert torch.equal(bhi, big) and torch.equal(blo, torch.zeros(2))


def test_split_weights_plain_order():
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((6, 40, 3, 3), generator=gen)
    hi, lo = split_weights_plain(w)
    assert hi.shape == lo.shape == (6, 3, 3, 40)
    assert torch.equal(hi + lo, w.permute(0, 2, 3, 1))
    for co, dy, dx, ci in ((0, 0, 0, 0), (5, 2, 1, 39), (3, 1, 2, 17)):
        assert hi[co, dy, dx, ci] == _tf32_reference(w[co, ci, dy, dx].reshape(1))[0]


def test_cpu_wrapper_equals_conv2d():
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((2, 9, 7, 64), generator=gen)
    w = torch.randn((24, 64, 3, 3), generator=gen)
    b = torch.randn((24,), generator=gen)
    want = F.conv2d(x.permute(0, 3, 1, 2), w, b, 1, 1).permute(0, 2, 3, 1)
    assert torch.equal(conv3x3(x, w, b), want)
    assert torch.equal(conv3x3_plain(x, w, None),
                       F.conv2d(x.permute(0, 3, 1, 2), w, None, 1, 1).permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="requires grad"):
        conv3x3(x, w.requires_grad_(True), b)


def _conv64(x, w):
    return F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), None, 1, 1).permute(0, 2, 3, 1)


def _trunc_tf32(t: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: the low 13 bits dropped."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_three_pass_arithmetic():
    """The kernel's products, summed in float64: both operands split exactly,
    lo read truncated to TF32, hi.lo + lo.hi + hi.hi.  Within 2^-20 of the
    largest output, where one pass (hi.hi) is not within 2^-14."""
    gen = torch.Generator().manual_seed(13)
    x = torch.randn((2, 11, 13, 96), generator=gen)
    w = torch.randn((40, 96, 3, 3), generator=gen) / (3 * 96 ** 0.5)
    xh, xl = split_tf32_plain(x)
    wh, wl = split_tf32_plain(w)
    xl, wl = _trunc_tf32(xl), _trunc_tf32(wl)
    ref = _conv64(x, w)
    three = _conv64(xh, wl) + _conv64(xl, wh) + _conv64(xh, wh)
    one = _conv64(xh, wh)
    scale = ref.abs().max()
    assert ((three - ref).abs().max() / scale).item() < 2 ** -20
    assert ((one - ref).abs().max() / scale).item() > 2 ** -14


# ---------------------------------------------------------------------------
# card


@pytest.fixture
def cuda_device(tf32_off):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _err(out, ref64) -> float:
    return ((out.double() - ref64).abs().max() / ref64.abs().max()).item()


def _shrink(out, ref64) -> float:
    """The outputs' mean signed gap toward zero over their mean magnitude:
    mean((out - ref) sign(ref)) / mean |ref|, negative where sums shrink."""
    return ((out.double() - ref64).mul(ref64.sign()).mean() / ref64.abs().mean()).item()


def _inputs(N, H, W, Cin, Cout, bias, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, H, W, Cin), generator=gen, device="cuda")
    w = torch.randn((Cout, Cin, 3, 3), generator=gen, device="cuda") / (3 * Cin ** 0.5)
    b = torch.randn((Cout,), generator=gen, device="cuda") if bias else None
    return x, w, b


def _check_against_float64(N, H, W, Cin, Cout, bias):
    x, w, b = _inputs(N, H, W, Cin, Cout, bias, seed=N * H + W * Cin + Cout)
    with torch.inference_mode():
        out = conv3x3(x, w, b)
        ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(),
                       None if b is None else b.double(), 1, 1).permute(0, 2, 3, 1)
        limit = 2 * _err(conv3x3_plain(x, w, b), ref)
        one_pass = cv._launch(x, w, b, fault=1)
    assert out.shape == (N, H, W, Cout)
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= limit
    assert _err(one_pass, ref) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,h,w", HEAD_SHAPES)
def test_kernel_matches_float64_at_head_shapes(cuda_device, cin, cout, h, w):
    _check_against_float64(2 if h * w <= 148 * 148 else 1, h, w, cin, cout, True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,bias", EDGE_SHAPES)
def test_kernel_edges(cuda_device, n, h, w, cin, cout, bias):
    _check_against_float64(n, h, w, cin, cout, bias)


@pytest.mark.cuda
def test_kernel_zero_border(cuda_device):
    """A map that is zero inside and large on its border rows and columns:
    the taps that fall outside the image read zeros, not the next row or
    the next image."""
    x = torch.zeros((3, 10, 12, 32), device="cuda")
    x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1] = 1e3, -1e3, 2e3, -2e3
    w = torch.randn((16, 32, 3, 3), device="cuda")
    with torch.inference_mode():
        out = conv3x3(x, w)
        ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), None, 1, 1).permute(0, 2, 3, 1)
    assert _err(out, ref) <= 2 * _err(conv3x3_plain(x, w), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", SHRINK_SHAPES)
def test_kernel_does_not_shrink(cuda_device, n, h, w, cin, cout):
    """On ReLU'd maps (as the heads' residual units feed them) the kernel's
    outputs keep their size on average, as cuDNN fp32's do; one chain per A
    slot does not."""
    x, wt, _ = _inputs(n, h, w, cin, cout, False, seed=7 * cin + cout)
    x = x.relu()
    with torch.inference_mode():
        ref = _conv64(x, wt)
        shrink = _shrink(conv3x3(x, wt), ref)
        cudnn = _shrink(conv3x3_plain(x, wt), ref)
        slot = _shrink(cv._launch(x, wt, None, fault=2), ref)
    assert abs(cudnn) <= SHRINK_LIMIT
    assert abs(shrink) <= SHRINK_LIMIT
    assert slot < -SHRINK_LIMIT


@pytest.mark.cuda
def test_kernel_byte_equal(cuda_device):
    x, w, b = _inputs(8, 74, 74, 256, 256, True)
    with torch.inference_mode():
        assert torch.equal(conv3x3(x, w, b), conv3x3(x, w, b))


@pytest.mark.cuda
def test_launch_counter(cuda_device):
    m = Conv2d(64, 32, 3, padding=1).cuda()
    x = torch.randn((2, 9, 9, 64), device="cuda")
    start = conv3x3.launches
    with torch.inference_mode():
        m(x)
        assert conv3x3.launches == start + 1
        Conv2d(64, 32, 3, stride=2, padding=1).cuda()(x)
        Conv2d(64, 32, 1).cuda()(x)
        torch.backends.cudnn.allow_tf32 = True
        m(x)
        torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        m(x)
    assert conv3x3.launches == start + 2


@pytest.mark.cuda
def test_launches_per_iggt_8x518_forward(cuda_device):
    from iggt_official_tpu_torch.config import ModelConfig
    from iggt_official_tpu_torch.models.vggt import IGGT

    torch.manual_seed(0)
    with torch.device("cuda"):
        model = IGGT(ModelConfig()).eval().requires_grad_(False)
    x = torch.rand((1, 8, 518, 518, 3), device="cuda")
    start = conv3x3.launches
    with torch.inference_mode():
        model(x)
    assert conv3x3.launches - start == IGGT_8x518_LAUNCHES
