"""The plain reference against the port on the CPU at test widths, equal seeded
weights on both sides, and the FLOP counts against `FlopCounterMode`."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import flops, program
from perfbench.tests.scaled import CHECKOUT, scaled_model

CONFIGS = ("iggt-1b", "vggt-1b")


def model_of(name: str, trunk_dtype: str = "float32") -> dict:
    cfg = json.loads((CHECKOUT / "perfbench" / "configs" / f"{name}.json").read_text())
    return scaled_model(cfg["model"], trunk_dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_equal_weights_both_sides(name):
    model = model_of(name)
    port = program.build_program(model, "cpu", seed=2**33 + 7)
    ref = program.build_reference(model, "cpu", seed=2**33 + 7)
    port_params = dict(port.named_parameters())
    ref_params = dict(ref.named_parameters())
    assert set(ref_params) <= set(port_params)
    for n, p in ref_params.items():
        assert torch.equal(p, port_params[n]), n
    other = program.build_reference(model, "cpu", seed=2**33 + 8)
    assert not torch.equal(dict(other.named_parameters())["aggregator.camera_token"],
                           ref_params["aggregator.camera_token"])


@pytest.mark.parametrize("name,hw", [("iggt-1b", (56, 56)), ("vggt-1b", (42, 56))])
def test_reference_matches_port_fp32(name, hw):
    """Both in fp32: the reference is the port's arithmetic (1e-5 of the
    largest value; the bilinear resizes sum in another order)."""
    model = model_of(name)
    port = program.build_program(model, "cpu", seed=5)
    ref = program.build_reference(model, "cpu", seed=5)
    images = torch.rand((1, 3, *hw, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = port(images)
        want = ref(images)
    assert set(want) <= set(out)
    pairs = [(k, out[k], v) for k, v in want.items() if k != "pose_enc_list"]
    pairs += [(f"pose_enc_list[{i}]", a, b)
              for i, (a, b) in enumerate(zip(out["pose_enc_list"], want["pose_enc_list"]))]
    for k, got, v in pairs:
        gap = float((got.float() - v).abs().max() / v.abs().max())
        assert gap < 1e-5, (k, gap)


@pytest.mark.parametrize("name,shape", [("iggt-1b", (2, 56, 56)), ("vggt-1b", (3, 42, 70))])
def test_flops_equal_flop_counter(name, shape):
    """At test widths and at a patch grid other than the trained one (the
    position embedding's resize) the count from shapes equals what
    FlopCounterMode counts on the reference."""
    model = model_of(name)
    ref = program.build_reference(model, "cpu", seed=3)
    S, H, W = shape
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ref(torch.rand((1, S, H, W, 3)))
    assert counter.get_total_flops() == sum(flops.forward_flops(model, S, H, W).values())


def test_attention_bound():
    call = flops.AttentionCall(1, 10992, 10992, 16, 64, True)
    assert call.ops() == 4 * 16 * 10992 ** 2 * 64
    assert call.bound_s() == pytest.approx(call.ops() / 989e12)
