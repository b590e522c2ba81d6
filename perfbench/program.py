"""What the benchmark takes from the measured program, `iggt_official_tpu_torch`.

The model classes, their configuration dataclasses, the kernel build and the
kernels' launch counters; nothing else of the program is read.  Models are
built on the device with the layers' own random initialization skipped,
then filled by `perfbench/weights.py`, as is the plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import typing
from typing import Dict

import torch
from torch import nn

from perfbench import weights
from perfbench.reference.model import Reference

# parameters of the program that no cell's forward reads (VGGT's track head
# runs only with query points): zero-filled, not drawn
UNUSED_PREFIXES = ("track_head.",)


@contextlib.contextmanager
def no_layer_init():
    """Skip nn.Linear / conv ``reset_parameters`` while a model is built: the
    seeded fill writes every parameter afterwards."""
    saved = (nn.Linear.reset_parameters, nn.modules.conv._ConvNd.reset_parameters)
    nn.Linear.reset_parameters = nn.modules.conv._ConvNd.reset_parameters = lambda self: None
    try:
        yield
    finally:
        nn.Linear.reset_parameters, nn.modules.conv._ConvNd.reset_parameters = saved


def _tuples(x):
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return x


def _build(cls, d: Dict):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            raise ValueError(f"{cls.__name__}.{f.name} is missing from the configuration file")
        v = d[f.name]
        kwargs[f.name] = _build(hints[f.name], v) if dataclasses.is_dataclass(hints[f.name]) \
            else _tuples(v)
    extra = set(d) - {f.name for f in dataclasses.fields(cls)}
    if extra:
        raise ValueError(f"{cls.__name__} has no fields {sorted(extra)}")
    return cls(**kwargs)


def model_config(model: Dict):
    """The program's `ModelConfig` holding exactly the file's ``model`` group."""
    from iggt_official_tpu_torch.config import ModelConfig

    cfg = _build(ModelConfig, model)
    if _tuples(dataclasses.asdict(cfg)) != _tuples(model):
        raise ValueError("the configuration file does not round-trip through ModelConfig")
    return cfg


def build_program(model: Dict, device, seed: int) -> nn.Module:
    """The program's IGGT / VGGT on ``device``, filled from ``seed``, in eval
    mode without gradients."""
    from iggt_official_tpu_torch.models.vggt import IGGT, VGGT

    cfg = model_config(model)
    with torch.device(device), no_layer_init():
        net = IGGT(cfg) if cfg.name == "iggt" else VGGT(cfg)
    fill_program(net, model, seed)
    return net.eval().requires_grad_(False)


def reference_keep_layers(model: Dict):
    """The trunk layers the heads read: the DPT and part heads' taps and the
    last one (the camera head's)."""
    layers = set(model["intermediate_layer_idx"]) | {model["aggregator"]["depth"] - 1}
    if model["name"] == "iggt" and model.get("enable_part", True):
        layers |= set(model["part"]["intermediate_layer_idx"])
    return sorted(layers)


_T0 = time.perf_counter()


def log_since(what: str) -> None:
    """Set-up progress on standard error: seconds since this module loaded."""
    print(f"[perfbench] {what}: {time.perf_counter() - _T0:.2f} s", file=sys.stderr, flush=True)


def log_detail(values: Dict[str, float]) -> None:
    for k, v in values.items():
        print(f"[perfbench] detail {k}: {v!r}", file=sys.stderr, flush=True)


def reference_names(model: Dict):
    """{name: shape} of the plain reference's parameters."""
    with torch.device("meta"):
        ref = Reference(model)
    return {n: tuple(p.shape) for n, p in ref.named_parameters()}


def fill_program(net: nn.Module, model: Dict, seed: int) -> None:
    """Fill the program's parameters with their seeded values."""
    params = dict(net.named_parameters())
    names = reference_names(model)
    for n, shape in names.items():
        if n not in params or tuple(params[n].shape) != shape:
            raise ValueError(f"the program has no parameter {n} {shape}")
    extra = [n for n in params if n not in names]
    if any(not n.startswith(UNUSED_PREFIXES) for n in extra):
        raise ValueError(f"program parameters the reference lacks: "
                         f"{[n for n in extra if not n.startswith(UNUSED_PREFIXES)][:5]}")
    with torch.no_grad():
        for n in extra:
            params[n].zero_()
    weights.fill(params, names, seed, model)


def build_reference(model: Dict, device, seed: int) -> Reference:
    with torch.device(device), no_layer_init():
        ref = Reference(model)
    params = dict(ref.named_parameters())
    weights.fill(params, params, seed, model)
    return ref.eval().requires_grad_(False)


def build_kernels() -> None:
    from iggt_official_tpu_torch.ops import cuda_build

    cuda_build.build_all()


def launch_counters():
    from iggt_official_tpu_torch.ops import flash_attention as fa
    from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm

    return {"flash_attention_fused": fa.flash_attention_fused,
            "flash_attention": fa.flash_attention, "qk_prep": fa.qk_prep,
            "fused_ln": fused_layernorm}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in launch_counters().items()}
