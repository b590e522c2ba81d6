"""Shared helpers for the PyTorch-port parity tests (no tests here).

Weights are made by the port (seeded init, then every 1-D parameter, token
and bias table redrawn from a numpy seed so norms, biases and layer scales
are exercised), and carried into the JAX package with its own converter
(`torch_state_dict_to_flax`), so both packages run the same numbers.
"""

from __future__ import annotations

from typing import Dict

import jax
import numpy as np
import torch

from iggt_official_tpu.utils.torch_convert import iggt_rename, torch_state_dict_to_flax

# The suite runs under pytest-xdist with about one worker per core, and every
# worker imports this module at collection: one torch intra-op thread per
# worker keeps the workers' thread pools from oversubscribing the cores (with
# torch's default of one thread per core, the port's tests ran up to ~100x
# slower in the parallel run than alone).
torch.set_num_threads(1)

_DENSE_TOKENS = {"camera_token", "register_token", "cls_token", "register_tokens",
                 "empty_pose_tokens", "relative_position_bias_table"}


def perturbed_state_dict(module: torch.nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """The module's state dict as numpy, with every 1-D tensor and token
    redrawn: norm weights 1 + N(0, 0.1), biases and running means N(0, 0.1),
    running variances U(0.5, 1.5), layer scales U(0.2, 0.6), tokens and bias
    tables N(0, 1).  Matrices and conv kernels keep their lecun init."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, value in module.state_dict().items():
        a = value.detach().cpu().numpy().copy()
        leaf = name.rsplit(".", 1)[-1]
        if a.dtype == np.int64:
            out[name] = a
            continue
        if a.ndim <= 1 or leaf in _DENSE_TOKENS:
            if leaf == "running_var":
                a = rng.uniform(0.5, 1.5, a.shape)
            elif leaf == "gamma":
                a = rng.uniform(0.2, 0.6, a.shape)
            elif leaf == "weight":
                a = 1.0 + 0.1 * rng.standard_normal(a.shape)
            elif leaf in ("bias", "running_mean"):
                a = 0.1 * rng.standard_normal(a.shape)
            else:
                a = rng.standard_normal(a.shape)
        out[name] = a.astype(np.float32)
    return out


def load_numpy(module: torch.nn.Module, sd: Dict[str, np.ndarray]) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module


def to_flax(sd: Dict[str, np.ndarray]) -> dict:
    """Port state dict -> JAX variables, through the JAX package's converter."""
    return {"params": torch_state_dict_to_flax(sd, rename=iggt_rename)}


def rel_err(a, b) -> float:
    """max |a - b| over max |a| (a is the JAX reference), over the entries
    where the reference is finite; non-finite entries must sit at the same
    places with the same values (random weights can give a zero field of
    view, hence an infinite focal length, in both packages)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    finite = np.isfinite(a)
    np.testing.assert_array_equal(np.where(finite, 0.0, a), np.where(finite, 0.0, b))
    a, b = a[finite], b[finite]
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def jit(fn):
    """jax.jit with XLA's cheaper CPU codegen: the tests compile each
    configuration once and run it once, so compile time dominates."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True})
