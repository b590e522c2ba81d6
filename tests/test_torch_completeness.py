"""Every public name of the JAX package has its counterpart in the port.

Each module of `iggt_official_tpu/` is parsed with `ast` (nothing is
imported), beside the module at the same path in `iggt_official_tpu_torch/`.
Every public top-level class or function (no leading ``_``) must have one of:

- a class or function of the same name in the port's module;
- an entry in `TABLE` naming the port's counterpart, ``"<module>::<name>"``
  (a rename, or the same work held elsewhere);
- an entry in `TABLE` giving the one-line reason it exists only for XLA,
  flax, orbax or the TPU (``"jax only: ..."``).

The table holds no entry that is not needed: each names a public JAX name
that has no same-named counterpart, and each port counterpart exists.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "iggt_official_tpu")
PORT_PKG = os.path.join(REPO, "iggt_official_tpu_torch")
JAX_ONLY = "jax only: "
WHOLE_MODULE = "*"

# (JAX module, public name) -> the port's counterpart, or why it has none
TABLE = {
    ("app/train.py", "build_model"): "app/train.py::build_config",   # the config; the CLI
    # then builds the model with models/vggt.py::build_model
    ("layers/blocks.py", "sdpa_xla"): "layers/blocks.py::sdpa_plain",
    ("heads/window_attn.py", "CAB"): "heads/window_attn.py::HAB",    # its conv_block.cab
    ("native/__init__.py", "available"): "native/__init__.py::load",  # builds the library
    # or raises NativeBuildError: the port has no fallback to gate
    ("ops/flash_attention.py", "attention_fused"): "ops/flash_attention.py::attention",
    ("ops/flash_attention.py", "sdpa_chunked"): "ops/flash_attention.py::flash_attention_plain",
    ("ops/fused_ln.py", "FusedLN"): "ops/fused_ln.py::fused_layernorm",
    ("ops/nn1_pallas.py", "nn1_pallas"): "ops/nn1.py::nn1",
    ("ops/nn1_pallas.py", "bucket_topk_pallas"): "ops/nn1.py::bucket_topk",
    ("train/step.py", "layer_decay_scales"): "train/step.py::layer_decay_scale",
    ("utils/logging.py", "StageTimer"): "utils/logging.py::span",   # profiler spans on
    # the device ops' clock in place of synchronizing wall timers
    ("train/step.py", "TrainState"):
        JAX_ONLY + "flax pytree of step, params and optax state; the port's model and "
                   "train/step.py::AdamWLayerDecay hold theirs",
    ("utils/checkpoint.py", "load_checkpoint"):
        JAX_ONLY + "orbax: restores flax params from an orbax checkpoint",
    ("utils/checkpoint.py", "load_torch_checkpoint"):
        JAX_ONLY + "torch -> flax; the port loads torch checkpoints as they are "
                   "(utils/checkpoint.py::load_reference_state)",
    ("utils/torch_convert.py", WHOLE_MODULE):
        JAX_ONLY + "torch -> flax converter; the port's modules carry the reference's "
                   "names, and utils/convert.py carries flax -> torch",
    ("parallel/mesh.py", "state_sharding"):
        JAX_ONLY + "XLA: GSPMD NamedShardings of the train state (the port: parallelize)",
    ("parallel/mesh.py", "batch_sharding"):
        JAX_ONLY + "XLA: GSPMD placement of a batch; a port process holds its own views",
    ("parallel/mesh.py", "fsdp_sharding"):
        JAX_ONLY + "XLA: GSPMD FSDP shardings (the port: param_specs, fully_shard)",
    ("parallel/mesh.py", "replicated"):
        JAX_ONLY + "XLA: a replicated NamedSharding",
    ("parallel/mesh.py", "make_token_sharder"):
        JAX_ONLY + "XLA: GSPMD sharding constraints inside the jitted forward",
    ("parallel/attention.py", "make_frame_attention"):
        JAX_ONLY + "XLA: shard_map of the frame attention, a no-op with one process per "
                   "device",
}


def public_names(text: str) -> set:
    """Public top-level classes and functions of a module's source."""
    return {node.name for node in ast.parse(text).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


def module_problems(module: str, jax_text: str, port_text, table: dict, port_names) -> list:
    """What `module` (a path under the JAX package) lacks in the port:
    ``port_text`` is the same-path port module's source (None: no such
    module); ``port_names(path)`` the public names of any port module."""
    if (module, WHOLE_MODULE) in table:
        return []
    have = public_names(port_text) if port_text is not None else set()
    problems = []
    for name in sorted(public_names(jax_text) - have):
        entry = table.get((module, name))
        if entry is None:
            problems.append(f"{module}::{name} has no counterpart in the port and no "
                            "entry in the table")
        elif not entry.startswith(JAX_ONLY):
            where, target = entry.split("::")
            if target not in port_names(where):
                problems.append(f"{module}::{name} maps to {entry}, which the port lacks")
    for (mod, name), entry in table.items():
        if mod == module and name in have:
            problems.append(f"{module}::{name} is matched by name: its entry {entry!r} "
                            "is not needed")
    return problems


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _jax_modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX_PKG)


def _port_names(module: str) -> set:
    path = os.path.join(PORT_PKG, module)
    return public_names(_read(path)) if os.path.exists(path) else set()


def test_every_public_jax_name_has_a_port_counterpart():
    modules = sorted(_jax_modules())
    assert len(modules) > 80
    problems, names = [], 0
    for module in modules:
        port = os.path.join(PORT_PKG, module)
        jax_text = _read(os.path.join(JAX_PKG, module))
        names += len(public_names(jax_text))
        problems += module_problems(module, jax_text,
                                    _read(port) if os.path.exists(port) else None,
                                    TABLE, _port_names)
    assert not problems, "\n".join(problems)
    assert names > 400


def test_table_entries_name_public_jax_names():
    """No stale entry: each names a module and a public name of the JAX
    package, and each reason is one line."""
    for (module, name), entry in TABLE.items():
        path = os.path.join(JAX_PKG, module)
        assert os.path.exists(path), module
        if name != WHOLE_MODULE:
            assert name in public_names(_read(path)), (module, name)
        assert "\n" not in entry and (entry.startswith(JAX_ONLY) or entry.count("::") == 1)


@pytest.mark.parametrize("port_text,table,want", [
    ("def kept():\n    pass\n", {}, ["x.py::Added has no counterpart"]),
    ("def kept():\n    pass\nclass Added:\n    pass\n", {}, []),
    ("def kept():\n    pass\n", {("x.py", "Added"): "y.py::Renamed"}, []),
    ("def kept():\n    pass\n", {("x.py", "Added"): "y.py::Missing"},
     ["x.py::Added maps to y.py::Missing"]),
    ("def kept():\n    pass\n", {("x.py", "Added"): JAX_ONLY + "XLA: a sharding"}, []),
    ("def kept():\n    pass\nclass Added:\n    pass\n", {("x.py", "Added"): "y.py::Renamed"},
     ["x.py::Added is matched by name"]),
    (None, {}, ["x.py::Added has no counterpart", "x.py::kept has no counterpart"]),
    (None, {("x.py", WHOLE_MODULE): JAX_ONLY + "TPU: a tunnel"}, []),
], ids=["unmapped", "matched", "mapped", "mapped-to-nothing", "jax-only", "not-needed",
        "no-module", "whole-module"])
def test_check_on_a_synthetic_pair(port_text, table, want):
    """A new public name in a JAX module fails the check until the port has
    it, or the table maps it or says why it is JAX-only; private names are
    never asked for."""
    jax_text = "def kept():\n    pass\nclass Added:\n    pass\ndef _private():\n    pass\n"
    got = module_problems("x.py", jax_text, port_text, table,
                          lambda m: {"Renamed"} if m == "y.py" else set())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.startswith(w), (g, w)
