"""Load a reference-layout IGGT checkpoint into the port's model.

Counterpart of `iggt_official_tpu/utils/checkpoint.py::load_torch_checkpoint`
(which mirrors the reference demo's loader), in four steps:

1. unwrap a ``"model"`` entry (a training checkpoint holds the weights there,
   beside the optimizer, the epoch and the training script's arguments);
2. strip a DDP ``module.`` prefix;
3. drop the dead entries, the JAX converter's drop rules (`DROP_RULES`): the
   part head's inherited DPT front end (``norm`` / ``projects`` /
   ``resize_layers``), the window-attention ``relative_position_index``
   buffers (rebuilt from the config) and the DINOv2 ``mask_token`` (unused at
   inference).  The port keeps the reference's module names, so no entry is
   renamed;
4. merge the rest by name with a shape check, strict=False: a name whose
   shape differs keeps the model's tensor and is reported, never raised.
   The report lists matched, shape-mismatched, missing (in the model, not in
   the checkpoint), unused (in the checkpoint, not in the model) and dropped
   names.  ``track_head.*`` entries are unused unless the model is built
   with ``enable_track=True``; then a reference checkpoint loads whole.

``weights_only``: the file is read with ``torch.load(..., weights_only=True)``,
so loading it cannot run code (the JAX loader reads with ``False``).  That
refuses a checkpoint that pickles any object beside its tensors and plain
containers; the one such entry a training checkpoint of the reference's
lineage carries is the training script's ``argparse.Namespace`` (``args``),
which is allowed here.  Anything else is refused with torch's error; a class
that a real checkpoint turns out to carry joins the allowed list.
"""

from __future__ import annotations

import argparse
import logging
import re
from typing import Dict, List, Mapping, Tuple

import torch

logger = logging.getLogger(__name__)

# `iggt_official_tpu/utils/torch_convert.py::_RENAME_RULES`, the rules whose
# replacement is None (dead weights and index buffers), copied
DROP_RULES = (
    r"^(.*\.)?part_head\.(norm|projects|resize_layers)\..*$",
    r".*relative_position_index.*$",
    r"^(.*\.)?patch_embed\.mask_token$",
)
_DROP = tuple(re.compile(p) for p in DROP_RULES)


def is_dead(name: str) -> bool:
    """True for a reference entry that the model does not hold by design."""
    return any(p.match(name) for p in _DROP)


def read_checkpoint(path: str) -> Mapping[str, torch.Tensor]:
    """The state dict of a checkpoint file, on the CPU, unwrapped from a
    ``"model"`` entry (see the module note on ``weights_only``)."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        state = torch.load(path, map_location="cpu", weights_only=True)
    return unwrap(state)


def unwrap(state: Mapping) -> Mapping[str, torch.Tensor]:
    """Step 1: the ``"model"`` entry of a training checkpoint, else ``state``."""
    if isinstance(state, Mapping) and "model" in state:
        state = state["model"]
    if not isinstance(state, Mapping):
        raise ValueError(f"a checkpoint must hold a state dict, got {type(state).__name__}")
    return state


def strip_module_prefix(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Step 2: the DDP ``module.`` prefix off every name that has it."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}


def align_state_dict(
    target: Mapping[str, torch.Tensor], state: Mapping
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """Steps 1-4 against the model's state dict ``target``: returns the
    entries to load (name -> checkpoint tensor, shapes equal) and the report
    (``matched``, ``shape_mismatch``, ``missing``, ``unused``, ``dropped``)."""
    state = strip_module_prefix(unwrap(state))
    report = {"matched": [], "shape_mismatch": [], "missing": [], "unused": [], "dropped": []}
    kept = {}
    for name, value in state.items():
        if is_dead(name):
            report["dropped"].append(name)
        elif name not in target:
            report["unused"].append(name)
        elif tuple(value.shape) != tuple(target[name].shape):
            report["shape_mismatch"].append(
                f"{name}: checkpoint {tuple(value.shape)} vs model {tuple(target[name].shape)}")
        else:
            kept[name] = value
            report["matched"].append(name)
    report["missing"] = [n for n in target if n not in state]
    return kept, report


def report_counts(report: Mapping[str, List[str]]) -> str:
    return ", ".join(f"{len(report[k])} {k.replace('_', '-')}"
                     for k in ("matched", "shape_mismatch", "missing", "unused", "dropped"))


def load_reference_state(model: torch.nn.Module, state: Mapping,
                         log=logger.info) -> Dict[str, List[str]]:
    """Merge ``state`` (a reference-layout state dict, bare, wrapped in
    ``"model"`` or with a ``module.`` prefix) into ``model`` in place and
    return the report; its counts go to ``log``, each shape mismatch too."""
    kept, report = align_state_dict(model.state_dict(), state)
    model.load_state_dict(kept, strict=False)
    if log is not None:
        log(f"checkpoint: {report_counts(report)}")
        for line in report["shape_mismatch"]:
            log(f"checkpoint: shape mismatch {line}")
    return report
