"""Training/eval config loaders: py-config files and `_BASE_` yaml nodes.

Behavioural parity (first-party — no mmengine/fvcore deps):
- `iggt/utils/configs.py:5-59`: mmengine-style `Config.fromfile` for
  `configs/*.py` files (module-level variables become config keys,
  `_base_ = [...]` inherits + deep-merges parent configs), argparse
  front-end (`parse_args`/`merge_args`/`parse_configs`) where non-None CLI
  flags override config keys, and `str2bool`.
- `utils/Config.py:3-26`: fvcore-style `CfgNode` — attribute-access nested
  dict with `_BASE_` yaml inheritance (`load_yaml_with_base`),
  `merge_from_other_cfg`, `merge_from_list`, freeze/defrost/clone.

Counterpart of `iggt_official_tpu/utils/config_io.py`, copied, with the YAML
read by the port's own subset reader (`utils/yaml_subset.py`, equal to
``yaml.safe_load`` on its subset, raising outside it; a ``.json`` file's
numbers resolved by YAML 1.1's rules, as ``yaml.safe_load`` reads JSON):
PyYAML is not a dependency of the port.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Dict, List, Optional, Sequence

from iggt_official_tpu_torch.utils import yaml_subset


def _deep_merge(base: Dict, new: Dict) -> Dict:
    """Recursively merge ``new`` into a copy of ``base`` (new wins)."""
    out = dict(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class Config(dict):
    """Attribute-access config dict loaded from a python file.

    ``Config.fromfile("configs/base.py")`` executes the file and collects
    its module-level, non-underscore variables; a ``_base_`` entry (str or
    list of str, relative to the file) is loaded first and deep-merged
    under the child (`iggt/utils/configs.py:40-42` semantics).
    """

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key: str, default: Any = None) -> Any:
        v = super().get(key, default)
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    @staticmethod
    def fromfile(path: str) -> "Config":
        path = os.path.abspath(path)
        scope: Dict[str, Any] = {}
        with open(path, encoding="utf-8") as f:
            code = compile(f.read(), path, "exec")
        exec(code, scope)  # noqa: S102 - config files are first-party code
        cfg: Dict[str, Any] = {
            k: v
            for k, v in scope.items()
            if not k.startswith("_") and not callable(v) and k != "yaml"
            and not isinstance(v, type(os))
        }
        bases = scope.get("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for base in bases:
            parent = Config.fromfile(os.path.join(os.path.dirname(path), base))
            merged = _deep_merge(merged, parent)
        return Config(_deep_merge(merged, cfg))


def str2bool(v: Any) -> bool:
    """Lenient CLI boolean (`iggt/utils/configs.py:51-59`)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Training CLI front-end (`iggt/utils/configs.py:5-24`)."""
    parser = argparse.ArgumentParser(description="Training script config.")
    parser.add_argument("--config", default="configs/base.py")
    parser.add_argument("--resume_model_path", type=str, default=None)
    parser.add_argument("--wandb", type=str2bool, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--num_train_epochs", type=int, default=None)
    parser.add_argument("--local_rank", type=int, default=-1)
    args = parser.parse_args(argv)
    env_local_rank = int(os.environ.get("LOCAL_RANK", -1))
    if env_local_rank != -1 and env_local_rank != args.local_rank:
        args.local_rank = env_local_rank
    return args


def merge_args(cfg: Config, args: argparse.Namespace) -> Config:
    """Non-None CLI flags override config keys (`configs.py:27-37`)."""
    for k, v in vars(args).items():
        if v is not None:
            cfg[k] = v
    return cfg


def parse_configs(argv: Optional[Sequence[str]] = None) -> Config:
    args = parse_args(argv)
    return merge_args(Config.fromfile(args.config), args)


BASE_KEY = "_BASE_"


class CfgNode(dict):
    """fvcore-style yaml config node (`utils/Config.py:3-26`).

    Supports `_BASE_` file inheritance, attribute access, deep clone,
    freeze/defrost, `merge_from_other_cfg`, and dotted-key
    `merge_from_list`.
    """

    def __init__(self, init: Optional[Dict] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        for k, v in (init or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = CfgNode(value) if isinstance(value, dict) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if getattr(self, "_frozen", False):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return self._frozen

    def clone(self) -> "CfgNode":
        return CfgNode(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> Dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else v
            for k, v in self.items()
        }

    @staticmethod
    def load_yaml_with_base(filename: str) -> "CfgNode":
        """Load yaml; a `_BASE_` key names a parent file (relative to this
        one or absolute) merged underneath (fvcore `load_yaml_with_base`)."""
        cfg = yaml_subset.load_file(filename) or {}
        base = cfg.pop(BASE_KEY, None)
        if base is not None:
            if not os.path.isabs(base):
                base = os.path.join(os.path.dirname(filename), base)
            parent = CfgNode.load_yaml_with_base(base).to_dict()
            cfg = _deep_merge(parent, cfg)
        return CfgNode(cfg)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], CfgNode)
                and isinstance(v, (dict, CfgNode))
            ):
                self[k].merge_from_other_cfg(
                    v if isinstance(v, CfgNode) else CfgNode(v)
                )
            else:
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def merge_from_list(self, opts: List[Any]) -> None:
        """[key1, val1, key2, val2, ...] with dotted keys; values parsed as
        python literals when possible."""
        assert len(opts) % 2 == 0, "merge_from_list expects key/value pairs"
        import ast

        for key, val in zip(opts[0::2], opts[1::2]):
            if isinstance(val, str):
                try:
                    val = ast.literal_eval(val)
                except (SyntaxError, ValueError):
                    pass
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = CfgNode(val) if isinstance(val, dict) else val
