"""Dot-key YAML config loader + CLI override merging.

Counterpart of `iggt_official_tpu/utils/arguments.py`, copied, with the YAML
read by the port's own subset reader (`utils/yaml_subset.py`): PyYAML is not
a dependency of the port.
Behavioural parity: `iggt/utils/arguments.py:9-117` (duplicated at
`utils/arguments.py`): nested opt dicts built from dot-separated keys,
later files/overrides winning, and a `--conf_files`/`--overrides` CLI.
"""

from __future__ import annotations

import argparse
import ast
import logging
from typing import Any, Dict, List, Sequence, Tuple

from iggt_official_tpu_torch.utils import yaml_subset

logger = logging.getLogger(__name__)


def load_config_dict_to_opt(opt: Dict, config_dict: Dict) -> None:
    """Merge dot-keyed entries into the nested opt dict
    (`arguments.py:9-27`)."""
    if not isinstance(config_dict, dict):
        raise TypeError("Config must be a Python dictionary")
    for k, v in config_dict.items():
        parts = k.split(".")
        pointer = opt
        for part in parts[:-1]:
            if part not in pointer:
                pointer[part] = {}
            pointer = pointer[part]
            assert isinstance(pointer, dict), (
                "Overriding key needs to be inside a Python dict."
            )
        ori = pointer.get(parts[-1])
        pointer[parts[-1]] = v
        if ori is not None:
            logger.warning("Overrode %s from %s to %s", k, ori, v)


def load_opt_from_config_files(conf_files: Sequence[str]) -> Dict:
    """Later files override earlier ones (`arguments.py:47-63`)."""
    opt: Dict = {}
    for conf_file in conf_files:
        load_config_dict_to_opt(opt, yaml_subset.load_file(conf_file))
    return opt


def load_opt_from_config_file(conf_file: str) -> Dict:
    return load_opt_from_config_files([conf_file])


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def load_opt_command(args: Sequence[str] = None) -> Tuple[Dict, Dict]:
    """CLI: command --conf_files ... --overrides k v k v ...
    (`arguments.py:66-117`)."""
    parser = argparse.ArgumentParser(description="IGGT-TPU runner")
    parser.add_argument("command", help="train/evaluate/train-and-evaluate")
    parser.add_argument("--conf_files", nargs="+", required=True)
    parser.add_argument("--overrides", nargs="*", default=[])
    ns = parser.parse_args(args)

    opt = load_opt_from_config_files(ns.conf_files)
    assert len(ns.overrides) % 2 == 0, "overrides must be key value pairs"
    overrides = {
        ns.overrides[i]: _parse_value(ns.overrides[i + 1])
        for i in range(0, len(ns.overrides), 2)
    }
    load_config_dict_to_opt(opt, overrides)
    cmdline = {"command": ns.command, "conf_files": ns.conf_files}
    return opt, cmdline
