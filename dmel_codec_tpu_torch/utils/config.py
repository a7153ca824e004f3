"""YAML <-> dataclass config system (copy of `dmel_codec_tpu/utils/config.py`,
which has no JAX in it; this package imports nothing of that one).

  * `load_yaml(path)` resolves a `defaults:` list (paths relative to the
    file, `_self_` position honored) into one merged dict
  * `dataclass_from_dict(cls, d)` recursively instantiates nested frozen
    dataclasses, tuple-izing list fields and rejecting unknown keys
  * `${...}` interpolation over top-level scalars
  * `print_config_tree(cfg)` renders a config dict as an indented tree
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from typing import Any, Dict, Type, TypeVar

import yaml

T = TypeVar("T")

_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")


def merge_dicts(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_interpolations(cfg: Dict) -> Dict:
    def lookup(path: str):
        node: Any = cfg
        for part in path.split("."):
            node = node[part]
        return node

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:
                return lookup(m.group(1))
        return node

    return walk(cfg)


def load_yaml(path: str) -> Dict:
    """Load YAML with `defaults:` list merging and `${}` interpolation."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    defaults = cfg.pop("defaults", None)
    if defaults:
        merged: Dict = {}
        base_dir = os.path.dirname(os.path.abspath(path))
        for entry in defaults:
            if entry == "_self_":
                merged = merge_dicts(merged, cfg)
            else:
                merged = merge_dicts(merged, load_yaml(os.path.join(base_dir, entry)))
        if "_self_" not in defaults:
            merged = merge_dicts(merged, cfg)
        cfg = merged
    return _resolve_interpolations(cfg)


def dataclass_from_dict(cls: Type[T], d: Dict) -> T:
    """Recursively build dataclass `cls` from a plain dict."""
    if d is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    hints = typing.get_type_hints(cls)  # resolves string annotations
    kwargs = {}
    for name, value in d.items():
        ftype = hints.get(name)
        if typing.get_origin(ftype) is typing.Union:  # Optional[...]
            args = [a for a in typing.get_args(ftype) if a is not type(None)]
            if len(args) == 1:
                ftype = args[0]
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            value = dataclass_from_dict(ftype, value)
        elif isinstance(value, list):
            value = _tuple_ize(value)
        kwargs[name] = value
    return cls(**kwargs)


def _tuple_ize(value):
    if isinstance(value, list):
        return tuple(_tuple_ize(v) for v in value)
    return value


def config_to_dict(cfg) -> Dict:
    return dataclasses.asdict(cfg)


def print_config_tree(cfg: Dict, indent: int = 0) -> str:
    """Plain-text tree render of a config dict."""
    lines = []
    pad = "  " * indent
    for k, v in cfg.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:")
            lines.append(print_config_tree(v, indent + 1))
        else:
            lines.append(f"{pad}{k}: {v}")
    return "\n".join(lines)
