"""Python-file config system with ``_base_`` composition and dotted overrides.

Reproduces the ergonomics of the reference's mmcv ``Config.fromfile`` +
``--cfg-options`` stack (reference: tools/train.py:67-74,263 and every
configs/exp_local/*.py:1-5) as a small standalone implementation:

- a config is a plain ``.py`` file whose module-level names become keys;
- ``_base_ = ["../relative/path.py", ...]`` pulls in parent configs which are
  deep-merged in order, leaf values winning;
- a dict value of ``{"_delete_": True, ...}`` replaces (instead of merging
  into) the base dict at that key;
- ``apply_overrides(cfg, {"a.b.c": v})`` merges dotted CLI options last.

Values are kept as plain dicts (attribute access provided via ``Config``),
so configs stay declarative and serializable.

Port of ``clover_tpu/config.py``: a copy (it reads the repo's ``configs/``,
which import nothing), held against it by ``tests/test_torch_config.py``.
"""

from __future__ import annotations

import ast
import copy
import json
import os
from typing import Any, Dict, List, Optional

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"

_RESERVED = {"__builtins__", "__name__", "__file__", "__doc__"}


class Config(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(dict(self))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=repr)


def _exec_config_file(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    with open(path) as f:
        source = f.read()
    # Validate syntax early with a clear filename.
    ast.parse(source, filename=path)
    namespace: Dict[str, Any] = {"__file__": path, "__name__": "_clover_cfg_"}
    exec(compile(source, path, "exec"), namespace)
    return {
        k: v
        for k, v in namespace.items()
        if k not in _RESERVED and not k.startswith("__") and not callable(v)
    }


def merge_dict(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``override`` into a copy of ``base``; leaf values win.

    A dict containing ``_delete_: True`` replaces the base value wholesale.
    """
    out = copy.deepcopy(base)
    for key, value in override.items():
        if (
            isinstance(value, dict)
            and isinstance(out.get(key), dict)
            and not value.get(_DELETE_KEY, False)
        ):
            out[key] = merge_dict(out[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != _DELETE_KEY}
            out[key] = copy.deepcopy(value)
    return out


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a config file, resolving its ``_base_`` chain then CLI overrides."""
    cfg_dict = _exec_config_file(path)
    bases: List[str] = cfg_dict.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(path))
    for base_rel in bases:
        base_cfg = load_config(os.path.join(cfg_dir, base_rel))
        merged = merge_dict(merged, base_cfg)
    merged = merge_dict(merged, cfg_dict)
    cfg = Config(merged)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: Config, options: Dict[str, Any]) -> Config:
    """Merge ``{"a.b.c": value}`` dotted options into ``cfg`` (last wins)."""
    patch: Dict[str, Any] = {}
    for dotted, value in options.items():
        if isinstance(value, str):
            value = _parse_value(value)
        node = patch
        keys = dotted.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return Config(merge_dict(cfg, patch))


def parse_cfg_options(pairs: List[str]) -> Dict[str, Any]:
    """Parse CLI ``key=value`` strings (mmcv DictAction equivalent)."""
    options: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--cfg-options entry must be key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        options[key.strip()] = value.strip()
    return options
