"""YAML config system with Hydra-style composition — the port's own copy of
``flocoder_tpu/config.py`` (it imports nothing of the JAX package), reading
the same ``configs/`` recipes as data.

- ``Config``: attribute-access mapping (OmegaConf-lite) with deep merge.
- ``load_config(name, config_dir, overrides)``: composes a recipe from its
  ``defaults`` list (``common/base`` fragments + ``_self_`` position), then
  applies dotted overrides ``a.b.c=1``, additions ``+key=val`` and deletions
  ``~key``.
- ``ldcfg(config, key, default)``: precedence lookup flow > flow.unet >
  preencoding > codec > root; the default is always honored.
- ``parse_cli``: ``--config-name`` may be a bare name, a ``.yaml`` name, or a
  full path.
"""
from __future__ import annotations

import copy
import os
import re
import sys
from typing import Any, Iterator, Mapping

import yaml

__all__ = [
    "Config",
    "load_config",
    "ldcfg",
    "parse_cli",
    "config_from_dict",
    "to_dict",
]


class Config(dict):
    """A dict with attribute access and recursive wrapping of nested dicts."""

    def __init__(self, data: Mapping | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- mapping protocol with recursive wrapping ---------------------------
    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, list):
            value = [Config(v) if isinstance(v, Mapping) and not isinstance(v, Config) else v for v in value]
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- helpers ------------------------------------------------------------
    def select(self, dotted: str, default: Any = None) -> Any:
        """Look up ``a.b.c`` style paths; returns default if any hop missing."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Mapping):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def delete_dotted(self, dotted: str) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if not isinstance(node, Mapping) or part not in node:
                return
            node = node[part]
        if isinstance(node, Mapping):
            node.pop(parts[-1], None)


def config_from_dict(d: Mapping | None) -> Config:
    return Config(d or {})


def to_dict(cfg: Any) -> Any:
    """Recursively convert Config to plain dict (for serialization)."""
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _deep_merge(base: Config, incoming: Mapping) -> Config:
    """Merge ``incoming`` into ``base`` in place; dicts merge, scalars/lists replace."""
    for k, v in incoming.items():
        if k in base and isinstance(base[k], Mapping) and isinstance(v, Mapping):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce_number(val: Any) -> Any:
    """YAML 1.1 leaves '1e-4' as a string; OmegaConf (which the reference's
    configs were written for) parses it as a float — match that."""
    if isinstance(val, str) and _FLOAT_RE.match(val):
        try:
            return int(val)
        except ValueError:
            return float(val)
    return val


def _coerce_tree(node: Any) -> Any:
    if isinstance(node, Mapping):
        for k in list(node.keys()):
            node[k] = _coerce_tree(node[k])
        return node
    if isinstance(node, list):
        return [_coerce_tree(v) for v in node]
    return _coerce_number(node)


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML semantics (ints, floats, bools, null, lists)."""
    if text == "~":
        return None
    try:
        return _coerce_tree(yaml.safe_load(text))
    except yaml.YAMLError:
        return text


def _resolve_config_file(name: str, config_dir: str) -> str:
    """Resolve a config name to a file path. Accepts bare names, ``x.yaml``,
    and absolute/relative filesystem paths (reference: general.py:23-47)."""
    candidates = []
    if os.path.isabs(name) or os.sep in name and os.path.exists(name):
        candidates.append(name)
    base = name if name.endswith((".yaml", ".yml")) else name + ".yaml"
    candidates += [name, os.path.join(config_dir, base), os.path.join(config_dir, name)]
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f"Config '{name}' not found (searched {candidates})")


def _load_yaml(path: str) -> Config:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, Mapping):
        raise ValueError(f"Top level of {path} must be a mapping")
    return Config(_coerce_tree(dict(data)))


def load_config(name: str, config_dir: str = "configs",
                overrides: list[str] | None = None) -> Config:
    """Compose a config from its ``defaults`` list, then apply CLI overrides.

    ``defaults`` entries are loaded relative to ``config_dir``; the ``_self_``
    sentinel controls where the file's own keys merge (Hydra semantics,
    reference: configs/flowers_sd.yaml:1-7). If ``_self_`` is absent the file's
    own keys merge last.
    """
    path = _resolve_config_file(name, config_dir)
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", None)

    merged = Config()
    if defaults:
        saw_self = False
        for entry in defaults:
            if entry == "_self_":
                _deep_merge(merged, raw)
                saw_self = True
            else:
                frag_path = _resolve_config_file(str(entry), config_dir)
                frag = _load_yaml(frag_path)
                frag.pop("defaults", None)
                _deep_merge(merged, frag)
        if not saw_self:
            _deep_merge(merged, raw)
    else:
        merged = raw

    for ov in overrides or []:
        _apply_override(merged, ov)
    return merged


def _apply_override(cfg: Config, override: str) -> None:
    override = override.strip()
    if override.startswith("~"):
        cfg.delete_dotted(override[1:])
        return
    force_add = override.startswith("+")
    if force_add:
        override = override[1:]
    if "=" not in override:
        raise ValueError(f"Override '{override}' must be key=value, +key=value or ~key")
    key, _, value = override.partition("=")
    cfg.set_dotted(key.strip(), _parse_value(value.strip()))


def parse_cli(argv: list[str] | None = None, default_config: str | None = None,
              config_dir: str = "configs") -> Config:
    """Parse ``--config-name X [--config-dir D] [key=val ...]`` like the
    reference's Hydra CLI (reference: README.md:91-120)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    name = default_config
    overrides: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--config-name", "-cn"):
            name = argv[i + 1]
            i += 2
        elif arg.startswith("--config-name="):
            name = arg.split("=", 1)[1]
            i += 1
        elif arg in ("--config-dir", "--config-path", "-cd", "-cp"):
            config_dir = argv[i + 1]
            i += 2
        elif arg.startswith(("--config-dir=", "--config-path=")):
            config_dir = arg.split("=", 1)[1]
            i += 1
        else:
            overrides.append(arg)
            i += 1
    if name is None:
        raise SystemExit("usage: script --config-name <recipe>[.yaml] [key=value ...]")
    # A full path implies its directory doubles as the config dir for fragments.
    if os.sep in name and os.path.exists(name):
        config_dir = os.path.dirname(os.path.abspath(name)) or config_dir
    return load_config(name, config_dir=config_dir, overrides=overrides)


def ldcfg(config: Mapping, key: str, default: Any = None, verbose: bool = False) -> Any:
    """Config lookup with flow > preencoding > codec > root precedence
    (reference: flocoder/general.py:50-74). Also searches ``flow.unet``.
    Unlike the reference, the default is always honored."""
    search_order = ["flow", "flow.unet", "preencoding", "codec"]
    cfg = config if isinstance(config, Config) else Config(config)
    # Accept hyphenated variants of the key: the reference's midi configs use
    # 'commitment-weight' which silently never matched (SURVEY.md §5.6);
    # here hyphen/underscore spellings are interchangeable.
    keys = (key, key.replace("_", "-")) if "_" in key else (key,)
    for section in search_order:
        node = cfg.select(section)
        if isinstance(node, Mapping):
            for k in keys:
                if k in node:
                    if verbose:
                        print(f"ldcfg: found '{k}' in '{section}': {node[k]}")
                    return node[k]
    for k in keys:
        if k in cfg:
            if verbose:
                print(f"ldcfg: found '{k}' at root: {cfg[k]}")
            return cfg[k]
    if verbose:
        print(f"ldcfg: '{key}' not found, using default: {default}")
    return default
