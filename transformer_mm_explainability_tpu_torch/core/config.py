"""Hierarchical configuration system (OmegaConf-cascade equivalent).

The port's copy of ``transformer_mm_explainability_tpu/core/config.py``
(pure Python; PyYAML imported lazily for ``.yaml`` files): importing that
module would load the JAX package.

Re-implements the capability of mmf/utils/configuration.py:202-560 with
a dependency-free nested-dict config: defaults → model defaults →
dataset defaults → user YAML → CLI dotlist overrides (``a.b.c=value``)
→ JSON override blob; attribute access, freeze/defrost, env-var
interpolation ``${env:VAR,default}``.

The reference ships three disjoint config systems (MMF OmegaConf, DETR
argparse, LXMERT argparse singleton — SURVEY §5); here one system feeds
every harness.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional

_ENV_PATTERN = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    if t.startswith("[") or t.startswith("{"):
        try:
            return json.loads(t)
        except json.JSONDecodeError:
            pass
    return t


def _interp(value: Any) -> Any:
    if isinstance(value, str):
        def sub(m):
            return os.environ.get(m.group(1), m.group(2) or "")
        return _ENV_PATTERN.sub(sub, value)
    return value


class Config:
    """Nested attribute/key access config with freeze semantics."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_frozen", False)
        if data:
            for k, v in data.items():
                self._data[k] = Config(v) if isinstance(v, Mapping) else _interp(v)

    # -- access -----------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setattr__(self, key: str, value: Any) -> None:
        if self._frozen:
            raise RuntimeError("config is frozen")
        self._data[key] = Config(value) if isinstance(value, Mapping) else value

    __setitem__ = __setattr__

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, Config) else v
            for k, v in self._data.items()
        }

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    # -- freeze ------------------------------------------------------------
    def freeze(self) -> "Config":
        object.__setattr__(self, "_frozen", True)
        for v in self._data.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def defrost(self) -> "Config":
        object.__setattr__(self, "_frozen", False)
        for v in self._data.values():
            if isinstance(v, Config):
                v.defrost()
        return self

    # -- merging ------------------------------------------------------------
    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Deep-merge ``other`` on top of self (in place)."""
        if self._frozen:
            raise RuntimeError("config is frozen")
        for k, v in (other.items() if hasattr(other, "items") else other):
            cur = self._data.get(k)
            if isinstance(cur, Config) and isinstance(v, (Mapping, Config)):
                cur.merge(v)
            else:
                self._data[k] = (Config(v) if isinstance(v, (Mapping,))
                                 else copy.deepcopy(v) if isinstance(v, Config)
                                 else _interp(v))
        return self

    def resolve_interpolations(self, env: Optional[Mapping[str, Any]] = None
                               ) -> "Config":
        """Resolve OmegaConf-style ``${a.b.c}`` references against the
        root of this config (mmf/utils/configuration.py resolves via
        OmegaConf at build time). ``${env.*}`` keys draw from ``env``
        (default: ``data_dir``/``save_dir`` from MMF's env defaults,
        overridable by MMF_DATA_DIR/MMF_SAVE_DIR). A string that IS a
        single reference takes the referenced value's type; embedded
        references substitute ``str(value)``. Dangling references are
        left untouched (the matrix ships paths that are only resolvable
        at data-load time)."""
        env = dict(env or {})
        env.setdefault("data_dir",
                       os.environ.get("MMF_DATA_DIR", "data"))
        env.setdefault("save_dir",
                       os.environ.get("MMF_SAVE_DIR", "./save"))
        pattern = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_.]*)\}")

        def lookup(path: str):
            if path.startswith("env."):
                return env.get(path[4:])
            node: Any = self
            for part in path.split("."):
                if isinstance(node, Config) and part in node:
                    node = node[part]
                else:
                    return None
            return node

        def resolve(value, depth=0):
            if not isinstance(value, str) or depth > 8:
                return value
            m = pattern.fullmatch(value)
            if m:
                ref = lookup(m.group(1))
                return value if ref is None else resolve(ref, depth + 1)

            def sub(mm):
                ref = lookup(mm.group(1))
                return mm.group(0) if ref is None else str(
                    resolve(ref, depth + 1))
            return pattern.sub(sub, value)

        def walk(node):
            for k, v in list(node._data.items()):
                if isinstance(v, Config):
                    walk(v)
                elif isinstance(v, list):
                    node._data[k] = [
                        resolve(x) if isinstance(x, str) else x for x in v]
                else:
                    node._data[k] = resolve(v)
        walk(self)
        return self

    def merge_dotlist(self, overrides: List[str]) -> "Config":
        """Apply ``a.b.c=value`` CLI overrides (the MMF ``opts``)."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"dotlist override {item!r} missing '='")
            path, value = item.split("=", 1)
            keys = path.strip().split(".")
            node = self
            for k in keys[:-1]:
                if k not in node._data or not isinstance(node._data[k], Config):
                    node._data[k] = Config()
                node = node._data[k]
            node._data[keys[-1]] = _parse_scalar(value)
        return self


def _resolve_include(inc: str, including_dir: str) -> str:
    """Resolve an ``includes:`` entry: absolute paths win; then
    relative to the including file; then relative to each ancestor
    directory (so repo-root-anchored paths like
    ``configs/datasets/vqa2/defaults.yaml`` work from any project
    yaml, the MMF root-relative convention —
    mmf/utils/configuration.py load_yaml)."""
    if os.path.isabs(inc):
        return inc
    cand = os.path.normpath(os.path.join(including_dir, inc))
    if os.path.exists(cand):
        return cand
    d = including_dir
    while True:
        cand = os.path.normpath(os.path.join(d, inc))
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            raise FileNotFoundError(
                f"include {inc!r} not found relative to "
                f"{including_dir!r} or any ancestor")
        d = parent


def load_yaml(path: str, _stack: Optional[List[str]] = None) -> Dict[str, Any]:
    """YAML loader (PyYAML when present; JSON files always work).

    Supports the MMF ``includes:`` convention: the key is popped, each
    listed file is loaded recursively and deep-merged in order, and the
    file's own content merges on top (mmf/utils/configuration.py
    load_yaml + OmegaConf.merge semantics)."""
    apath = os.path.abspath(path)
    stack = _stack or []
    if apath in stack:
        chain = " -> ".join(stack + [apath])
        raise RuntimeError(f"circular config include: {chain}")
    with open(apath) as f:
        text = f.read()
    if apath.endswith(".json"):
        data = json.loads(text)
    else:
        try:
            import yaml  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "PyYAML unavailable — use .json configs") from e
        data = yaml.safe_load(text) or {}
    includes = data.pop("includes", None) if isinstance(data, dict) else None
    if not includes:
        return data
    base = Config()
    here = os.path.dirname(apath)
    for inc in includes:
        base.merge(load_yaml(_resolve_include(str(inc), here),
                             stack + [apath]))
    base.merge(data)
    return base.to_dict()


def build_config(
    defaults: Optional[Mapping[str, Any]] = None,
    config_paths: Optional[List[str]] = None,
    overrides: Optional[List[str]] = None,
    config_override_json: Optional[str] = None,
) -> Config:
    """The MMF merge cascade: defaults → yaml files (in order) →
    dotlist → json blob (configuration.py:202-560)."""
    cfg = Config(defaults or {})
    for path in config_paths or []:
        cfg.merge(load_yaml(path))
    if overrides:
        cfg.merge_dotlist(overrides)
    if config_override_json:
        cfg.merge(json.loads(config_override_json))
    return cfg.resolve_interpolations()
