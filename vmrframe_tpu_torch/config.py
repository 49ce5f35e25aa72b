"""Config system (counterpart of ``vmrframe_tpu/config.py``).

An attribute-access view over the reference's YAML/JSON config files, plus a
separate ``Derived`` record for runtime quantities (vocab sizes, step
counts).  ``yaml`` is imported only inside ``load_config``: configs built in
code (``tools/serve.py::make_cfg``) need no YAML parser installed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict


class Config:
    """Read-only attribute tree: ``cfg.model.dim``.  Missing keys raise
    AttributeError with the full dotted path."""

    def __init__(self, data: Dict[str, Any], _path: str = ""):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_path", _path)
        for k, v in data.items():
            if isinstance(v, dict):
                v = Config(v, _path=f"{_path}.{k}" if _path else str(k))
            self._data[k] = v

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        path = object.__getattribute__(self, "_path")
        raise AttributeError(f"config key not found: {path + '.' if path else ''}{name}")

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("Config is read-only; use .updated() to derive a new one")

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self._data.items()}

    def updated(self, updates: Dict[str, Any]) -> "Config":
        """A new Config with (possibly nested, dot-keyed) updates."""
        data = self.to_dict()
        for key, value in updates.items():
            node = data
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return Config(data)

    def __repr__(self) -> str:
        return f"Config({json.dumps(self.to_dict(), indent=2, default=str)})"


@dataclasses.dataclass
class Derived:
    """Runtime-derived quantities, kept apart from the user's config (the
    serving slice's subset: vocabulary sizes and the char width)."""

    num_words: int = 0
    num_chars: int = 0
    # static char-sequence width per word
    char_len: int = 16


def load_config(path: str) -> Config:
    """Load a reference-format YAML (or JSON) config file."""
    with open(path, encoding="utf8") as fr:
        if path.endswith(".json"):
            data = json.load(fr)
        else:
            import yaml

            data = yaml.safe_load(fr)
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} did not parse to a mapping")
    return Config(data)
