"""Hierarchical configuration: a copy of ``gan_mpc_tpu/config.py``.

A nested, read-only tree with attribute and item access, ``from_dict`` /
``to_dict`` round-trip (the schema of a saved run's ``config.json``),
dotted-path ``get_path`` and ``replace`` overrides. A run's
``config.json`` needs only ``json``; ``yaml`` is imported where a YAML
file or string is read or written, and nowhere else.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class Config(Mapping[str, Any]):
    """Immutable-ish nested config with attribute and item access."""

    __slots__ = ("_fields",)

    def __init__(self, **fields: Any):
        object.__setattr__(self, "_fields", {})
        for name, value in fields.items():
            self._fields[name] = (
                Config.from_dict(value) if isinstance(value, dict) else value
            )

    # -- constructors -------------------------------------------------

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "Config":
        return cls(**dict(data))

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path, "r") as fp:
            return cls.from_dict(yaml.safe_load(fp))

    @classmethod
    def from_yaml_str(cls, text: str) -> "Config":
        import yaml

        return cls.from_dict(yaml.safe_load(text))

    # -- mapping protocol ----------------------------------------------

    def __getitem__(self, name: str) -> Any:
        return self._fields[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, name: object) -> bool:
        return name in self._fields

    # -- attribute access ----------------------------------------------

    def __getattr__(self, name: str) -> Any:
        try:
            return self._fields[name]
        except KeyError as exc:
            raise AttributeError(f"config has no field {name!r}") from exc

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError(
            "Config is read-only; use .replace(path=value) instead"
        )

    # -- conversion / overrides -----------------------------------------

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._fields.items():
            out[k] = v.to_dict() if isinstance(v, Config) else copy.copy(v)
        return out

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            else:
                return default
        return node

    def replace(self, **overrides: Any) -> "Config":
        """Return a new Config with dotted-path overrides applied.

        Dots in paths are written as ``__`` in kwargs, e.g.
        ``cfg.replace(mpc__horizon=50)``.
        """
        data = self.to_dict()
        for key, value in overrides.items():
            parts = key.split("__")
            node = data
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        return Config.from_dict(data)

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        return NotImplemented
