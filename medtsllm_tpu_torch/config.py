"""Attribute-access config trees (the subset of ``medtsllm_tpu/config.py``
the port reads). Any mapping with attribute access and ``.get`` works as a
config, the JAX package's ``Config`` included; this one lets the port run
without that package.
"""

from __future__ import annotations

from typing import Any


class Config:
    """Recursive attribute-access wrapper over a nested dict: attribute and
    item access, ``in`` and ``.get(key, default)``."""

    __slots__ = ("_data",)

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {k: _wrap(v) for k, v in (data or {}).items()})

    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(f"Config has no key {key!r}") from None

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, _wrap(default))


def _wrap(v: Any) -> Any:
    return Config(v) if isinstance(v, dict) else v
