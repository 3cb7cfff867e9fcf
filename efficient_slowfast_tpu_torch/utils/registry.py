"""Name → builder registry (reference: fvcore Registry used by
slowfast/models/build.py:9-16 and slowfast/datasets/build.py:6-13)."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._objects: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, *, name: Optional[str] = None):
        """Use as ``@REGISTRY.register()`` decorator or ``REGISTRY.register(obj)``."""
        if obj is None:
            def deco(fn_or_cls):
                self._do_register(name or fn_or_cls.__name__, fn_or_cls)
                return fn_or_cls
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._objects:
            raise KeyError(f"'{name}' already registered in {self._name}")
        self._objects[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._objects:
            raise KeyError(
                f"'{name}' not found in registry {self._name}. "
                f"Available: {sorted(self._objects)}"
            )
        return self._objects[name]

    def __contains__(self, name: str) -> bool:
        return name in self._objects

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._objects.items())

    def keys(self):
        return self._objects.keys()
