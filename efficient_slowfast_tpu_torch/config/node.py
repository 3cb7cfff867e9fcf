"""Attribute-accessible config tree (yacs/fvcore-style) for the port.

The port's own copy of ``efficient_slowfast_tpu/config/node.py``: attribute
access, YAML file merge, CLI key-value list merge, freezing and thawing, a
sorted-key YAML dump and a hashable ``static()`` view. PyYAML is imported
only where a YAML file is read or written, so a config built in code needs
nothing beyond the standard library.
CLI values are parsed with ``ast.literal_eval`` (as yacs does).
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List

_FROZEN = "__cfg_frozen__"


class CfgNode(dict):
    """Attribute-accessible nested config dict with freeze/merge semantics."""

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{name}' on a frozen config")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def __delattr__(self, name: str) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot delete '{name}' on a frozen config")
        del self[name]

    # -- freeze -----------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    # -- merge ------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge(other, self, [])

    def merge_from_file(self, filename: str,
                        allow_unsafe: bool = False) -> None:
        """Merge a YAML file. ``allow_unsafe`` is yacs's flag, accepted for
        its callers: the file is read with ``yaml.safe_load`` either way."""
        import yaml

        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self.merge_from_other_cfg(CfgNode(loaded))

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge ``[KEY, value, KEY, value, ...]`` pairs (the CLI `opts` tail)."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            d = self
            for sub in keys[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent config key: {full_key}")
                d = d[sub]
            last = keys[-1]
            if last not in d:
                raise KeyError(f"Non-existent config key: {full_key}")
            d[last] = _coerce(v, d[last], full_key)

    # -- io ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
                for k, v in self.items()}

    def dump(self) -> str:
        """The config as block-style YAML with sorted keys."""
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=False,
                              sort_keys=True)

    def clone(self) -> "CfgNode":
        return CfgNode(self.to_dict())

    def static(self) -> "CfgStatic":
        """Hashable immutable view, safe to keep on a module."""
        return CfgStatic(self.to_dict())

    def __deepcopy__(self, memo):
        return CfgNode(self.to_dict())


def _to_hashable(v: Any) -> Any:
    if isinstance(v, dict):
        return CfgStatic(v)
    if isinstance(v, (list, tuple)):
        return tuple(_to_hashable(x) for x in v)
    return v


class CfgStatic:
    """Immutable, hashable namespace view of a CfgNode (lists → tuples)."""

    def __init__(self, d: dict):
        object.__setattr__(self, "_items", tuple(sorted(
            (k, _to_hashable(v)) for k, v in d.items()
        )))
        for k, v in self._items:
            object.__setattr__(self, k, v)

    def __setattr__(self, k, v):
        raise AttributeError("CfgStatic is immutable")

    def __eq__(self, other):
        return isinstance(other, CfgStatic) and self._items == other._items

    def __hash__(self):
        return hash(self._items)


def _merge(src: CfgNode, dst: CfgNode, path: List[str]) -> None:
    for k, v in src.items():
        full = ".".join(path + [k])
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full}")
        if isinstance(v, CfgNode) and isinstance(dst[k], CfgNode):
            _merge(v, dst[k], path + [k])
        else:
            dst[k] = _coerce(v, dst[k], full)


def _literal(value: str) -> Any:
    """Python literal of a CLI string, or the string itself."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _as_float(v: str):
    try:
        return float(v)
    except ValueError:
        return None


def _coerce_list(value: list, existing, key: str) -> list:
    """Numeric strings in a list (YAML 1.1 reads ``1e-4`` as a string)."""
    numeric = [e for e in existing
               if isinstance(e, (int, float)) and not isinstance(e, bool)]
    if existing and len(numeric) == len(existing):
        all_int = all(isinstance(e, int) for e in existing)
        out = []
        for v in value:
            if isinstance(v, str):
                f = _as_float(v)
                if f is None:
                    raise ValueError(
                        f"Cannot coerce {v!r} to float in list key {key}")
                v = int(f) if all_int and f.is_integer() else f
            out.append(v)
        return out
    if not existing and all(
            (isinstance(v, (int, float)) and not isinstance(v, bool))
            or (isinstance(v, str) and _as_float(v) is not None)
            for v in value):
        return [float(v) if isinstance(v, str) else v for v in value]
    return value


def _coerce(value: Any, existing: Any, key: str) -> Any:
    """Coerce a merged value to the type already present at ``key``."""
    if isinstance(value, str) and not isinstance(existing, str):
        value = _literal(value)
    if isinstance(value, str) and isinstance(existing, float):
        try:
            value = float(value)
        except ValueError:
            raise ValueError(f"Cannot coerce {value!r} to float for key {key}")
    elif (isinstance(value, str) and isinstance(existing, int)
          and not isinstance(existing, bool)):
        try:
            f = float(value)
        except ValueError:
            raise ValueError(f"Cannot coerce {value!r} to int for key {key}")
        value = int(f) if f.is_integer() else f
    if (isinstance(value, list) and isinstance(existing, (list, tuple))
            and any(isinstance(v, str) for v in value)):
        value = _coerce_list(value, existing, key)
    if existing is None or value is None:
        return value
    if isinstance(existing, bool) and not isinstance(value, bool):
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        raise ValueError(f"Cannot coerce {value!r} to bool for key {key}")
    if isinstance(existing, float) and isinstance(value, int):
        return float(value)
    if isinstance(existing, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if (isinstance(existing, int) and isinstance(value, float)
            and value.is_integer()):
        return int(value)
    return value
