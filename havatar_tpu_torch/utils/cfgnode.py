"""Attribute-style configuration nodes with YAML round-tripping.

The port's own copy of ``havatar_tpu/utils/cfgnode.py`` (the same API:
attribute access, ``dump``, ``merge_from_file`` / ``merge_from_list``,
``freeze``). ``yaml`` is imported inside the functions that read or write
YAML, so importing this module needs no PyYAML.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List

_FROZEN = "__frozen__"


class CfgNode(dict):
    """A dict subclass exposing keys as attributes, with optional freezing."""

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        for k, v in init_dict.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value)
        if isinstance(value, list):
            return [cls._wrap(v) for v in value]
        return value

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {name!r}")
        self[name] = self._wrap(value)

    def __setitem__(self, key, value):
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {key!r}")
        super().__setitem__(key, self._wrap(value))

    # -- freezing ----------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self):
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    # -- (de)serialisation ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        def _unwrap(v):
            if isinstance(v, CfgNode):
                return {k: _unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [_unwrap(x) for x in v]
            return v

        return _unwrap(self)

    def dump(self, **kwargs) -> str:
        import yaml

        kwargs.setdefault("default_flow_style", False)
        kwargs.setdefault("sort_keys", False)
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def clone(self) -> "CfgNode":
        return CfgNode(copy.deepcopy(self.to_dict()))

    # -- merging ----------------------------------------------------------
    def merge_from_other(self, other: "CfgNode"):
        for k, v in other.items():
            if k in self and isinstance(self[k], CfgNode) and isinstance(v, (dict, CfgNode)):
                self[k].merge_from_other(CfgNode(dict(v)))
            else:
                self[k] = v
        return self

    def merge_from_file(self, path: str):
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        return self.merge_from_other(CfgNode(loaded))

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, raw in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node[parts[-1]] = value
        return self


def load_config(path: str) -> CfgNode:
    import yaml

    with open(path, "r") as f:
        return CfgNode(yaml.safe_load(f) or {})
