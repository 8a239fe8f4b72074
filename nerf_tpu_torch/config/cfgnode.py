"""YACS-style nested configuration node (port of
``nerf_tpu/config/cfgnode.py``, unchanged but for the lazy ``yaml`` import:
the package needs ``pyyaml`` only to read or write a YAML file).

Behavioral parity target (reference: krrish94/nerf-pytorch, nerf/cfgnode.py —
itself a vendored YACS/fvcore variant). Capabilities reproduced:

  - nested attribute-style access over dict config trees (cfgnode.py:36)
  - ``merge_from_file`` / ``merge_from_other_cfg`` / ``merge_from_list``
    (cfgnode.py:189-236) with type-coerced merging (cfgnode.py:465-505):
    a replacement value must match the original's type, with the YACS
    casting whitelist (list<->tuple, str<->unicode analog dropped,
    None-able targets, int->float promotion)
  - ``freeze`` / ``defrost`` / ``is_frozen`` immutability (cfgnode.py:238-252)
  - ``clone`` (cfgnode.py:254), ``dump`` to YAML (cfgnode.py:180),
    ``load_cfg`` from a YAML string/file object (cfgnode.py:324) or a
    Python source file exporting a ``cfg`` attribute (cfgnode.py:369-384)
  - new-key control: ``set_new_allowed`` and the ``__new_allowed__``
    semantics so merging files with novel keys can be permitted per-node
  - deprecated / renamed key registries (cfgnode.py:270-319): merging a
    registered deprecated key warns and drops it; merging a renamed key
    raises with the new name (and optional migration message)

This is a fresh implementation (plain-Python, no torch), not a copy: state is
held in reserved dunder slots on the dict subclass, YAML I/O uses safe_load,
and error messages name the full key path.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

_RESERVED = ("__frozen__", "__new_allowed__", "__deprecated_keys__", "__renamed_keys__")


class CfgNode(dict):
    """A nested, attribute-accessible, freezable configuration dictionary."""

    def __init__(
        self,
        init_dict: Optional[Dict[str, Any]] = None,
        new_allowed: bool = False,
    ):
        init_dict = {} if init_dict is None else init_dict
        init_dict = self._create_tree(init_dict, new_allowed)
        super().__init__(init_dict)
        object.__setattr__(self, "__frozen__", False)
        object.__setattr__(self, "__new_allowed__", new_allowed)
        object.__setattr__(self, "__deprecated_keys__", set())
        object.__setattr__(self, "__renamed_keys__", {})

    @classmethod
    def _create_tree(cls, d: Dict[str, Any], new_allowed: bool) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = cls(v, new_allowed=new_allowed)
            else:
                cls._assert_valid_value(v, k)
                out[k] = v
        return out

    @staticmethod
    def _assert_valid_value(value: Any, name: str) -> None:
        valid = (type(None), bool, int, float, str, list, tuple, CfgNode)
        if not isinstance(value, valid):
            raise ValueError(
                f"Config key {name!r} has invalid type {type(value).__name__}; "
                f"allowed: None/bool/int/float/str/list/tuple/CfgNode"
            )

    # -- attribute protocol -------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name!r} on an immutable (frozen) CfgNode"
            )
        if name in _RESERVED:
            raise AttributeError(f"{name!r} is reserved")
        self._assert_valid_value(value, name)
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name!r} on an immutable (frozen) CfgNode"
            )
        super().__setitem__(name, value)

    # -- immutability --------------------------------------------------------

    def freeze(self) -> "CfgNode":
        self._set_frozen(True)
        return self

    def defrost(self) -> "CfgNode":
        self._set_frozen(False)
        return self

    def is_frozen(self) -> bool:
        return getattr(self, "__frozen__", False)

    def _set_frozen(self, frozen: bool) -> None:
        object.__setattr__(self, "__frozen__", frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def set_new_allowed(self, new_allowed: bool) -> None:
        object.__setattr__(self, "__new_allowed__", new_allowed)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(new_allowed)

    def is_new_allowed(self) -> bool:
        return getattr(self, "__new_allowed__", False)

    # -- deprecated / renamed key registries ----------------------------------
    # Registered on the ROOT node being merged into; full keys are dotted
    # paths ("nerf.ndc"). Reference semantics (cfgnode.py:270-319): merging a
    # deprecated key warns + ignores it; merging a renamed key raises KeyError
    # naming the replacement.

    def register_deprecated_key(self, key: str) -> None:
        # __init__ always sets the registry, so it is never absent.
        deprecated = getattr(self, "__deprecated_keys__")
        if key in deprecated:
            raise ValueError(f"key {key!r} is already registered as deprecated")
        deprecated.add(key)

    def register_renamed_key(
        self, old_name: str, new_name: str, message: Optional[str] = None
    ) -> None:
        renamed = getattr(self, "__renamed_keys__")
        if old_name in renamed:
            raise ValueError(f"key {old_name!r} is already registered as renamed")
        renamed[old_name] = (new_name, message) if message else new_name

    def key_is_deprecated(self, full_key: str) -> bool:
        if full_key in getattr(self, "__deprecated_keys__", ()):
            import warnings

            warnings.warn(f"deprecated config key (ignoring): {full_key}")
            return True
        return False

    def key_is_renamed(self, full_key: str) -> bool:
        return full_key in getattr(self, "__renamed_keys__", {})

    def raise_key_rename_error(self, full_key: str) -> None:
        new_key = getattr(self, "__renamed_keys__", {})[full_key]
        msg = ""
        if isinstance(new_key, tuple):
            msg = " Note: " + new_key[1]
            new_key = new_key[0]
        raise KeyError(
            f"Key {full_key} was renamed to {new_key}; please update your config.{msg}"
        )

    # -- cloning / serialization ---------------------------------------------

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self, **kwargs: Any) -> str:
        kwargs.setdefault("default_flow_style", False)
        kwargs.setdefault("sort_keys", False)
        import yaml

        return yaml.safe_dump(self.to_dict(), **kwargs)

    # -- merging ---------------------------------------------------------------

    def merge_from_file(self, cfg_filename: str) -> None:
        if cfg_filename.endswith(".py"):
            loaded = _load_cfg_py_source(cfg_filename)
        else:
            with open(cfg_filename, "r") as f:
                loaded = load_cfg(f)
        self.merge_from_other_cfg(loaded)

    def merge_from_other_cfg(self, cfg_other: "CfgNode") -> None:
        _merge_a_into_b(cfg_other, self, self, [])

    def merge_from_list(self, cfg_list: List[Any]) -> None:
        """Merge dotted-key / value pairs, e.g. ["optimizer.lr", 1e-3]."""
        if len(cfg_list) % 2 != 0:
            raise ValueError(
                f"Override list has odd length {len(cfg_list)}; expected key-value pairs"
            )
        for full_key, value in zip(cfg_list[0::2], cfg_list[1::2]):
            if self.key_is_deprecated(full_key):
                continue
            if self.key_is_renamed(full_key):
                self.raise_key_rename_error(full_key)
            parts = full_key.split(".")
            node = self
            for part in parts[:-1]:
                if part not in node:
                    raise KeyError(f"Non-existent config key: {full_key}")
                node = node[part]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"{full_key}: {part} is a leaf, not a node")
            leaf = parts[-1]
            if leaf not in node and not node.is_new_allowed():
                raise KeyError(f"Non-existent config key: {full_key}")
            value = _decode_value(value)
            if leaf in node:
                value = _check_and_coerce_value_type(value, node[leaf], full_key)
            node[leaf] = value

    def __str__(self) -> str:
        def _indent(text: str, num: int) -> str:
            lines = text.split("\n")
            return ("\n" + " " * num).join(lines)

        parts = []
        for k, v in sorted(self.items()):
            sep = "\n" if isinstance(v, CfgNode) else " "
            parts.append(f"{k}:{sep}{_indent(str(v), 2)}")
        return "\n".join(parts)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({super().__repr__()})"


def load_cfg(source) -> CfgNode:
    """Load a CfgNode from a YAML string or file-like object (cfgnode.py:324).

    A file object backed by a ``.py`` source file loads through the
    Python-source path (reference cfgnode.py:348-384): the module must export
    a ``cfg`` attribute that is a dict or CfgNode.
    """
    if hasattr(source, "read"):
        name = getattr(source, "name", "")
        if isinstance(name, str) and name.endswith(".py"):
            return _load_cfg_py_source(name)
        source = source.read()
    import yaml

    data = yaml.safe_load(source)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise TypeError(f"Config YAML must map keys to values; got {type(data)}")
    return CfgNode(data)


def _load_cfg_py_source(filename: str) -> CfgNode:
    """Load a config from a Python source file exporting ``cfg``
    (reference cfgnode.py:369-384)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("nerf_tpu_torch.config.override", filename)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, "cfg"):
        raise AttributeError(
            f"Python config module {filename} must export a 'cfg' attribute"
        )
    if not isinstance(module.cfg, (dict, CfgNode)):
        raise TypeError(
            f"{filename}: 'cfg' must be a dict or CfgNode, got {type(module.cfg)}"
        )
    return CfgNode(dict(module.cfg))


def _decode_value(value: Any) -> Any:
    """Parse CLI-style string overrides into Python literals where possible."""
    if not isinstance(value, str):
        return value
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _merge_a_into_b(a: CfgNode, b: CfgNode, root: CfgNode, key_path: List[str]) -> None:
    """Merge tree a into tree b with type coercion (cfgnode.py:427-462)."""
    for k, v_ in a.items():
        full_key = ".".join(key_path + [k])
        v = copy.deepcopy(v_)
        if k not in b:
            if root.key_is_deprecated(full_key):
                continue
            if root.key_is_renamed(full_key):
                root.raise_key_rename_error(full_key)
        if k in b:
            v = _check_and_coerce_value_type(v, b[k], full_key)
            if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
                _merge_a_into_b(v, b[k], root, key_path + [k])
            else:
                b[k] = v
        elif b.is_new_allowed():
            b[k] = v
        else:
            raise KeyError(f"Non-existent config key: {full_key}")


_CASTS = [
    (tuple, list),
    (list, tuple),
]


def _check_and_coerce_value_type(replacement: Any, original: Any, full_key: str) -> Any:
    """Type-check a replacement value against the original (cfgnode.py:465-505)."""
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type:
        return replacement
    # None-able targets / replacing None with anything
    if original is None or replacement is None:
        return replacement
    # numeric promotion: allow int -> float
    if original_type is float and replacement_type is int:
        return float(replacement)
    if original_type is int and replacement_type is float and float(replacement).is_integer():
        return int(replacement)
    # bool is an int subclass in Python; forbid silent bool<->int swaps
    for src, dst in _CASTS:
        if replacement_type is src and original_type is dst:
            return dst(replacement)
    # dict loaded from yaml merging into CfgNode
    if isinstance(replacement, dict) and isinstance(original, CfgNode):
        return CfgNode(replacement)
    raise ValueError(
        f"Type mismatch ({original_type.__name__} vs {replacement_type.__name__}) "
        f"for config key {full_key}: {original!r} vs {replacement!r}"
    )
