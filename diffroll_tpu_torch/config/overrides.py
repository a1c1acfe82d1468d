"""Dotted-key overrides over frozen dataclass trees (the pure-Python
`diffroll_tpu/config/overrides.py`): `task.w=0.5`, `task.inpainting_t=[100,200]`,
`trainer.run_name=null`, with values coerced by the target field's type."""

from __future__ import annotations

import ast
import collections.abc
import dataclasses
import typing
from typing import Any, Dict, List, Tuple


def parse_argv(argv: List[str]) -> Tuple[List[str], Dict[str, str]]:
    """Split argv into positional args and `key=value` overrides."""
    positional, overrides = [], {}
    for tok in argv:
        if "=" in tok and not tok.startswith("-"):
            k, _, v = tok.partition("=")
            overrides[k] = v
        else:
            positional.append(tok)
    return positional, overrides


def _literal(text: str) -> Any:
    low = text.lower()
    if low in ("null", "none"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def coerce(value: str, annotation: Any) -> Any:
    """Coerce a CLI string to a field annotation's type."""
    lit = _literal(value)
    origin = typing.get_origin(annotation)
    if origin is typing.Union:  # Optional[...] and friends
        if lit is None:
            return None
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        return coerce(value, args[0]) if len(args) == 1 else lit
    if origin is collections.abc.Sequence:
        origin = tuple  # Sequence fields are stored as tuples (hashable)
    if origin in (tuple, list):
        if isinstance(lit, str):
            lit = [s.strip() for s in lit.strip("[]()").split(",") if s.strip()]
        item_types = typing.get_args(annotation)
        seq = list(lit) if isinstance(lit, (list, tuple)) else [lit]
        if item_types and item_types[-1] is not Ellipsis and len(item_types) == len(seq):
            seq = [t(v) if t in (int, float, str, bool) else v
                   for t, v in zip(item_types, seq)]
        elif item_types and item_types[0] in (int, float, str, bool):
            seq = [item_types[0](v) for v in seq]
        return tuple(seq) if origin is tuple else seq
    if annotation in (int, float, bool, str) and lit is not None:
        if annotation is bool and isinstance(lit, str):
            raise ValueError(f"cannot parse bool from {value!r}")
        return annotation(lit)
    return lit


def apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """A copy of `cfg` with dotted-key overrides applied; string values are
    coerced via the target field's annotation."""
    grouped: Dict[str, Dict[str, Any]] = {}
    direct: Dict[str, Any] = {}
    for key, val in overrides.items():
        head, _, rest = key.partition(".")
        if rest:
            grouped.setdefault(head, {})[rest] = val
        else:
            direct[head] = val

    fields = {f.name: f for f in dataclasses.fields(cfg)}
    hints = typing.get_type_hints(type(cfg))
    updates: Dict[str, Any] = {}
    for name, val in direct.items():
        if name not in fields:
            raise KeyError(f"unknown config key {name!r} on {type(cfg).__name__}; "
                           f"choices: {sorted(fields)}")
        ann = hints.get(name, fields[name].type)
        updates[name] = coerce(val, ann) if isinstance(val, str) else val
    for name, sub in grouped.items():
        if name not in fields:
            raise KeyError(f"unknown config group {name!r} on {type(cfg).__name__}; "
                           f"choices: {sorted(fields)}")
        child = updates.get(name, getattr(cfg, name))
        if not (dataclasses.is_dataclass(child) and not isinstance(child, type)):
            raise KeyError(f"config key {name!r} is not a group; cannot set {sub}")
        updates[name] = apply_overrides(child, sub)
    return dataclasses.replace(cfg, **updates)
