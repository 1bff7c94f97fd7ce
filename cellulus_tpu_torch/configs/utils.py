"""Helpers shared by the config dataclasses."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional, Type, TypeVar

T = TypeVar("T")


def as_config(cls: Type[T], value: Any) -> Optional[T]:
    """Convert a (possibly nested) dict into a config object of type ``cls``.

    ``None`` passes through, and already-constructed config objects are
    returned as-is so configs can be built programmatically.
    """
    if value is None:
        return None
    if isinstance(value, cls):
        return value
    if isinstance(value, dict):
        return cls(**value)
    raise TypeError(f"cannot convert {type(value).__name__} to {cls.__name__}")


def as_path(value: Any) -> Optional[Path]:
    if value is None:
        return None
    return Path(value)


def check_type(obj: Any, field_name: str, types: tuple) -> None:
    value = getattr(obj, field_name)
    if not isinstance(value, types):
        raise TypeError(
            f"{type(obj).__name__}.{field_name} must be of type "
            f"{'/'.join(t.__name__ for t in types)}, got {type(value).__name__}"
        )


def asdict_config(obj: Any) -> dict:
    """Recursively convert a config dataclass to a plain dict (for printing
    and serialization). Paths become strings."""

    def convert(v: Any) -> Any:
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: convert(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, (list, tuple)):
            return [convert(x) for x in v]
        return v

    return convert(obj)
