"""Environment flags of the JAX package's perf knobs, read the same way.

A copy of ``cellulus_tpu/utils/env.py``: the config field wins when set;
otherwise the environment variable is read, and ``NAME=0`` / ``NAME=false``
disable exactly as ``NAME=1`` enables.
"""

from __future__ import annotations

import os
from typing import Optional

_FALSY = {"", "0", "false", "no", "off"}


def env_flag(name: str) -> bool:
    """True when env var ``name`` holds a truthy string (unset, empty,
    ``0``, ``false``, ``no`` and ``off``, in any case, read as False)."""
    return os.environ.get(name, "").strip().lower() not in _FALSY


def resolve_flag(config_value: Optional[bool], env_name: str) -> bool:
    """Config field wins when set (not None); else fall back to the env var."""
    if config_value is not None:
        return bool(config_value)
    return env_flag(env_name)
