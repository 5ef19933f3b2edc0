"""Guarded environment-variable parsing.

An operator typo (``HORAEDB_MXU_MAX_SEGMENTS=8k``) must degrade to the
default, not abort the process — several of these are read at module
import, where an unguarded ``int()`` kills the whole server before it can
log anything. The guarded pattern existed ad hoc (merge.py, mesh.py);
this is the one shared helper every env-int read routes through.
"""

from __future__ import annotations

import os
from typing import Optional


def env_int(name: str, default: Optional[int]) -> Optional[int]:
    """``int(os.environ[name])`` with the malformed/missing cases folded
    to ``default``. Never raises. ``default=None`` lets a caller
    distinguish unset/malformed from any explicit value (including
    negatives) instead of burning a sentinel in the value space."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        return default


def env_float(name: str, default: float) -> float:
    """Float twin of :func:`env_int`. Never raises."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default
