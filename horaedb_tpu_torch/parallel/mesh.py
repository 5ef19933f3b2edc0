"""Device mesh provider for the serving path.

The executor asks for THE mesh and shards large scans over it; small scans
stay single-device where dispatch overhead would dominate. The port serves
from one card, so there is no mesh yet and every scan is single-device.
"""

from __future__ import annotations

# Below this many valid rows a sharded dispatch costs more than it saves.
DEFAULT_DIST_MIN_ROWS = 1 << 18


def dist_min_rows() -> int:
    from ..utils.env import env_int

    return env_int("HORAEDB_DIST_MIN_ROWS", DEFAULT_DIST_MIN_ROWS)


def serving_mesh(min_devices: int = 2):
    """The mesh over the local cards, or None: single-device serving."""
    return None
