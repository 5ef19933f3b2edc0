"""Device mesh provider for the serving path.

The executor asks for THE mesh (every local card on one ``"shard"`` axis)
and shards large scans over it; small scans stay single-device where
dispatch overhead would dominate (ref boundary:
df_engine_extensions/src/dist_sql_query/resolver.rs:105-120, where the
reference decides local vs distributed execution).

A ``Mesh`` is an ordered tuple of ``torch.device``s. ``serving_mesh()``
builds one over all cards when there are at least two, else returns None.
``use_mesh(mesh)`` installs a mesh for the calls made inside it, which is
how the tests run the sharded path on the CPU and ``chip_smoke.py`` runs it
on one card: a **logical** mesh, several shards on one device
(``Mesh.logical``). ``use_mesh(None)`` pins single-device serving on a host
of several cards. The logical mesh is the counterpart of the reference's
forced host devices (``--xla_force_host_platform_device_count``), not a
serving feature: ``serving_mesh()`` never builds one by itself.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence

import torch

# Below this many valid rows a sharded dispatch costs more than it saves.
DEFAULT_DIST_MIN_ROWS = 1 << 18

_lock = threading.Lock()
_cached: Optional["Mesh"] = None
_cached_key = None
_NOTHING = object()  # no mesh installed: serving_mesh() looks at the cards
_installed = _NOTHING


def dist_min_rows() -> int:
    from ..utils.env import env_int

    return env_int("HORAEDB_DIST_MIN_ROWS", DEFAULT_DIST_MIN_ROWS)


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(device: torch.device):
    """A context that makes ``device`` the current card while a shard's
    work is queued (the kernels' launchers set the card themselves, and
    this restores the caller's on exit); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Mesh:
    """An ordered tuple of devices on the one ``"shard"`` axis: shard d of
    a sharded tensor lives on ``devices[d]``. A device may repeat (a
    logical mesh); the combine's output lives on ``devices[0]``."""

    def __init__(self, devices: Sequence) -> None:
        devs = tuple(_indexed(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type: {devs}")
        self.devices = devs

    @classmethod
    def logical(cls, device, shards: int) -> "Mesh":
        """``shards`` shards, all on ``device``."""
        if shards < 1:
            raise ValueError(f"{shards} shards")
        return cls([device] * shards)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def shard_rows(t: torch.Tensor, mesh: Mesh, fill=0) -> list:
    """Host tensor ``t`` (rows on its last axis) padded with ``fill`` to a
    multiple of the mesh size and cut into contiguous shards, shard d
    uploaded to ``mesh.devices[d]``."""
    extra = -t.shape[-1] % mesh.size
    if extra:
        pad = torch.full((*t.shape[:-1], extra), fill, dtype=t.dtype)
        t = torch.cat([t, pad], dim=-1)
    per = t.shape[-1] // mesh.size
    return [t[..., d * per:(d + 1) * per].contiguous().to(dev)
            for d, dev in enumerate(mesh.devices)]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``serving_mesh()`` return ``mesh`` (process-wide: the proxy's
    pool threads see it too) until the block ends; ``None`` serves from
    one device whatever the card count."""
    global _installed
    with _lock:
        before, _installed = _installed, mesh
    try:
        yield mesh
    finally:
        with _lock:
            _installed = before


def serving_mesh(min_devices: int = 2, device=None) -> Optional[Mesh]:
    """The mesh over all local cards, or None when not worth it.

    Cached per card set, so the same object comes back while the set is
    unchanged (the scan cache compares meshes by identity); safe to call
    per query. ``None`` means "run single-device": fewer than
    ``min_devices`` cards, or ``device`` (the connection's) is not a card.
    An installed mesh (``use_mesh``) wins, ``None`` included; one on
    another device type than ``device`` raises."""
    global _cached, _cached_key
    dev = torch.device(device) if device is not None else None
    with _lock:
        installed = _installed
    if installed is not _NOTHING:
        if installed is not None and dev is not None and installed.first.type != dev.type:
            raise ValueError(f"installed {installed} but the connection is on {dev}")
        return installed
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < min_devices:
        return None
    with _lock:
        if _cached_key != n:
            _cached = Mesh([torch.device("cuda", i) for i in range(n)])
            _cached_key = n
        return _cached
