"""Distributed execution over a device mesh.

Where the reference distributes queries by shipping serialized DataFusion
subplans over gRPC to remote nodes and merging arrow streams back
(SURVEY §2.5, df_engine_extensions dist push-down), the port expresses
the same partial-aggregate/final-aggregate split over a ``Mesh`` of
devices: rows are cut into contiguous shards, one per device, every shard
runs the single-device kernel on its rows, and the ``mesh_combine`` kernel
does the final combine on the mesh's first device. No plan codec, no RPC
on the data path. ``serving_mesh()`` finds a mesh over every card when a
host has two or more; ``use_mesh(Mesh.logical(device, S))`` runs S shards
on one device (the tests on the CPU, ``chip_smoke.py`` on one card).
"""

from .dist_agg import dist_cached_step, dist_direct_step, dist_scan_aggregate
from .dist_merge import dist_merge_dedup

__all__ = ["dist_scan_aggregate", "dist_direct_step", "dist_cached_step", "dist_merge_dedup"]
