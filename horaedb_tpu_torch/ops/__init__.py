"""The CUDA compute path.

- ``scan_agg``  — the fused filter -> time-bucket -> group-by -> aggregate
                  kernel (``csrc/scan_agg.cu``), its wrappers and their
                  plain PyTorch versions.
- ``merge_dedup`` — the k-way merge + dedup sort (``csrc/merge_dedup.cu``,
                  a stable LSD radix sort with the dedup mask as its
                  epilogue), its wrappers, plain versions and host packing.
- ``scan_topk`` — the raw-read fused filter + top-k and bounded selection
                  (``csrc/scan_topk.cu``) over the resident columns, their
                  wrappers and plain PyTorch versions.
- ``encoding``  — host-side prep (dense series codes, time buckets,
                  padding, the compressed resident layouts) and the plain
                  decode of those layouts.
- ``_build``    — builds the CUDA sources with ``nvcc`` at first use.
"""

from .encoding import (
    PaddedBatch,
    encode_group_codes,
    pad_to_bucket,
    shape_bucket,
)
from .merge_dedup import merge_dedup_permutation
from .scan_agg import AGG_OPS, ScanAggSpec, scan_aggregate

__all__ = [
    "PaddedBatch",
    "encode_group_codes",
    "pad_to_bucket",
    "shape_bucket",
    "AGG_OPS",
    "ScanAggSpec",
    "scan_aggregate",
    "merge_dedup_permutation",
]
