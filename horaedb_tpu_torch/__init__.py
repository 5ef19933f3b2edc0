"""horaedb_tpu_torch — the time-series database of ``horaedb_tpu``, with its
device work in PyTorch and hand-written CUDA kernels for one NVIDIA Hopper
card.

The package follows ``horaedb_tpu``'s layout module for module. Host code
(SQL front end, LSM engine over Parquet SSTs, WAL, manifest) is the same
code; the device path — the fused scan-aggregate over the resident scan
cache — runs as the CUDA kernel in ``ops/csrc/scan_agg.cu``.

    import horaedb_tpu_torch
    db = horaedb_tpu_torch.connect(None, device="cuda")   # or "cpu"

``device="cpu"`` runs every kernel's plain PyTorch version (what the tests
use); ``device="cuda"`` raises when no card is usable.
"""

__version__ = "0.1.0"

from .db import Connection, connect  # noqa: E402

__all__ = ["Connection", "connect", "__version__"]
