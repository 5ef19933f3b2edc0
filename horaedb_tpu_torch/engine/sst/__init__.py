"""SST layer: Parquet files in object storage (ref: analytic_engine/src/sst)."""

from .meta import SstMeta
from .writer import SstWriter
from .reader import SstReader
from .manager import FileHandle, LevelsController, MAX_LEVEL

__all__ = [
    "SstMeta",
    "SstWriter",
    "SstReader",
    "FileHandle",
    "LevelsController",
    "MAX_LEVEL",
]
