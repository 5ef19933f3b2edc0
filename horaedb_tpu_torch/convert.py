"""State carried across from the JAX package.

The on-disk state — WAL, manifest, Parquet SSTs — is written by the same
code in both packages, so a data directory opens in either with no
conversion. What does not carry over by itself is a scan-cache entry's
device-resident columns: ``entry_from_reference`` rebuilds them on a
torch device from their numpy form, bit for bit, so both packages' kernels
can run on identical encoded columns.

``arrays`` names each resident part by ``<column>/<part index>``:
``series_codes/0``, ``series_codes/1`` (codes, or words + block bases),
``ts_rel/0``, ``ts_rel/1`` (values, words + bases, or words + dictionary),
and ``value/<field>/<part>`` per value field in query order (values, or
words + dictionary). ``layouts`` holds the matching descriptors under
``series_codes``, ``ts_rel`` and ``value`` (a tuple, one per field), in the
forms ``ops.encoding`` documents.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ops.encoding import layout_rows


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype == np.uint32:
        # packed words travel as int32 bits
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


def _parts(arrays: dict, prefix: str, device) -> tuple:
    out = []
    k = 0
    while f"{prefix}/{k}" in arrays:
        out.append(_tensor(arrays[f"{prefix}/{k}"], device))
        k += 1
    if not out:
        raise KeyError(f"no parts under {prefix!r}")
    return tuple(out)


@dataclass(frozen=True)
class ResidentEntry:
    """A scan-cache entry's resident columns on one device: the inputs
    ``ops.scan_agg.cached_scan_agg_packed`` reads."""

    series_parts: tuple
    ts_parts: tuple
    value_parts: tuple  # one part tuple per value field
    series_layout: tuple
    ts_layout: tuple
    value_layouts: tuple
    padded_rows: int

    def kernel_args(self) -> dict:
        return dict(
            series_parts=self.series_parts,
            ts_parts=self.ts_parts,
            values=self.value_parts,
        )

    def layout_kwargs(self) -> dict:
        return dict(
            value_layouts=self.value_layouts,
            ts_layout=self.ts_layout,
            series_layout=self.series_layout,
        )


def entry_from_reference(arrays: dict[str, np.ndarray], layouts, device) -> ResidentEntry:
    """Build the port's resident entry on ``device`` from a JAX scan-cache
    entry's resident parts (as numpy) and their layout descriptors."""
    device = torch.device(device)
    series_layout = tuple(layouts["series_codes"])
    ts_layout = tuple(layouts["ts_rel"])
    value_layouts = tuple(tuple(l) for l in layouts["value"])
    series_parts = _parts(arrays, "series_codes", device)
    ts_parts = _parts(arrays, "ts_rel", device)
    value_parts = tuple(
        _parts(arrays, f"value/{f}", device) for f in range(len(value_layouts))
    )
    n_rows = layout_rows(series_parts, series_layout)
    if ts_layout[0] != "dict" and layout_rows(ts_parts, ts_layout) != n_rows:
        raise ValueError("series and timestamp columns differ in length")
    return ResidentEntry(
        series_parts=series_parts,
        ts_parts=ts_parts,
        value_parts=value_parts,
        series_layout=series_layout,
        ts_layout=ts_layout,
        value_layouts=value_layouts,
        padded_rows=n_rows,
    )
