"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where torch sees no card; run them there with

    python -m pytest tests/test_torch_cuda.py -m cuda

The cases are chip_smoke.py's phase 3 at test size: counts, mins and maxs
bit-equal, sums within SUM_RTOL of the segment's sum of |x|.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("arm,G,B", [("single", 1, 1), ("shared", 16, 8), ("scatter", 512, 64)])
@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("op", chip_smoke.OPS)
def test_direct_kernel_matches_plain(card, arm, G, B, need_minmax, op):
    rng = np.random.default_rng(len(op) + G)
    chip_smoke._direct_case(torch, rng, 30_011, G, B, 3, op, need_minmax, arm)


@pytest.mark.parametrize("arm,G,B", [("single", 1, 1), ("shared", 16, 8), ("scatter", 512, 64)])
@pytest.mark.parametrize("case", chip_smoke.LAYOUT_CASES, ids=lambda c: "-".join([c[0], c[1], *c[2]]))
@pytest.mark.parametrize("selective", [False, True])
def test_cached_kernel_matches_plain(card, arm, G, B, case, selective):
    rng = np.random.default_rng(G + selective)
    chip_smoke._cached_case(torch, rng, case, arm, selective, True, ">", G, B, n_series=20, per=1001)


@pytest.mark.parametrize("kind", ["rk", "f32", "f64", "gen"])
@pytest.mark.parametrize("n", [1, 4095, 4097, 100_003])
@pytest.mark.parametrize("dup", [False, True])
def test_merge_kernel_matches_plain(card, kind, n, dup):
    """The merge-dedup sort of each kind against its plain version on the
    same CUDA tensors (chip_smoke.py's phase 7 at test size): perm and
    keep bit-equal, with dedup on and off."""
    rng = np.random.default_rng(n + len(kind) + dup)
    cols, fills, masks = chip_smoke._kind_words(rng, kind, n, dup)
    words = chip_smoke._upload_words(torch, cols, fills, n)
    for dedup in (True, False):
        chip_smoke._merge_check(torch, kind, words, masks, n, dedup, f"{kind} n={n}")


def test_cuda_compaction_raises_when_the_kernel_cannot_build(card, monkeypatch, tmp_path):
    """A compaction on a CUDA table whose merge kernel cannot be built
    raises; it never sorts on the host instead."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.engine.compaction import Compactor
    from horaedb_tpu_torch.engine.instance import EngineConfig
    from horaedb_tpu_torch.ops import _build
    from horaedb_tpu_torch.ops import merge_dedup as md

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "missing" / "nvcc"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(md, "_lib", None)
    db = horaedb_tpu_torch.connect(None, device="cuda", engine_config=EngineConfig(
        compaction_l0_trigger=10**9, compaction_interval_s=0))
    db.execute("CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
               "ENGINE=Analytic WITH (segment_duration='2h')")
    table = db.catalog.open("demo")
    for run in range(3):
        table.write(RowGroup.from_rows(table.schema, [
            {"name": f"h{i % 3}", "value": float(run), "t": i} for i in range(50)]))
        table.flush()
    td = table.physical_datas()[0]
    md.reset_counts()
    with pytest.raises((RuntimeError, OSError)):
        Compactor(td).compact()
    assert not any(md.PLAIN_CALLS.values()) and not any(md.LAUNCHES.values())
    assert len(td.version.levels.files_at(0)) == 3
