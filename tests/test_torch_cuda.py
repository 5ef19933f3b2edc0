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
@pytest.mark.parametrize("n", [1, 5119, 5120, 5121, 100_003])
@pytest.mark.parametrize("dup", [False, True])
def test_merge_kernel_matches_plain(card, kind, n, dup):
    """The merge-dedup sort of each kind against its plain version on the
    same CUDA tensors (chip_smoke.py's phase 7 at test size): perm and
    keep bit-equal, with dedup on and off, on exact and padded words."""
    rng = np.random.default_rng(n + len(kind) + dup)
    cols, fills, masks = chip_smoke._kind_words(rng, kind, n, dup)
    for pad in (0, 1000):
        words = chip_smoke._upload_words(torch, cols, fills, n, pad)
        for dedup in (True, False):
            chip_smoke._merge_check(torch, kind, words, masks, n, dedup,
                                    f"{kind} n={n} pad={pad}")


@pytest.mark.parametrize("kind", ["rk", "f32", "f64", "gen"])
@pytest.mark.parametrize("what", ["const", "top", "boundary"])
def test_merge_kernel_skips_constant_digits(card, kind, what):
    """Keys constant in every digit take no pass; keys that vary only in
    the top bit of a word take one a word, across the first digit boundary
    two: perm and keep still bit-equal to the plain version."""
    n = 3 * 5120 + 7
    cols, fills, masks, want = chip_smoke._edge_words(kind, n, what)
    words = chip_smoke._upload_words(torch, cols, fills, n)
    assert chip_smoke._merge_check(torch, kind, words, masks, n, True, what) == want


@pytest.mark.parametrize("kind", ["rk", "f32", "f64", "gen"])
def test_merge_kernel_replays_on_one_scratch(card, kind):
    """One call twice on the same scratch, the second finding the first's
    status words and tile counters there: the same answer as the plain
    version both times."""
    rng = np.random.default_rng(len(kind))
    n = 100_003
    cols, fills, masks = chip_smoke._kind_words(rng, kind, n, True)
    words = chip_smoke._upload_words(torch, cols, fills, n)
    chip_smoke._replay_check(torch, kind, words, masks, n, kind)


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


@pytest.mark.parametrize("depth,cap", [(8, 64), (8, 4096), (128, 64), (128, 4096)])
@pytest.mark.parametrize("n", [1, 4000, 24_000])
@pytest.mark.parametrize("one_cell", [False, True])
@pytest.mark.parametrize("reset", ["none", "one", "all"])
def test_livewindow_fold_matches_plain(card, depth, cap, n, one_cell, reset):
    """The fold kernel against its plain version on clones of one CUDA ring
    (chip_smoke.py's phase 10 at test size): counts, mins and maxs
    bit-equal, sums and increments within SUM_RTOL of the cell's sum of
    |x|; +-0, a masked row, wrapped and dropped indices in every batch."""
    from horaedb_tpu_torch.ops import livewindow as L

    rng = np.random.default_rng(depth + cap + n)
    base = L.alloc_rings(depth, cap, card)
    warm = chip_smoke._lw_batch(rng, depth, cap, 3 * cap, False, "none", True)
    L.fold_plain(base, *chip_smoke._lw_words(torch, warm))
    batch = chip_smoke._lw_batch(rng, depth, cap, n, one_cell, reset, n % 2 == 0)
    chip_smoke._lw_fold_check(torch, base, *chip_smoke._lw_words(torch, batch), "fold")


@pytest.mark.parametrize("depth,cap", [(8, 64), (128, 4096)])
@pytest.mark.parametrize("n", [1, 60, 128])
def test_livewindow_gather_matches_plain(card, depth, cap, n):
    from horaedb_tpu_torch.ops import livewindow as L

    rng = np.random.default_rng(n)
    base = L.alloc_rings(depth, cap, card)
    warm = chip_smoke._lw_batch(rng, depth, cap, 2 * depth * cap, False, "none", True)
    L.fold_plain(base, *chip_smoke._lw_words(torch, warm))
    idx = rng.integers(0, depth, n).astype(np.int32)
    if n >= 4:
        idx[:4] = (depth, depth + 7, -1, -depth - 3)
    # the whole ring, a half plus one, and at cap 4096 widths off 16 bytes
    # (1, 3, 4001) and the main path's 4000
    for g in chip_smoke.LW_GATHER_G[cap]:
        chip_smoke._lw_gather_check(torch, base, torch.from_numpy(idx).to(card), g,
                                    f"gather g {g}")


@pytest.mark.parametrize("odd", ["sliced", "shifted"])
@pytest.mark.parametrize("n", [1, 60, 128])
def test_livewindow_gather_on_odd_rings_matches_plain(card, odd, n):
    """A ring of cap 4093 sliced from a wider one, and one whose base lies
    4 bytes past a 16-byte boundary: the gather takes its 4-byte path and
    stays bit-equal to the plain version."""
    from horaedb_tpu_torch.ops import livewindow as L

    rng = np.random.default_rng(n)
    base = L.alloc_rings(128, 4096, card)
    warm = chip_smoke._lw_batch(rng, 128, 4096, 2 * 128 * 4096, False, "none", True)
    L.fold_plain(base, *chip_smoke._lw_words(torch, warm))
    ring = dict(chip_smoke._lw_odd_rings(torch, base))[odd]
    assert ring.shape[2] % 4 != 0 or ring.data_ptr() % 16 != 0
    idx = rng.integers(-140, 140, n).astype(np.int32)
    for g in sorted({int(ring.shape[2]), 4000}):
        chip_smoke._lw_gather_check(torch, ring, torch.from_numpy(idx).to(card), g,
                                    f"{odd} gather g {g} n {n}")


@pytest.mark.parametrize("n_states", [1, 6, 33])
def test_livewindow_grouped_fold_matches_plain(card, n_states):
    """One grouped fold launch over several states' rings on the card
    (tests/torch_livewindow_cases.py: a reset slot the same commit's rows
    land in, every slot reset, counter pairs, a long run on one cell, a
    state without rows; 33 states take two launches) against the plain
    version state by state: counts, mins and maxs bit-equal, sums within
    SUM_RTOL of the cell's sum of |x|; the same words fold again alike."""
    from horaedb_tpu_torch.ops import livewindow as L

    from torch_livewindow_cases import grouped_commit

    bases, batches = [], []
    for depth, cap, warm, batch in grouped_commit(seed=n_states, n_states=n_states):
        base = L.alloc_rings(depth, cap, card)
        L.fold_plain(base, *chip_smoke._lw_words(torch, warm))
        bases.append(base)
        batches.append(batch)
    words, spans = L.pack_group(batches)
    words = torch.from_numpy(words).to(card)
    L.reset_counts()
    for _ in range(2):  # the barrier words are zero again after a launch
        chip_smoke._lw_group_check(torch, bases, words, spans, f"{n_states} states")
    assert L.LAUNCHES["fold"] == 2 * -(-n_states // L.MAX_GROUP)
    assert L.STATES_FOLDED == 2 * n_states


def test_livewindow_fold_on_one_thread_gather_on_another(card):
    """A writer thread's acknowledged INSERTs fold into the CUDA ring; a
    reader thread's refresh right after each acknowledgement, served from
    state, counts every acknowledged row."""
    import queue
    import threading

    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import livewindow as L
    from horaedb_tpu_torch.state import livewindow as S

    S.STORE.clear()
    db = horaedb_tpu_torch.connect(None, device="cuda")
    try:
        db.execute("CREATE TABLE lw_threads (host string TAG, value double NOT NULL, "
                   "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
                   "WITH (segment_duration='2h', update_mode='append')")
        t0 = 1_786_000_000_000 // 60_000 * 60_000
        db.execute("INSERT INTO lw_threads (host, value, ts) VALUES "
                   + ",".join(f"('h{h}', 1.0, {t0 - 60_000 + h})" for h in range(50)))
        panel = (f"SELECT time_bucket(ts, '1m') AS b, host, count(value) AS c FROM lw_threads "
                 f"WHERE ts >= {t0} GROUP BY time_bucket(ts, '1m'), host")
        for _ in range(S.promote_reads()):
            db.execute(panel)
        assert len(S.STORE.stats()["states"]) == 1
        acked: queue.Queue = queue.Queue()
        checked: queue.Queue = queue.Queue()
        errors = []

        def writer():
            for i in range(40):
                db.execute("INSERT INTO lw_threads (host, value, ts) VALUES "
                           + ",".join(f"('h{h}', {float(i)}, {t0 + i * 1_500 + h})"
                                      for h in range(50)))
                acked.put((i + 1) * 50)
                checked.get(timeout=60)  # the next write waits for the read
            acked.put(None)

        def reader():
            while (want := acked.get(timeout=60)) is not None:
                rows = db.execute(panel).to_pylist()
                if db.interpreters.executor.last_path != "livewindow":
                    errors.append("not served from state")
                if sum(r["c"] for r in rows) != want:
                    errors.append(f"counted {sum(r['c'] for r in rows)} of {want}")
                checked.put(True)

        L.reset_counts()
        threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors[:5]
        assert L.LAUNCHES["fold"] == 40 and L.LAUNCHES["gather"] >= 40
        assert L.FOLD_ERRORS == 0
    finally:
        S.STORE.clear()
        db.close()


def test_livewindow_writers_of_one_group_commit_read_their_rows(card):
    """Two writers acknowledged from one group commit each read, right
    after the acknowledgement, a panel served from the CUDA ring that
    holds both writers' rows (tests/torch_livewindow_cases.py)."""
    from torch_livewindow_cases import two_writers_in_one_group

    two_writers_in_one_group("cuda")


@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 16])
@pytest.mark.parametrize("layout", chip_smoke.RAW_LAYOUTS,
                         ids=lambda c: "-".join([c[0], c[1], *c[2]]))
def test_raw_kernels_match_plain(card, layout, n):
    """The raw-read top-k and selection against their plain versions on the
    same CUDA tensors (chip_smoke.py's phase 14 at test size): indices and
    counts bit-equal, every key, k and filter op."""
    rng = np.random.default_rng(n + len(layout[2][0]))
    assert chip_smoke._raw_cases(torch, rng, n, layout, chip_smoke.RAW_KS, chip_smoke.RAW_KEYS,
                                 n % 6) > 0


@pytest.mark.parametrize("layout", chip_smoke.RAW_LAYOUTS,
                         ids=lambda c: "-".join([c[0], c[1], *c[2]]))
def test_raw_select_over_windows_matches_plain(card, layout):
    """The selection over row windows (the series windows the executor
    builds, every real row, runs of passing rows, windows of one row, many
    short windows, the empty list where no row passes; windows that end
    inside a tile and start inside a 128-row delta block) against its
    plain version over every row: bit-equal, and each launch walks the
    windows' tiles and no others."""
    from horaedb_tpu_torch.ops import scan_agg as S

    rng = np.random.default_rng(len(layout[2][0]) + 7)
    n = (1 << 16) + 128
    cols, lay, n_series, ts_max = chip_smoke._raw_columns(torch, rng, n, layout)
    filters = ((1, S._FILTER_OPS[">"]),)
    for frac, lo, hi in ((0.8, 0, ts_max + 1), (0.05, 15, ts_max - 25), (0.0, 0, ts_max + 1)):
        session, dyn = chip_smoke._raw_inputs(torch, rng, n_series, frac, [5.0], lo, hi)
        assert chip_smoke._raw_window_cases(torch, rng, cols, lay, session, dyn, filters,
                                            f"{layout} allow {frac}") >= 2


@pytest.mark.parametrize("k", [16, 128, 1024, 1 << 18])
@pytest.mark.parametrize("key_is_ts,desc", chip_smoke.RAW_KEYS)
def test_raw_topk_over_windows_matches_plain(card, key_is_ts, desc, k):
    """The top-k over row windows (the executor's series windows, every real
    row, runs of passing rows, windows of one row, many short windows; ones
    that start inside a 128-row delta block and end inside a tile) against
    its plain version over every row: slots and keys bit-equal, at n not a
    multiple of the tile, and each launch visits the windows' rows."""
    from horaedb_tpu_torch.ops import scan_agg as S, scan_topk as T

    rng = np.random.default_rng(k + 2 * key_is_ts + desc)
    n = max(k, 1 << 16) + 4096 + 3 * 128
    layout = chip_smoke.RAW_LAYOUTS[1 + (k.bit_length() % 2)]
    cols, lay, n_series, ts_max = chip_smoke._raw_columns(torch, rng, n, layout)
    filters = ((1, S._FILTER_OPS[">="]),)
    for frac, lo, hi in ((0.8, 0, ts_max + 1), (0.3, 15, ts_max - 25)):
        key_lo, key_hi = T.topk_key_bounds(desc, key_is_ts, lo, hi)
        session, dyn = chip_smoke._raw_inputs(torch, rng, n_series, frac, [-20.0], lo, hi,
                                              key_lo, key_hi)
        kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
                  numeric_filters=filters, **lay)
        assert chip_smoke._raw_window_cases(torch, rng, cols, lay, session, dyn, filters,
                                            f"{layout} allow {frac}", topk=kw) >= 2


def test_raw_topk_walks_only_the_executor_windows(card, monkeypatch):
    """A top-k through ``Connection.execute`` on the card launches over the
    executor's windows: its keys kernel counts, as it runs, their rows and
    tiles and no others, with at most five kernels, and answers as a CPU
    connection does."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_topk as T

    rows = ", ".join(f"('h{i % 9}', {float((i * 37) % 101)}, {1_700_000_000_000 + i * 1000})"
                     for i in range(20_000))
    sql = "SELECT host, v FROM rd WHERE host IN ('h2', 'h7') ORDER BY v DESC LIMIT 30"
    answers, seen = [], []
    real = T.raw_topk_packed
    stats = torch.zeros(len(T.TOPK_STATS), dtype=torch.int64, device="cuda")

    def spy(*a, **k):
        seen.append(k)
        if a[3].device.type == "cuda":
            k = {**k, "stats": stats}
        return real(*a, **k)

    monkeypatch.setattr(T, "raw_topk_packed", spy)
    for device in ("cpu", "cuda"):
        db = horaedb_tpu_torch.connect(None, device=device)
        try:
            db.execute("CREATE TABLE rd (host string TAG, v double, "
                       "ts timestamp NOT NULL, TIMESTAMP KEY(ts))")
            db.execute(f"INSERT INTO rd (host, v, ts) VALUES {rows}")
            for _ in range(2):
                db.execute(sql)
            stats.zero_()
            kernels = T.KERNELS["raw_topk"]
            out = db.execute(sql)
            assert out.metrics.get("raw_kernel") == "topk"
            answers.append(out.to_pylist())
            n_valid = db.interpreters.executor.scan_cache._entries["rd"].n_valid
        finally:
            db.close()
    w = seen[-1]["windows"]
    assert 1 <= len(w) <= 2 and int(w[-1, 1]) <= n_valid
    rows, tiles = stats.tolist()
    assert rows == int((w[:, 1] - w[:, 0]).sum()) < n_valid
    assert tiles == int(((w[:, 1] - w[:, 0] + T.TILE - 1) // T.TILE).sum())
    assert 1 <= T.KERNELS["raw_topk"] - kernels <= 5
    assert answers[0] == answers[1]


def test_launcher_tile_table_is_select_tiles(card):
    """The tile table the selection's launcher builds (in C) is the spec's,
    ``select_tiles``, and it refuses the windows the spec refuses."""
    from horaedb_tpu_torch.ops import scan_topk as T

    lib = T._kernels()
    rng = np.random.default_rng(3)
    n = 1 << 20
    for _ in range(30):
        edges = np.unique(rng.integers(0, n + 1, 2 * int(rng.integers(1, 60))))
        w = np.ascontiguousarray(edges[: len(edges) // 2 * 2].reshape(-1, 2), dtype=np.int64)
        want = T.select_tiles(w, n)
        got = np.zeros(2 * len(want) + 2, np.int32)
        assert lib.raw_select_tiles(w.ctypes.data, len(w), n, got.ctypes.data) == len(want)
        assert np.array_equal(got[:2 * len(want)].reshape(-1, 2), want)
    for bad in ([[5, 9], [8, 12]], [[9, 5]], [[0, 11]], [[-1, 3]], [[6, 8], [0, 2]]):
        b = np.ascontiguousarray(bad, dtype=np.int64)
        assert lib.raw_select_tiles(b.ctypes.data, len(b), 10, None) == -1


@pytest.mark.parametrize("windows", [None, "series", "padded"], ids=["all", "series", "padded"])
@pytest.mark.parametrize("key_is_ts,desc", chip_smoke.RAW_KEYS)
@pytest.mark.parametrize("layout", chip_smoke.RAW_LAYOUTS,
                         ids=lambda c: "-".join([c[0], c[1], *c[2]]))
def test_topk_cohort_matches_plain(card, layout, key_is_ts, desc, windows):
    """The cohort top-k (B4c) against its plain version and against each
    member's solo top-k over its windows, bit-equal: every layout, key and
    order, k 1/16/128, B 1/5/32/33 (33: two launch sequences), over every
    row, over each member's series windows (member 1 allows no series and
    member 2 no time: no windows) and over windows widened to overlap."""
    at = chip_smoke.RAW_LAYOUTS.index(layout) * 4 + chip_smoke.RAW_KEYS.index((key_is_ts, desc))
    rng = np.random.default_rng(at + 100 * len(windows or ""))
    n = (1 << 16) + 3 * 128
    cols, lay, n_series, ts_max = chip_smoke._raw_columns(torch, rng, n, layout)
    k = (1, 16, 128)[at % 3]
    B = (1, 5, 32, 33)[at % 4]
    assert chip_smoke._raw_cohort_case(torch, rng, cols, lay, n_series, ts_max, B, k, key_is_ts,
                                       desc, chip_smoke.OPS[at % 6], f"{layout}", windows) == 1


def test_cohort_tile_builder_is_cohort_tiles(card):
    """The cohort's tile table as its launcher builds it (in C) is the
    spec's, ``cohort_tiles``, for overlapping, touching and empty windows
    of up to 32 members; windows one member's list would refuse are
    refused."""
    import ctypes

    from horaedb_tpu_torch.ops import scan_topk as T

    lib = T._kernels()
    rng = np.random.default_rng(11)
    for _ in range(40):
        n = int(rng.integers(1, 1 << 20))
        windows = []
        for _ in range(int(rng.integers(1, 33))):
            edges = np.unique(rng.integers(0, n + 1, 2 * int(rng.integers(0, 9))))
            windows.append(edges[: len(edges) // 2 * 2].reshape(-1, 2).astype(np.int64))
        M = len(windows)
        flat = np.ascontiguousarray(np.concatenate(windows), dtype=np.int64)
        off = np.cumsum([0] + [len(w) for w in windows]).astype(np.int64)
        want = T.cohort_tiles(windows, n)
        items = ctypes.c_longlong(0)
        nt = lib.raw_cohort_tiles(flat.ctypes.data, off.ctypes.data, M, n, None, None, None,
                                  None, ctypes.byref(items))
        assert (nt, items.value) == (len(want[0]), len(want[1]))
        I = items.value
        buf = np.zeros(4 * nt + 2 * I + M + 1, np.int32)
        at = buf.ctypes.data
        lib.raw_cohort_tiles(flat.ctypes.data, off.ctypes.data, M, n, at, at + 16 * nt,
                             at + 4 * (4 * nt + I), at + 4 * (4 * nt + I + M + 1),
                             ctypes.byref(items))
        got = (buf[:4 * nt].reshape(-1, 4), buf[4 * nt:4 * nt + I],
               buf[4 * nt + I:4 * nt + I + M + 1], buf[4 * nt + I + M + 1:])
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    for bad in ([[5, 9], [8, 12]], [[9, 5]], [[0, 11]], [[-1, 3]], [[6, 8], [0, 2]]):
        b = np.ascontiguousarray(bad, dtype=np.int64)
        off = np.array([0, len(b)], np.int64)
        assert lib.raw_cohort_tiles(b.ctypes.data, off.ctypes.data, 1, 10, None, None, None,
                                    None, ctypes.byref(items)) == -1


def test_dist_merge_sorts_each_shard_on_its_own_stream(card, monkeypatch):
    """The sharded merge over 8 logical shards of the card, three tsids:
    the empty shards are not sorted, every other shard's sort is queued on
    a stream of its own before any result is read, and the answer is the
    one-device merge's, with dedup on and off."""
    from horaedb_tpu_torch.ops import merge_dedup as md
    from horaedb_tpu_torch.parallel import dist_merge
    from horaedb_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(8)
    n = 300_000
    tsid = rng.integers(0, 2**63, 3, dtype=np.uint64)[rng.integers(0, 3, n)]
    ts = rng.integers(0, 50_000, n).astype(np.int64)
    seq = rng.integers(1, 9, n).astype(np.uint64)
    mesh = Mesh.logical(card, 8)
    full = sum(1 for i in dist_merge.shard_words(mesh, tsid, ts, seq)[0] if len(i))
    streams, gets = [], []
    sort, get = md.sort_dedup, md.MergeHandle.get

    def spy_sort(*a, **k):
        streams.append(torch.cuda.current_stream().cuda_stream)
        return sort(*a, **k)

    def spy_get(self):
        gets.append(len(streams))
        return get(self)

    monkeypatch.setattr(md, "sort_dedup", spy_sort)
    monkeypatch.setattr(md.MergeHandle, "get", spy_get)
    for dedup in (True, False):
        streams.clear()
        gets.clear()
        perm, keep = md.merge_dedup_permutation(tsid, ts, seq, dedup=dedup, device=card)
        gets.clear()
        before = md.LAUNCHES["f32"]
        got = dist_merge.dist_merge_dedup(mesh, tsid, ts, seq, dedup=dedup)
        assert md.LAUNCHES["f32"] - before == full < 8
        assert np.array_equal(got, perm[keep])
        mine = streams[1:]
        assert len(set(mine)) == full
        assert torch.cuda.default_stream().cuda_stream not in mine
        assert gets == [full + 1] * full  # every sort queued before the first read


def test_raw_kernel_traps(card):
    """+-0 at the threshold, NaN last, +-inf, ties past k, fewer passing
    rows than k, an empty allow list and an empty time range."""
    assert chip_smoke._raw_traps(torch, np.random.default_rng(0)) > 0


def test_raw_reads_on_the_card_launch_the_kernels(card):
    """Raw reads through ``Connection.execute`` on a CUDA connection answer
    as a CPU connection does, through the kernels, never the plain
    versions."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_topk as T

    rows = ", ".join(f"('h{i % 7}', {float((i * 37) % 101)}, {float(i)}, "
                     f"{1_700_000_000_000 + i * 1000})" for i in range(3000))
    queries = {
        "SELECT host, v, w FROM rd WHERE v < 60 ORDER BY ts DESC LIMIT 25": "topk",
        "SELECT host, v FROM rd WHERE host IN ('h1', 'h4') ORDER BY v ASC LIMIT 40": "topk",
        "SELECT host, v, w FROM rd WHERE v >= 90": "select",
    }
    answers = {}
    for device in ("cpu", "cuda"):
        db = horaedb_tpu_torch.connect(None, device=device)
        try:
            db.execute("CREATE TABLE rd (host string TAG, v double, w double, "
                       "ts timestamp NOT NULL, TIMESTAMP KEY(ts))")
            db.execute(f"INSERT INTO rd (host, v, w, ts) VALUES {rows}")
            T.reset_counts()
            for sql, kernel in queries.items():
                for _ in range(3):
                    out = db.execute(sql)
                assert out.metrics.get("path") == "raw_device"
                assert out.metrics.get("raw_kernel") == kernel
                answers.setdefault(sql, []).append(out.to_pylist())
            if device == "cuda":
                assert T.LAUNCHES["raw_topk"] > 0 and T.LAUNCHES["raw_select"] > 0
                assert not any(T.PLAIN_CALLS.values())
        finally:
            db.close()
    for sql, (cpu, cuda) in answers.items():
        assert cpu == cuda, sql


def test_raw_selection_walks_only_the_executor_windows(card, monkeypatch):
    """A selection through ``Connection.execute`` on the card launches over
    the executor's windows: inside the real rows, one tile a TILE rows of
    each window, and the answer of a CPU connection."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_topk as T

    rows = ", ".join(f"('h{i % 9}', {float((i * 37) % 101)}, {1_700_000_000_000 + i * 1000})"
                     for i in range(20_000))
    sql = "SELECT host, v FROM rd WHERE host IN ('h2', 'h7') AND v > 60"
    answers, seen = [], []
    real = T.raw_select_packed

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(T, "raw_select_packed", spy)
    for device in ("cpu", "cuda"):
        db = horaedb_tpu_torch.connect(None, device=device)
        try:
            db.execute("CREATE TABLE rd (host string TAG, v double, "
                       "ts timestamp NOT NULL, TIMESTAMP KEY(ts))")
            db.execute(f"INSERT INTO rd (host, v, ts) VALUES {rows}")
            for _ in range(2):
                db.execute(sql)
            tiles = T.TILES["raw_select"]
            out = db.execute(sql)
            assert out.metrics.get("raw_kernel") == "select"
            answers.append(out.to_pylist())
            n_valid = db.interpreters.executor.scan_cache._entries["rd"].n_valid
        finally:
            db.close()
    w = seen[-1]["windows"]
    rows_w = w[:, 1] - w[:, 0]
    assert 1 <= len(w) <= 2 and int(w[-1, 1]) <= n_valid
    assert T.TILES["raw_select"] - tiles == int(((rows_w + T.TILE - 1) // T.TILE).sum())
    assert answers[0] == answers[1]


@pytest.mark.parametrize("label,domain,live", chip_smoke.GROUPBY_SHAPES)
def test_hash_direct_kernel_matches_plain(card, label, domain, live):
    """The hash arm (B2d) of the direct kernel against its plain version
    at bench.py's groupby shapes (chip_smoke.py's phase 19 at test size):
    counts, mins and maxs bit-equal, sums within SUM_RTOL of sum |x|."""
    from horaedb_tpu_torch.ops.hash_agg import hash_slots_for

    rng = np.random.default_rng(domain + live)
    args, kw = chip_smoke._groupby_inputs(torch, rng, 1 << 16, domain, live)
    kw.update(hash_slots=hash_slots_for(domain, live))
    chip_smoke._hash_check(torch, "direct", args, kw, label)


@pytest.mark.parametrize("case", chip_smoke.LAYOUT_CASES, ids=lambda c: "-".join([c[0], c[1], *c[2]]))
@pytest.mark.parametrize("selective", [False, True])
@pytest.mark.parametrize("slots,rounds", [(16, 1), (2048, 2), (4096, 4)])
def test_hash_cached_kernel_matches_plain(card, case, selective, slots, rounds):
    rng = np.random.default_rng(slots + rounds + selective)
    args, kw, kind, form = chip_smoke._cached_inputs(torch, rng, case, "hash", selective, True,
                                                     ">", 4096, 64, n_series=20, per=1001)
    kw.update(hash_slots=slots)
    chip_smoke._hash_check(torch, form, args, kw, kind, rounds)


def test_hash_tables_fill_and_overflow(card):
    """A block that sees exactly H segments and probes all H slots places
    every row; a table of 16 slots over 2**18 segments overflows."""
    rng = np.random.default_rng(5)
    for H in (16, 2048):
        args, kw = chip_smoke._groupby_inputs(torch, rng, 2048, 65536, H, every_row=True)
        _, ov, _, counted = chip_smoke._hash_check(
            torch, "direct", args, {**kw, "hash_slots": H}, f"load 1.0 H={H}", H)
        assert ov == 0 and counted == 2048
    args, kw = chip_smoke._groupby_inputs(torch, rng, 1 << 16, 262144, 262144)
    _, ov, _, _ = chip_smoke._hash_check(
        torch, "direct", args, {**kw, "hash_slots": 16}, "overflow", 1)
    assert ov > 0


@pytest.mark.parametrize("prefix", chip_smoke.PREFIX_KINDS)
@pytest.mark.parametrize("B", chip_smoke.PREFIX_BS)
@pytest.mark.parametrize("arm", list(chip_smoke.PREFIX_ARMS))
def test_cohort_and_full_scan_over_a_prefix_match_plain(card, arm, B, prefix):
    """The cohort, and members 0 and 1 as solo full scans, over the table's
    real rows (ending inside a step and a chunk), over the layout's rows
    and over none, against the plain versions, which read every row:
    counts, mins and maxs bit-equal, sums within SUM_RTOL of sum |x|.
    Segments of 1,250 or 80 rows cross steps, chunks, tiles and blocks;
    members miss whole chunks, have no time or no series. (F, minmax)
    cycles through PREFIX_FIELDS and the filter op through OPS. The
    launch statistics count every chunk once and every member-chunk as
    run or skipped."""
    j = (chip_smoke.PREFIX_BS.index(B) + chip_smoke.PREFIX_KINDS.index(prefix)
         + list(chip_smoke.PREFIX_ARMS).index(arm))
    F, need_minmax = chip_smoke.PREFIX_FIELDS[j % len(chip_smoke.PREFIX_FIELDS)]
    rng = np.random.default_rng(100 * B + j)
    chip_smoke._prefix_case(torch, rng, F, need_minmax, arm, B, prefix, op=chip_smoke.OPS[j % 6])


@pytest.mark.parametrize("arm", list(chip_smoke.PREFIX_ARMS))
@pytest.mark.parametrize("per", [5003, 4096])
def test_cohort_specials_at_run_and_chunk_edges_match_plain(card, arm, per):
    """NaN, -0.0, +0.0, +inf and -inf at series, bucket and chunk edges
    (per = 4096: the real rows end at a chunk's edge), seven members."""
    rng = np.random.default_rng(per + len(arm))
    chip_smoke._prefix_case(torch, rng, 3, True, arm, 7, "real", per=per, special=True)


@pytest.mark.parametrize("arm", ["shared", "scatter"])
def test_cohort_carries_two_passes_of_fields_matches_plain(card, arm):
    """12 fields with min/max: each member's records hold two passes of
    FCAP fields, carried from chunk to chunk."""
    from horaedb_tpu_torch.ops import scan_agg as S

    G, nb = chip_smoke.PREFIX_ARMS[arm]
    taken = S.cohort_arm(arm, 5, 13, G * nb, 12, True)
    assert S.cohort_carry(taken, 5, 13, G * nb, 12, True)
    chip_smoke._prefix_case(torch, np.random.default_rng(12), 12, True, arm, 5, "real",
                            per=2003, special=True)


def test_cohort_without_room_to_carry_matches_plain(card):
    """64 members of 31 fields with min/max: the records do not fit beside
    the tile, so each member commits at each chunk's end; four passes of
    FCAP fields."""
    from horaedb_tpu_torch.ops import scan_agg as S

    assert not S.cohort_carry("scatter", 64, 32, 16 * 64, 31, True)
    chip_smoke._prefix_case(torch, np.random.default_rng(64), 31, True, "scatter", 64, "real",
                            per=1201)


_RUN_FORMS = ("direct", "cached", "cached_selective")


@pytest.mark.parametrize("run_len", chip_smoke.RUN_LENGTHS)
@pytest.mark.parametrize("arm", list(chip_smoke.RUN_ARMS))
@pytest.mark.parametrize("form", _RUN_FORMS)
def test_short_runs_match_plain(card, run_len, arm, form):
    """Rows sorted in runs of ``run_len`` that start and end inside and
    across 32-row steps, on every arm and form (the segmented core of the
    SELECTIVE launches and of the hash arm; the run-partial core of the
    other full scans), against the plain version: counts, mins and maxs
    bit-equal, sums within SUM_RTOL of sum |x|. (F, need_minmax) cycles
    through F in {0, 1, 5, 10} with and without min/max, and every other
    case filters; SELECTIVE gathers end in pad slots that fill the last
    steps."""
    j = (chip_smoke.RUN_LENGTHS.index(run_len) + _RUN_FORMS.index(form)
         + list(chip_smoke.RUN_ARMS).index(arm))
    F, need_minmax = chip_smoke.RUN_FIELDS[j % len(chip_smoke.RUN_FIELDS)]
    op = chip_smoke.OPS[j % 6] if j % 2 else None
    rng = np.random.default_rng(1000 * run_len + j)
    chip_smoke._run_case(torch, rng, run_len, arm, form, F, need_minmax, op=op)


@pytest.mark.parametrize("run_len", [6, 33])
@pytest.mark.parametrize("arm", list(chip_smoke.RUN_ARMS))
@pytest.mark.parametrize("form", _RUN_FORMS)
def test_short_run_specials_match_plain(card, run_len, arm, form):
    """NaN, -0.0 among +0.0 and +0.0 among -0.0 at the first, middle and
    last row of a run: NaN propagates and -0.0 < +0.0, bit-equal to the
    plain version."""
    rng = np.random.default_rng(run_len + len(arm) + len(form))
    chip_smoke._run_case(torch, rng, run_len, arm, form, 3, True, special=True)


@pytest.mark.parametrize("form", _RUN_FORMS)
def test_short_run_hash_overflow_counts_and_answers(card, form):
    """A 16-slot table probed once: rows overflow (the counter is above 0)
    and the answers still equal the plain version's."""
    _, ov = chip_smoke._run_case(torch, np.random.default_rng(16), 6, "hash", form, 5, True,
                                 hash_slots=16, rounds=1)
    assert ov > 0


def test_short_run_hash_fitted_table_at_load_one(card):
    """Every block of 256 unsorted rows fills a 16-slot table with its 16
    segments; probed in full, no row overflows."""
    args, kw = chip_smoke._groupby_inputs(torch, np.random.default_rng(17), 4096, 65536, 16,
                                          every_row=True)
    _, ov, _, counted = chip_smoke._hash_check(
        torch, "direct", args, {**kw, "hash_slots": 16}, "load 1.0 in every block", 16)
    assert ov == 0 and counted == 4096


def test_hash_pin_launches_the_hash_kernel(card, monkeypatch):
    from horaedb_tpu_torch.ops import scan_agg as S

    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "hash")
    args, kw = chip_smoke._groupby_inputs(torch, np.random.default_rng(9), 5000, 65536, 100)
    before = S.LAUNCHES["direct"]["hash"]
    S.fused_scan_agg(*args, **{**kw, "segment_impl": "auto"})
    torch.cuda.synchronize()
    assert S.LAUNCHES["direct"]["hash"] == before + 1


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("F,need_minmax", [(0, True), (1, True), (10, True), (3, False)])
def test_mesh_combine_matches_plain(card, shards, F, need_minmax):
    """The combine of a sharded aggregate (chip_smoke.py's phase 21 at test
    size): both packed forms against the plain version, +-0 and NaN across
    shards."""
    from horaedb_tpu_torch.ops import scan_agg as S

    special = bool(F) and need_minmax
    parts = chip_smoke._combine_parts(torch, shards, chip_smoke.MESH_SEGMENTS, F, need_minmax,
                                      special, shards * 31 + F)
    kw = dict(n_seg=chip_smoke.MESH_SEGMENTS, n_agg_fields=F, need_minmax=need_minmax)
    for src in (parts, torch.stack(parts)):
        got = S.mesh_combine(src, **kw)
        chip_smoke._combine_compare(torch, S, got, parts, chip_smoke.MESH_SEGMENTS, F,
                                    need_minmax, f"S={shards} F={F}")


@pytest.mark.parametrize("n_seg", chip_smoke.COMBINE_EDGE_SEGMENTS)
def test_mesh_combine_edges_match_plain(card, n_seg):
    """The combine where its vector body meets its edges: n_seg % 4 of 0-3
    (packed planes and stacked rows off 16 bytes), planes shorter than a
    float4, S of 1, 2, 3, 8 and 64, both forms, +-0 and NaN across shards."""
    cases, _ = chip_smoke._combine_edges(torch, n_seg, n_seg)
    assert cases == 9 * len(chip_smoke.COMBINE_EDGE_SHARDS)


def test_sharded_sql_on_a_logical_mesh_launches_the_kernels(card, monkeypatch):
    """SQL over a table sharded on 4 logical shards of the card: one launch a
    shard and one combine per aggregate, the answer of one device."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_agg as S
    from horaedb_tpu_torch.parallel.mesh import Mesh, use_mesh

    monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", "1")
    db = horaedb_tpu_torch.connect(None, device="cuda")
    db.execute("CREATE TABLE t (h string TAG, v double, ts timestamp NOT NULL, "
               "TIMESTAMP KEY(ts)) ENGINE=Analytic")
    vals = ", ".join(f"('h{i % 7}', {float(i % 97) - 40.5}, {1000 + i})" for i in range(5000))
    db.execute(f"INSERT INTO t (h, v, ts) VALUES {vals}")
    sql = "SELECT h, count(v) AS c, min(v) AS mn, max(v) AS mx FROM t GROUP BY h ORDER BY h"
    for _ in range(3):
        one = db.execute(sql).to_pylist()
    db.interpreters.executor.scan_cache.invalidate("t")
    with use_mesh(Mesh.logical("cuda", 4)):
        for _ in range(2):
            db.execute(sql)
        S.reset_counts()
        out = db.execute(sql)
        assert out.metrics["mesh_devices"] == 4
        assert sum(S.LAUNCHES["cached"].values()) == 4 and S.COMBINE_LAUNCHES["packed"] == 1
        assert out.to_pylist() == one
    db.close()


def test_sharded_topk_over_windows_matches_one_device(card, monkeypatch):
    """Raw top-k reads over a table sharded on 4 logical shards of the card:
    only the shards whose clipped windows hold rows launch, each keys
    kernel counts its part's rows and tiles and no others, and the answer
    is one device's."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_topk as T
    from horaedb_tpu_torch.parallel import dist_raw
    from horaedb_tpu_torch.parallel.mesh import Mesh, use_mesh

    rows = ", ".join(f"('h{i % 9}', {float((i * 37) % 101)}, {1_700_000_000_000 + i * 1000})"
                     for i in range(20_000))
    queries = ["SELECT host, v FROM rd WHERE host = 'h4' ORDER BY v DESC LIMIT 30",
               "SELECT host, v, ts FROM rd WHERE host IN ('h2', 'h3') ORDER BY ts DESC LIMIT 50",
               "SELECT host, v FROM rd ORDER BY v ASC LIMIT 40"]
    db = horaedb_tpu_torch.connect(None, device="cuda")
    db.execute("CREATE TABLE rd (host string TAG, v double, ts timestamp NOT NULL, "
               "TIMESTAMP KEY(ts)) ENGINE=Analytic")
    db.execute(f"INSERT INTO rd (host, v, ts) VALUES {rows}")
    one = {}
    for sql in queries:
        for _ in range(3):
            one[sql] = db.execute(sql).to_pylist()
    db.interpreters.executor.scan_cache.invalidate("rd")
    monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", "1")
    real = T.raw_topk_packed
    shard_calls, windows = [], []
    real_dist = dist_raw.dist_raw_topk

    def spy(*a, **k):
        stats = torch.zeros(len(T.TOPK_STATS), dtype=torch.int64, device="cuda")
        shard_calls.append((k["windows"], stats))
        return real(*a, **k, stats=stats)

    def dist(*a, **k):
        windows.append(k["windows"])
        return real_dist(*a, **k)

    monkeypatch.setattr(T, "raw_topk_packed", spy)
    monkeypatch.setattr(dist_raw, "dist_raw_topk", dist)
    with use_mesh(Mesh.logical("cuda", 4)):
        for sql in queries:
            for _ in range(2):
                db.execute(sql)
            shard_calls.clear()
            windows.clear()
            before = T.LAUNCHES["raw_topk"]
            out = db.execute(sql)
            assert out.metrics["mesh_devices"] == 4 and out.metrics["raw_kernel"] == "topk"
            assert out.to_pylist() == one[sql], sql
            per = db.interpreters.executor.scan_cache._entries["rd"].padded_rows // 4
            parts = [dist_raw.shard_windows(windows[0], d * per, per) for d in range(4)]
            parts = [w for w in parts if int((w[:, 1] - w[:, 0]).sum())]
            assert T.LAUNCHES["raw_topk"] - before == len(shard_calls) == len(parts)
            for w, (got, stats) in zip(parts, shard_calls):
                assert np.array_equal(np.asarray(got).reshape(-1, 2), w)
                n = w[:, 1] - w[:, 0]
                assert stats.tolist() == [int(n.sum()), int(((n + T.TILE - 1) // T.TILE).sum())]
            if "ORDER BY v ASC" not in sql:
                assert len(parts) < 4
    db.close()


def test_sharded_sql_over_every_card(card, monkeypatch):
    """On a host of two or more cards ``serving_mesh()`` takes them all: a
    table sharded over the cards (peer copies of the partials to the first
    card, one combine there) answers as one device does; the merge too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import merge_dedup as md, scan_agg as S
    from horaedb_tpu_torch.parallel import dist_merge
    from horaedb_tpu_torch.parallel.mesh import serving_mesh
    from horaedb_tpu_torch.tools import tsbs

    mesh = serving_mesh(device="cuda")
    assert mesh is serving_mesh() and mesh.size == torch.cuda.device_count()
    queries = [
        tsbs.high_cpu_all(6).sql,
        tsbs.single_groupby(5, 8, 1).sql,
        "SELECT hostname, max(usage_user) AS m, count(usage_user) AS c FROM cpu "
        "GROUP BY hostname ORDER BY hostname",
        "SELECT * FROM cpu WHERE hostname = 'host_7' ORDER BY ts DESC LIMIT 10",
        "SELECT * FROM cpu WHERE hostname = 'host_3' AND usage_user > 50",
    ]
    answers = {}
    for floor in (1 << 40, 1):
        monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", str(floor))
        db = horaedb_tpu_torch.connect(None, device="cuda")
        db.execute(chip_smoke._cpu_table_sql(tsbs))
        t = db.catalog.open("cpu")
        t.write(tsbs.generate_cpu(40, 6 * 3_600_000, seed=5))
        t.flush()
        for sql in queries:
            before = S.COMBINE_LAUNCHES["packed"] + S.COMBINE_LAUNCHES["state"]
            for _ in range(3):
                out = db.execute(sql)
            if floor == 1:
                assert out.metrics.get("mesh_devices") == mesh.size, (sql, out.metrics)
                if "ORDER BY ts" not in sql and "usage_user > 50" not in sql:
                    assert S.COMBINE_LAUNCHES["packed"] + S.COMBINE_LAUNCHES["state"] > before
                assert out.to_pylist() == answers[sql], sql
            else:
                assert "mesh_devices" not in out.metrics
                answers[sql] = out.to_pylist()
        entry = db.interpreters.executor.scan_cache._entries["cpu"]
        if floor == 1:
            assert entry.mesh is mesh
            assert [p.device for p in entry.series_parts] == list(mesh.devices)
        db.close()
    rng = np.random.default_rng(9)
    tsid = rng.integers(0, 2**63, 500, dtype=np.uint64)[rng.integers(0, 500, 300_000)]
    ts = rng.integers(0, 50_000, 300_000).astype(np.int64)
    seq = rng.integers(1, 9, 300_000).astype(np.uint64)
    perm, keep = md.merge_dedup_permutation(tsid, ts, seq, device=mesh.first)
    assert np.array_equal(dist_merge.dist_merge_dedup(mesh, tsid, ts, seq), perm[keep])
