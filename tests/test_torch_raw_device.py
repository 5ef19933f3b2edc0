"""Raw (non-aggregate) reads as SQL: the port against the JAX package.

The same rows go into ``horaedb_tpu.connect(None)`` (device-first raw
routing, ``HORAEDB_ADAPTIVE_PATH=0``, as its own tests pin it) and into
``horaedb_tpu_torch.connect(None, device="cpu")``. The port serves every
eligible raw read from the resident scan cache through
``ops/scan_topk`` (its plain versions on the CPU) and must answer as the
reference's device route does, row for row, slot order included; its
kill-switch host route as the reference's host route. Each host route of
the port (the kill switch, LIMIT pushdown, the row budget, a NULL in a
filtered or sorted column, an entry without host rows, an OVERWRITE delta
that could shadow a base row, a cache miss) has its own case, seen in
``m["path"]``, ``m["raw_host"]`` and the ``horaedb_raw_scan_total``
counters.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu_torch.ops import scan_topk as port_kernels
from horaedb_tpu_torch.utils import querystats as port_stats

DDL = (
    "CREATE TABLE rd (host string TAG, v double, w double, "
    "ts timestamp NOT NULL, TIMESTAMP KEY(ts))"
)
T0 = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _deterministic_raw(monkeypatch):
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    from horaedb_tpu.query.path_router import KERNEL_ROUTER

    KERNEL_ROUTER.reset()
    yield
    KERNEL_ROUTER.reset()


@pytest.fixture()
def dbs():
    ref = horaedb_tpu.connect(None)
    port = horaedb_tpu_torch.connect(None, device="cpu")
    yield ref, port
    ref.close()
    port.close()


def _both(dbs, sql):
    for db in dbs:
        db.execute(sql)


def _seed(dbs, n=400, hosts=8, null_w_every=0, ts_step=1000, seed=None):
    rng = None if seed is None else np.random.default_rng(seed)
    parts = []
    for i in range(n):
        w = "NULL" if null_w_every and i % null_w_every == 0 else f"{float(3 * i)}"
        v = float(i if rng is None else rng.integers(0, 10 * n))
        parts.append(f"('h{i % hosts}', {v}, {w}, {T0 + i * ts_step})")
    _both(dbs, DDL)
    _both(dbs, f"INSERT INTO rd (host, v, w, ts) VALUES {', '.join(parts)}")


def _warm(db, sql, times=3):
    out = None
    for _ in range(times):
        out = db.execute(sql)
    return out


def _host(db, sql, monkeypatch):
    monkeypatch.setenv("HORAEDB_RAW_DEVICE", "0")
    try:
        return db.execute(sql)
    finally:
        monkeypatch.delenv("HORAEDB_RAW_DEVICE", raising=False)


def _signed(rows):
    """Rows with every float's sign made visible (-0.0 == 0.0 otherwise)."""
    return [{k: (v, math.copysign(1.0, v)) if isinstance(v, float) and not math.isnan(v)
             else v for k, v in r.items()} for r in rows]


def _parity(dbs, sql, monkeypatch, kernel=None):
    """Warm both; the port's device answer equals the reference's device
    answer exactly, and its kill-switch answer the reference's host one."""
    ref, port = dbs
    want, got = _warm(ref, sql), _warm(port, sql)
    assert got.metrics.get("path") == want.metrics.get("path") == "raw_device", sql
    if kernel is not None:
        assert got.metrics.get("raw_kernel") == kernel, sql
    assert _signed(got.to_pylist()) == _signed(want.to_pylist()), sql
    h_ref, h_port = _host(ref, sql, monkeypatch), _host(port, sql, monkeypatch)
    assert h_port.metrics.get("path") == "host"
    assert _signed(h_port.to_pylist()) == _signed(h_ref.to_pylist()), sql
    return got, h_port


def _counter(path):
    return port_stats._RAW_SCAN_COUNTERS[path].value


class TestRawEquivalence:
    def test_randomized_topk_and_selection(self, dbs, monkeypatch):
        rng = np.random.default_rng(42)
        _seed(dbs, n=500, hosts=10, null_w_every=7, seed=42)
        filters = ["", "WHERE v < 250", "WHERE v >= 100 AND host IN ('h1', 'h3', 'h5')",
                   "WHERE host = 'h2'", "WHERE v != 123"]
        orders = ["ts DESC", "ts ASC", "v DESC", "v ASC"]
        for trial in range(16):
            limit = int(rng.integers(1, 60))
            offset = int(rng.integers(0, 20)) if trial % 3 == 0 else 0
            sql = (
                f"SELECT host, v, w, ts FROM rd {filters[trial % 5]} "
                f"ORDER BY {orders[trial % 4]} LIMIT {limit}"
                + (f" OFFSET {offset}" if offset else "")
            )
            got, host = _parity(dbs, sql, monkeypatch, "topk")
            assert got.to_pylist() == host.to_pylist(), sql

    @pytest.mark.parametrize("sql", [
        "SELECT host, v, w FROM rd WHERE v < 120 ORDER BY host ASC, v DESC",
        "SELECT host, v FROM rd WHERE v >= 250 ORDER BY v ASC, host DESC LIMIT 20 OFFSET 5",
        "SELECT DISTINCT host FROM rd WHERE v < 50 ORDER BY host",
        "SELECT host, v FROM rd WHERE v < 70",
    ])
    def test_selection(self, dbs, monkeypatch, sql):
        _seed(dbs, n=300, hosts=6, null_w_every=11)
        got, host = _parity(dbs, sql, monkeypatch, "select")
        if "ORDER BY" in sql:
            assert got.to_pylist() == host.to_pylist()

    def test_desc_ties_follow_the_resident_order(self, dbs, monkeypatch):
        """Which tied rows cross the LIMIT is the resident order's, on both
        packages' device routes; the host reads in its own order, so
        against it only the keys agree."""
        rows = ", ".join(
            f"('h{i % 4}', {float(i % 5)}, {float(i)}, {T0 + i * 1000})" for i in range(200)
        )
        _both(dbs, DDL)
        _both(dbs, f"INSERT INTO rd (host, v, w, ts) VALUES {rows}")
        got, host = _parity(dbs, "SELECT v, w FROM rd WHERE w < 150 ORDER BY v DESC LIMIT 30",
                            monkeypatch, "topk")
        g, h = got.to_pylist(), host.to_pylist()
        assert [x["v"] for x in g] == [x["v"] for x in h]
        assert all(x["w"] < 150 for x in g)

    def test_empty_allow_list_launches_nothing(self, dbs, monkeypatch):
        _seed(dbs, n=100)
        sql = "SELECT host, v FROM rd WHERE host = 'nope' ORDER BY ts DESC LIMIT 5"
        _warm(dbs[1], sql)
        before = dict(port_kernels.PLAIN_CALLS)
        got, _ = _parity(dbs, sql, monkeypatch, "topk")
        assert got.num_rows == 0
        assert port_kernels.PLAIN_CALLS == before

    @pytest.mark.parametrize("lo,hi,rows", [(50_000, 150_000, 20), (10_000_000, None, 0)])
    def test_time_range(self, dbs, monkeypatch, lo, hi, rows):
        _seed(dbs, n=200)
        sql = (f"SELECT v, ts FROM rd WHERE ts >= {T0 + lo}"
               + (f" AND ts < {T0 + hi}" if hi else "") + " ORDER BY ts DESC LIMIT 20")
        _warm(dbs[1], sql)
        before = port_kernels.PLAIN_CALLS["raw_topk"]
        got, _ = _parity(dbs, sql, monkeypatch, "topk")
        assert got.num_rows == rows
        # an empty time range passes no resident row: nothing launches
        assert (port_kernels.PLAIN_CALLS["raw_topk"] == before) == (rows == 0)

    def test_delta_rows_including_new_series(self, dbs, monkeypatch):
        _seed(dbs, n=120)
        sql = "SELECT host, v, ts FROM rd ORDER BY ts DESC LIMIT 10"
        for db in dbs:
            _warm(db, sql)
        newer = T0 + 500 * 1000
        _both(dbs, "INSERT INTO rd (host, v, w, ts) VALUES "
                   f"('brand_new', 9001.0, 1.0, {newer}), ('h1', 9002.0, 2.0, {newer + 1000})")
        got, _ = _parity(dbs, sql, monkeypatch, "topk")
        assert got.metrics.get("delta_rows") == 2
        assert got.metrics.get("cache") == "hit+delta"
        assert [r["host"] for r in got.to_pylist()][:2] == ["h1", "brand_new"]


def _entry_rows(entry):
    """(series code, relative ts) of every resident real row of ``entry``."""
    offsets = np.asarray(entry.series_offsets, np.int64)
    codes = np.searchsorted(offsets, np.arange(entry.n_valid), "right") - 1
    return codes, np.asarray(entry.ts_rel_host, np.int64)


class TestCandidateWindows:
    """The executor's row windows: sorted, disjoint, touching ones merged,
    holding exactly the allowed series' rows inside the time range, their
    rows the candidate estimate that sizes the selection's buffer."""

    def _entry(self, seed, n, hosts, step):
        port = horaedb_tpu_torch.connect(None, device="cpu")
        rng = np.random.default_rng(seed)
        ts = T0 + np.cumsum(rng.integers(0, 3, n)) * step  # ties and gaps
        rows = ", ".join(f"('h{int(h)}', {float(i)}, 1.0, {int(t)})"
                         for i, (h, t) in enumerate(zip(rng.integers(0, hosts, n), ts)))
        port.execute(DDL)
        port.execute(f"INSERT INTO rd (host, v, w, ts) VALUES {rows}")
        _warm(port, "SELECT host, v FROM rd WHERE v < 10")
        return port, port.interpreters.executor.scan_cache._entries["rd"]

    @pytest.mark.parametrize("seed", range(6))
    def test_windows_hold_exactly_the_allowed_rows_in_range(self, seed):
        port, entry = self._entry(seed, n=int(300 + 97 * seed), hosts=3 + 2 * seed, step=1000)
        try:
            executor = port.interpreters.executor
            codes, ts = _entry_rows(entry)
            rng = np.random.default_rng(100 + seed)
            span = int(ts.max()) + 1
            one = int(ts[int(rng.integers(0, len(ts)))])
            ranges = [(0, span + 5), (0, 0), (one, one + 1), (span // 3, span // 3),
                      (int(rng.integers(0, span)), int(rng.integers(0, span)) + 1000),
                      (-50, span // 2), (span // 2, 2 * span)]
            S = entry.n_series
            allows = [np.ones(S, bool), np.zeros(S, bool), np.arange(S) == S - 1,
                      rng.random(S) < 0.5, np.arange(S) % 2 == 0]
            for allowed in allows:
                for lo, hi in ranges:
                    count, windows = executor._raw_candidate_estimate(entry, allowed, lo, hi)
                    keep = allowed[codes] & (ts >= lo) & (ts < hi)
                    want = np.flatnonzero(np.diff(np.concatenate([[0], keep, [0]]))).reshape(-1, 2)
                    assert windows.dtype == np.int64 and windows.shape[1:] == (2,)
                    assert np.array_equal(windows, want), (allowed, lo, hi)
                    assert count == int(keep.sum()) == int((windows[:, 1] - windows[:, 0]).sum())
        finally:
            port.close()

    def test_every_series_over_the_whole_range_is_one_window(self):
        port, entry = self._entry(9, n=500, hosts=7, step=1000)
        try:
            count, windows = port.interpreters.executor._raw_candidate_estimate(
                entry, np.ones(entry.n_series, bool), 0, 10**12)
            assert count == entry.n_valid and windows.tolist() == [[0, entry.n_valid]]
        finally:
            port.close()

    def test_the_selection_gets_the_windows_and_answers_as_the_reference(
            self, dbs, monkeypatch):
        """A selection hands its wrapper the estimate's windows (their rows
        are its slots); the answer is the reference's."""
        _seed(dbs, n=600, hosts=9, seed=3)
        seen = []
        real = port_kernels.raw_select_packed

        def spy(*a, **k):
            seen.append(k)
            return real(*a, **k)

        monkeypatch.setattr(port_kernels, "raw_select_packed", spy)
        sql = ("SELECT host, v FROM rd WHERE host IN ('h2', 'h5') AND v > 100 "
               f"AND ts < {T0 + 400_000}")
        _parity(dbs, sql, monkeypatch, "select")
        w = seen[-1]["windows"]
        assert len(w) >= 1 and int((w[:, 1] - w[:, 0]).sum()) == seen[-1]["select_slots"]
        entry = dbs[1].interpreters.executor.scan_cache._entries["rd"]
        assert int(w[-1, 1]) <= entry.n_valid


class TestSeriesTimeIndex:
    """The row bounds of a time range for every series, from the index:
    exact ones equal np.searchsorted over each series; the top-k's are a
    superset by at most one step of rows at each end."""

    @staticmethod
    def _series(rng, S, crowded):
        lens = rng.integers(0, 60, S)
        if crowded:  # one series far denser than the others: steps of many rows
            lens[int(rng.integers(0, S))] = 3000
        ts = [np.sort(rng.integers(0, 5000, n)) for n in lens]
        ts = np.concatenate(ts + [np.empty(0, np.int64)]).astype(np.int32)
        return ts, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    @pytest.mark.parametrize("crowded", [False, True])
    @pytest.mark.parametrize("seed", range(4))
    def test_row_bounds_against_searchsorted(self, seed, crowded):
        from horaedb_tpu_torch.query.scan_cache import SeriesTimeIndex

        rng = np.random.default_rng(40 + seed)
        ts, offsets = self._series(rng, int(rng.integers(1, 40)), crowded)
        index = SeriesTimeIndex(ts, offsets)
        S = len(offsets) - 1
        span = int(ts.max()) + 1 if len(ts) else 1
        xs = [-3, 0, 1, index.width, 2 * index.width + 1, span - 1, span, span + 9,
              index.n_steps * index.width] + [int(x) for x in rng.integers(0, span, 12)]
        for _ in range(6):
            series = np.flatnonzero(rng.random(S) < 0.6)
            for lo in xs:
                for hi in xs[::3]:
                    want_lo = [s0 + np.searchsorted(ts[s0:s1], lo, "left")
                               for s0, s1 in zip(offsets[series], offsets[series + 1])]
                    want_hi = [s0 + np.searchsorted(ts[s0:s1], hi, "left")
                               for s0, s1 in zip(offsets[series], offsets[series + 1])]
                    starts, ends = index.row_bounds(series, lo, hi)
                    assert starts.tolist() == want_lo and ends.tolist() == want_hi
                    wide_s, wide_e = index.row_bounds(series, lo, hi, exact=False)
                    assert (wide_s <= starts).all() and (wide_e >= ends).all()
                    assert (wide_s >= offsets[series]).all()
                    assert (wide_e <= offsets[series + 1]).all()
                    # at most the rows of one step beyond each exact bound
                    step_of = lambda r: ts[np.minimum(r, len(ts) - 1)] // index.width  # noqa: E731
                    inner = wide_s < starts
                    assert (step_of(wide_s[inner]) == lo // index.width).all()
                    outer = wide_e > ends
                    assert (step_of(ends[outer]) == hi // index.width).all()

    def test_steps_hold_about_rows_per_step(self):
        from horaedb_tpu_torch.query.scan_cache import SeriesTimeIndex

        ts = np.tile(np.arange(8640, dtype=np.int32) * 10_000, 50)
        index = SeriesTimeIndex(ts, np.arange(51, dtype=np.int64) * 8640)
        per_step = np.diff(index.first.astype(np.int64), axis=0)
        assert index.n_steps == 8640 // SeriesTimeIndex.ROWS_PER_STEP
        assert per_step.max() <= SeriesTimeIndex.ROWS_PER_STEP + 1
        assert index.nbytes == index.first.nbytes < ts.nbytes // 4

    def test_the_topk_windows_cover_the_exact_ones(self):
        port, entry = TestCandidateWindows()._entry(4, n=900, hosts=11, step=1000)
        try:
            executor = port.interpreters.executor
            span = int(entry.max_ts - entry.min_ts) + 1
            rng = np.random.default_rng(7)
            for _ in range(20):
                allowed = rng.random(entry.n_series) < 0.7
                lo = int(rng.integers(-10, span))
                hi = lo + int(rng.integers(0, span))
                count, exact = executor._raw_candidate_estimate(entry, allowed, lo, hi)
                _, wide = executor._raw_candidate_estimate(entry, allowed, lo, hi, exact=False)
                inside = np.zeros(entry.n_valid + 1, bool)
                for a, b in wide:
                    inside[a:b] = True
                for a, b in exact:
                    assert inside[a:b].all()
                assert int(inside.sum()) >= count
        finally:
            port.close()


class TestTopkWindows:
    """The top-k gets the executor's row windows too: they cover every row
    its mask passes, and the answer is the reference's."""

    @pytest.mark.parametrize("sql", [
        "SELECT host, v, ts FROM rd WHERE host = 'h3' ORDER BY ts DESC LIMIT 10",
        f"SELECT host, v FROM rd WHERE ts >= {T0 + 150_000} AND ts < {T0 + 420_000} "
        "ORDER BY v DESC LIMIT 25",
        "SELECT host, w FROM rd WHERE v > 100 ORDER BY w ASC LIMIT 40 OFFSET 3",
        "SELECT host, v FROM rd WHERE host IN ('h1', 'h6') ORDER BY v DESC LIMIT 7",
    ])
    def test_windows_cover_every_passing_row(self, dbs, monkeypatch, sql):
        _seed(dbs, n=700, hosts=9, seed=5)
        seen = []
        real = port_kernels.raw_topk_packed

        def spy(*a, **k):
            seen.append((a, k))
            return real(*a, **k)

        monkeypatch.setattr(port_kernels, "raw_topk_packed", spy)
        _parity(dbs, sql, monkeypatch, "topk")
        args, kw = seen[-1]
        w = kw["windows"]
        entry = dbs[1].interpreters.executor.scan_cache._entries["rd"]
        assert len(w) and int(w[0, 0]) >= 0 and int(w[-1, 1]) <= entry.n_valid
        assert bool((w[1:, 0] > w[:-1, 1]).all())
        sel = port_kernels.raw_select_plain(*args, select_slots=entry.n_valid,
                                            numeric_filters=kw["numeric_filters"],
                                            value_layouts=kw["value_layouts"],
                                            ts_layout=kw["ts_layout"],
                                            series_layout=kw["series_layout"])
        passing = sel[1:1 + int(sel[0])].numpy()
        inside = np.zeros(entry.padded_rows + 1, bool)
        for a, b in w:
            inside[a:b] = True
        assert inside[passing].all()

    def test_segment_search_is_searchsorted_per_segment(self):
        from horaedb_tpu_torch.query.scan_cache import _segment_search

        rng = np.random.default_rng(8)
        for _ in range(50):
            lens = rng.integers(0, 40, int(rng.integers(1, 30)))
            values = np.concatenate([np.sort(rng.integers(0, 60, n)) for n in lens] +
                                    [np.empty(0, np.int64)]).astype(np.int32)
            ends = np.cumsum(lens)
            starts = ends - lens
            x = rng.integers(-5, 70, len(lens))
            want = [s + np.searchsorted(values[s:e], t, "left")
                    for s, e, t in zip(starts, ends, x)]
            assert _segment_search(values, starts, ends, x).tolist() == want


class TestHostRoutes:
    """Each deterministic rule that keeps a raw read on the host."""

    def _route(self, dbs, sql, monkeypatch, reason, counter):
        ref, port = dbs
        before = _counter(counter)
        got = _warm(port, sql)
        assert got.metrics.get("path") == "host", sql
        assert got.metrics.get("raw_host") == reason
        assert "raw_kernel" not in got.metrics and "cache" not in got.metrics
        assert _counter(counter) > before
        assert got.to_pylist() == _warm(ref, sql).to_pylist()
        return got

    def test_kill_switch(self, dbs, monkeypatch):
        _seed(dbs, n=100)
        monkeypatch.setenv("HORAEDB_RAW_DEVICE", "0")
        self._route(dbs, "SELECT host, v FROM rd WHERE v < 50 ORDER BY ts DESC LIMIT 5",
                    monkeypatch, "kill_switch", "host")

    def test_limit_pushdown(self, dbs, monkeypatch):
        _seed(dbs, n=100)
        out = self._route(dbs, "SELECT host, v FROM rd LIMIT 5", monkeypatch,
                          "limit_pushdown", "host")
        assert out.num_rows == 5

    def test_candidate_estimate_over_the_row_budget(self, dbs, monkeypatch):
        _seed(dbs, n=200, hosts=4)
        sql = "SELECT host, v FROM rd ORDER BY host ASC, v ASC"  # multikey: selection
        monkeypatch.setenv("HORAEDB_RAW_MAX_ROWS", "10")  # 200 > 10
        self._route(dbs, sql, monkeypatch, "over_budget", "host")
        monkeypatch.setenv("HORAEDB_RAW_MAX_ROWS", "200")  # exactly at the bound
        _parity(dbs, sql, monkeypatch, "select")

    def test_null_in_a_sorted_column(self, dbs, monkeypatch):
        rows = ", ".join(
            f"('h{i % 3}', {float(i)}, " + ("NULL" if i % 2 else f"{float(i)}")
            + f", {T0 + i * 1000})" for i in range(60)
        )
        _both(dbs, DDL)
        _both(dbs, f"INSERT INTO rd (host, v, w, ts) VALUES {rows}")
        self._route(dbs, "SELECT host, w FROM rd ORDER BY w DESC LIMIT 10", monkeypatch,
                    "null", "fallback")

    def test_null_in_a_filtered_column(self, dbs, monkeypatch):
        _seed(dbs, n=90, null_w_every=4)
        self._route(dbs, "SELECT host, v FROM rd WHERE w > 30 ORDER BY ts DESC LIMIT 10",
                    monkeypatch, "null", "fallback")

    def test_entry_without_host_rows(self, monkeypatch):
        monkeypatch.setenv("HORAEDB_CACHE_HOST_ROWS_MB", "0")  # every host copy dropped
        ref = horaedb_tpu.connect(None)
        port = horaedb_tpu_torch.connect(None, device="cpu")
        try:
            _seed((ref, port), n=100)
            self._route((ref, port), "SELECT host, v FROM rd ORDER BY ts DESC LIMIT 5",
                        monkeypatch, "no_host_rows", "fallback")
            assert port.interpreters.executor.scan_cache._entries["rd"].rows is None
        finally:
            ref.close()
            port.close()

    def test_overwrite_delta_that_could_shadow_a_base_row(self, dbs, monkeypatch):
        _seed(dbs, n=80)
        sql = "SELECT host, v, ts FROM rd ORDER BY ts DESC LIMIT 5"
        for db in dbs:
            _warm(db, sql)
        # the same (series, ts) key as a base row: an overwrite
        _both(dbs, f"INSERT INTO rd (host, v, w, ts) VALUES ('h1', 7777.0, 1.0, {T0 + 1000})")
        self._route(dbs, sql, monkeypatch, "overwrite_delta", "fallback")

    def test_first_sighting_is_a_cache_miss(self, dbs, monkeypatch):
        _seed(dbs, n=50)
        ref, port = dbs
        sql = "SELECT host, v FROM rd ORDER BY ts DESC LIMIT 3"
        before = _counter("fallback")
        got = port.execute(sql)
        assert got.metrics.get("path") == "host" and got.metrics.get("raw_host") == "cache"
        assert _counter("fallback") > before
        assert got.to_pylist() == ref.execute(sql).to_pylist()
        assert port.execute(sql).metrics.get("path") == "raw_device"


class TestFloatKeyNaN:
    def _seed_with_nan(self, dbs, n=60, nan_every=4):
        hosts = np.array([f"h{i % 4}" for i in range(n)], dtype=object)
        v = np.arange(n, dtype=np.float64)
        v[::nan_every] = np.nan
        _both(dbs, DDL)
        for pkg, db in zip((horaedb_tpu, horaedb_tpu_torch), dbs):
            table = db.catalog.open("rd")
            table.write(pkg.common_types.RowGroup(table.schema, {
                "tsid": pkg.common_types.schema.compute_tsid([hosts]),
                "host": hosts,
                "v": v,
                "w": np.ones(n),
                "ts": (T0 + np.arange(n) * 1000).astype(np.int64),
            }))

    @pytest.mark.parametrize("order", ["DESC", "ASC"])
    def test_nan_sorts_last_both_directions(self, dbs, monkeypatch, order):
        self._seed_with_nan(dbs)
        got, host = _parity(dbs, f"SELECT v, ts FROM rd ORDER BY v {order} LIMIT 8",
                            monkeypatch, "topk")
        vals = [r["v"] for r in got.to_pylist()]
        assert not any(np.isnan(x) for x in vals)
        assert vals == [r["v"] for r in host.to_pylist()]

    def test_limit_past_real_values_includes_nans_like_host(self, dbs, monkeypatch):
        self._seed_with_nan(dbs, n=20, nan_every=2)  # 10 real, 10 NaN
        ref, port = dbs
        sql = "SELECT v FROM rd ORDER BY v DESC LIMIT 15"
        got = [r["v"] for r in _warm(port, sql).to_pylist()]
        want = [r["v"] for r in _warm(ref, sql).to_pylist()]
        host = [r["v"] for r in _host(port, sql, monkeypatch).to_pylist()]
        for other in (want, host):
            assert [np.isnan(x) for x in got] == [np.isnan(x) for x in other]
            assert [x for x in got if not np.isnan(x)] == [x for x in other if not np.isnan(x)]


class TestSignedZeros:
    def test_device_order_of_the_reference(self, dbs, monkeypatch):
        """The device key ranks -0.0 below +0.0, the host's sort does not:
        with LIMIT 1 both zeros of the table compete for the last of the
        16 candidate slots. The port answers as the reference's device
        route, and its kill switch as the reference's host route."""
        v = [-0.0] * 20 + [0.0] * 20 + [-1.0 - i for i in range(8)]
        rows = ", ".join(f"('h', {x!r}, {float(i)}, {T0 + i * 1000})" for i, x in enumerate(v))
        _both(dbs, DDL)
        _both(dbs, f"INSERT INTO rd (host, v, w, ts) VALUES {rows}")
        got, host = _parity(dbs, "SELECT v, w FROM rd ORDER BY v DESC LIMIT 1", monkeypatch,
                            "topk")
        assert _signed(got.to_pylist()) == [{"v": (0.0, 1.0), "w": (20.0, 1.0)}]
        assert _signed(host.to_pylist()) == [{"v": (-0.0, -1.0), "w": (0.0, 1.0)}]


class TestSurfaces:
    def test_explain_names_the_raw_route(self, dbs, monkeypatch):
        _seed(dbs, n=50)
        port = dbs[1]

        def line(sql):
            plan = port.execute("EXPLAIN " + sql).column("plan")
            return next(p for p in plan if "Execution:" in p)

        topk = line("SELECT host, v FROM rd WHERE v < 10 ORDER BY ts DESC LIMIT 5")
        assert "raw device" in topk and "top-k" in topk
        assert "bounded selection" in line("SELECT host, v FROM rd WHERE v < 10")
        assert "projection scan (host)" in line("SELECT host, v FROM rd LIMIT 5")
        monkeypatch.setenv("HORAEDB_RAW_DEVICE", "0")
        assert "projection scan (host)" in line(
            "SELECT host, v FROM rd WHERE v < 10 ORDER BY ts DESC LIMIT 5")

    @pytest.mark.parametrize("kill", ["1", "0"])
    @pytest.mark.parametrize("sql", [
        "SELECT host, v FROM rd WHERE v < 10 ORDER BY ts DESC LIMIT 5",
        "SELECT host, v FROM rd WHERE v < 10",
        "SELECT host, v FROM rd LIMIT 5",
        "SELECT host, avg(v) AS a FROM rd GROUP BY host",
    ])
    def test_explain_agrees_with_execution(self, dbs, monkeypatch, kill, sql):
        _seed(dbs, n=50)
        port = dbs[1]
        monkeypatch.setenv("HORAEDB_RAW_DEVICE", kill)
        plan = port.execute("EXPLAIN " + sql).column("plan")
        line = next(p for p in plan if "Execution:" in p)
        got = _warm(port, sql)
        assert ("raw device" in line) == (got.metrics.get("path") == "raw_device"), line

    def test_counters_and_the_plain_versions(self, dbs):
        from horaedb_tpu_torch.utils.metrics import REGISTRY

        _seed(dbs, n=100)
        port = dbs[1]
        topk, select = _counter("topk"), _counter("select")
        calls = dict(port_kernels.PLAIN_CALLS)
        _warm(port, "SELECT host, v FROM rd WHERE v < 50 ORDER BY ts DESC LIMIT 5")
        _warm(port, "SELECT host, v FROM rd WHERE v < 50")
        assert _counter("topk") > topk and _counter("select") > select
        assert port_kernels.PLAIN_CALLS["raw_topk"] > calls["raw_topk"]
        assert port_kernels.PLAIN_CALLS["raw_select"] > calls["raw_select"]
        assert "horaedb_raw_scan_total" in REGISTRY.expose()

    def test_allow_list_session_is_resident_and_counted(self, dbs):
        from horaedb_tpu_torch.obs.device import DEVICE_KERNEL_KINDS

        assert {"raw_topk", "raw_select"} <= set(DEVICE_KERNEL_KINDS)
        _seed(dbs, n=100)
        port = dbs[1]
        _warm(port, "SELECT host, v FROM rd WHERE host = 'h3' ORDER BY ts DESC LIMIT 5")
        rows = port.execute("SELECT column_name, component, bytes FROM system.public.device "
                            "WHERE table_name = 'rd'").to_pylist()
        sessions = [r for r in rows if r["column_name"] == "__raw_sessions__"]
        assert sessions and sessions[0]["component"] == "session" and sessions[0]["bytes"] > 0
        cache = port.interpreters.executor.scan_cache
        assert cache.occupancy_bytes()["session"] >= sessions[0]["bytes"]

    def test_selection_past_its_exact_bound_raises(self, dbs, monkeypatch):
        """The candidate estimate bounds the mask exactly; a count past the
        buffer is a fault the port raises (the reference bails to host)."""
        _seed(dbs, n=100)
        port = dbs[1]
        sql = "SELECT host, v FROM rd WHERE v < 50"
        assert _warm(port, sql).metrics.get("path") == "raw_device"
        executor = type(port.interpreters.executor)
        real = executor._raw_candidate_estimate

        def quarter(self, *a):  # 25 of the 50 rows, the windows left whole
            count, windows = real(self, *a)
            return count // 4, windows

        monkeypatch.setattr(executor, "_raw_candidate_estimate", quarter)
        with pytest.raises(RuntimeError, match="exact bound"):
            port.execute(sql)
