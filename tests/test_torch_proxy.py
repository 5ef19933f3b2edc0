"""The port's ``Proxy`` gateway with cohort batching, on the CPU.

The scenarios of the reference's ``tests/test_batch.py``, run against
``horaedb_tpu_torch.proxy.Proxy`` over ``connect(None, device="cpu")``:
shape-identical in-flight SELECTs with differing literals gather in a
micro-batching window and serve from ONE fused dispatch (the cohort
scan-aggregate, its plain version here), with per-query demux, per-member
error isolation, epoch-fenced read-your-writes, and identical twins
coalescing inside the cohort. A flood through the port's Proxy answers as
the reference's Proxy does on the same data, and ``[wlm.batch]`` parses
and validates as the reference's loader does.
"""

from __future__ import annotations

import threading
import time

import pytest

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.proxy import Proxy as RefProxy
from horaedb_tpu.utils.config import BatchSection as RefBatchSection
from horaedb_tpu_torch.ops import scan_agg as port_kernels
from horaedb_tpu_torch.proxy import Proxy
from horaedb_tpu_torch.utils.config import BatchSection, ConfigError, _apply_batch
from horaedb_tpu_torch.utils.metrics import REGISTRY
from horaedb_tpu_torch.utils.querystats import STATS_STORE
from horaedb_tpu_torch.wlm.quota import QuotaExceededError

from torch_parity import SUM_RTOL


def _counter(name: str, **labels) -> float:
    return REGISTRY.counter(name, "", labels=labels or None).value


def _dash_db(hosts: int = 6, rows: int = 40, pkg=horaedb_tpu_torch):
    db = pkg.connect(None, device="cpu") if pkg is horaedb_tpu_torch else pkg.connect(None)
    db.execute(
        "CREATE TABLE dash (host string TAG, v double, "
        "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic"
    )
    values = []
    for h in range(hosts):
        for i in range(rows):
            values.append(f"('h{h}', {h + i * 0.25}, {1000 + i * 10})")
    db.execute("INSERT INTO dash (host, v, ts) VALUES " + ",".join(values))
    db.flush_all()
    return db


def _batch_proxy(db, window_s=0.25, max_cohort=8, proxy=Proxy, section=BatchSection, **kw):
    return proxy(
        db,
        batch_cfg=section(enabled=True, window_s=window_s, max_cohort=max_cohort, **kw),
    )


def _run_concurrent(proxy, sqls, tenants=None):
    """Fire the statements concurrently; returns {sql: result-or-error}."""
    out: dict = {}

    def worker(sql, tenant):
        try:
            out[sql] = proxy.handle_sql(sql, tenant=tenant)
        except BaseException as e:  # noqa: BLE001 — outcomes under test
            out[sql] = e

    threads = [
        threading.Thread(
            target=worker,
            args=(s, tenants[i] if tenants else "default"),
        )
        for i, s in enumerate(sqls)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _rows(result) -> list:
    return sorted(tuple(r.values()) for r in result.to_pylist())


class TestCohortFusion:
    def test_flood_smoke_fused_and_correct(self):
        """A burst of param-varied dashboard queries through the batcher
        serves from ONE fused dispatch (one cohort launch) and every
        member's answer matches its solo execution."""
        db = _dash_db()
        proxy = _batch_proxy(db, max_cohort=8)
        try:
            sqls = [
                f"SELECT host, count(v), sum(v) FROM dash "
                f"WHERE ts >= {1000 + i * 10} AND ts < 1400 GROUP BY host"
                for i in range(8)
            ]
            expected = {s: _rows(proxy.handle_sql(s)) for s in sqls}
            fused0 = _counter("horaedb_batch_dispatch_total", kind="fused")
            cohort0 = port_kernels.PLAIN_CALLS["cached_cohort"]
            out = _run_concurrent(proxy, sqls)
            for s in sqls:
                assert not isinstance(out[s], BaseException), out[s]
                assert _rows(out[s]) == expected[s]
            assert (
                _counter("horaedb_batch_dispatch_total", kind="fused")
                >= fused0 + 1
            )
            assert port_kernels.PLAIN_CALLS["cached_cohort"] >= cohort0 + 1
            # ledger roles: one leader row carrying the cohort size,
            # members carrying batch_member, all carrying batch_cohort
            recent = [
                r for r in STATS_STORE.list() if r.get("batch_cohort")
            ]
            assert any(r["batch_leader"] >= 2 for r in recent)
            assert any(r["batch_member"] == 1 for r in recent)
        finally:
            proxy.close()
            db.close()

    def test_mixed_limits_demux_per_member(self):
        """Mixed LIMITs share one shape (LIMIT is masked in the cohort
        key) and one fused dispatch; each member's LIMIT applies to ITS
        demuxed result."""
        db = _dash_db(hosts=6)
        proxy = _batch_proxy(db, max_cohort=4)
        try:
            sqls = [
                f"SELECT host, sum(v) FROM dash GROUP BY host "
                f"ORDER BY host LIMIT {k}"
                for k in (1, 2, 3, 4)
            ]
            for s in sqls:  # warm cache + solo answers
                proxy.handle_sql(s)
            fused0 = _counter("horaedb_batch_dispatch_total", kind="fused")
            out = _run_concurrent(proxy, sqls)
            for k, s in zip((1, 2, 3, 4), sqls):
                assert not isinstance(out[s], BaseException), out[s]
                assert out[s].num_rows == k
                assert list(out[s].column("host")) == [
                    f"h{i}" for i in range(k)
                ]
            assert (
                _counter("horaedb_batch_dispatch_total", kind="fused")
                == fused0 + 1
            )
        finally:
            proxy.close()
            db.close()

    def test_cohort_of_one_degenerates_to_solo_path(self):
        """A window that gathers a single query runs the dedup+admission
        path: solo dispatch accounting, no fused dispatch, no batch ledger
        roles, no cohort launch."""
        db = _dash_db()
        proxy = _batch_proxy(db, window_s=0.01)
        try:
            sql = "SELECT host, count(v) FROM dash GROUP BY host"
            fused0 = _counter("horaedb_batch_dispatch_total", kind="fused")
            solo0 = _counter("horaedb_batch_dispatch_total", kind="solo")
            cohort0 = port_kernels.PLAIN_CALLS["cached_cohort"]
            out = proxy.handle_sql(sql)
            assert out.num_rows == 6
            assert _counter("horaedb_batch_dispatch_total", kind="fused") == fused0
            assert _counter("horaedb_batch_dispatch_total", kind="solo") == solo0 + 1
            assert port_kernels.PLAIN_CALLS["cached_cohort"] == cohort0
            row = STATS_STORE.list()[-1]
            assert row["batch_cohort"] == 0 and row["batch_member"] == 0
        finally:
            proxy.close()
            db.close()

    def test_identical_twins_coalesce_inside_cohort(self):
        """Members with the SAME sql share one cohort slot (the dedup
        contract survives inside the batch layer)."""
        db = _dash_db()
        proxy = _batch_proxy(db, max_cohort=3)
        try:
            twin = "SELECT host, sum(v) FROM dash GROUP BY host"
            other = (
                "SELECT host, sum(v) FROM dash WHERE ts >= 1100 GROUP BY host"
            )
            expected_twin = _rows(proxy.handle_sql(twin))
            dedup0 = _counter(
                "horaedb_admission_dedup_total", role="follower"
            )
            out: dict = {}

            def worker(tag, sql):
                out[tag] = proxy.handle_sql(sql)

            threads = [
                threading.Thread(target=worker, args=("a", twin)),
                threading.Thread(target=worker, args=("b", twin)),
                threading.Thread(target=worker, args=("c", other)),
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert _rows(out["a"]) == expected_twin
            assert _rows(out["b"]) == expected_twin
            assert (
                _counter("horaedb_admission_dedup_total", role="follower")
                >= dedup0 + 1
            )
        finally:
            proxy.close()
            db.close()

    def test_disabled_batcher_is_inert(self):
        """[wlm.batch] enabled=false (the default): no batch metrics move,
        no cohort launch."""
        db = _dash_db()
        proxy = Proxy(db)  # no batch_cfg: disabled
        try:
            fused0 = _counter("horaedb_batch_dispatch_total", kind="fused")
            solo0 = _counter("horaedb_batch_dispatch_total", kind="solo")
            cohort0 = port_kernels.PLAIN_CALLS["cached_cohort"]
            sqls = [
                f"SELECT host, count(v) FROM dash WHERE ts >= {1000 + i * 10} "
                "GROUP BY host"
                for i in range(4)
            ]
            out = _run_concurrent(proxy, sqls)
            assert all(not isinstance(v, BaseException) for v in out.values())
            assert _counter("horaedb_batch_dispatch_total", kind="fused") == fused0
            assert _counter("horaedb_batch_dispatch_total", kind="solo") == solo0
            assert port_kernels.PLAIN_CALLS["cached_cohort"] == cohort0
        finally:
            proxy.close()
            db.close()

    def test_shapes_filter_restricts_eligibility(self):
        db = _dash_db()
        proxy = _batch_proxy(db, shapes=["from other_table"])
        try:
            assert not proxy.wlm.batch.eligible(
                db._cached_plan("SELECT host, sum(v) FROM dash GROUP BY host"),
                "select host, sum(v) from dash group by host",
            )
        finally:
            proxy.close()
            db.close()

    def test_flood_answers_as_the_reference_proxy(self):
        """The same flood through both packages' Proxies, batching on:
        every member's rows equal the reference's (sums within SUM_RTOL of
        their magnitude: the two sum in different orders)."""
        sqls = [
            f"SELECT host, count(v), sum(v), max(v) FROM dash "
            f"WHERE ts >= {1000 + (i % 4) * 40} AND ts < 1400 AND v >= {(i // 4) * 2.5} "
            "GROUP BY host"
            for i in range(8)
        ]
        answers = []
        for pkg, proxy_cls, section in ((horaedb_tpu, RefProxy, RefBatchSection),
                                        (horaedb_tpu_torch, Proxy, BatchSection)):
            db = _dash_db(pkg=pkg)
            proxy = _batch_proxy(db, max_cohort=8, proxy=proxy_cls, section=section)
            try:
                for s in sqls[:2]:  # warm: a miss, then the cache build
                    proxy.handle_sql(s)
                out = _run_concurrent(proxy, sqls)
                answers.append({s: _rows(out[s]) for s in sqls})
            finally:
                proxy.close()
                db.close()
        want, got = answers
        for s in sqls:
            assert len(got[s]) == len(want[s]) > 0, s
            for w, g in zip(want[s], got[s]):
                assert w[:2] == g[:2] and w[3] == g[3], (s, w, g)  # host, count, max
                assert g[2] == pytest.approx(w[2], rel=SUM_RTOL), (s, w, g)


class TestCorrectnessRails:
    def test_write_mid_window_fences_fresh_cohort(self):
        """A write landing while a cohort is forming fences later-arriving
        members into a FRESH cohort — two fused size-2 cohorts, never one
        of size 4 — and the post-write members see the row."""
        db = _dash_db()
        proxy = _batch_proxy(db, window_s=0.6, max_cohort=2)
        try:
            pre = [
                "SELECT host, count(v) FROM dash WHERE ts < 9000 GROUP BY host",
                "SELECT host, count(v) FROM dash WHERE ts < 9100 GROUP BY host",
            ]
            post = [
                "SELECT host, count(v) FROM dash WHERE ts < 9200 GROUP BY host",
                "SELECT host, count(v) FROM dash WHERE ts < 9300 GROUP BY host",
            ]
            size2_0 = _counter("horaedb_batch_cohort_total", size="2")
            size4_0 = _counter("horaedb_batch_cohort_total", size="4")
            out: dict = {}

            def worker(sql):
                out[sql] = proxy.handle_sql(sql)

            pre_threads = [
                threading.Thread(target=worker, args=(s,)) for s in pre
            ]
            pre_threads[0].start()
            time.sleep(0.1)  # the leader is mid-window
            proxy.handle_sql(
                "INSERT INTO dash (host, v, ts) VALUES ('hNEW', 1.0, 5000)"
            )  # bumps the dedup epoch -> fences the forming key
            post_threads = [
                threading.Thread(target=worker, args=(s,)) for s in post
            ]
            pre_threads[1].start()  # joins whichever epoch is current
            for t in post_threads:
                t.start()
            for t in pre_threads + post_threads:
                t.join()
            for s in post:
                hosts = list(out[s].column("host"))
                assert "hNEW" in hosts, "post-write member missed the write"
            assert _counter("horaedb_batch_cohort_total", size="4") == size4_0
            assert _counter("horaedb_batch_cohort_total", size="2") >= size2_0 + 1
        finally:
            proxy.close()
            db.close()

    def test_quota_exceeded_member_does_not_poison_cohort(self):
        """A member shed by its tenant quota fails alone; the rest of the
        cohort serves normally."""
        db = _dash_db()
        proxy = _batch_proxy(db, max_cohort=3)
        try:
            proxy.wlm.quota.set_quota("tenant", "starved", "read_qps", 0.001, burst=0)
            sqls = [
                f"SELECT host, sum(v) FROM dash WHERE ts >= {1000 + i * 10} "
                "GROUP BY host"
                for i in range(3)
            ]
            out = _run_concurrent(
                proxy, sqls, tenants=["default", "default", "starved"]
            )
            assert isinstance(out[sqls[2]], QuotaExceededError)
            for s in sqls[:2]:
                assert not isinstance(out[s], BaseException), out[s]
                assert out[s].num_rows == 6
        finally:
            proxy.close()
            db.close()

    def test_error_isolation_one_bad_member(self, monkeypatch):
        """A member whose demux/assembly fails inside the fused dispatch
        poisons only its own slot."""
        from horaedb_tpu_torch.query.executor import Executor

        db = _dash_db()
        proxy = _batch_proxy(db, max_cohort=3)
        try:
            orig = Executor._assemble_agg_result

            def poisoned(self, plan, *args, **kw):
                if plan.select.limit == 13:
                    raise RuntimeError("injected member failure")
                return orig(self, plan, *args, **kw)

            monkeypatch.setattr(Executor, "_assemble_agg_result", poisoned)
            base = "SELECT host, sum(v) FROM dash GROUP BY host ORDER BY host"
            sqls = [f"{base} LIMIT {k}" for k in (2, 13, 4)]
            out = _run_concurrent(proxy, sqls)
            bad = out[sqls[1]]
            assert isinstance(bad, RuntimeError)
            assert "injected member failure" in str(bad)
            assert out[sqls[0]].num_rows == 2
            assert out[sqls[2]].num_rows == 4
        finally:
            proxy.close()
            db.close()

    def test_batch_config_section_parses(self, tmp_path):
        """[wlm.batch] through the port's validation gives what the
        reference's loader gives for the same TOML; a bad width raises."""
        from horaedb_tpu.utils.config import Config

        p = tmp_path / "c.toml"
        p.write_text(
            "[wlm.batch]\nenabled = true\nwindow = \"5ms\"\n"
            "max_cohort = 16\nshapes = [\"from dash\"]\n"
        )
        want = Config.load(str(p)).wlm.batch
        bs = BatchSection()
        _apply_batch(bs, {"enabled": True, "window": "5ms", "max_cohort": 16,
                          "shapes": ["from dash"]})
        assert bs.enabled is True is want.enabled
        assert bs.window_s == pytest.approx(0.005) == want.window_s
        assert bs.max_cohort == 16 == want.max_cohort
        assert bs.shapes == ["from dash"] == want.shapes
        for bad in ({"max_cohort": 1}, {"enabled": "yes"}, {"window": "0s"},
                    {"shapes": "from dash"}, {"size": 3}, []):
            with pytest.raises(ConfigError):
                _apply_batch(BatchSection(), bad)

    def test_workload_snapshot_carries_batch_state(self):
        db = horaedb_tpu_torch.connect(None, device="cpu")
        proxy = _batch_proxy(db, window_s=0.002, max_cohort=4)
        try:
            snap = proxy.wlm.snapshot()["batch"]
            assert snap["enabled"] is True
            assert snap["max_cohort"] == 4
            assert snap["forming_cohorts"] == 0
        finally:
            proxy.close()
            db.close()
