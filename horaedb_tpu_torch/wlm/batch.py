"""Cohort batching — the dashboard flood as ONE device dispatch.

``wlm/dedup`` single-flights *identical* SELECTs; this layer generalizes
it: in-flight queries that share a normalized plan shape but differ in
their literals (the same dashboard SELECT asked for thousands of
tenants/hosts/time windows at once) gather for a micro-batching window,
then the whole cohort is served by one fused kernel call — the packed
cached scan-agg kernel vmapped over a ``[B, ...]`` params axis
(ops/scan_agg.cached_scan_agg_cohort), each member's literals hoisted
into its row of the batched session/dyn uploads.

Correctness rails:

- **per-query demux**: every member gets its own ResultSet assembled
  from its slice of the batched kernel state — mixed LIMITs/ORDER BYs
  within one shape apply per member, after the shared dispatch;
- **error isolation**: the cohort executor returns one outcome PER
  member; a member whose execution fails raises only to its own caller
  (and a wholesale fused failure falls back to per-member solo
  execution inside the executor);
- **read-your-writes**: the cohort key carries the dedup write epoch —
  a write landing while a cohort is forming fences later-arriving
  members into a fresh cohort (wlm/dedup.ReadDeduper.epoch);
- **degenerate cohorts**: a window that gathers only one unique query
  executes through today's solo path (dedup single-flight + admission)
  with no extra dispatch;
- **identical twins**: members with the SAME sql coalesce onto one
  cohort slot (the dedup contract survives inside the batch layer; the
  twins count into the ``horaedb_admission_dedup_total`` family).

Ledger roles mirror dedup's: the leader's ledger records
``batch_leader`` (cohort size) and every participant records
``batch_cohort``; non-leader members record ``batch_member=1`` — all
queryable per request in ``system.public.query_stats``.

Field-registry discipline (the contract): every
``horaedb_batch_*`` family is declared in ``BATCH_METRIC_FAMILIES``
below and linted in tests/test_observability.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils.metrics import REGISTRY
from ..utils.querystats import record

# family -> help; the single source of truth the registry lint walks.
BATCH_METRIC_FAMILIES: dict[str, str] = {
    "horaedb_batch_dispatch_total":
        "batched-serving dispatch outcomes, by kind (fused cohort vs solo)",
    "horaedb_batch_cohort_total":
        "fused cohorts served, by cohort-size bucket",
    "horaedb_batch_window_wait_seconds":
        "time queries spent gathering in the micro-batching window",
}

# cohort-size histogram as a bucket-labeled counter (the metrics lint
# reserves histogram suffixes for real units; sizes bucket cleanly)
COHORT_SIZE_BUCKETS = ("1", "2", "4", "8", "16", "32+")


def _size_bucket(n: int) -> str:
    for b in ("1", "2", "4", "8", "16"):
        if n <= int(b):
            return b
    return "32+"


def _register_families() -> None:
    for kind in ("fused", "solo"):
        REGISTRY.counter(
            "horaedb_batch_dispatch_total",
            BATCH_METRIC_FAMILIES["horaedb_batch_dispatch_total"],
            labels={"kind": kind},
        )
    for b in COHORT_SIZE_BUCKETS:
        REGISTRY.counter(
            "horaedb_batch_cohort_total",
            BATCH_METRIC_FAMILIES["horaedb_batch_cohort_total"],
            labels={"size": b},
        )
    REGISTRY.histogram(
        "horaedb_batch_window_wait_seconds",
        BATCH_METRIC_FAMILIES["horaedb_batch_window_wait_seconds"],
    )


_register_families()


def _member_error(err: BaseException) -> BaseException:
    """What non-leader members see for a wholesale cohort failure. A
    leader cancelled (KILL/disconnect) or dead to ITS deadline is a
    leader-personal ending — members who never cancelled and carry
    their own budgets get a typed retryable overload instead (a retry
    forms or joins a fresh cohort)."""
    from ..utils.deadline import DeadlineExceeded, QueryCancelled
    from .admission import OverloadedError

    if isinstance(err, QueryCancelled):
        return OverloadedError(
            "the cohort leader serving this read was cancelled; retry "
            "forms a fresh cohort",
            reason="batch_leader_cancelled",
            retry_after_s=0.1,
        )
    if isinstance(err, DeadlineExceeded):
        return OverloadedError(
            "the cohort leader serving this read exceeded ITS time "
            "budget; retry forms a fresh cohort",
            reason="batch_leader_timeout",
            retry_after_s=0.1,
        )
    return err


_BATCH_KEYS: dict = {}


def batch_plan_key(plan) -> tuple:
    """Normalized plan-shape key for cohort grouping: the path router's
    literal-masked shape with LIMIT/OFFSET additionally masked (mixed
    LIMITs demux per member AFTER the shared dispatch, so they must not
    split a cohort). Computed once per plan object (memo_by_plan)."""
    import dataclasses

    from ..query.path_router import _shape, memo_by_plan

    def key_of(p) -> tuple:
        sel = dataclasses.replace(p.select, limit=None, offset=0)
        return (p.table, _shape(sel))

    return memo_by_plan(_BATCH_KEYS, plan, key_of)


class _Member:
    """One unique SQL within a forming cohort. Identical-SQL arrivals
    share the slot (waiters beyond the first are dedup twins)."""

    __slots__ = ("sql", "plan", "event", "result", "error", "twins")

    def __init__(self, sql: str, plan) -> None:
        self.sql = sql
        self.plan = plan
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.twins = 0


class _Cohort:
    __slots__ = ("members", "closed", "full", "created", "closed_at")

    def __init__(self) -> None:
        self.members: dict[str, _Member] = {}
        self.closed = False
        self.full = threading.Event()  # set when max_cohort is reached
        self.created = time.perf_counter()
        self.closed_at = 0.0


class CohortBatcher:
    """The micro-batching window in front of the dedup/admission path.

    ``run`` is the one entry point: the first arrival for a (epoch,
    shape) key leads — it waits the window (cut short when the cohort
    fills), then either executes solo (single unique member) or hands
    the whole cohort to ``cohort_exec`` for one fused dispatch; joiners
    block on their member slot and get their own demuxed result (or
    their own error)."""

    def __init__(
        self,
        enabled: bool = False,
        window_s: float = 0.002,
        max_cohort: int = 32,
        shapes: tuple = (),
        deduper=None,
    ) -> None:
        self.enabled = enabled
        self.window_s = float(window_s)
        self.max_cohort = max(2, int(max_cohort))
        self.shapes = tuple(shapes or ())
        self.deduper = deduper
        self._lock = threading.Lock()
        self._forming: dict[tuple, _Cohort] = {}
        self._m_dispatch = {
            kind: REGISTRY.counter(
                "horaedb_batch_dispatch_total",
                BATCH_METRIC_FAMILIES["horaedb_batch_dispatch_total"],
                labels={"kind": kind},
            )
            for kind in ("fused", "solo")
        }
        self._m_cohort = {
            b: REGISTRY.counter(
                "horaedb_batch_cohort_total",
                BATCH_METRIC_FAMILIES["horaedb_batch_cohort_total"],
                labels={"size": b},
            )
            for b in COHORT_SIZE_BUCKETS
        }
        self._m_wait = REGISTRY.histogram(
            "horaedb_batch_window_wait_seconds",
            BATCH_METRIC_FAMILIES["horaedb_batch_window_wait_seconds"],
        )

    @staticmethod
    def from_config(batch_cfg, deduper=None) -> "CohortBatcher":
        """Build from a config [wlm.batch] section (utils/config
        BatchSection) — or defaults (disabled) when ``batch_cfg`` is
        None."""
        g = lambda k, d: getattr(batch_cfg, k, d) if batch_cfg is not None else d  # noqa: E731
        return CohortBatcher(
            enabled=g("enabled", False),
            window_s=g("window_s", 0.002),
            max_cohort=g("max_cohort", 32),
            shapes=tuple(g("shapes", ()) or ()),
            deduper=deduper,
        )

    def eligible(self, plan, shape_sql: str) -> bool:
        """Cheap proxy-side probe: may this SELECT gather in a cohort?
        Conservative — a wrong yes only costs the window wait (the
        executor falls back to solo execution for members it cannot
        fuse); a wrong no just skips batching."""
        if not self.enabled:
            return False
        sel = getattr(plan, "select", None)
        if sel is None or sel.join is not None or sel.ctes:
            return False
        if not getattr(plan, "is_aggregate", False):
            return False  # the fused cohort kernel serves agg shapes
        table = getattr(plan, "table", "") or ""
        if table.lower().startswith("system"):
            return False  # introspection answers about the asking moment
        if self.shapes and not any(s in shape_sql for s in self.shapes):
            return False
        return True

    def run(
        self,
        key: tuple,
        sql: str,
        plan,
        solo: Callable[[], object],
        cohort_exec: Callable[[list], list],
    ):
        """Serve one query through the batching window.

        ``key`` must already carry the write epoch (read-your-writes
        fencing). ``solo`` is today's full path (dedup single-flight +
        admission + execute); ``cohort_exec`` takes the list of unique
        ``(sql, plan)`` members and returns one Output-or-exception per
        member, positionally."""
        if not self.enabled:
            return solo()
        t_join = time.perf_counter()
        with self._lock:
            cohort = self._forming.get(key)
            if cohort is not None and not cohort.closed:
                member = cohort.members.get(sql)
                if member is not None:
                    member.twins += 1
                    joined: Optional[_Member] = member
                    twin = True
                elif len(cohort.members) < self.max_cohort:
                    member = _Member(sql, plan)
                    cohort.members[sql] = member
                    if len(cohort.members) >= self.max_cohort:
                        cohort.full.set()  # cut the leader's window short
                    joined = member
                    twin = False
                else:  # full but not yet closed: lead a fresh cohort
                    joined = None
                    twin = False
            else:
                joined = None
                twin = False
            if joined is None:
                cohort = _Cohort()
                leader_member = _Member(sql, plan)
                cohort.members[sql] = leader_member
                self._forming[key] = cohort

        if joined is not None:
            return self._await_member(cohort, joined, twin, t_join)

        # ---- leader: gather, close, dispatch ----------------------------
        cohort.full.wait(self.window_s)
        with self._lock:
            cohort.closed = True
            cohort.closed_at = time.perf_counter()
            if self._forming.get(key) is cohort:
                del self._forming[key]
            members = list(cohort.members.values())
        self._m_wait.observe(cohort.closed_at - t_join)
        n = len(members)
        if n == 1:
            # Degenerate cohort: today's path, no extra dispatch. Twins
            # (identical SQL that joined during the window) ride the
            # leader's execution exactly like dedup followers.
            self._m_dispatch["solo"].inc()
            self._m_cohort["1"].inc()
            m = members[0]
            try:
                m.result = solo()
            except BaseException as e:
                m.error = e
                raise
            finally:
                m.event.set()
                if m.twins and self.deduper is not None:
                    record(dedup_followers=m.twins)
            return m.result
        self._m_dispatch["fused"].inc()
        self._m_cohort[_size_bucket(n)].inc()
        record(batch_leader=n, batch_cohort=n)
        try:
            outcomes = cohort_exec([(m.sql, m.plan) for m in members])
        except BaseException as e:
            # wholesale failure (admission shed, runtime teardown):
            # every member sees the same error — EXCEPT a leader-
            # personal ending (its KILL, its deadline), which other
            # members must not inherit: they get the typed retryable
            # overload instead (same contract as dedup followers)
            member_err = _member_error(e)
            for m in members:
                m.error = e if m is members[0] else member_err
                m.event.set()
            raise
        for m, out in zip(members, outcomes):
            if isinstance(out, BaseException):
                m.error = out
            else:
                m.result = out
            m.event.set()
            if m.twins and self.deduper is not None:
                record(dedup_followers=m.twins)
        mine = members[0]
        if mine.error is not None:
            raise mine.error
        return mine.result

    def _await_member(self, cohort: _Cohort, member: _Member, twin: bool,
                      t_join: float):
        if twin and self.deduper is not None:
            # same contract as a dedup follower: one execution serves us
            self.deduper.note_coalesced()
            record(dedup_follower=1)
        # the leader always resolves every member in its finally; the
        # long timeout is a defensive bound, not a protocol step.
        # Sliced waits: a member observes ITS OWN deadline/cancel flag
        # while the cohort gathers/dispatches — a cancelled or expired
        # member demuxes out with its typed error and the cohort
        # SURVIVES (the leader still resolves every other slot; this
        # member's result is simply never consumed).
        from ..utils.deadline import current_deadline

        budget = current_deadline()
        bound = time.monotonic() + 300
        while not member.event.wait(0.25):
            if budget is not None:
                budget.check("executing")
            if time.monotonic() >= bound:
                from .admission import OverloadedError

                raise OverloadedError(
                    "cohort leader did not complete within 300s; retry",
                    reason="batch_timeout",
                    retry_after_s=1.0,
                )
        waited = max(0.0, (cohort.closed_at or time.perf_counter()) - t_join)
        self._m_wait.observe(waited)
        if len(cohort.members) > 1:
            record(batch_member=1, batch_cohort=len(cohort.members))
        if member.error is not None:
            # joiners (members and identical twins) never surface the
            # LEADER's personal ending (its kill, its deadline) — the
            # converter passes every other error through untouched
            raise _member_error(member.error)
        return member.result

    def snapshot(self) -> dict:
        with self._lock:
            forming = len(self._forming)
            gathering = sum(
                len(c.members) for c in self._forming.values()
            )
        return {
            "enabled": self.enabled,
            "window_s": self.window_s,
            "max_cohort": self.max_cohort,
            "shapes": list(self.shapes),
            "forming_cohorts": forming,
            "gathering_members": gathering,
        }
