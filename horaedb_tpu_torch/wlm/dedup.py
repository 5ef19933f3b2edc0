"""In-flight read dedup — single-flight for identical SELECTs
(ref: proxy/src/read.rs:89,167 + components/notifier RequestNotifiers:
concurrent identical reads coalesce onto one leader execution; followers
await the leader's ``Output`` instead of re-running the scan).

This is the THREAD-level flight table used by the proxy: the HTTP
gateway keeps its own asyncio single-flight in front (one event loop),
but the proxy is also driven from wire-protocol executors, embedded
callers, and multiple gateways — this layer coalesces across all of
them. Both layers feed the same ``horaedb_admission_dedup_total``
family and the workload table.

Read-your-writes survives the dedup: the flight key carries a write
epoch the proxy bumps on every statement that can change visible state,
so a SELECT issued after a write never joins a pre-write execution.

Ledger roles: the leader's ledger records ``dedup_followers`` (how many
twins it served); each follower's records ``dedup_follower=1`` — the
roles are queryable per request in ``system.public.query_stats``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, TypeVar

from ..utils.metrics import REGISTRY
from ..utils.querystats import record

T = TypeVar("T")


class _Flight:
    __slots__ = ("event", "result", "error", "followers")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.followers = 0


class ReadDeduper:
    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._inflight: dict[tuple, _Flight] = {}
        self._epoch = 0
        self._m_role = {
            role: REGISTRY.counter(
                "horaedb_admission_dedup_total",
                "in-flight read dedup outcomes, by role",
                labels={"role": role},
            )
            for role in ("leader", "follower")
        }

    def bump_epoch(self) -> None:
        """Any statement that may change visible state calls this; later
        reads start a fresh flight (conservative: bumped even when the
        statement ultimately fails)."""
        with self._lock:
            self._epoch += 1

    def epoch(self) -> int:
        """The current write epoch. Shared fencing truth for every
        coalescing layer: the cohort batcher (wlm/batch) keys forming
        cohorts by this value, so a write landing while a cohort gathers
        fences later-arriving members into a fresh cohort — the same
        read-your-writes contract the flight table gets from carrying
        the epoch in its key."""
        with self._lock:
            return self._epoch

    def run(self, sql_key: str, fn: Callable[[], T]) -> T:
        """Execute ``fn`` single-flight per (epoch, sql_key). The leader
        runs it; concurrent twins block on the leader's result (or
        re-raise its exception)."""
        if not self.enabled:
            return fn()
        with self._lock:
            key = (self._epoch, sql_key)
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Flight()
                self._inflight[key] = flight
                leader = True
            else:
                flight.followers += 1
                leader = False
        if not leader:
            self._m_role["follower"].inc()
            record(dedup_follower=1)
            # the leader always resolves the flight in its finally; the
            # long timeout is a defensive bound, not a protocol step —
            # but if it ever fires, answer with a typed retryable error
            # instead of handing back a None "result". Sliced waits:
            # the follower observes ITS OWN deadline/cancel flag
            # (utils/deadline) while the leader runs — a tight-budget
            # follower unwinds with its typed error instead of riding
            # a slower leader past its deadline.
            import time as _time

            from ..utils.deadline import current_deadline

            budget = current_deadline()
            bound = _time.monotonic() + 300
            while not flight.event.wait(0.25):
                if budget is not None:
                    budget.check("executing")
                if _time.monotonic() >= bound:
                    from .admission import OverloadedError

                    raise OverloadedError(
                        "in-flight twin did not complete within 300s; retry",
                        reason="dedup_timeout",
                        retry_after_s=1.0,
                    )
            if flight.error is not None:
                raise self._follower_error(flight.error)
            return flight.result
        followers = 0
        try:
            flight.result = fn()
            return flight.result
        except BaseException as e:
            flight.error = e
            raise
        finally:
            with self._lock:
                # only new arrivals AFTER this pop start a fresh flight
                if self._inflight.get(key) is flight:
                    del self._inflight[key]
                followers = flight.followers
            flight.event.set()
            if followers:
                self._m_role["leader"].inc()
                record(dedup_followers=followers)

    @staticmethod
    def _follower_error(err: BaseException) -> BaseException:
        """The error a follower should surface for a leader-side
        failure. A leader that was CANCELLED (KILL/disconnect) or died
        to ITS deadline must not leak that personal ending to followers
        who never cancelled and carry their own budgets — they get a
        typed, retryable overload instead (a retry starts a fresh
        flight)."""
        from ..utils.deadline import DeadlineExceeded, QueryCancelled

        if isinstance(err, QueryCancelled):
            from .admission import OverloadedError

            return OverloadedError(
                "the in-flight leader serving this read was cancelled; "
                "retry starts a fresh execution",
                reason="dedup_leader_cancelled",
                retry_after_s=0.1,
            )
        if isinstance(err, DeadlineExceeded):
            from .admission import OverloadedError

            return OverloadedError(
                "the in-flight leader serving this read exceeded ITS "
                "time budget; retry starts a fresh execution",
                reason="dedup_leader_timeout",
                retry_after_s=0.1,
            )
        return err

    def note_coalesced(self, n: int = 1) -> None:
        """An upstream single-flight layer (the gateway's asyncio dedup)
        served ``n`` follower(s) — count them in the same family so the
        workload table reflects every coalesced read."""
        self._m_role["follower"].inc(n)

    def snapshot(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
            waiting = sum(f.followers for f in self._inflight.values())
            epoch = self._epoch
        return {
            "inflight_leaders": inflight,
            "waiting_followers": waiting,
            "write_epoch": epoch,
            "enabled": self.enabled,
        }
