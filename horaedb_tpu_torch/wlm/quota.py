"""Per-tenant / per-table quotas — token buckets + the block-list
(ref: proxy/src/limiter.rs — the reference Limiter carries both block
and quota semantics; this subsumes the old bare block-list).

Two bucket kinds, each keyed by scope:

- ``read_qps``    — SELECT statements per second
- ``write_rows``  — written rows per second

Scopes are ``("tenant", name)`` and ``("table", name)``; a request is
charged against every bucket that applies (its table's and its
tenant's). Rates are runtime-adjustable through ``/admin/quota`` and a
rejection is a typed, retryable ``QuotaExceededError`` carrying the
time until the bucket refills (HTTP 429 + Retry-After, MySQL errno
1040, PG SQLSTATE 53300).

Operator-applied state (blocked tables + quota rules) persists through
the config layer: every mutation rewrites ``persist_path`` (JSON under
the node's data dir), and a restarted node reloads it — an
``/admin/block`` survives the process.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Iterable, Optional

from ..utils.metrics import REGISTRY

logger = logging.getLogger("horaedb_tpu_torch.wlm")

QUOTA_KINDS = ("read_qps", "write_rows")
SCOPE_KINDS = ("tenant", "table")


class BlockedError(RuntimeError):
    """Table is on the operator block-list (ref: limiter.rs). Not
    retryable — only an operator unblock clears it."""

    retryable = False


class QuotaExceededError(RuntimeError):
    """A token bucket ran dry. Retryable after ``retry_after_s``."""

    retryable = True

    def __init__(self, msg: str, scope: str, retry_after_s: float) -> None:
        super().__init__(msg)
        self.scope = scope
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Classic refill-on-demand bucket; rate 0 means 'always empty'."""

    def __init__(self, rate: float, burst: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        self.tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def reconfigure(self, rate: float, burst: Optional[float] = None) -> None:
        with self._lock:
            self.rate = float(rate)
            self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
            # an operator changing the rate grants a fresh allowance —
            # keeping a drained bucket would delay the new rate's effect
            self.tokens = self.burst
            self._last = time.monotonic()

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_consume(self, n: float = 1.0) -> float:
        """0.0 on success; else seconds until ``n`` tokens will exist
        (inf for a zero-rate bucket)."""
        with self._lock:
            self._refill_locked()
            if self.tokens >= n:
                self.tokens -= n
                return 0.0
            if self.rate <= 0:
                return float("inf")
            return (n - self.tokens) / self.rate

    def peek(self, n: float = 1.0) -> float:
        """Like ``try_consume`` but without debiting."""
        with self._lock:
            self._refill_locked()
            if self.tokens >= n:
                return 0.0
            if self.rate <= 0:
                return float("inf")
            return (n - self.tokens) / self.rate

    def refund(self, n: float) -> None:
        with self._lock:
            self.tokens = min(self.burst, self.tokens + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "tokens": round(self.tokens, 3)}


class QuotaManager:
    """Block-list + token buckets, persisted as one JSON document."""

    def __init__(self, persist_path: Optional[str] = None) -> None:
        self._blocked: set[str] = set()
        # (scope_kind, name, quota_kind) -> bucket
        self._buckets: dict[tuple[str, str, str], TokenBucket] = {}
        self._lock = threading.Lock()
        self.persist_path = persist_path
        self._m_rejected = {
            kind: REGISTRY.counter(
                "horaedb_admission_quota_rejected_total",
                "requests rejected by tenant/table token buckets",
                labels={"kind": kind},
            )
            for kind in QUOTA_KINDS
        }
        self._load()

    # ---- block-list (the old Limiter surface, unchanged) ----------------
    def block(self, tables: Iterable[str]) -> None:
        with self._lock:
            self._blocked.update(tables)
        self._save()

    def unblock(self, tables: Iterable[str]) -> None:
        with self._lock:
            self._blocked.difference_update(tables)
        self._save()

    def blocked(self) -> list[str]:
        with self._lock:
            return sorted(self._blocked)

    def check(self, table: Optional[str]) -> None:
        if table is None:
            return
        with self._lock:
            if table in self._blocked:
                raise BlockedError(f"table blocked by limiter: {table}")

    # ---- quotas ----------------------------------------------------------
    def set_quota(
        self,
        scope: str,
        name: str,
        kind: str,
        rate: float,
        burst: Optional[float] = None,
    ) -> None:
        if scope not in SCOPE_KINDS:
            raise ValueError(f"scope must be one of {SCOPE_KINDS}, got {scope!r}")
        if kind not in QUOTA_KINDS:
            raise ValueError(f"kind must be one of {QUOTA_KINDS}, got {kind!r}")
        key = (scope, name, kind)
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                self._buckets[key] = TokenBucket(rate, burst)
            else:
                b.reconfigure(rate, burst)
        self._save()

    def remove_quota(self, scope: str, name: str, kind: str) -> bool:
        with self._lock:
            removed = self._buckets.pop((scope, name, kind), None) is not None
        self._save()
        return removed

    def _consume_all(self, kind: str, charges: list) -> None:
        """Atomically-ish debit ``[(scope, name, bucket, n), ...]``: peek
        every applicable bucket before debiting ANY of them — a request
        rejected by one bucket must not drain the others (rejections
        would otherwise consume quota), and retries of a rejected batch
        must find their allowance intact."""

        def reject(scope: str, name: str, wait: float) -> QuotaExceededError:
            self._m_rejected[kind].inc()
            from ..utils.events import record_event

            record_event(
                "quota_reject",
                table=name if scope == "table" else "",
                scope=scope, name=name, quota_kind=kind,
            )
            return QuotaExceededError(
                f"{kind} quota exceeded for {scope} {name!r}; "
                f"retry in {min(wait, 60.0):.2f}s",
                scope=f"{scope}:{name}",
                retry_after_s=min(wait, 60.0) if wait != float("inf") else 1.0,
            )

        for scope, name, bucket, n in charges:
            wait = bucket.peek(n)
            if wait > 0:
                raise reject(scope, name, wait)
        taken: list = []
        for scope, name, bucket, n in charges:
            wait = bucket.try_consume(n)
            if wait > 0:
                # raced another charger between peek and consume: refund
                # what this request already took and reject
                for b, m in taken:
                    b.refund(m)
                raise reject(scope, name, wait)
            taken.append((bucket, n))

    def _charge(self, kind: str, tenant: str, table: Optional[str], n: float) -> None:
        charges = []
        with self._lock:
            for scope, name in (("tenant", tenant), ("table", table)):
                if name is None:
                    continue
                b = self._buckets.get((scope, name, kind))
                if b is not None:
                    charges.append((scope, name, b, n))
        self._consume_all(kind, charges)

    def charge_read(self, tenant: str, table: Optional[str]) -> None:
        self._charge("read_qps", tenant, table, 1.0)

    def charge_write(self, tenant: str, table: Optional[str], rows: int) -> None:
        self._charge("write_rows", tenant, table, float(rows))

    def charge_write_batch(self, tenant: str, counts: dict) -> None:
        """Charge a multi-table ingest batch (Influx line protocol,
        OpenTSDB put) as ONE all-or-nothing debit: the tenant bucket is
        peeked for the batch total and every table bucket for its share
        before anything is consumed — a rejected batch leaves every
        bucket untouched."""
        charges = []
        with self._lock:
            b = self._buckets.get(("tenant", tenant, "write_rows"))
            if b is not None:
                charges.append(
                    ("tenant", tenant, b, float(sum(counts.values())))
                )
            for table, n in counts.items():
                b = self._buckets.get(("table", table, "write_rows"))
                if b is not None:
                    charges.append(("table", table, b, float(n)))
        self._consume_all("write_rows", charges)

    # ---- persistence -----------------------------------------------------
    def _load(self) -> None:
        if not self.persist_path or not os.path.exists(self.persist_path):
            return
        try:
            with open(self.persist_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            self._blocked = set(doc.get("blocked", []))
            for q in doc.get("quotas", []):
                key = (q["scope"], q["name"], q["kind"])
                self._buckets[key] = TokenBucket(q["rate"], q.get("burst"))
        except (OSError, ValueError, KeyError, TypeError) as e:
            # TypeError included: a hand-edited state file with e.g. a
            # null rate must degrade to a warning, not block node startup
            logger.warning("could not load wlm state %s: %s", self.persist_path, e)

    def _save(self) -> None:
        if not self.persist_path:
            return
        with self._lock:
            doc = {
                "blocked": sorted(self._blocked),
                "quotas": [
                    {"scope": s, "name": n, "kind": k,
                     "rate": b.rate, "burst": b.burst}
                    for (s, n, k), b in sorted(self._buckets.items())
                ],
            }
        tmp = self.persist_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self.persist_path)
        except OSError as e:
            logger.warning("could not persist wlm state %s: %s", self.persist_path, e)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "blocked": sorted(self._blocked),
                "quotas": [
                    {"scope": s, "name": n, "kind": k, **b.snapshot()}
                    for (s, n, k), b in sorted(self._buckets.items())
                ],
                "persist_path": self.persist_path,
            }
