"""Workload management: cost-based admission control, in-flight read
dedup, and per-tenant/per-table quotas — the serving-robustness layer
between the proxy and the executor (ref: the reference proxy's
Limiter/hotspot/read-dedup trio; StreamBox-HBM's capacity-aware
admission for why gating arrivals beats queueing them).

One ``WorkloadManager`` per proxy composes the three pieces
(``wlm.admission``, ``wlm.dedup``, ``wlm.quota``). Managers register in
a process-wide weak set so the SQL-queryable virtual table
``system.public.workload`` (table_engine/system.py) and the metrics lint
can observe live state without holding references.

Field-registry discipline (the contract): every
``horaedb_admission_*`` family is declared in
``ADMISSION_METRIC_FAMILIES`` below; the lint in
tests/test_observability.py checks each one is registered live, follows
the naming convention, surfaces as rows of ``system.public.workload``,
and is documented in docs/WORKLOAD.md.
"""

from __future__ import annotations

import weakref
from typing import Optional

from .admission import (  # noqa: F401  (re-exports: the subsystem surface)
    AdmissionController,
    COST_HISTORY,
    CLASSES,
    OverloadedError,
    classify_plan,
    current_admission,
    lane_for,
    normalize_shape,
)
from .batch import (  # noqa: F401  (re-exports: the subsystem surface)
    BATCH_METRIC_FAMILIES,
    COHORT_SIZE_BUCKETS,
    CohortBatcher,
    batch_plan_key,
)
from .dedup import ReadDeduper
from .quota import BlockedError, QuotaExceededError, QuotaManager  # noqa: F401

# family -> help; the single source of truth the lint walks.
ADMISSION_METRIC_FAMILIES: dict[str, str] = {
    "horaedb_admission_admitted_total":
        "queries admitted by the workload manager, by class",
    "horaedb_admission_shed_total":
        "queries shed by admission control, by class and reason",
    "horaedb_admission_wait_seconds":
        "time queries spent waiting for an admission slot",
    "horaedb_admission_dedup_total":
        "in-flight read dedup outcomes, by role",
    "horaedb_admission_quota_rejected_total":
        "requests rejected by tenant/table token buckets",
}

# Eager registration: the families exist from the first scrape (and for
# the registry lint / system.public.workload counter rows) even before
# any WorkloadManager is constructed — same discipline as the ledger's
# horaedb_query_* families (utils/querystats).
def _register_families() -> None:
    from ..utils.metrics import REGISTRY

    for c in CLASSES:
        REGISTRY.counter(
            "horaedb_admission_admitted_total",
            ADMISSION_METRIC_FAMILIES["horaedb_admission_admitted_total"],
            labels={"class": c},
        )
        REGISTRY.counter(
            "horaedb_admission_shed_total",
            ADMISSION_METRIC_FAMILIES["horaedb_admission_shed_total"],
            labels={"class": c, "reason": "queue_full"},
        )
    REGISTRY.histogram(
        "horaedb_admission_wait_seconds",
        ADMISSION_METRIC_FAMILIES["horaedb_admission_wait_seconds"],
    )
    for role in ("leader", "follower"):
        REGISTRY.counter(
            "horaedb_admission_dedup_total",
            ADMISSION_METRIC_FAMILIES["horaedb_admission_dedup_total"],
            labels={"role": role},
        )
    for kind in ("read_qps", "write_rows"):
        REGISTRY.counter(
            "horaedb_admission_quota_rejected_total",
            ADMISSION_METRIC_FAMILIES["horaedb_admission_quota_rejected_total"],
            labels={"kind": kind},
        )


_register_families()

_MANAGERS: "weakref.WeakSet[WorkloadManager]" = weakref.WeakSet()


def registered_managers() -> list["WorkloadManager"]:
    """Live managers, for the workload system table / debug surfaces."""
    return list(_MANAGERS)


class WorkloadManager:
    """Admission + dedup + quota behind one handle (one per proxy)."""

    def __init__(
        self,
        total_units: int = 8,
        memory_budget_bytes: int = 1 << 30,
        queue_depth: int = 32,
        deadline_s: float = 5.0,
        dedup_enabled: bool = True,
        persist_path: Optional[str] = None,
        batch_cfg=None,
    ) -> None:
        self.admission = AdmissionController(
            total_units=total_units,
            memory_budget_bytes=memory_budget_bytes,
            queue_depth=queue_depth,
            deadline_s=deadline_s,
        )
        self.dedup = ReadDeduper(enabled=dedup_enabled)
        self.quota = QuotaManager(persist_path=persist_path)
        # cohort batching (wlm/batch): disabled unless [wlm.batch] says
        # otherwise — with it off the read path is exactly the old one
        self.batch = CohortBatcher.from_config(batch_cfg, deduper=self.dedup)
        _MANAGERS.add(self)

    @staticmethod
    def from_limits(
        limits, persist_path: Optional[str] = None, batch_cfg=None
    ) -> "WorkloadManager":
        """Build from a config ``[limits]`` section (utils/config
        LimitsConfig) — or defaults when ``limits`` is None — plus the
        optional ``[wlm.batch]`` section for cohort batching."""
        g = lambda k, d: getattr(limits, k, d) if limits is not None else d  # noqa: E731
        return WorkloadManager(
            total_units=g("admission_slots", 8),
            memory_budget_bytes=g("admission_memory_budget", 1 << 30),
            queue_depth=g("admission_queue_depth", 32),
            deadline_s=g("admission_deadline_s", 5.0),
            dedup_enabled=g("dedup", True),
            persist_path=persist_path,
            batch_cfg=batch_cfg,
        )

    def close(self) -> None:
        _MANAGERS.discard(self)

    def snapshot(self) -> dict:
        """The /debug/workload payload."""
        return {
            "admission": self.admission.snapshot(),
            "dedup": self.dedup.snapshot(),
            "quota": self.quota.snapshot(),
            "batch": self.batch.snapshot(),
        }
