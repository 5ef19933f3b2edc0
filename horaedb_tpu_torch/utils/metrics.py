"""Minimal Prometheus-style metrics registry
(ref: lazy-static prometheus registries in nearly every reference crate,
exposed at /metrics — server/src/http.rs:532).

Counters, gauges and histograms (what the serving path needs); text
exposition format compatible with Prometheus scraping. Counters and
gauges take optional labels — one HELP/TYPE header per family, one
sample line per label set (how prometheus-client renders families).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Optional, Sequence


def _escape_label_value(v: str) -> str:
    # Prometheus text format: backslash, double-quote and newline must be
    # escaped or one bad label value fails the ENTIRE scrape.
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    TYPE = "counter"

    def __init__(self, name: str, help_: str, labels: dict[str, str] | None = None) -> None:
        self.name = name
        self.help = help_
        self.labels = dict(labels) if labels else {}
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def snapshot(self) -> float:
        """The value, read under the lock — the one way scrapes and the
        self-monitoring recorder read a counter/gauge, so a read racing
        ``inc()`` can never observe a torn update."""
        with self._lock:
            return self._value

    @property
    def value(self) -> float:
        return self.snapshot()

    def expose_parts(self) -> tuple[str, str]:
        header = (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} {self.TYPE}\n"
        )
        body = f"{self.name}{_render_labels(self.labels)} {self.snapshot()}\n"
        return header, body

    def expose(self) -> str:
        header, body = self.expose_parts()
        return header + body


class Gauge(Counter):
    """A value that can go down (queue depths, in-flight work)."""

    TYPE = "gauge"

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


class Histogram:
    def __init__(self, name: str, help_: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 labels: dict[str, str] | None = None):
        self.name = name
        self.help = help_
        self.labels = dict(labels) if labels else {}
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._counts[bisect_right(self.buckets, v)] += 1
            self._sum += v
            self._total += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """``(bucket_counts, sum, count)`` under the lock — a consistent
        view (buckets sum to count) for scrapes, the system tables, and
        the self-monitoring recorder."""
        with self._lock:
            return list(self._counts), self._sum, self._total

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def expose_parts(self) -> tuple[str, str]:
        # consistent snapshot: buckets must sum to count
        counts, sum_, total = self.snapshot()
        header = (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} histogram\n"
        )
        # Per-labelset samples: the labels merge INTO the bucket braces
        # alongside ``le`` (one family header, many labelsets — same
        # rendering rule the Counter/Gauge families follow).
        base = sorted(self.labels.items())
        suffix = _render_labels(self.labels)
        out = []
        acc = 0
        for le, c in zip(self.buckets, counts):
            acc += c
            inner = ",".join(
                f'{k}="{_escape_label_value(v)}"'
                for k, v in (*base, ("le", str(le)))
            )
            out.append(f"{self.name}_bucket{{{inner}}} {acc}")
        inner = ",".join(
            f'{k}="{_escape_label_value(v)}"'
            for k, v in (*base, ("le", "+Inf"))
        )
        out.append(f"{self.name}_bucket{{{inner}}} {total}")
        out.append(f"{self.name}_sum{suffix} {sum_}")
        out.append(f"{self.name}_count{suffix} {total}")
        return header, "\n".join(out) + "\n"

    def expose(self) -> str:
        header, body = self.expose_parts()
        return header + body


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, key: str, factory, cls):
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            elif type(m) is not cls:
                # A name registered as one kind silently returned as
                # another would blow up far from the registration site
                # (.set on a Counter, .observe on a Gauge) — fail HERE.
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, help_: str = "",
                labels: dict[str, str] | None = None) -> Counter:
        key = name + _render_labels(labels)
        return self._get(key, lambda: Counter(name, help_, labels), Counter)

    def gauge(self, name: str, help_: str = "",
              labels: dict[str, str] | None = None) -> Gauge:
        key = name + _render_labels(labels)
        return self._get(key, lambda: Gauge(name, help_, labels), Gauge)

    def histogram(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS,
                  labels: dict[str, str] | None = None) -> Histogram:
        key = name + _render_labels(labels)
        return self._get(key, lambda: Histogram(name, help_, buckets, labels), Histogram)

    def remove(self, name: str, labels: dict[str, str] | None = None) -> None:
        """Unregister one labelset (per-entity series — e.g. a dropped
        table's memtable gauge — must not pin the registry forever)."""
        with self._lock:
            self._metrics.pop(name + _render_labels(labels), None)

    def families(self) -> dict[str, list]:
        """Live family name -> member metrics (the metrics-name lint and
        other introspection walk this instead of parsing exposition)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict[str, list] = {}
        for m in metrics:
            out.setdefault(m.name, []).append(m)
        return out

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        # Group samples by family: labeled children may have registered
        # interleaved with other metrics, but the exposition format wants
        # one HELP/TYPE header followed by ALL of that family's samples.
        order: list[str] = []
        families: dict[str, list] = {}
        for m in metrics:
            if m.name not in families:
                families[m.name] = []
                order.append(m.name)
            families[m.name].append(m)
        out: list[str] = []
        for name in order:
            members = families[name]
            out.append(members[0].expose_parts()[0])
            out.extend(m.expose_parts()[1] for m in members)
        return "".join(out)


REGISTRY = Registry()
