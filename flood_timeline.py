"""Where a member's time goes in the dashboard flood, on the card.

Builds the TSBS cpu table (4000 hosts, seed 123) on one connection and
leaves one tick of 4000 rows past its end unflushed, as chip_smoke's
phase 15 leaves it for phase 18 (every flood query then folds that
delta, outside its time range, on the host), then drives chip_smoke's
flood (32 threads on one shared query counter, the
reference flood's closed loop) through ``Proxy.handle_sql``: the fused
arm ([wlm.batch] on, chip_smoke's window, cohorts up to 32), the solo arm, the
fused arm again. Each arm records, per query, when it entered
``handle_sql``, joined the batcher, came back and left, and how long the
executor's prepare, dispatch and assembly took, under the GIL contention
of the flood. Then the same steps run one at a time, with cProfile.

    python3 flood_timeline.py                      # the card, 24 h at 10 s
    python3 flood_timeline.py --device cpu --interval-ms 10800000

Prints one JSON object; the event timelines go to
chiprun_out/flood_timeline_<arm>.txt. Every answer is checked against
numpy as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import os
import pstats
import threading
import time

import numpy as np
import torch

import chip_smoke as C


class Timeline:
    """Per-thread events: (seconds since start, thread, event)."""

    def __init__(self) -> None:
        self.events: list = []
        self.t0 = time.perf_counter()

    def reset(self) -> None:
        self.events.clear()
        self.t0 = time.perf_counter()

    def add(self, kind: str) -> None:
        self.events.append((time.perf_counter() - self.t0, threading.get_ident(), kind))

    def stats(self) -> dict:
        spans = collections.defaultdict(list)
        last = {}
        for t, th, kind in self.events:
            if kind.endswith(">") or kind in ("in", "join", "ret"):
                last[(th, kind.rstrip(">"))] = t
            if kind == "join":
                spans["in->join"].append(t - last[(th, "in")])
            if kind == "out":
                if (th, "ret") in last:
                    spans["ret->out"].append(t - last.pop((th, "ret")))
                spans["in->out"].append(t - last[(th, "in")])
            if kind.endswith("<"):
                spans[kind[:-1]].append(t - last[(th, kind[:-1])])
        return {k: {"n": len(v), "median_ms": float(np.median(v) * 1e3),
                    "mean_ms": float(np.mean(v) * 1e3)} for k, v in spans.items()}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for t, th, kind in self.events:
                f.write(f"{t * 1e3:9.3f} {th % 100000:6d} {kind}\n")


def instrument(tl: Timeline) -> None:
    """Wrap the batcher's entry and the executor's cohort steps."""
    from horaedb_tpu_torch.query import executor as X
    from horaedb_tpu_torch.wlm import batch as WB

    run = WB.CohortBatcher.run

    def joined(self, *a, **k):
        tl.add("join")
        try:
            return run(self, *a, **k)
        finally:
            tl.add("ret")

    WB.CohortBatcher.run = joined
    for name in ("prepare_cached_agg", "dispatch_cached_agg_cohort", "_fold_and_assemble",
                 "dispatch_cached_agg", "execute_cohort"):
        def wrap(fn, name=name):
            def step(self, *a, **k):
                tl.add(name + ">")
                try:
                    return fn(self, *a, **k)
                finally:
                    tl.add(name + "<")
            return step
        setattr(X.Executor, name, wrap(getattr(X.Executor, name)))


def profiled(fn, top=30) -> str:
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    return out.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--interval-ms", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=C.FLOOD_MEASURED)
    args = ap.parse_args()
    C.DEV = args.device
    if args.device == "cuda":
        C.phase_build()

    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_agg as S
    from horaedb_tpu_torch.proxy import Proxy
    from horaedb_tpu_torch.query import executor as X
    from horaedb_tpu_torch.tools import tsbs
    from horaedb_tpu_torch.utils.config import BatchSection

    tsbs.INTERVAL_MS = args.interval_ms
    out = {"device": args.device, "interval_ms": args.interval_ms}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    db = horaedb_tpu_torch.connect(None, device=args.device)
    db.execute(C._cpu_table_sql(tsbs))
    rows = tsbs.generate_cpu(C.HOSTS, C.HOURS * 3_600_000, seed=C.SEED)
    table = db.catalog.open("cpu")
    table.write(rows)
    table.flush()
    expected = C._flood_expected(tsbs, rows)
    out["rows"] = len(rows)
    del rows
    texts = C.flood_queries()
    for sql in texts[:3]:  # first sighting, cache build, a hit
        db.execute(sql)
    table.write(tsbs.generate_cpu(C.HOSTS, tsbs.INTERVAL_MS, t0=C.HOURS * 3_600_000,
                                  seed=C.SEED + 1))
    out["setup_seconds"] = time.perf_counter() - t0

    tl = Timeline()
    instrument(tl)
    os.makedirs(C.OUT_DIR, exist_ok=True)
    for i, arm in enumerate(("fused", "solo", "fused")):
        cfg = (BatchSection(enabled=True, window_s=C.FLOOD_WINDOW_S, max_cohort=32)
               if arm == "fused" else None)
        proxy = Proxy(db, batch_cfg=cfg)
        handle = proxy.handle_sql

        def timed(sql, handle=handle):
            tl.add("in")
            try:
                return handle(sql)
            finally:
                tl.add("out")

        proxy.handle_sql = timed
        C._flood_arm(torch, proxy, texts, C.FLOOD_WARMUP)
        C._sync(torch)
        tl.reset()
        S.reset_counts()
        X.reset_counts()
        res = C._flood_arm(torch, proxy, texts, args.queries)
        for q, r in enumerate(res["results"]):
            C._check_flood(r, expected[q % 32], f"{arm} query {q}")
        sizes = [r.metrics.get("batch_cohort", 0) for r in res["results"]]
        lat = sorted(res["lat"])
        out[f"{arm}_{i}"] = {
            "qps": args.queries / res["wall"],
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "cohort_sizes": dict(sorted(collections.Counter(sizes).items())),
            "launches": {f: dict(a) for f, a in S.LAUNCHES.items()},
            "fallbacks": X.COHORT_FALLBACKS,
            "steps": tl.stats(),
        }
        tl.dump(os.path.join(C.OUT_DIR, f"flood_timeline_{arm}_{i}.txt"))
        proxy.close()
        print(arm, json.dumps(out[f"{arm}_{i}"]), flush=True)

    # the same steps one at a time
    tl.reset()
    proxy = Proxy(db)
    for sql in texts:
        proxy.handle_sql(sql)
    t = time.perf_counter()
    for sql in texts:
        proxy.handle_sql(sql)
    out["serial_solo_ms_per_query"] = (time.perf_counter() - t) / len(texts) * 1e3
    out["serial_solo_profile"] = profiled(lambda: [proxy.handle_sql(q) for q in texts])
    proxy.close()
    ex = db.interpreters.executor
    plans = [db._cached_plan(q) for q in texts]

    def prepare():
        return [ex.prepare_cached_agg(p, table, {"table": "cpu"}, allow_selective=False)
                for p in plans]

    preps = prepare()
    t = time.perf_counter()
    preps = prepare()
    out["serial_prepare_ms_per_member"] = (time.perf_counter() - t) / len(plans) * 1e3
    ex.dispatch_cached_agg_cohort(preps)
    t = time.perf_counter()
    ex.dispatch_cached_agg_cohort(preps)
    out["serial_cohort_of_32_ms"] = (time.perf_counter() - t) * 1e3
    out["serial_cohort_profile"] = profiled(
        lambda: ex.dispatch_cached_agg_cohort(prepare()))
    db.close()
    with open(os.path.join(C.OUT_DIR, "flood_timeline.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if not k.endswith("profile")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
