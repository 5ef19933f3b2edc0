#!/usr/bin/env python3
"""Time two checkouts' raw reads (the B4 top-k and the selection, on one
device and on a 4-shard logical mesh) and live window (the B6a fold and
the B6b gather) in turns on one NVIDIA card: this checkout and another one
(its parent commit, unpacked with ``git archive``), in the order other,
this, this, other, each turn a process of its own that imports that
checkout's ``horaedb_tpu_torch`` (ab_turns.py).

    mkdir -p chip_proof/parent
    git archive HEAD~1 horaedb_tpu_torch | tar -x -C chip_proof/parent
    python3 topk_fold_ab.py --other chip_proof/parent [--runs 12] [--commits 120] \
        [--arms fold,gather,raw,mesh,cohort]

Each turn runs the arms named in ``--arms``:

- fold: the cpu-live scenario of chip_smoke.py's phase 11 (one hour of
  history, the five per-field panels promoted, ``--commits`` live commits
  of 4000 rows): each commit's wall time, the write hook's host time
  split into the states' preparation and the launch path, the fold
  launches a commit; then the last head-advance commit's folds replayed
  on copies of the rings, device time with L2 flushed.
- gather: after the same commits, a refresh of the first panel over the
  last hour (phase 11's refresh: 60 slots x 4000 groups), its gather
  replayed: the kernel against its plain version (bit-equal, and the same
  words in every turn), device time on the profiler's timeline with L2
  flushed, split by kernel, and by CUDA events.
- raw: the TSBS cpu table (4000 hosts x 24 h at 10 s, seed 123) written
  through the engine; chip_smoke.py's five raw queries through
  ``Connection.execute``, ``--runs`` times each after the cache miss and
  the build, each run a new instance of the query as TSBS issues them: a
  host and a 12 h range drawn per run (the same draws in every turn;
  coolest-asc has neither). Every run must take the device raw route;
  a digest of each run's rows must be the same in every turn. Then each
  top-k query's last call is replayed: the kernel against its plain
  version (bit-equal), its device time on the profiler's timeline with L2
  flushed before each call, split by kernel, and, where the checkout's
  wrapper counts them, the rows its keys kernel decoded.
- mesh: the same cpu table rebuilt over 4 logical shards of the card
  (phase 22's mesh); lastpoint-host and high-cpu-1, ``--runs`` instances
  each as above, each run's shard launches counted (a run whose allow
  list or range passes nothing launches none); the shard launches of the
  last run that launched any replayed against their plain versions and
  timed on the device timeline (L2 flushed, split by kernel) and by CUDA
  events around the shards' wrappers.
- cohort: the cohort top-k (B4c) as chip_smoke.py's phase 18 calls it: 32
  lastpoint-host members (hosts 0-31) on the cpu table's resident columns,
  k 16; over every row, and, where the checkout's ``raw_topk_cohort``
  takes windows, over each member's windows as the executor computes them.
  Each call against its plain version (bit-equal; a digest of the slots the
  same in every turn), its device time on the profiler's timeline with L2
  flushed, split by kernel, and by CUDA events with the wrapper.

Prints every time with the card's name and power limit; writes
chiprun_out/topk_fold_ab.json. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import statistics
import sys
import time

from ab_turns import emit, enter, run_turns, say, write_report

TOPK_QUERIES = ("lastpoint-host", "hottest-12h", "coolest-asc")
# every kernel either checkout's top-k and selection launch, by base name
RAW_NAMES = ("raw_init", "raw_keys", "topk_hist", "topk_pick", "raw_flags", "raw_scan",
             "raw_write", "raw_fill", "topk_keys", "topk_refine", "topk_write", "raw_select",
             "Memset", "HtoD")
FOLD_NAMES = ("ring_reset", "ring_scatter", "ring_fold", "HtoD")
# either checkout's gather kernel
GATHER_NAMES = ("ring_gather", "ring_gather_rows")
# every kernel either checkout's cohort top-k launches
COHORT_NAMES = ("cohort_init", "cohort_keys", "cohort_hist", "cohort_pick", "cohort_flags",
                "cohort_scan", "cohort_write", "cohort_fill", "cohort_topk_keys",
                "cohort_topk_refine", "cohort_topk_write", "Memset", "HtoD")
ARMS = ("fold", "gather", "raw", "mesh", "cohort")
MESH_QUERIES = ("lastpoint-host", "high-cpu-1")


def query_runs(C, n_runs: int) -> dict:
    """name -> (kernel, [SQL of each run]): chip_smoke.py's raw queries,
    each run with its own host and 12 h range where the query has them."""
    import numpy as np

    rng = np.random.default_rng(C.SEED + 11)
    day = C.HOURS * 3_600_000

    def host() -> int:
        return int(rng.integers(0, C.HOSTS))

    def since() -> int:
        return int(rng.integers(0, day - C.H12))

    hosts16 = ", ".join(f"'host_{i}'" for i in range(16))
    coolest = next(q[1] for q in C.raw_queries(C.HC_FROM) if q[0] == "coolest-asc")
    return {
        "lastpoint-host": ("topk", [
            f"SELECT * FROM cpu WHERE hostname = 'host_{host()}' ORDER BY ts DESC LIMIT 10"
            for _ in range(n_runs)]),
        "hottest-12h": ("topk", [
            f"SELECT hostname, ts, usage_user FROM cpu WHERE ts >= {s} AND ts < {s + C.H12} "
            "ORDER BY usage_user DESC LIMIT 100" for s in (since() for _ in range(n_runs))]),
        "coolest-asc": ("topk", [coolest] * n_runs),
        "high-cpu-1": ("select", [
            f"SELECT * FROM cpu WHERE hostname = 'host_{h}' AND usage_user > 90 "
            f"AND ts >= {s} AND ts < {s + C.H12}"
            for h, s in ((host(), since()) for _ in range(n_runs))]),
        "high-cpu-16": ("select", [
            f"SELECT * FROM cpu WHERE hostname IN ({hosts16}) AND usage_user > 50 "
            f"AND ts >= {s} AND ts < {s + C.H12}" for s in (since() for _ in range(n_runs))]),
    }


def cpu_table(C):
    """A CUDA connection holding the TSBS cpu table, its host-copy budget
    raised for raw reads of 34.56M rows."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.tools import tsbs

    db = horaedb_tpu_torch.connect(None, device="cuda")
    db.execute(C._cpu_table_sql(tsbs))
    t0 = time.perf_counter()
    rows = tsbs.generate_cpu(C.HOSTS, C.HOURS * 3_600_000, seed=C.SEED)
    table = db.catalog.open("cpu")
    table.write(rows)
    table.flush()
    del rows
    say(f"cpu table: {C.HOSTS} hosts x {C.HOURS} h in {time.perf_counter() - t0:.1f} s")
    db.interpreters.executor.scan_cache.max_host_rows_bytes = 64 << 30
    return db


def last_split(C) -> dict | None:
    """The ms a call of each kernel in the last window
    ``C._family_device_ms`` timed with a label."""
    return (C.DETAIL.get("device_ms_windows") or [{}])[-1].get("ms_a_call")


def digest(res) -> str:
    return hashlib.sha1(repr(res.to_pylist()).encode()).hexdigest()


def arm_raw(torch, C, card, db, n_runs: int) -> dict:
    from horaedb_tpu_torch.ops import scan_topk as T

    calls, orig = {}, T.raw_topk_packed
    current = [""]

    def rec(*a, **k):
        calls[current[0]] = (a, k)
        return orig(*a, **k)

    T.raw_topk_packed = rec
    out = {}
    try:
        for name, (kernel, sqls) in query_runs(C, n_runs).items():
            current[0] = name
            for _ in range(3):  # the first read misses the cache, the next builds it
                if db.execute(sqls[0]).metrics.get("path") == "raw_device":
                    break
            runs, digests = [], []
            for sql in sqls:
                t = time.perf_counter()
                res = db.execute(sql)
                runs.append((time.perf_counter() - t) * 1e3)
                m = res.metrics
                if m.get("path") != "raw_device" or m.get("raw_kernel") != kernel:
                    raise AssertionError(f"{name}: path {m.get('path')} {m.get('raw_host')}")
                digests.append(digest(res))
            out[name] = {"runs_ms": runs, "warm_ms": statistics.median(runs),
                         "digests": digests}
            say(f"raw {name}: warm execute median {out[name]['warm_ms']:.3f} ms over "
                f"{len(runs)} runs, each its own instance (min {min(runs):.3f}, max "
                f"{max(runs):.3f}) [{card}]")
    finally:
        T.raw_topk_packed = orig
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    counts = getattr(T, "TOPK_STATS", None)  # the keys kernel's counts, where it has them
    for name in TOPK_QUERIES:
        args, kw = calls[name]
        want = T.raw_topk_plain(*args, **kw)
        fn = lambda a=args, k=kw: T.raw_topk_packed(*a, **k)  # noqa: E731
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name}: the kernel differs from the plain version")
        visited = None
        if counts is not None:
            stats = torch.zeros(len(counts), dtype=torch.int64, device="cuda")
            T.raw_topk_packed(*args, **kw, stats=stats)
            visited = stats.tolist()[0]
        ms = C._family_device_ms(torch, fn, RAW_NAMES, reps=10, flush=flush,
                                 label=f"top-k at {name}")
        out[name].update(ms=ms, k=kw["k"], visited=visited)
        say(f"raw {name} (k {kw['k']}): kernel {ms:.4f} ms on the device timeline, L2 "
            f"flushed; rows the keys kernel decoded {visited} [{card}]")
    return out


def arm_mesh(torch, C, card, db, n_runs: int) -> dict:
    """lastpoint-host and high-cpu-1 on the cpu table sharded over
    ``C.MESH_SHARDS`` logical shards of the card."""
    from horaedb_tpu_torch.ops import scan_topk as T
    from horaedb_tpu_torch.parallel.mesh import Mesh, on_device, use_mesh

    cache = db.interpreters.executor.scan_cache
    cache.invalidate("cpu")
    cache._candidate.pop("cpu", None)
    mesh = Mesh.logical(torch.device("cuda", 0), C.MESH_SHARDS)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    runs_of = query_runs(C, n_runs)
    kept = {"raw_topk": [], "raw_select": []}  # each shard call of the current run
    orig = {kind: getattr(T, f"{kind}_packed") for kind in kept}

    def recorder(kind):
        def call(*a, **k):
            kept[kind].append((a, k))
            return orig[kind](*a, **k)
        return call

    out = {}
    try:
        for kind in kept:
            setattr(T, f"{kind}_packed", recorder(kind))
        with use_mesh(mesh):
            for name in MESH_QUERIES:
                kernel, sqls = runs_of[name]
                kind = f"raw_{kernel}"
                for _ in range(3):  # a miss, then the sharded build
                    m = db.execute(sqls[0]).metrics
                    if m.get("path") == "raw_device" and m.get("mesh_devices") == mesh.size:
                        break
                runs, digests, launches, calls = [], [], [], []
                for sql in sqls:
                    kept[kind].clear()
                    before = T.LAUNCHES[kind]
                    t = time.perf_counter()
                    res = db.execute(sql)
                    runs.append((time.perf_counter() - t) * 1e3)
                    launches.append(T.LAUNCHES[kind] - before)
                    m = res.metrics
                    # a run whose allow list or range passes nothing launches
                    # nothing and reports no mesh
                    if (m.get("path") != "raw_device" or m.get("raw_kernel") != kernel
                            or m.get("mesh_devices", None if launches[-1] == 0 else 0)
                            not in (mesh.size, None)):
                        raise AssertionError(f"mesh {name}: {m}, {launches[-1]} launches")
                    digests.append(digest(res))
                    calls = list(kept[kind]) or calls  # the last run that launched

                def shards(fn, calls=calls):
                    res = []
                    for a, k in calls:
                        with on_device(a[3].device):
                            res.append(fn(*a, **k))
                    return res

                plain = getattr(T, f"{kind}_plain")
                for got, want in zip(shards(orig[kind]), shards(plain)):
                    if not torch.equal(got, want):
                        raise AssertionError(f"mesh {name}: a shard's kernel differs from plain")
                fn = lambda s=shards, f=orig[kind]: s(f)  # noqa: E731
                dev_ms = C._family_device_ms(torch, fn, RAW_NAMES, reps=10, flush=flush,
                                             label=f"mesh {name}")
                split = last_split(C) if dev_ms else None
                events_ms = C._time_launch(torch, fn, flush=flush)
                out[name] = {"runs_ms": runs, "warm_ms": statistics.median(runs),
                             "digests": digests, "launches": launches,
                             "shards_launched": len(calls), "device_ms": dev_ms,
                             "split": split, "events_ms": events_ms}
                say(f"mesh {name}: warm execute median {out[name]['warm_ms']:.3f} ms over "
                    f"{len(runs)} runs; shard launches a run {launches}; the last launching "
                    f"run's {len(calls)} shard launches {dev_ms} ms on the device timeline, L2 "
                    f"flushed, {events_ms:.4f} ms by events with the wrappers [{card}]")
    finally:
        for kind in kept:
            setattr(T, f"{kind}_packed", orig[kind])
    return out


def arm_cohort(torch, C, card, db) -> dict:
    import inspect

    import numpy as np

    from horaedb_tpu_torch.common_types.dict_column import as_values
    from horaedb_tpu_torch.ops import encoding as E, scan_topk as T

    calls, orig = [], T.raw_topk_packed

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    sql = query_runs(C, 1)["lastpoint-host"][1][0]
    T.raw_topk_packed = rec
    try:
        for _ in range(3):  # a miss, then the build
            if db.execute(sql).metrics.get("path") == "raw_device":
                break
    finally:
        T.raw_topk_packed = orig
    (sp, tp, vals, session, dyn), kw = calls[-1]
    ex = db.interpreters.executor
    entry = ex.scan_cache._entries["cpu"]
    names = np.asarray(as_values(entry.series_rows.columns["hostname"]), dtype=object)
    allow = np.zeros((32, session.shape[0]), dtype=np.int32)
    for h in range(32):
        allow[h, int(np.flatnonzero(names == f"host_{h}")[0])] = 1
    sess = torch.from_numpy(allow).to("cuda")
    dyns = dyn.repeat(32, 1)
    ckw = {**{n: v for n, v in kw.items() if n != "windows"},
           "k": T.padded_k(E.layout_rows(sp, kw["series_layout"]), 10)}
    n_f = len(kw["numeric_filters"])
    lo, hi = (int(x) for x in dyn[n_f:n_f + 2].tolist())
    want = T.raw_topk_cohort_plain(sp, tp, vals, sess, dyns, **ckw)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    forms = {"every_row": {}}
    if "windows" in inspect.signature(T.raw_topk_cohort).parameters:
        forms["windows"] = {"windows": [
            ex._raw_candidate_estimate(entry, allow[h, :-1] != 0, lo, hi, exact=False)[1]
            for h in range(32)]}
    out = {}
    for form, extra in forms.items():
        fn = lambda e=extra: T.raw_topk_cohort(sp, tp, vals, sess, dyns, **e, **ckw)  # noqa: E731
        got = fn()
        if not torch.equal(got, want):
            raise AssertionError(f"cohort {form}: the kernel differs from the plain version")
        ms = C._family_device_ms(torch, fn, COHORT_NAMES, reps=10, flush=flush,
                                 label=f"cohort {form}")
        events = C._time_launch(torch, fn, reps=10, flush=flush)
        out[form] = {"ms": ms, "split": last_split(C) if ms else None, "events_ms": events,
                     "digest": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}
        say(f"cohort {form} (32 lastpoint-host members, k {ckw['k']}): {ms} ms on the device "
            f"timeline, L2 flushed, {events:.4f} ms by events with the wrapper [{card}]")
    return out


def gather_replay(torch, C, card, db, L, field: str, clock: int, flush) -> dict:
    """Phase 11's refresh of ``field``'s panel over the hour before
    ``clock``, served from state; its gather replayed."""
    rec, orig = [], L.gather

    def gather(rings, idx, g):
        rec.append((rings, idx, g))
        return orig(rings, idx, g)

    L.gather = gather
    try:
        db.execute(C._lw_panel(field, clock - 60 * 60_000))
    finally:
        L.gather = orig
    path = db.interpreters.executor.last_path
    if path != "livewindow" or not rec:
        raise AssertionError(f"the refresh took {path}, {len(rec)} gathers")
    rings, idx, g = rec[-1]
    fn = lambda: L.gather(rings, idx, g)  # noqa: E731
    got = fn()
    if not torch.equal(got, L.gather_plain(rings, idx, g)):
        raise AssertionError("the gather differs from its plain version")
    words = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()
    n = int(idx.shape[0])
    device_ms = C._family_device_ms(torch, fn, GATHER_NAMES, reps=20, flush=flush,
                                    label="the refresh's gather")
    split = last_split(C) if device_ms else None
    events_ms = C._time_launch(torch, fn, flush=flush)
    bound_ms = 2 * 20 * n * g / C.PEAK_BYTES_S * 1e3
    # a yardstick: one device-to-device copy of the same bytes
    copy = torch.empty_like(got)
    copy_ms = C._family_device_ms(torch, lambda: copy.copy_(got), ("DtoD",), reps=20,
                                  flush=flush)
    say(f"gather (n {n} x g {g}, the refresh of {field}): {device_ms} ms on the device "
        f"timeline, L2 flushed ({split}), {events_ms:.4f} ms by events; bound {bound_ms:.6f} "
        f"ms; a DtoD copy of the same {got.numel() * 4} B {copy_ms} ms; equal to plain "
        f"[{card}]")
    return {"n": n, "g": g, "device_ms": device_ms, "split": split, "events_ms": events_ms,
            "bound_ms": bound_ms, "copy_ms": copy_ms, "words": words}


def arm_fold(torch, C, card, n_commits: int, arms) -> dict:
    import numpy as np

    import horaedb_tpu_torch
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.ops import livewindow as L
    from horaedb_tpu_torch.state import livewindow as S
    from horaedb_tpu_torch.tools import tsbs

    # the grouped fold (fold_batches, fold_group) or the parent's per state
    grouped = hasattr(L, "fold_group")
    fields = tsbs.CPU_FIELDS[:C.LW_FIELDS]
    S.STORE.clear()
    db = horaedb_tpu_torch.connect(None, device="cuda")
    db.execute(C._cpu_table_sql(tsbs).replace("segment_duration='2h'",
                                               "segment_duration='2h', update_mode='append'"))
    table = db.catalog.open("cpu")
    history = tsbs.generate_cpu(C.HOSTS, C.LW_HISTORY_MIN * 60_000, t0=C.LW_T0, seed=C.SEED + 3)
    table.write(RowGroup(table.schema, dict(history.columns)))
    live_t0 = C.LW_T0 + C.LW_HISTORY_MIN * 60_000
    live = tsbs.generate_cpu(C.HOSTS, n_commits * tsbs.INTERVAL_MS, t0=live_t0, seed=C.SEED + 4)
    for f in fields:
        for _ in range(S.promote_reads()):
            db.execute(C._lw_panel(f, live_t0 - 60 * 60_000))
    n_states = len(S.STORE.stats()["states"])
    if n_states != C.LW_FIELDS:
        raise AssertionError(f"{n_states} states promoted")
    # timers: the write hook, and inside it the launch path
    hook, launch, calls = {"s": 0.0}, {"s": 0.0}, []
    orig_hook = S.STORE._fold_committed
    launch_name, kernel_name = ("fold_batches", "fold_group") if grouped else ("fold_batch",
                                                                              "fold")
    orig_launch, orig_kernel = getattr(L, launch_name), getattr(L, kernel_name)

    def timed(fn, acc):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc["s"] += time.perf_counter() - t
        return run

    def recorded(*a):
        calls.append(a)
        return orig_kernel(*a)

    S.STORE._fold_committed = timed(orig_hook, hook)
    setattr(L, launch_name, timed(orig_launch, launch))
    setattr(L, kernel_name, recorded)
    commit_ms, hook_ms, launch_ms, adv_flags = [], [], [], []
    last_adv_calls, head = None, None
    L.reset_counts()
    try:
        for k in range(n_commits):
            rows = live.slice(k * C.HOSTS, (k + 1) * C.HOSTS)
            bmax = int(rows.columns["ts"].max()) // 60_000
            adv = head is not None and bmax > head
            head = bmax if head is None else max(head, bmax)
            hook["s"] = launch["s"] = 0.0
            calls.clear()
            t = time.perf_counter()
            table.write(RowGroup(table.schema, dict(rows.columns)))
            commit_ms.append((time.perf_counter() - t) * 1e3)
            hook_ms.append(hook["s"] * 1e3)
            launch_ms.append(launch["s"] * 1e3)
            adv_flags.append(adv)
            if adv:
                last_adv_calls = list(calls)
        torch.cuda.synchronize()
        launches, errors = dict(L.LAUNCHES), L.FOLD_ERRORS
    finally:
        S.STORE._fold_committed = orig_hook
        setattr(L, launch_name, orig_launch)
        setattr(L, kernel_name, orig_kernel)
    if errors:
        raise AssertionError(f"{errors} fold errors")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gathered = None
    if "gather" in arms:
        gathered = gather_replay(torch, C, card, db, L, fields[0],
                                 live_t0 + n_commits * tsbs.INTERVAL_MS, flush)
    # one head-advance commit's folds, replayed on copies of its rings
    if grouped:
        (rings_list, words, spans), = last_adv_calls
        copies = [r.clone() for r in rings_list]
        replay = lambda: L.fold_group(copies, words, spans)  # noqa: E731
    else:
        copies = [(c[0].clone(), *c[1:]) for c in last_adv_calls]
        replay = lambda: [L.fold(*c) for c in copies]  # noqa: E731
    device_ms = C._family_device_ms(torch, replay, FOLD_NAMES, reps=20, flush=flush,
                                    label="a head-advance commit's folds")
    adv = np.asarray(adv_flags)[10:]  # the first commits warm the allocator and kernels

    def med(xs, sel=None):
        x = np.asarray(xs)[10:]
        x = x if sel is None else x[sel]
        return float(np.median(x)) if len(x) else None

    out = {
        "grouped": grouped, "commits": n_commits, "launches": launches, "states": n_states,
        "launches_per_commit": sum(v for k, v in launches.items() if k != "gather") / n_commits,
        "commit_ms": med(commit_ms), "commit_ms_advance": med(commit_ms, adv),
        "hook_ms": med(hook_ms), "launch_path_ms": med(launch_ms),
        "prep_ms": med(np.asarray(hook_ms) - np.asarray(launch_ms)),
        "device_ms_advance_commit": device_ms, "gather": gathered,
    }
    say(f"fold ({'one grouped launch a commit' if grouped else 'per state'}; {n_commits} "
        f"commits, launches {launches}): commit median {out['commit_ms']:.3f} ms (head advance "
        f"{out['commit_ms_advance']}); write hook {out['hook_ms']:.3f} ms = prep "
        f"{out['prep_ms']:.3f} + launch path {out['launch_path_ms']:.3f}; a head-advance "
        f"commit's folds {device_ms:.4f} ms on the device, L2 flushed [{card}]")
    db.close()
    S.STORE.clear()
    return out


def arm(opt) -> int:
    """One turn: this process imports the checkout ``opt.arm``."""
    enter(opt.arm)
    import torch

    import chip_smoke as C

    C.DEV = "cuda"
    card = C.phase_card(torch)
    arms = opt.arms.split(",")
    res = {"dir": opt.arm, "card": card}
    if {"fold", "gather"} & set(arms):
        res["fold"] = arm_fold(torch, C, card, opt.commits, arms)
    if {"raw", "mesh", "cohort"} & set(arms):
        db = cpu_table(C)
        if "raw" in arms:
            res["raw"] = arm_raw(torch, C, card, db, opt.runs)
        if "cohort" in arms:
            res["cohort"] = arm_cohort(torch, C, card, db)
        if "mesh" in arms:
            res["mesh"] = arm_mesh(torch, C, card, db, opt.runs)
        db.close()
    emit(res)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout of the other commit")
    ap.add_argument("--arm", help="(internal) run one turn with this checkout")
    ap.add_argument("--runs", type=int, default=12, help="instances of each raw query a turn")
    ap.add_argument("--commits", type=int, default=120, help="live commits before the fold "
                    "and gather arms' replays")
    ap.add_argument("--arms", default=",".join(ARMS),
                    help=f"comma-separated, of {', '.join(ARMS)}")
    opt = ap.parse_args(argv)
    arms = set(opt.arms.split(","))
    if not arms <= set(ARMS):
        ap.error(f"--arms takes some of {', '.join(ARMS)}")
    if arms & {"fold", "gather"} and opt.commits < 1:
        ap.error("the fold and gather arms need --commits of 1 or more")
    if opt.arm:
        return arm(opt)
    turns = run_turns(__file__, opt.other, ["--runs", str(opt.runs), "--commits",
                                            str(opt.commits), "--arms", opt.arms])
    card = write_report("topk_fold_ab.json", turns)

    def each(f) -> str:
        return " / ".join(f"{t['label']} {f(t)}" for t in turns)

    same = True
    for q, r in turns[0].get("raw", {}).items():
        equal = all(t["raw"][q]["digests"] == r["digests"] for t in turns)
        same &= equal
        kernel = (" kernel ms " + each(lambda t: f"{t['raw'][q]['ms']:.4f}") + ";"
                  if q in TOPK_QUERIES else "")
        say(f"{q}:{kernel} warm execute ms " + each(lambda t: f"{t['raw'][q]['warm_ms']:.3f}")
            + f"; the same rows in every turn: {equal} [{card}]")
    for q, r in turns[0].get("mesh", {}).items():
        equal = all(t["mesh"][q]["digests"] == r["digests"] for t in turns)
        same &= equal
        say(f"mesh {q}: shard launches device ms "
            + each(lambda t: t["mesh"][q]["device_ms"]) + "; events ms "
            + each(lambda t: f"{t['mesh'][q]['events_ms']:.4f}") + "; shards launched "
            + each(lambda t: t["mesh"][q]["shards_launched"]) + "; warm execute ms "
            + each(lambda t: f"{t['mesh'][q]['warm_ms']:.3f}")
            + f"; the same rows in every turn: {equal} [{card}]")
    for form in sorted({f for t in turns for f in t.get("cohort", {})}):
        has = [t for t in turns if form in t["cohort"]]
        equal = len({t["cohort"][form]["digest"] for t in has}
                    | {t["cohort"]["every_row"]["digest"] for t in turns}) == 1
        same &= equal
        say(f"cohort {form}: device ms " + " / ".join(
            f"{t['label']} {t['cohort'][form]['ms'] if form in t['cohort'] else '-'}"
            for t in turns) + "; events ms " + " / ".join(
            f"{t['cohort'][form]['events_ms']:.4f}" if form in t["cohort"] else "-"
            for t in turns) + f"; the same slots in every turn and form: {equal} [{card}]")
    if "fold" in arms:
        say("fold a head-advance commit, device ms "
            + each(lambda t: f"{t['fold']['device_ms_advance_commit']:.4f}")
            + "; commit median ms " + each(lambda t: f"{t['fold']['commit_ms']:.3f}")
            + "; launches a commit " + each(lambda t: f"{t['fold']['launches_per_commit']:.2f}")
            + f" [{card}]")
    if "gather" in arms:
        equal = all(t["fold"]["gather"]["words"] == turns[0]["fold"]["gather"]["words"]
                    for t in turns)
        same &= equal
        say("gather at the refresh, device ms " + each(lambda t: t["fold"]["gather"]["device_ms"])
            + "; events ms " + each(lambda t: f"{t['fold']['gather']['events_ms']:.4f}")
            + "; a DtoD copy of its bytes ms " + each(lambda t: t["fold"]["gather"]["copy_ms"])
            + f"; the same words in every turn: {equal} [{card}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
