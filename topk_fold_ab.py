#!/usr/bin/env python3
"""Time two checkouts' raw reads (the B4 top-k and the selection) and
live-window fold (B6a) in turns on one NVIDIA card: this checkout and
another one (its parent commit, unpacked with ``git archive``), in the
order other, this, this, other, each turn a process of its own that
imports that checkout's ``horaedb_tpu_torch`` (ab_turns.py).

    mkdir -p chip_proof/parent
    git archive HEAD~1 horaedb_tpu_torch | tar -x -C chip_proof/parent
    python3 topk_fold_ab.py --other chip_proof/parent [--runs 12] [--commits 120]

Each turn:

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
- fold: the cpu-live scenario of chip_smoke.py's phase 11 (one hour of
  history, the five per-field panels promoted, ``--commits`` live commits
  of 4000 rows): each commit's wall time, the write hook's host time
  split into the states' preparation and the launch path, the fold
  launches a commit; then the last head-advance commit's folds replayed
  on copies of the rings, device time with L2 flushed.

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
# every kernel either checkout's top-k and fold launch, by base name
RAW_NAMES = ("raw_init", "raw_keys", "topk_hist", "topk_pick", "raw_flags", "raw_scan",
             "raw_write", "raw_fill", "topk_keys", "topk_refine", "topk_write", "Memset",
             "HtoD")
FOLD_NAMES = ("ring_reset", "ring_scatter", "ring_fold", "HtoD")


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


def arm_raw(torch, C, card, n_runs: int) -> dict:
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import scan_topk as T
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
                digests.append(hashlib.sha1(repr(res.to_pylist()).encode()).hexdigest())
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
    db.close()
    return out


def arm_fold(torch, C, card, n_commits: int) -> dict:
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
    # one head-advance commit's folds, replayed on copies of its rings
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
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
        "device_ms_advance_commit": device_ms,
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
    res = {"dir": opt.arm, "card": card}
    if opt.commits:
        res["fold"] = arm_fold(torch, C, card, opt.commits)
    res["raw"] = arm_raw(torch, C, card, opt.runs)
    emit(res)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout of the other commit")
    ap.add_argument("--arm", help="(internal) run one turn with this checkout")
    ap.add_argument("--runs", type=int, default=12, help="instances of each raw query a turn")
    ap.add_argument("--commits", type=int, default=120, help="0: no fold turn")
    opt = ap.parse_args(argv)
    if opt.arm:
        return arm(opt)
    turns = run_turns(__file__, opt.other,
                      ["--runs", str(opt.runs), "--commits", str(opt.commits)])
    card = write_report("topk_fold_ab.json", turns)
    same = True
    for q, r in turns[0]["raw"].items():
        equal = all(t["raw"][q]["digests"] == r["digests"] for t in turns)
        same &= equal
        kernel = (" kernel ms " + " / ".join(f"{t['label']} {t['raw'][q]['ms']:.4f}"
                                             for t in turns) + ";") if q in TOPK_QUERIES else ""
        say(f"{q}:{kernel} warm execute ms " + " / ".join(
            f"{t['label']} {t['raw'][q]['warm_ms']:.3f}" for t in turns)
            + f"; the same rows in every turn: {equal} [{card}]")
    if opt.commits:
        say("fold a head-advance commit, device ms " + " / ".join(
            f"{t['label']} {t['fold']['device_ms_advance_commit']:.4f}" for t in turns)
            + "; commit median ms " + " / ".join(f"{t['fold']['commit_ms']:.3f}" for t in turns)
            + "; launches a commit " + " / ".join(f"{t['fold']['launches_per_commit']:.2f}"
                                                   for t in turns) + f" [{card}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
