#!/usr/bin/env python3
"""Time two builds of the scan_agg kernel library in turns on one NVIDIA
card: this checkout's and another checkout's (its parent commit, unpacked
with ``git archive``), at the main path's selective, hash, full-scan and
cohort shapes and at bench.py's groupby shapes.

    git archive --prefix=chip_proof/parent/ HEAD~1 | tar -x
    python3 scan_agg_ab.py --other chip_proof/parent [--probe] [--hours 24]

The TSBS cpu table (4000 hosts x ``--hours`` at 10 s, seed 123) is
written through the port's engine; single-groupby-5-8-1, sparse-8x1h and
sparse-16x12h run through ``Connection.execute`` until each is served
from the cache, and the SELECTIVE launch each one's kernel call made
(the shared arm, and the hash arm for the sparse panels) is replayed
against both libraries in the order other, this, this, other: each launch
checked against the plain version (counts, mins and maxs bit-equal, sums
within chip_smoke.SUM_RTOL of sum |x|), then timed on the device timeline
with L2 flushed before each launch, beside index_add_ on the same inputs.
Then bench.py's groupby shapes (the direct form, 2**18 rows, unsorted):
the hash arm of both libraries in turns with the scatter arm beside each.
Then the full scans and the cohort: double-groupby-all's and high-cpu-all's
full-scan launches and the flood's 32 texts as one cohort, the same way
(this checkout's wrappers over the entry's real rows where they take
them, the other library over the padded rows).

``--probe`` also builds the other checkout's run-partial core with one
suspected cost taken away at a time, by edits made to a copy of its
source at build time (``PROBE_EDITS``), and times each at the full-scan
and cohort shapes: the per-step shuffles off (wrong answers), a step's
field loads hoisted, min and max commits without read back, the cohort's
per-tile commits off but for a block's last tile (wrong answers); and the
other library over the real rows only (``other+prefix``).

Prints each time with the card's name and power limit, and writes
chiprun_out/scan_agg_ab.json. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out")

# the parent's run-partial core (``reduce_range``, the cohort's tile loop)
# and each probe's edit of it: one suspected cost taken away at a time
PROBE_EDITS = {
    # each step's warp reductions skipped: lane f keeps its own row's
    # value of field f (wrong answers; a probe of the shuffles' cost)
    "noshfl": [
        ("const float s = warp_sum(v);", "const float s = v;"),
        ("mn = warp_min(valid ? v : INFINITY);", "mn = valid ? v : INFINITY;"),
        ("mx = warp_max(valid ? v : -INFINITY);", "mx = valid ? v : -INFINITY;")],
    # a step's field loads issued together before the first reduction
    "hoist": [(
        """      run_cnt += __popc(vmask);
      for (int f = 0; f < n_agg; ++f) {
        const float v = valid ? src.value(f, i) : 0.f;""",
        """      run_cnt += __popc(vmask);
      float hv[10];
#pragma unroll
      for (int f = 0; f < 10; ++f) hv[f] = (valid && f < n_agg) ? src.value(f, i) : 0.f;
      for (int f = 0; f < n_agg; ++f) {
        const float v = f < 10 ? hv[f] : (valid ? src.value(f, i) : 0.f);""")],
    # every min and max commit one atomic with no read back
    "red": [("atomic_extreme<true>(", "red_min("), ("atomic_extreme<false>(", "red_max(")],
    # the cohort commits a member's last run partial of a tile only in the
    # block's last tile (wrong answers; a probe of the per-tile commits)
    "commit1": [
        ("""                             const Sink& t) {""",
         """                             const Sink& t, bool last = true) {"""),
        ("""  t.commit(run_seg, run_cnt, run_sum, run_min, run_max, lane, n_agg, minmax);
}
""", """  if (last) t.commit(run_seg, run_cnt, run_sum, run_min, run_max, lane, n_agg, minmax);
}
"""),
        ("reduce_range<ARM>(src, begin, begin + per_warp, out, t);",
         "reduce_range<ARM>(src, begin, begin + per_warp, out, t, tile + gridDim.x >= n_tiles);")],
}
# probes whose answers differ from the plain version by design
WRONG_PROBES = ("noshfl", "commit1")


def say(*parts) -> None:
    print(*parts, flush=True)


def _declare(lib):
    from horaedb_tpu_torch.ops import scan_agg as S

    lib.scan_agg_cached_launch.argtypes = [ctypes.POINTER(S._CachedArgs), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    lib.scan_agg_cached_launch.restype = ctypes.c_int
    lib.scan_agg_direct_launch.argtypes = [ctypes.POINTER(S._DirectArgs), ctypes.c_int,
                                           ctypes.c_void_p]
    lib.scan_agg_direct_launch.restype = ctypes.c_int
    lib.scan_agg_cohort_launch.argtypes = [ctypes.POINTER(S._CohortArgs), ctypes.c_int,
                                           ctypes.c_void_p]
    lib.scan_agg_cohort_launch.restype = ctypes.c_int
    lib.scan_agg_blocks_per_sm.argtypes = [ctypes.POINTER(S._Out), ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.scan_agg_blocks_per_sm.restype = ctypes.c_int
    lib.scan_agg_error_string.argtypes = [ctypes.c_int]
    lib.scan_agg_error_string.restype = ctypes.c_char_p
    return lib


def _nvcc(src_dir: str, name: str, edits) -> tuple[ctypes.CDLL, str]:
    """Build ``src_dir``/scan_agg.cu with ``edits`` applied to a copy of
    it, beside its headers; returns the library and the ptxas report."""
    import shutil

    from horaedb_tpu_torch.ops import _build

    work = os.path.join(_build.BUILD_DIR, f"ab_{name}")
    os.makedirs(work, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, f), work)
    with open(os.path.join(src_dir, "scan_agg.cu")) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"probe {name}: the source has no {old[:60]!r}")
        text = text.replace(old, new)
    src = os.path.join(work, "scan_agg.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(work, "libscan_agg.so")
    p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{p.stdout}{p.stderr}")
    return _declare(ctypes.CDLL(out)), p.stdout + p.stderr


def _ptxas(log: str) -> list:
    """(kernel, registers/spills line) of each scan_agg_cached and
    scan_agg_direct instantiation."""
    lines = log.splitlines()
    out = []
    for j, line in enumerate(lines):
        if "Compiling entry function" in line and any(
                k in line for k in ("scan_agg_cached", "scan_agg_direct", "scan_agg_cohort")):
            name = line.split("'")[1]
            info = [x.split("ptxas info    :")[-1].strip() for x in lines[j + 1:j + 4]
                    if "registers" in x or "spill" in x]
            out.append((name, "; ".join(info)))
    return out


def _launch(S, lib, args, kw):
    """One SELECTIVE launch of ``lib`` on a cached call's inputs, with the
    segmented core's geometry from ``lib``'s own occupancy query."""
    import torch

    sp, tp, values, session, dyn = args
    dev = session.device
    n_seg = kw["n_groups"] * kw["n_buckets"]
    arm = kw["segment_impl"]
    a, _ = S._cached_args(sp, tp, tuple(values), kw["value_layouts"], kw["ts_layout"],
                          kw["series_layout"], kw["numeric_filters"], kw["n_agg_fields"],
                          kw["n_buckets"], dev)
    a.session, a.dyn = session.data_ptr(), dyn.data_ptr()
    a.n_rows = dyn.shape[0] - len(kw["numeric_filters"]) - 4
    a.s1 = session.shape[0] // 2
    packed = S._packed_out(1, n_seg, kw["n_agg_fields"], kw["need_minmax"], dev)[0]
    a.out = S._out_of(packed.data_ptr(), n_seg, kw["n_agg_fields"], kw["need_minmax"])
    S._set_launch(a.out, arm, kw.get("hash_slots", 0), None, dev, a.n_rows, "cached_selective",
                  lib=lib)
    err = lib.scan_agg_cached_launch(ctypes.byref(a), S._ARM_CODE[arm], 1,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(lib.scan_agg_error_string(err).decode())
    return packed


def _launch_direct(S, lib, args, kw, arm: str):
    """One ``scan_agg_direct`` launch of ``lib`` with ``arm`` on a direct
    call's inputs, its geometry as in ``_launch``."""
    import torch

    g, b, m, v, lits = args
    dev = g.device
    n_seg = kw["n_groups"] * kw["n_buckets"]
    F = kw["n_agg_fields"]
    counts = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    sums = torch.zeros((F, n_seg), dtype=torch.float32, device=dev)
    mins = torch.full_like(sums, float("inf"))
    maxs = torch.full_like(sums, float("-inf"))
    a = S._DirectArgs()
    a.group_codes, a.bucket_ids, a.mask = g.data_ptr(), b.data_ptr(), m.data_ptr()
    a.values, a.literals = v.data_ptr(), lits.data_ptr()
    a.n_rows, a.n_buckets, a.device = g.shape[0], kw["n_buckets"], S._device_index(dev)
    a.filt = S._filters(kw["numeric_filters"], v.shape[0])
    a.out = S._Out(counts.data_ptr(), sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
                   n_seg, F, int(kw["need_minmax"]))
    S._set_launch(a.out, arm, kw.get("hash_slots", 0), None, dev, g.shape[0], "direct", lib=lib)
    err = lib.scan_agg_direct_launch(ctypes.byref(a), S._ARM_CODE[arm],
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(lib.scan_agg_error_string(err).decode())
    G, B = kw["n_groups"], kw["n_buckets"]
    return counts.view(G, B), sums.view(F, G, B), mins.view(F, G, B), maxs.view(F, G, B)


def _launch_full(S, lib, args, kw, n_rows: int):
    """One full-scan ``scan_agg_cached`` launch of ``lib`` over the first
    ``n_rows`` resident rows (the other checkout's launcher sizes its own
    grid)."""
    import torch

    sp, tp, values, session, dyn = args
    dev = session.device
    n_seg = kw["n_groups"] * kw["n_buckets"]
    a, _ = S._cached_args(sp, tp, tuple(values), kw["value_layouts"], kw["ts_layout"],
                          kw["series_layout"], kw["numeric_filters"], kw["n_agg_fields"],
                          kw["n_buckets"], dev)
    a.session, a.dyn = session.data_ptr(), dyn.data_ptr()
    a.n_rows, a.s1 = n_rows, session.shape[0] // 2
    packed = S._packed_out(1, n_seg, kw["n_agg_fields"], kw["need_minmax"], dev)[0]
    a.out = S._out_of(packed.data_ptr(), n_seg, kw["n_agg_fields"], kw["need_minmax"])
    err = lib.scan_agg_cached_launch(ctypes.byref(a), S._ARM_CODE[kw["segment_impl"]], 0,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(lib.scan_agg_error_string(err).decode())
    return packed


def _launch_cohort(S, lib, args, kw, n_rows: int):
    """One ``scan_agg_cohort`` launch of ``lib`` (the other checkout's,
    whose ``CohortArgs`` is a prefix of this checkout's) over the first
    ``n_rows`` resident rows, with the parent's tile and arm rules."""
    import torch

    sp, tp, values, sessions, dyns = args
    dev = sessions.device
    values = tuple(values)
    n_seg = kw["n_groups"] * kw["n_buckets"]
    B = sessions.shape[0]
    arm = S.cohort_arm(kw["segment_impl"], B, len(values), n_seg, kw["n_agg_fields"],
                       kw["need_minmax"])
    c, _ = S._cached_args(sp, tp, values, kw["value_layouts"], kw["ts_layout"],
                          kw["series_layout"], kw["numeric_filters"], kw["n_agg_fields"],
                          kw["n_buckets"], dev)
    c.s1, c.n_rows = sessions.shape[1] // 2, n_rows
    packed = S._packed_out(B, n_seg, kw["n_agg_fields"], kw["need_minmax"], dev)
    c.out = S._out_of(packed.data_ptr(), n_seg, kw["n_agg_fields"], kw["need_minmax"])
    a = S._CohortArgs()
    a.c = c
    a.sessions, a.dyns = sessions.data_ptr(), dyns.data_ptr()
    a.out_w, a.members = packed.shape[1], B
    a.sess_w, a.dyn_w = sessions.shape[1], dyns.shape[1]
    a.n_fields, a.tile = len(values), S.cohort_tile(len(values))
    # an older library reads only the fields before ``stats``
    a.carry = int(S.cohort_carry(arm, B, len(values), n_seg, kw["n_agg_fields"],
                                 kw["need_minmax"]))
    err = lib.scan_agg_cohort_launch(ctypes.byref(a), S._ARM_CODE[arm],
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(lib.scan_agg_error_string(err).decode())
    return packed


def _full_calls(C, S, torch, db, tsbs, hours: int) -> dict:
    """The run-partial core's shapes: double-groupby-all's and
    high-cpu-all's full-scan launches as ``Connection.execute`` made them,
    and the flood's 32 texts as one cohort (their preps' sessions and dyn
    rows stacked, as ``Executor.dispatch_cached_agg_cohort`` stacks them).
    Returns name -> (form, args, kw)."""
    import numpy as np

    rec = C.Recorder(S)
    calls = {}
    try:
        for name, sql in (("double-groupby-all", tsbs.double_groupby_all(hours).sql),
                          ("high-cpu-all", tsbs.high_cpu_all(min(C.HC_HOURS, hours)).sql)):
            for _ in range(3):
                db.execute(sql)
                c = rec.take().get("cached")
                if c is not None:
                    calls[name] = ("cached", *c)
        texts = C.flood_queries()
        for _ in range(2):
            db.execute(texts[0])
    finally:
        S.fused_scan_agg, S.cached_scan_agg_packed = rec.orig_fused, rec.orig_cached
    ex, table = db.interpreters.executor, db.catalog.open("cpu")
    preps = [ex.prepare_cached_agg(db._cached_plan(t), table, {"table": "cpu"},
                                   allow_selective=False) for t in texts]
    p0 = preps[0]
    entry, spec = p0.entry, p0.spec
    dev = db.device
    sessions = torch.from_numpy(np.stack([S.pack_session(p.gos, p.allow_scan)
                                          for p in preps])).to(dev)
    dyns = torch.from_numpy(np.stack([S.pack_dyn(p.literals, p.lo_rel, p.hi_rel, p.t0_rel,
                                                 p.width_i) for p in preps])).to(dev)
    n_seg = spec.n_groups * spec.n_buckets
    impl = S.resolve_segment_impl(n_seg, spec.segment_impl, spec.n_agg_fields, spec.need_minmax)
    kw = dict(n_groups=spec.n_groups, n_buckets=spec.n_buckets, n_agg_fields=spec.n_agg_fields,
              numeric_filters=S.encode_filter_ops(spec.numeric_filters),
              need_minmax=spec.need_minmax, segment_impl=impl, value_layouts=p0.value_layouts,
              ts_layout=entry.ts_layout, series_layout=entry.series_layout)
    calls["flood-32"] = ("cohort", (entry.series_parts, entry.ts_parts,
                                    entry.values_for(p0.value_names), sessions, dyns), kw)
    return calls


def _full_shapes(C, S, torch, db, tsbs, libs, probes, flush, card, hours: int) -> dict:
    """Step 0 and the A/B of the full scan and the cohort: each shape's
    kernel against its plain version, then timed on the device timeline
    with L2 flushed, in the order other, this, this, other; then each
    probe of the other checkout (``other+prefix`` is the other library
    over the real rows only, a launch argument)."""
    import inspect

    entry = db.interpreters.executor.scan_cache._entries["cpu"]
    n_valid, padded = int(entry.n_valid), int(entry.padded_rows)
    calls = _full_calls(C, S, torch, db, tsbs, hours)
    out = {}
    for name, (form, args, kw) in calls.items():
        cohort = form == "cohort"
        kernel = "scan_agg_cohort" if cohort else "scan_agg_cached"
        wrapper = S.cached_scan_agg_cohort if cohort else S.cached_scan_agg_packed
        # this checkout's wrapper over the real rows where it takes them
        this_kw = ({"n_rows": n_valid} if "n_rows" in inspect.signature(wrapper).parameters
                   else {})
        raw = _launch_cohort if cohort else _launch_full
        B = args[3].shape[0] if cohort else 1
        if cohort:
            want = S._cohort_body(*args, **kw)
            abs_sums = C._cohort_abs_sums(torch, args, kw)
        else:
            want = S._packed_body(*args, **kw)[None]
            abs_sums = [C._abs_sums(torch, "cached", args, kw)]
        turns = ["other", "this", "this", "other"]
        turns += [p for p in probes if not (p == "other+commit1" and not cohort)]
        shape = {"form": form, "members": B, "arm": kw["segment_impl"], "padded_rows": padded,
                 "real_rows": n_valid, "n_seg": kw["n_groups"] * kw["n_buckets"],
                 "F": kw["n_agg_fields"], "minmax": kw["need_minmax"], "runs": []}
        for which in turns:
            rows = n_valid if which in ("this", "other+prefix") else padded
            if which == "this":
                fn = lambda: wrapper(*args, **{**kw, **this_kw})  # noqa: E731
            else:
                lib = libs["other" if which == "other+prefix" else which][0]
                fn = lambda lib=lib, rows=rows: raw(S, lib, args, kw, rows)  # noqa: E731
            got = fn().reshape(B, -1)
            torch.cuda.synchronize()
            try:
                for b in range(B):
                    C._compare(f"{name} {which} member {b}", *C._split(torch, got[b], kw),
                               C._split(torch, want[b], kw), abs_sums[b], kw["need_minmax"])
                equal = True
            except AssertionError:
                equal = False
            if not equal and which.split("+")[-1] not in WRONG_PROBES:
                raise AssertionError(f"{name}: {which} differs from the plain version")
            ms = C._device_ms(torch, fn, kernel, reps=5 if cohort else 20, flush=flush)
            shape["runs"].append({"lib": which, "ms": ms, "rows": rows, "equal_plain": equal})
            say(f"{name} ({form}, B {B}, {shape['arm']}, n_seg {shape['n_seg']}, F "
                f"{shape['F']}, minmax {shape['minmax']}) {which} over {rows} rows: {ms} ms "
                f"on the device timeline, equal to plain {equal} [{card}]")
        out[name] = shape
    return out


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a checkout of the other commit")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--hours", type=int, default=12)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        say("no CUDA card: torch.cuda.is_available() is False")
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import _build, scan_agg as S
    from horaedb_tpu_torch.tools import tsbs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    say(f"card: {card}")
    other_src = os.path.join(os.path.abspath(opt.other), "horaedb_tpu_torch", "ops", "csrc")
    builds = {"other": []}
    if opt.probe:
        builds.update({f"other+{k}": v for k, v in PROBE_EDITS.items()})
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(builds) + 1) as pool:
        mine = pool.submit(S._kernels)
        futs = {k: pool.submit(_nvcc, other_src, k.replace("+", "_"), e) for k, e in builds.items()}
        libs = {"this": (mine.result(), _build.load("scan_agg").build_log)}
        libs.update({k: f.result() for k, f in futs.items()})
    report = {"card": card, "ptxas": {}, "shapes": {}}
    for name in ("this", "other"):
        report["ptxas"][name] = _ptxas(libs[name][1])
        for kernel, info in report["ptxas"][name]:
            say(f"ptxas {name}: {kernel}: {info}")

    C.DEV = "cuda"
    db = horaedb_tpu_torch.connect(None, device="cuda")
    db.execute(C._cpu_table_sql(tsbs))
    t0 = time.perf_counter()
    rows = tsbs.generate_cpu(C.HOSTS, opt.hours * 3_600_000, seed=C.SEED)
    table = db.catalog.open("cpu")
    table.write(rows)
    table.flush()
    del rows
    say(f"cpu table: {C.HOSTS} hosts x {opt.hours} h in {time.perf_counter() - t0:.1f} s")
    rec = C.Recorder(S)
    calls = {}
    queries = [("single-groupby-5-8-1", tsbs.single_groupby(5, 8, 1).sql)]
    queries += [(n, C.sparse_sql(h, hr)) for n, h, hr in C.sparse_queries() if hr <= opt.hours]
    # the arm each query's main-path launch takes (the router probes others
    # on the way): the last selective call of that arm
    want = {"single-groupby-5-8-1": "shared", "sparse-8x1h": "hash", "sparse-16x12h": "hash"}
    try:
        for name, sql in queries:
            for _ in range(4):
                db.execute(sql)
                c = rec.take().get("cached_selective")
                if c is not None and (name not in calls or c[1]["segment_impl"] == want[name]):
                    calls[name] = c
    finally:
        S.fused_scan_agg, S.cached_scan_agg_packed = rec.orig_fused, rec.orig_cached
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    order = ["other", "this", "this", "other"]
    for name, (args, kw) in calls.items():
        n_f = len(kw["numeric_filters"])
        shape = {"arm": kw["segment_impl"], "rows": int(args[4].shape[0] - n_f - 4),
                 "n_seg": kw["n_groups"] * kw["n_buckets"], "F": kw["n_agg_fields"],
                 "runs": []}
        want = C._split(torch, S._packed_body(*args, **kw), kw)
        abs_sums = C._abs_sums(torch, "cached_selective", args,
                               {**kw, "segment_impl": "scatter"})
        lib_call = C._library_call(torch, S, "cached_selective", args, kw)
        for which in order:
            lib = libs[which][0]
            fn = lambda lib=lib: _launch(S, lib, args, kw)  # noqa: E731
            got = C._split(torch, fn(), kw)
            torch.cuda.synchronize()
            try:
                C._compare(f"{name} {which}", *got, want, abs_sums, kw["need_minmax"])
                equal = True
            except AssertionError:
                equal = False
            if not equal:
                raise AssertionError(f"{name}: {which} differs from the plain version")
            ms = C._device_ms(torch, fn, "scan_agg_cached", reps=30, flush=flush)
            lib_ms = C._time_launch(torch, lib_call, reps=30, flush=flush)
            shape["runs"].append({"lib": which, "ms": ms, "equal_plain": equal,
                                  "index_add_ms": lib_ms})
            say(f"{name} ({shape['arm']}, {shape['rows']} rows, n_seg {shape['n_seg']}, F "
                f"{shape['F']}) {which}: {ms} ms on the device timeline, equal to plain "
                f"{equal}; index_add_ {lib_ms:.4f} ms [{card}]")
        report["shapes"][name] = shape
    # bench.py's groupby shapes (direct form, 2**18 rows): the hash arm of
    # both libraries against the scatter arm (the run-partial core in both)
    import numpy as np

    from horaedb_tpu_torch.ops.hash_agg import hash_slots_for

    rng = np.random.default_rng(C.SEED + 9)
    report["groupby"] = {}
    turns = [("other", "hash"), ("other", "scatter"), ("this", "hash"), ("this", "scatter"),
             ("this", "hash"), ("this", "scatter"), ("other", "hash"), ("other", "scatter")]
    for label, domain, live in C.GROUPBY_SHAPES:
        args, kw = C._groupby_inputs(torch, rng, C.HASH_ROWS, domain, live)
        kw["hash_slots"] = hash_slots_for(domain, live)
        want = S.scan_agg_body(*args, **kw)
        abs_sums = C._abs_sums(torch, "direct", args, {**kw, "segment_impl": "scatter"})
        runs = []
        for which, arm in turns:
            lib = libs[which][0]
            fn = lambda lib=lib, arm=arm: _launch_direct(S, lib, args, kw, arm)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            C._compare(f"{label} {which} {arm}", *got, want, abs_sums, kw["need_minmax"])
            ms = C._device_ms(torch, fn, "scan_agg_direct", reps=20, flush=flush)
            runs.append({"lib": which, "arm": arm, "ms": ms})
        report["groupby"][label] = runs
        say(f"{label} (direct, {C.HASH_ROWS} rows, domain {domain}, {live} live, hash_slots "
            f"{kw['hash_slots']}): " + ", ".join(f"{r['lib']} {r['arm']} {r['ms']:.4f}"
                                                  for r in runs) + f" ms [{card}]")
    probes = [f"other+{k}" for k in PROBE_EDITS] + ["other+prefix"] if opt.probe else []
    report["full"] = _full_shapes(C, S, torch, db, tsbs, libs, probes, flush, card, opt.hours)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "scan_agg_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    say(json.dumps({n: [(r["lib"], r["ms"]) for r in s["runs"]] for n, s in
                    {**report["shapes"], **report["full"]}.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
