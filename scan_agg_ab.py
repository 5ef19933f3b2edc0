#!/usr/bin/env python3
"""Time two builds of the scan_agg kernel library in turns on one NVIDIA
card: this checkout's and another checkout's (its parent commit, unpacked
with ``git archive``), at the main path's selective and hash shapes and
at bench.py's groupby shapes.

    git archive --prefix=chip_proof/parent/ HEAD~1 | tar -x
    python3 scan_agg_ab.py --other chip_proof/parent [--probe] [--hours 12]

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

``--probe`` also builds the other checkout's run-partial core (the kernel
before the segmented core) with one suspected cost removed at a time, by
edits made to a copy of its source at build time: the per-row path off
(wrong answers; a probe of its cost), one warp per 32 rows, a row's field
loads hoisted before the shuffles, a 256-slot hash table, and all four.

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

# the run-partial core's text and each probe's edit of it
PROBE_EDITS = {
    "norow": [(
        "const bool uniform = (ARM == ARM_SINGLE) || __all_sync(FULL_MASK, !valid || seg == seg0);",
        "const bool uniform = true;")],
    "grid": [(
        "long long rows_per_block = BLOCK * 8) {",
        "long long rows_per_block = BLOCK * 8) {\n  if (smem_ < 0) rows_per_block = BLOCK;")],
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
    "h256": [(
        """int scan_agg_cached_launch(const CachedArgs* a, int arm, int selective, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;""",
        """int scan_agg_cached_launch(const CachedArgs* a0, int arm, int selective, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  CachedArgs b = *a0;
  if (b.out.hash_slots > 256) b.out.hash_slots = 256;
  if (b.out.hash_rounds > b.out.hash_slots) b.out.hash_rounds = b.out.hash_slots;
  const CachedArgs* a = &b;""")],
}
PROBE_EDITS["all"] = [e for k in ("norow", "grid", "hoist", "h256") for e in PROBE_EDITS[k]]


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
        if "Compiling entry function" in line and ("scan_agg_cached" in line
                                                   or "scan_agg_direct" in line):
            name = line.split("'")[1]
            info = [x.split("ptxas info    :")[-1].strip() for x in lines[j + 1:j + 4]
                    if "registers" in x or "spill" in x]
            out.append((name, "; ".join(info)))
    return out


def _launch(S, lib, segmented: bool, args, kw):
    """One SELECTIVE launch of ``lib`` on a cached call's inputs: the
    segmented core's geometry (``S._set_launch``) for this checkout's
    library, the full-size table of ``block_hash_slots`` (16 B less a
    slot: no claim list) and the kernel's own grid for the other's."""
    import torch

    from horaedb_tpu_torch.ops.hash_agg import default_hash_slots, probe_rounds

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
    if segmented:
        S._set_launch(a.out, arm, kw.get("hash_slots", 0), None, dev, a.n_rows,
                      "cached_selective")
    elif arm == "hash":
        planes = 3 if kw["need_minmax"] else 1
        h = kw.get("hash_slots") or default_hash_slots(n_seg)
        while h > 2 and h * (4 + (1 + planes * kw["n_agg_fields"]) * 4) > S.SHARED_MEM_BYTES:
            h //= 2
        a.out.hash_slots, a.out.hash_rounds = h, probe_rounds(h)
    err = lib.scan_agg_cached_launch(ctypes.byref(a), S._ARM_CODE[arm], 1,
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(lib.scan_agg_error_string(err).decode())
    return packed


def _launch_direct(S, lib, segmented: bool, args, kw, arm: str):
    """One ``scan_agg_direct`` launch of ``lib`` with ``arm`` on a direct
    call's inputs, its geometry as in ``_launch``."""
    import torch

    from horaedb_tpu_torch.ops.hash_agg import default_hash_slots, probe_rounds

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
    if segmented:
        S._set_launch(a.out, arm, kw.get("hash_slots", 0), None, dev, g.shape[0], "direct")
    elif arm == "hash":
        planes = 3 if kw["need_minmax"] else 1
        h = kw.get("hash_slots") or default_hash_slots(n_seg)
        while h > 2 and h * (4 + (1 + planes * F) * 4) > S.SHARED_MEM_BYTES:
            h //= 2
        a.out.hash_slots, a.out.hash_rounds = h, probe_rounds(h)
    err = lib.scan_agg_direct_launch(ctypes.byref(a), S._ARM_CODE[arm],
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(lib.scan_agg_error_string(err).decode())
    G, B = kw["n_groups"], kw["n_buckets"]
    return counts.view(G, B), sums.view(F, G, B), mins.view(F, G, B), maxs.view(F, G, B)


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
    order = ["other", "this", "this", "other"] + [k for k in builds if k != "other"]
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
            fn = lambda lib=lib, w=which: _launch(S, lib, w == "this", args, kw)  # noqa: E731
            got = C._split(torch, fn(), kw)
            torch.cuda.synchronize()
            try:
                C._compare(f"{name} {which}", *got, want, abs_sums, kw["need_minmax"])
                equal = True
            except AssertionError:
                equal = False
            if not equal and "+norow" not in which and "+all" not in which:
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
            fn = lambda lib=lib, w=which, arm=arm: _launch_direct(  # noqa: E731
                S, lib, w == "this" and arm == "hash", args, kw, arm)
            got = fn()
            torch.cuda.synchronize()
            C._compare(f"{label} {which} {arm}", *got, want, abs_sums, kw["need_minmax"])
            ms = C._device_ms(torch, fn, "scan_agg_direct", reps=20, flush=flush)
            runs.append({"lib": which, "arm": arm, "ms": ms})
        report["groupby"][label] = runs
        say(f"{label} (direct, {C.HASH_ROWS} rows, domain {domain}, {live} live, hash_slots "
            f"{kw['hash_slots']}): " + ", ".join(f"{r['lib']} {r['arm']} {r['ms']:.4f}"
                                                  for r in runs) + f" ms [{card}]")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "scan_agg_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    say(json.dumps({n: [(r["lib"], r["ms"]) for r in s["runs"]] for n, s in
                    report["shapes"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
