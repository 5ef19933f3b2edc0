#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horaedb_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only   # phases 1, 2, 4, 15 and 22 only

Every phase but 22 serves from one card, also on a host of several cards;
phase 22 shards over every card where there are two or more (run it there
with ``--mesh-only``), else over 4 logical shards of the one card.

Phases, each of which fails the run (non-zero exit, no result line):

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the four CUDA kernel libraries from ``horaedb_tpu_torch/ops/csrc``,
   one nvcc per source, all started together.
3. Kernel vs plain: every entry point (direct, cached full, cached
   selective) and arm (single, shared, scatter) against its plain PyTorch
   version on the same CUDA tensors, over every resident layout, all six
   filter ops, both need_minmax values, F = 0, ragged N, NaN and signed
   zeros, and one segment of more than 2**24 rows; then rows sorted in runs
   of 1, 2, 5, 6, 7, 31, 32, 33, 64 and 1000 (TSBS rows grouped by minute
   are runs of 6) on each arm and form, F in {0, 1, 5, 10} with and
   without min/max, NaN and +-0 at the first, middle and last row of a run,
   gathers ending in pad slots. Counts, mins and maxs must be bit-equal;
   sums within SUM_RTOL of the segment's sum of |x|.
4. Main path: ``connect(None, device="cuda")``, the TSBS cpu table at
   4000 hosts x 24 h (34,560,000 rows x 10 fields, seed 123) and the
   README demo table (1M rows), written and flushed through the engine;
   single-groupby-5-8-1, double-groupby-all (24 h), high-cpu-all (12 h)
   and avg(value) GROUP BY name, each REPEATS times, checked against an
   independent numpy group-by over the generated rows. The launch counters
   must show the direct kernel and both forms of the cached kernel ran.
5. Replay: each form's last main-path call of every query, the kernel
   against its plain version on the same tensors, as in phase 3; the
   kernel table's max_abs_err comes from here.
6. Timings: per query cold and warm wall time and the cached kernel's
   time (CUDA events), and peak device memory.
7. Merge kernels vs plain: the merge-dedup sort of every kind (rk, f32,
   f64, gen) against its plain version on the same CUDA tensors, at
   MERGE_SIZES rows (the tile's edges), unique and duplicate-heavy keys,
   dedup on and off, exact and padded words (the largest size, 3,277
   tiles so look-back chains are long, for f32 alone: unique keys, dedup);
   keys constant in every digit (every pass skipped), keys that differ
   only in the top bit of a word or at a digit boundary (the passes taken
   checked on the card), n_valid = 0; one call twice on the same scratch,
   the second finding the first's words there; and a stress set
   through the dispatcher (exact duplicates, all-ones real keys, +-2**62
   timestamps with a 64-bit seq span) that must reach its kind by the
   counters. perm and keep bit-equal.
8. Main path of BASELINE config 5: 64 overlapping L0 SSTs, 40M rows (the
   config's 100M, cut for the script's time limit), written through the
   engine's SstWriter and manifest; the SELECT before compaction (the f32
   read merge), ``Compactor.compact()`` (one rk launch a chunk), the SELECT
   after and a GROUP BY, all checked against an
   independent numpy merge, as are the L1 SST's rows and order; host
   stage seconds.
9. Merge replay and timings: the last f32 and rk main-path calls, kernel
   against plain (bit-equal), staged at exactly their real rows; per kind
   the kernel's time on the profiler's timeline where its trace holds every
   launch of the calls, else by CUDA events around calls queued behind a
   device sleep; its split by kernel, radix passes, launches a call,
   bound, plain and library times, upload and download bytes and ms.
10. Live-window kernels vs plain: the ring fold and gather on CUDA rings
   against their plain versions: depth {8, 128} x cap {64, 4096} x rows
   {0, 1, 4000, 24000, 2**20} x {distinct cells, one cell} x reset
   {none, one slot, all} x pairs {none, present}, +-0, masked, wrapped and
   dropped indices in every batch; gathers at n {1, 60, 128} with
   out-of-range slots. Counts, mins and maxs bit-equal, sums and counter
   increments within SUM_RTOL of the cell's sum of |x|.
11. Live-window main path: the TSBS cpu table at 4000 hosts (append mode),
   one hour of history, five per-field open-tail panels promoted at the
   default knobs, 90 minutes of live commits (540 x 4000 rows; the
   128-bucket ring rolls over), one late batch inside the ring and one
   below its tail, every panel refreshed each simulated minute. Every
   answer equals an independent numpy group-by; at six checkpoints the
   kill-switch rescan too; >= 90% of refreshes served from state; one
   fold launch a commit, which folds every state of the table (states
   folded = commits x states), no fold error. A profiler trace over two
   steady minutes gives the device's idle share of their commits' and
   refreshes' wall time.
12. Live-window replay and timings: the last grouped folds (with a reset
   and without) and gather of the main path, kernel against plain state by
   state; fold and gather device times, bounds, plain and library times,
   the gather's copy back, the write hook's host time per commit (the
   states' preparation, the launch path), refresh latency from state and
   rescan.
13. PromQL and alerts: a counter table at 4000 hosts, 10 s scrapes, a
   counter reset on every host; its all-tags state promoted, 30 min of live
   commits; increase/rate over the last 30 min at step 5 m served from
   state, equal to numpy and to the kill-switch fold at 1e-4 relative; one
   RuleEngine alert fires for the expected hosts from state.
14. Raw-read kernels vs plain (run after phase 6, on the card beside the
   resident cpu table): the top-k and the bounded selection against their
   plain versions on the same CUDA tensors over every resident layout (a
   dictionary-coded key, delta and dictionary timestamps, delta series
   codes, bf16), ts and f32 keys both ways, k in {1, 16, 128, 4096, n},
   n in {0, 1, 1000, 2**20, 2**25 + 4096}, every filter op, selections at
   the exact count and around it, both kernels over row windows (the
   executor's, every real row, runs of passing rows and windows of one row
   or a few, ones that start inside a delta block and end inside a tile),
   and the traps (+-0 at the threshold, NaN last, +-inf, ties past k, fewer
   passing rows than k, an empty allow list or time range). Indices, keys
   and counts bit-equal; a windowed launch visits the windows' rows only.
15. Raw main path: phases 4-6 ran at the default host-copy budget, which
   drops the copy that raw reads gather from, so lastpoint-host first
   takes the host route (no_host_rows); then the connection's budget is
   raised and the cpu entry evicted; five raw reads on the cpu table
   (34,560,000 rows, rebuilt resident by the first) through
   ``Connection.execute``, REPEATS times each, every run on
   the device raw route with its kernel and equal to an independent numpy
   answer, each launch over the executor's windows (a top-k's rows and
   tiles counted by its keys kernel on the card, its kernels launched
   counted); once each the kill-switch
   host route; one unflushed tick then lastpoint-host again (hit+delta,
   the new row first); EXPLAIN; the launch counters.
16. Raw replay and timings: each query's last kernel call, with its
   windows, against its plain version (bit-equal); device time, the rows
   it visited and kernels it ran, the bound over the window rows and over
   every real row, plain and library (torch.topk / torch.nonzero) times,
   the copy back; warm execute latency against the kill-switch route.
17. Cohort kernels vs plain (after phase 16, beside the resident cpu
   table): the cohort scan-aggregate (B1e) against its plain version over
   every resident layout, each arm, need_minmax both ways, all six filter
   ops, F = 0, B in {1, 2, 7, 32}, members with an empty allow list or
   time range, NaN and +-0 (counts, mins, maxs bit-equal; sums within
   SUM_RTOL of each member's sum of |x|); the cohort top-k (B4c) against
   its plain version and against B launches of the solo top-k, bit-equal,
   over phase 14's layouts, keys and sizes at B in {1, 3, 32} and its
   traps; selective_cached_scan_agg (B1d) against the SELECTIVE cached
   kernel and its plain version.
18. The dashboard flood, on phase 4's connection and resident cpu table:
   32 threads send 32 distinct texts of one shape (hostname count/sum/max
   of usage_user over a sliding start and a usage_user literal) through
   ``Proxy`` with [wlm.batch] on (window 40 ms, cohorts up to 32), in the
   reference flood's closed loop (each thread takes the next query number
   from one shared counter and sends it as soon as its last is answered):
   64 warm-up queries, 256 measured; then the same 256 through a Proxy
   with batching off (one solo launch a query, or none when the same text
   is already in flight). Every answer of both arms equals an independent
   numpy group-by; dispatches per query from the launch counters,
   p50/p99 latency, qps, cohort sizes. It fails unless a fused cohort
   reached B >= 8, the cohort kernel launched, no cohort form ran a plain
   version, no fused dispatch fell back (warm-up included), and the fused
   arm dispatched less per query than the solo arm. Then the last fused
   call replayed (kernel against plain) and timed against B solo
   launches, its bound and index_add_; the cohort top-k replayed on the
   resident columns for 32 lastpoint-host members (hosts 0-31, k 16),
   bit-equal to 32 solo top-k launches, and timed against them and
   torch.topk; B1d timed at single-groupby-5-8-1's gather.
19. Hash arm vs plain (B2d, beside the resident cpu table): the hash arm of
   the direct, cached and SELECTIVE cached kernels against
   hash_segment_agg_plain on the same CUDA tensors: every resident layout,
   F in {0, 1, 5, 10} with and without min/max, H in {16, 2048, 4096},
   rounds in {1, 2, 4}, exactly H live segments probed in full (no row may
   overflow), tables that overflow (at least one case must), NaN and +-0,
   an empty mask, bench.py's groupby shapes at 2**18 rows, a 16-slot table
   that every block fills (no row may overflow), phase 3's short runs on
   the hash arm, and a 16-slot table probed once on runs of 6 in every
   form (rows must overflow). Counts, mins and maxs bit-equal; sums within
   SUM_RTOL of sum |x|.
20. Sparse-domain panels, on phase 4's connection and resident cpu table:
   sparse-8x1h (TSBS single-groupby-5-8-1 grouped by host too: n_seg
   4096 x 64, 480 live) and sparse-16x12h (16 hosts, 12 h: n_seg
   4096 x 1024, 11,520 live) through ``Connection.execute``, REPEATS times
   routed (the router seeds hash; the first cached call must report it and
   the hash launch count must move), once pinned to scatter; every answer
   bit-equal to numpy and to the scatter answer. Each query's hash call
   replayed (kernel against plain, overflow rows of the per-block tables
   and of the plain version's one table) and timed against the scatter and
   shared arms, its bound, index_add_ and plain; the packed output's
   memset, copy back and host unpack apart; bench.py's groupby shapes
   timed the same way (direct form, 2**18 rows).
21. Mesh combine vs plain (B7a): ``mesh_combine`` against its plain version
   on CUDA tensors, S in {1, 2, 3, 4, 8} shards, the packed form (S buffers
   and one [S, L] buffer) and the state form, F in {0, 1, 10}, need_minmax
   both ways, empty segments in some shards, -0.0 and +0.0 split across
   shards both ways, NaN in one shard's sum, min and max, and
   sparse-16x12h's packed size (4,194,304 segments, F = 5: 268 MB a shard)
   over 4 shards. Counts, mins and maxs bit-equal, sums within SUM_RTOL.
22. The sharded main path, on phase 4's connection and cpu table with phase
   15's host-copy budget: the single-device answers first, then the entry
   evicted and a mesh installed (4 logical shards on the card, or every
   card where there are two or more). Through ``Connection.execute``:
   high-cpu-all cold (the sharded direct path), single-groupby-5-8-1 (which
   builds the sharded entry), double-groupby-all, sparse-16x12h (the hash
   arm on every shard, then the 268 MB combine), lastpoint-host and
   high-cpu-1, each equal to numpy and to the single-device answer
   (counts, mins and maxs bit-equal, raw rows in order); every run reports
   the mesh and moves the counters by one launch a shard and one combine
   an aggregate. The per-shard real rows (at 2**26 padded rows the last of
   four shards is all padding). dist_merge_dedup at a compaction chunk's
   shape (6,299,325 rows) bit-equal to the one-device f32 merge. The last
   combine, the last run's shard top-k (lastpoint-host, with the keys it
   ranked by) and selection (high-cpu-1) launches and the merge's shard
   sorts replayed against their plain versions and timed against their
   bounds and library calls (torch.sum/amin/amax, torch.topk,
   torch.nonzero); warm executes against the single-device ones. Every
   launch count comes from the kernels' own counters, counted where each
   kernel launches; no plain version runs on the path.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

HOSTS = 4000
HOURS = 24
HC_HOURS = 12
DEMO_ROWS = 1_000_000
SEED = 123
REPEATS = 5
REPEATS_MESH = 3
SUM_RTOL = 1e-5
# rows in the one segment that must count past 2**24
BIG_SEGMENT = (1 << 24) + 4096
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor op/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
SRC = "horaedb_tpu_torch/ops/csrc/scan_agg.cu"
REPLACES = {
    "direct": "horaedb_tpu/ops/scan_agg.py:328",
    "cached": "horaedb_tpu/ops/scan_agg.py:572",
    "cached_selective": "horaedb_tpu/ops/scan_agg.py:572",
}
KERNEL_NAMES = {
    "direct": "scan_agg_direct",
    "cached": "scan_agg_cached",
    "cached_selective": "scan_agg_cached[selective]",
}

DETAIL: dict = {}
# the card; a rehearsal of the phases on the CPU sets "cpu"
DEV = "cuda"
MESH_ONLY = False  # --mesh-only: phases 1, 2, 4, 15 and 22


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


# ---- phase 1: card ---------------------------------------------------------


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    DETAIL["card"] = card
    return card


# ---- phase 2: build --------------------------------------------------------


def phase_build() -> None:
    """The kernel libraries, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from horaedb_tpu_torch.ops import livewindow, merge_dedup, scan_agg, scan_topk

    loaders = {"scan_agg": scan_agg._kernels, "merge_dedup": merge_dedup._kernels,
               "livewindow": livewindow._kernels, "scan_topk": scan_topk._kernels}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        # each builds and loads its library and checks its struct layouts
        futures = {name: pool.submit(fn) for name, fn in loaders.items()}
        libs = {name: f.result() for name, f in futures.items()}
    for name, lib in libs.items():
        say(f"build: {name}.cu in {lib.build_seconds:.2f} s of nvcc")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
        DETAIL[f"build_log_{name}"] = lib.build_log
        DETAIL[f"nvcc_seconds_{name}"] = lib.build_seconds
    secs = time.perf_counter() - t0
    say(f"build: {secs:.2f} s for all four with loading")
    DETAIL["build_seconds"] = secs


# ---- phase 3: kernels against their plain versions ------------------------


def _canon(t):
    """float32 bits with every NaN one pattern (as numpy int32)."""
    import torch

    t = t.detach().float().clone()
    t[torch.isnan(t)] = float("nan")
    return t.cpu().numpy().view("int32")


def _compare(kind, counts, sums, mins, maxs, want, abs_sums, need_minmax) -> float:
    """Bit-equal counts/mins/maxs, sums within SUM_RTOL * sum|x|; returns
    the largest |sum difference|."""
    import numpy as np

    wc, ws, wmn, wmx = want
    check(np.array_equal(counts.cpu().numpy(), wc.cpu().numpy()), f"{kind}: counts differ")
    if need_minmax:
        check(np.array_equal(_canon(mins), _canon(wmn)), f"{kind}: mins differ")
        check(np.array_equal(_canon(maxs), _canon(wmx)), f"{kind}: maxs differ")
    g = sums.double().cpu().numpy()
    w = ws.double().cpu().numpy()
    a = abs_sums.double().cpu().numpy()
    # both NaN, or equal (an infinite sum equals only the same infinity)
    same = (np.isnan(g) & np.isnan(w)) | (g == w)
    with np.errstate(invalid="ignore"):
        diff = np.where(same, 0.0, np.abs(g - w))
    with np.errstate(invalid="ignore"):
        bad = ~(same | (diff <= SUM_RTOL * a))
    check(not bad.any(), f"{kind}: sums differ beyond {SUM_RTOL} of sum|x|: "
          f"{g[bad][:3]} vs {w[bad][:3]} (scale {a[bad][:3]})")
    return float(diff.max()) if diff.size else 0.0


def _split(torch, packed, kw):
    """(counts, sums, mins, maxs) views of a packed cached output."""
    gb = kw["n_groups"] * kw["n_buckets"]
    fs = kw["n_agg_fields"] * gb
    c = packed[:gb].view(torch.int32)
    s = packed[gb:gb + fs]
    if kw["need_minmax"]:
        return c, s, packed[gb + fs:gb + 2 * fs], packed[gb + 2 * fs:]
    return c, s, s, s


def _abs_sums(torch, form, args, kw):
    """The plain version's sums of |x| over the rows the call aggregates:
    the scale each sum's tolerance is taken against."""
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    n_agg = kw["n_agg_fields"]
    if form == "direct":
        g, b, m, v, lits = args
        kept = S._apply_filters(m, v, lits, kw["numeric_filters"])
        return S.scan_agg_body(g, b, kept, v[:n_agg].abs(), lits[:0],
                               **{**kw, "numeric_filters": ()})[1]
    sp, tp, values, session, dyn = args
    n_f = len(kw["numeric_filters"])
    layouts = kw.get("value_layouts") or tuple(S._dense_layout(p) for p in values)
    sc, tr, vals = E.decode_layouts(
        sp, tp, values, kw.get("series_layout", ("raw",)), kw.get("ts_layout", ("raw",)),
        layouts, idx=dyn[n_f + 4:] if kw.get("selective") else None,
    )
    # |x| of the agg fields first, then every field as stored, which the
    # filters (moved past the |x| columns) read
    cols = [v.float().abs() for v in vals[:n_agg]] + [v.float() for v in vals]
    raw_kw = {**kw, "selective": False,
              "numeric_filters": tuple((n_agg + f, op) for f, op in kw["numeric_filters"]),
              "value_layouts": tuple(("raw",) for _ in cols),
              "ts_layout": ("raw",), "series_layout": ("raw",)}
    packed = S._packed_body((sc.contiguous(),), (tr.contiguous(),),
                            tuple((c.contiguous(),) for c in cols), session, dyn[:n_f + 4],
                            **raw_kw)
    return _split(torch, packed, kw)[1]


def _check_call(torch, form, args, kw, kind) -> tuple[float, int]:
    """Launch the kernel of ``form`` once and run its plain version once
    on the same tensors; fails unless they agree (``_compare``). Returns
    the largest |sum difference| and the rows counted."""
    from horaedb_tpu_torch.ops import scan_agg as S

    if form == "direct":
        got = S.fused_scan_agg(*args, **kw)
        _sync(torch)
        want = S.scan_agg_body(*args, **kw)
    else:
        got = _split(torch, S.cached_scan_agg_packed(*args, **kw), kw)
        _sync(torch)
        want = _split(torch, S._packed_body(*args, **kw), kw)
    err = _compare(kind, *got, want, _abs_sums(torch, form, args, kw), kw["need_minmax"])
    return err, int(got[0].sum())


def _direct_case(torch, rng, n_valid, G, B, F, op, need_minmax, arm, special=False,
                 big_segment=False):
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    g = rng.integers(0, G, n_valid).astype(np.int32)
    b = rng.integers(0, B, n_valid).astype(np.int32)
    if big_segment:
        g[:BIG_SEGMENT] = 0
        b[:BIG_SEGMENT] = 0
    m = rng.random(n_valid) < 0.97
    if big_segment:
        m[:BIG_SEGMENT] = True
    n_fields = F + (op is not None)
    # agg fields at full precision (their sums round); the filter-only
    # field integer-valued so that = and != select rows
    vals = rng.normal(0, 50, (n_fields, n_valid)).astype(np.float32)
    vals[F:] = np.round(vals[F:])
    if special:
        vals[:, 1], vals[:, 2], vals[:, 3] = np.nan, -0.0, 0.0
    batch = E.build_padded_batch(g, b, m, list(vals))
    filters = ((F, S._FILTER_OPS[op]),) if op is not None else ()
    lits = torch.tensor([3.0] * len(filters), dtype=torch.float32, device=dev)
    args = [torch.from_numpy(x).to(dev) for x in (batch.group_codes, batch.bucket_ids,
                                                 batch.mask, batch.values)]
    kw = dict(n_groups=G, n_buckets=B, n_agg_fields=F, numeric_filters=filters,
              need_minmax=need_minmax, segment_impl=arm)
    return _check_call(torch, "direct", (*args, lits), kw, f"direct/{arm}")[0]


def _resident_case(rng, n_series, per, series_layout, ts_layout, kinds):
    """Sorted (series, ts) resident columns with a pad row, encoded by the
    port's codecs; returns (arrays, layouts) for convert.entry_from_reference."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E

    n = n_series * per
    codes = np.repeat(np.arange(n_series), per).astype(np.int32)
    # 10 ms apart, jittered below the step: a 128-row block spans < 2**16
    if ts_layout == "dict":
        ts = np.tile(np.arange(per) * 10, n_series).astype(np.int32)
    else:
        ts = (np.tile(np.arange(per) * 10, n_series) + rng.integers(0, 9, n)).astype(np.int32)
    padded = E.shape_bucket(n + 1)
    codes_p = E.pad_to_bucket(np.append(codes, np.int32(n_series)), n + 1, fill=n_series)
    ts_p = E.pad_to_bucket(np.append(ts, np.int32(-1)), n + 1, fill=np.int32(-1))
    arrays, layouts = {}, {"value": []}
    if series_layout == "delta":
        d = E.delta_for_encode(codes_p, 8)
        arrays["series_codes/0"], arrays["series_codes/1"] = d.words, d.base
        layouts["series_codes"] = ("delta", d.width)
    else:
        arrays["series_codes/0"] = codes_p
        layouts["series_codes"] = ("raw",)
    ts_src = ts_p.copy()
    ts_src[n:] = ts_src[n - 1]
    if ts_layout == "delta":
        d = E.delta_for_encode(ts_src, 16)
        arrays["ts_rel/0"], arrays["ts_rel/1"] = d.words, d.base
        layouts["ts_rel"] = ("delta", d.width)
    elif ts_layout == "dict":
        d = E.dict_encode(ts_src, 4096)
        arrays["ts_rel/0"], arrays["ts_rel/1"] = d.words, d.dictionary
        layouts["ts_rel"] = ("dict", d.width)
    else:
        arrays["ts_rel/0"] = ts_p
        layouts["ts_rel"] = ("raw",)
    for f, kind in enumerate(kinds):
        if kind in ("dict", "codes"):
            vocab = rng.choice(np.arange(-500, 500), 300, replace=False).astype(np.float32)
            col = np.pad(vocab[rng.integers(0, len(vocab), n)], (0, padded - n))
            d = E.dict_encode(col, 4096)
            arrays[f"value/{f}/0"], arrays[f"value/{f}/1"] = d.words, d.dictionary
            layouts["value"].append(("dict", d.width, kind == "dict"))
        else:
            col = rng.normal(0, 50, n).astype(np.float32)
            if f == len(kinds) - 1:
                col = np.round(col)  # the filter-only field: = and != select rows
            col = np.pad(col, (0, padded - n))
            arrays[f"value/{f}/0"] = col
            layouts["value"].append(("raw",))
    return arrays, layouts


def _cached_case(torch, rng, layout_case, arm, selective, need_minmax, op, G=1, B=1,
                 n_series=40, per=3001):
    args, kw, kind, form = _cached_inputs(torch, rng, layout_case, arm, selective, need_minmax,
                                          op, G, B, n_series, per)
    err, n_counted = _check_call(torch, form, args, kw, kind)
    check(n_counted > 0, f"{kind}: no row passed")
    return err


def _cached_inputs(torch, rng, layout_case, arm, selective, need_minmax, op, G=1, B=1,
                   n_series=40, per=3001):
    """A resident table of ``n_series`` series x ``per`` rows in
    ``layout_case``'s layouts and one query over it: (args, kw, kind, form)
    of a cached launch."""
    import numpy as np

    from horaedb_tpu_torch.convert import entry_from_reference
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    series_layout, ts_layout, kinds = layout_case
    arrays, layouts = _resident_case(rng, n_series, per, series_layout, ts_layout, kinds)
    entry = entry_from_reference(arrays, layouts, dev)
    if any(k == "bf16" for k in kinds):
        entry = _with_bf16(torch, entry, kinds)
    nf = len(kinds)
    n_agg = nf - 1  # the last field is filter-only
    gos = np.append(rng.integers(0, G, n_series), 0).astype(np.int32)
    allow = np.append(rng.random(n_series) < 0.8, False)
    allow[: 1 if n_series > 2 else n_series] = True
    filters = ((nf - 1, S._FILTER_OPS[op]),) if op is not None else ()
    n = n_series * per
    idx = None
    if selective:
        pick = np.nonzero(allow[:n_series])[0][:5]
        idx = np.concatenate([np.arange(s * per + 7, s * per + per - 9, dtype=np.int32)
                              for s in pick])
        idx = E.pad_to_bucket(idx, len(idx), fill=np.int32(n))
    width = max(1, (per * 10) // max(B - 1, 1))
    dyn = S.pack_dyn([5.0] * len(filters), 15, per * 10 - 25, -7, width, idx)
    session = torch.from_numpy(S.pack_session(gos, allow)).to(dev)
    dyn = torch.from_numpy(dyn).to(dev)
    kw = dict(n_groups=G, n_buckets=B, n_agg_fields=n_agg, numeric_filters=filters,
              need_minmax=need_minmax, segment_impl=arm, selective=selective,
              **entry.layout_kwargs())
    kind = f"cached/{arm}/{'sel' if selective else 'full'}/{layout_case}"
    form = "cached_selective" if selective else "cached"
    return (*entry.kernel_args().values(), session, dyn), kw, kind, form


def _with_bf16(torch, entry, kinds):
    """Store the ``bf16`` kinds as bfloat16 resident columns."""
    import dataclasses

    parts = list(entry.value_parts)
    layouts = list(entry.value_layouts)
    for f, k in enumerate(kinds):
        if k == "bf16":
            parts[f] = (parts[f][0].to(torch.bfloat16),)
            layouts[f] = ("bf16",)
    return dataclasses.replace(entry, value_parts=tuple(parts), value_layouts=tuple(layouts))


LAYOUT_CASES = [
    ("raw", "raw", ("raw", "raw")),
    ("delta", "delta", ("raw", "bf16", "codes")),
    ("delta", "dict", ("dict", "bf16", "dict")),
    ("raw", "dict", ("bf16", "dict", "codes")),
    ("delta", "raw", ("dict", "raw")),
]
OPS = ("=", "!=", "<", "<=", ">", ">=")


# Short sorted runs (the segmented core: SELECTIVE launches and the hash
# arm): rows sorted by segment in runs of RUN_LENGTHS rows, the first run
# of each stretch shortened so that runs start and end inside and across
# 32-row steps; TSBS rows at 10 s grouped by minute are runs of 6.
RUN_LENGTHS = (1, 2, 5, 6, 7, 31, 32, 33, 64, 1000)
# (F, need_minmax) the run cases cycle through
RUN_FIELDS = ((0, True), (1, True), (5, True), (10, True), (0, False), (1, False),
              (5, False), (10, False))
# an arm's (n_groups, n_buckets) for the direct form; the cached forms
# group series by minute-like buckets (_run_cached_inputs)
RUN_ARMS = {"single": (1, 1), "shared": (16, 8), "scatter": (512, 64), "hash": (4096, 64)}


def _run_bounds(seg_rows):
    """[start, end) of each run of equal consecutive ids."""
    import numpy as np

    cut = np.flatnonzero(np.diff(seg_rows) != 0) + 1
    starts = np.concatenate([[0], cut])
    return list(zip(starts.tolist(), np.concatenate([cut, [len(seg_rows)]]).tolist()))


def _run_specials(vals, runs, keep):
    """NaN, -0.0 among +0.0 and +0.0 among -0.0 at the first, middle and
    last row of nine runs (of two rows or more, past the first), in every
    agg field; those runs' rows are kept."""
    import numpy as np

    picked = [r for r in runs[1:] if r[1] - r[0] >= 2][:9]
    for j, (a, b) in enumerate(picked):
        at = (a, (a + b) // 2, b - 1)[j % 3]
        keep[a:b] = True
        if j < 3:
            vals[:, at] = np.nan
        else:
            vals[:, a:b] = 0.0 if j < 6 else -0.0
            vals[:, at] = -0.0 if j < 6 else 0.0
    return len(picked)


def _run_direct_inputs(torch, rng, run_len, arm, F, need_minmax, special=False, op=None):
    """A padded batch whose valid rows come in sorted runs of ``run_len``
    rows (consecutive runs in different segments; for ``single``, runs of
    kept rows between dropped ones); 3% of the other rows masked. (args,
    kw) of a direct launch."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    G, B = RUN_ARMS[arm]
    n_seg = G * B
    n = max(2048, 8 * run_len) + 77
    # the first run is shorter: boundaries fall inside steps
    k = (np.arange(n) + run_len // 2) // run_len
    seg_rows = (k * 7919 + 13) % n_seg if n_seg > 1 else np.zeros(n, np.int64)
    keep = rng.random(n) >= 0.03
    if arm == "single":
        keep &= (np.arange(n) + run_len // 2) % (run_len + 1) != run_len
    n_fields = F + (op is not None)
    vals = rng.normal(0, 50, (n_fields, n)).astype(np.float32)
    vals[F:] = np.round(vals[F:])
    if special:
        runs = _run_bounds(k if arm == "single" else seg_rows)
        _run_specials(vals[:F], runs, keep)
    batch = E.build_padded_batch((seg_rows // B).astype(np.int32), (seg_rows % B).astype(np.int32),
                                 keep, list(vals))
    filters = ((F, S._FILTER_OPS[op]),) if op is not None else ()
    lits = torch.tensor([3.0] * len(filters), dtype=torch.float32, device=dev)
    args = tuple(torch.from_numpy(x).to(dev) for x in (batch.group_codes, batch.bucket_ids,
                                                      batch.mask, batch.values)) + (lits,)
    kw = dict(n_groups=G, n_buckets=B, n_agg_fields=F, numeric_filters=filters,
              need_minmax=need_minmax, segment_impl=arm)
    return args, kw


def _run_cached_inputs(torch, rng, run_len, arm, selective, F, need_minmax, special=False,
                       op=None):
    """Resident columns of 6 series sorted by time (10 apart, delta-coded
    series codes, raw f32 values), bucketed ``run_len`` rows a bucket with
    buckets shifted half a run, and one query grouping by series group and
    bucket: runs of ``run_len`` rows (``single``: one segment). SELECTIVE
    gathers four series and ends in pad slots that fill the last steps.
    (args, kw, form) of a cached launch."""
    import numpy as np

    from horaedb_tpu_torch.convert import entry_from_reference
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    n_series = 6
    per = max(4 * run_len, 400) + 45
    arrays, layouts = _resident_case(rng, n_series, per, "delta", "raw", ("raw",) * (F + 1))
    n = n_series * per
    k = np.tile((np.arange(per) + run_len // 2) // run_len, n_series)
    series = np.repeat(np.arange(n_series), per)
    nb = int(k.max()) + 1
    if arm == "single":
        G, B, gos = 1, 1, np.zeros(n_series + 1, np.int32)
    else:
        G = {"shared": 2, "scatter": n_series, "hash": 512}[arm]
        B = E.next_pow2(nb)
        gos = np.append((np.arange(n_series) * 97) % G, 0).astype(np.int32)
    if special:
        vals = np.stack([arrays[f"value/{f}/0"][:n] for f in range(F)]) if F else None
        if F:
            _run_specials(vals, _run_bounds(series * (nb + 1) + k), np.ones(n, bool))
            for f in range(F):
                arrays[f"value/{f}/0"][:n] = vals[f]
    entry = entry_from_reference(arrays, layouts, dev)
    allow = np.append(np.ones(n_series, bool), False)
    idx = None
    if selective:
        idx = np.concatenate([np.arange(s * per, (s + 1) * per, dtype=np.int32)
                              for s in (0, 1, 3, 4)] + [np.full(70, n, np.int32)])
        idx = E.pad_to_bucket(idx, len(idx), fill=np.int32(n))
    filters = ((F, S._FILTER_OPS[op]),) if op is not None else ()
    dyn = S.pack_dyn([5.0] * len(filters), 0, per * 10, -10 * (run_len // 2), 10 * run_len, idx)
    session = torch.from_numpy(S.pack_session(gos, allow)).to(dev)
    kw = dict(n_groups=G, n_buckets=B, n_agg_fields=F, numeric_filters=filters,
              need_minmax=need_minmax, segment_impl=arm, selective=selective,
              **entry.layout_kwargs())
    form = "cached_selective" if selective else "cached"
    return (*entry.kernel_args().values(), session, torch.from_numpy(dyn).to(dev)), kw, form


def _run_case(torch, rng, run_len, arm, form, F, need_minmax, special=False, op=None,
              hash_slots=0, rounds=2) -> tuple[float, int]:
    """One short-run case, kernel against plain (the hash arm through
    ``_hash_check``, with ``hash_slots`` and ``rounds``); returns the
    largest |sum difference| and, for the hash arm, the overflow rows."""
    if form == "direct":
        args, kw = _run_direct_inputs(torch, rng, run_len, arm, F, need_minmax, special, op)
    else:
        args, kw, form = _run_cached_inputs(torch, rng, run_len, arm, form == "cached_selective",
                                            F, need_minmax, special, op)
    kind = f"runs of {run_len} {form}/{arm} F={F} minmax={need_minmax}" + (
        " specials" if special else "")
    if arm == "hash":
        kw["hash_slots"] = hash_slots
        err, ov, _, counted = _hash_check(torch, form, args, kw, kind, rounds)
    else:
        (err, counted), ov = _check_call(torch, form, args, kw, kind), 0
    check(counted > 0, f"{kind}: no row passed")
    return err, ov


def _run_cases(torch, arms) -> tuple[int, float]:
    """Every run length of RUN_LENGTHS on every arm of ``arms`` and form,
    (F, need_minmax) cycling through RUN_FIELDS and a filter op through
    OPS; then NaN and +-0 at the first, middle and last row of a run of 6
    and of 33 on each arm and form. Returns the cases and the largest
    |sum difference|."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    n, err = 0, 0.0
    for a, arm in enumerate(arms):
        for f, form in enumerate(("direct", "cached", "cached_selective")):
            for j, run_len in enumerate(RUN_LENGTHS):
                F, need_minmax = RUN_FIELDS[(j + f + a) % len(RUN_FIELDS)]
                op = OPS[(j + 2 * f) % 6] if j % 2 else None
                err = max(err, _run_case(torch, rng, run_len, arm, form, F, need_minmax,
                                         op=op)[0])
                n += 1
            for run_len in (6, 33):
                err = max(err, _run_case(torch, rng, run_len, arm, form, 3, True,
                                         special=True)[0])
                n += 1
    return n, err


def phase_kernels(torch) -> None:
    import numpy as np

    rng = np.random.default_rng(SEED)
    errs = {"direct": 0.0, "cached": 0.0, "cached_selective": 0.0}
    n_cases = 0
    arms = (("single", 1, 1), ("shared", 16, 8), ("scatter", 512, 64))
    for i, (arm, G, B) in enumerate(arms):
        for F in (0, 3):
            for need_minmax in (True, False):
                op = OPS[(i * 4 + F + need_minmax) % 6]
                n_valid = 100_003 + 977 * i  # ragged: the pad tail is masked
                e = _direct_case(torch, rng, n_valid, G, B, F, op, need_minmax, arm)
                errs["direct"] = max(errs["direct"], e)
                n_cases += 1
        e = _direct_case(torch, rng, 50_000, G, B, 2, None, True, arm, special=True)
        errs["direct"] = max(errs["direct"], e)
        n_cases += 1
    for arm, G, B in arms:
        for c, case in enumerate(LAYOUT_CASES):
            for selective in (False, True):
                for need_minmax in (True, False):
                    op = OPS[(c * 2 + selective + 3 * need_minmax) % 6]
                    form = "cached_selective" if selective else "cached"
                    e = _cached_case(torch, rng, case, arm, selective, need_minmax, op, G, B)
                    errs[form] = max(errs[form], e)
                    n_cases += 1
    # one segment of more than 2**24 rows, on every arm
    for arm, G, B in (("single", 1, 1), ("shared", 2, 1), ("scatter", 2, 1)):
        e = _direct_case(torch, rng, BIG_SEGMENT + (0 if arm == "single" else 9000), G, B, 1,
                         ">=", True, arm, big_segment=True)
        errs["direct"] = max(errs["direct"], e)
        n_cases += 1
    e = _cached_case(torch, rng, ("delta", "delta", ("raw", "raw")), "shared", False, True,
                     "!=", G=1, B=2, n_series=2, per=BIG_SEGMENT // 2)
    errs["cached"] = max(errs["cached"], e)
    n_cases += 1
    # short sorted runs through the segmented core (the SELECTIVE launches)
    # and the run-partial core (the full scans) of every non-hash arm
    n_runs, run_err = _run_cases(torch, ("single", "shared", "scatter"))
    n_cases += n_runs
    _sync(torch)
    say(f"kernels vs plain: {n_cases} cases passed ({n_runs} of short runs, max |sum diff| "
        f"{run_err}); max |sum diff| {errs}")
    DETAIL["kernel_cases"] = n_cases
    DETAIL["kernel_cases_max_abs_err"] = errs
    DETAIL["run_cases"] = {"cases": n_runs, "max_abs_err": run_err}


# ---- phase 4: the main path -------------------------------------------------


class Recorder:
    """Wraps the kernel wrappers to keep the last main-path call of each
    form (args and kwargs), so phases 5 and 6 can check and time the
    kernel on exactly the inputs the main path gave it."""

    def __init__(self, S):
        self.S = S
        self.calls: dict = {}
        self.orig_fused = S.fused_scan_agg
        self.orig_cached = S.cached_scan_agg_packed

        def fused(*a, **k):
            self.calls["direct"] = (a, k)
            return self.orig_fused(*a, **k)

        def cached(*a, **k):
            self.calls["cached_selective" if k.get("selective") else "cached"] = (a, k)
            return self.orig_cached(*a, **k)

        S.fused_scan_agg = fused
        S.cached_scan_agg_packed = cached

    def take(self) -> dict:
        out, self.calls = self.calls, {}
        return out


def _cpu_table_sql(tsbs) -> str:
    return (
        "CREATE TABLE cpu (hostname string TAG, region string TAG, "
        "datacenter string TAG, "
        + ", ".join(f"{f} double" for f in tsbs.CPU_FIELDS)
        + ", ts timestamp NOT NULL, TIMESTAMP KEY(ts)) "
        "ENGINE=Analytic WITH (segment_duration='2h')"
    )


def _expected(tsbs, rows, demo):
    """Independent answers: numpy group-bys over the generated rows, on the
    float32 values the device columns hold, accumulated in float64."""
    import numpy as np

    n_ticks = HOURS * 3_600_000 // tsbs.INTERVAL_MS
    host = np.tile(np.arange(HOSTS), n_ticks)  # generate_cpu's row order
    ts = rows.columns["ts"]
    check(np.array_equal(ts[:HOSTS * 2], np.repeat([0, tsbs.INTERVAL_MS], HOSTS)), "row order")
    check(rows.columns["hostname"][HOSTS + 7] == "host_7", "row order (hosts)")
    f32 = {f: rows.columns[f].astype(np.float32).astype(np.float64) for f in tsbs.CPU_FIELDS}
    exp = {}
    # single-groupby-5-8-1: per-minute max of 5 fields over host_0..7, hour 0
    sel = (host < 8) & (ts < 3_600_000)
    minute = ts[sel] // 60_000
    sg = {}
    for f in tsbs.CPU_FIELDS[:5]:
        mx = np.full(60, -np.inf)
        np.maximum.at(mx, minute, f32[f][sel])
        sg[f] = mx
    exp["single-groupby-5-8-1"] = sg
    # double-groupby-all: per (host, hour) mean of 10 fields, 24 h
    key = host * HOURS + ts // 3_600_000
    cnt = np.bincount(key, minlength=HOSTS * HOURS)
    exp["double-groupby-all"] = {
        f: (np.bincount(key, weights=f32[f], minlength=HOSTS * HOURS) / cnt,
            np.bincount(key, weights=np.abs(f32[f]), minlength=HOSTS * HOURS) / cnt)
        for f in tsbs.CPU_FIELDS
    }
    # high-cpu-all: usage_user > 90 in the first HC_HOURS hours
    hc = (f32["usage_user"] > 90) & (ts < HC_HOURS * 3_600_000)
    exp["high-cpu-all"] = (int(hc.sum()), float(f32["usage_user"][hc].max()))
    # readme: avg(value) per name
    names, inv = np.unique(demo["name"], return_inverse=True)
    v = demo["value"].astype(np.float32).astype(np.float64)
    c = np.bincount(inv)
    exp["readme"] = {
        n: (s / k, a / k) for n, s, a, k in zip(
            names, np.bincount(inv, weights=v), np.bincount(inv, weights=np.abs(v)), c)
    }
    return exp


def _check_answer(name, got, exp) -> None:
    import numpy as np

    from horaedb_tpu_torch.tools import tsbs

    if name == "single-groupby-5-8-1":
        check(len(got) == 60, f"{name}: {len(got)} rows")
        for r in got:
            i = r["minute"] // 60_000
            for f in tsbs.CPU_FIELDS[:5]:
                check(r[f"max_{f}"] == exp[f][i], f"{name}: max_{f} minute {i}")
    elif name == "double-groupby-all":
        check(len(got) == HOSTS * HOURS, f"{name}: {len(got)} rows")
        for r in got:
            k = int(r["hostname"][5:]) * HOURS + r["hour"] // 3_600_000
            for f in tsbs.CPU_FIELDS:
                mean, scale = exp[f][0][k], exp[f][1][k]
                check(abs(r[f"avg_{f}"] - mean) <= SUM_RTOL * scale,
                      f"{name}: avg_{f} {r['hostname']} {r['hour']}")
    elif name == "high-cpu-all":
        check(len(got) == 1 and got[0]["c"] == exp[0] and got[0]["peak"] == exp[1],
              f"{name}: {got} vs {exp}")
    else:
        check(len(got) == len(exp), f"{name}: {len(got)} rows")
        for r in got:
            mean, scale = exp[r["name"]]
            check(abs(r["a"] - mean) <= SUM_RTOL * scale, f"{name}: {r['name']}")
    check(not any(isinstance(v, float) and np.isnan(v) for r in got for v in r.values()),
          f"{name}: NaN in the answer")


def phase_main(torch) -> dict:
    import numpy as np

    import horaedb_tpu_torch
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.common_types.schema import compute_tsid
    from horaedb_tpu_torch.ops import scan_agg as S
    from horaedb_tpu_torch.tools import tsbs

    rec = Recorder(S)
    t0 = time.perf_counter()
    db = horaedb_tpu_torch.connect(None, device=DEV)
    check(db.device.type == DEV, f"connection is not on {DEV}")
    db.execute(_cpu_table_sql(tsbs))
    rows = tsbs.generate_cpu(HOSTS, HOURS * 3_600_000, seed=SEED)
    check(len(rows) == HOSTS * HOURS * 360, f"{len(rows)} rows")
    t_gen = time.perf_counter()
    table = db.catalog.open("cpu")
    table.write(rows)
    table.flush()
    t_cpu = time.perf_counter()
    db.execute("CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
               "ENGINE=Analytic WITH (segment_duration='2h')")
    rng = np.random.default_rng(SEED)
    name_ids = rng.integers(0, 100, DEMO_ROWS)
    host_names = np.array([f"host_{i}" for i in range(100)], dtype=object)
    demo = {
        # drawn without replacement: no row overwrites another's key
        "t": rng.choice(3_600_000, DEMO_ROWS, replace=False).astype(np.int64),
        "name": host_names[name_ids],
        "value": rng.normal(10.0, 3.0, DEMO_ROWS),
    }
    dt = db.catalog.open("demo")
    dt.write(RowGroup(dt.schema, {**demo, "tsid": compute_tsid([host_names])[name_ids]}))
    dt.flush()
    t_load = time.perf_counter()
    say(f"load: {len(rows)} cpu rows generated in {t_gen - t0:.1f} s, written and flushed "
        f"in {t_cpu - t_gen:.1f} s; {DEMO_ROWS} demo rows in {t_load - t_cpu:.1f} s")
    exp = _expected(tsbs, rows, demo)
    raw_exp = _raw_expected(tsbs, rows)
    hash_exp = _hash_expected(tsbs, rows)
    flood_exp = _flood_expected(tsbs, rows)
    del rows

    queries = [
        ("single-groupby-5-8-1", tsbs.single_groupby(5, 8, 1).sql),
        ("double-groupby-all", tsbs.double_groupby_all(HOURS).sql),
        ("high-cpu-all", tsbs.high_cpu_all(HC_HOURS).sql),
        ("readme", "SELECT name, avg(value) AS a FROM demo GROUP BY name"),
    ]
    _sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    S.reset_counts()  # the main path's launches start here
    results = {}
    for name, sql in queries:
        runs = []
        for r in range(REPEATS):
            t = time.perf_counter()
            out = db.execute(sql)
            t_exec = time.perf_counter()
            got = out.to_pylist()
            runs.append({
                "seconds": t_exec - t,
                "to_pylist_seconds": time.perf_counter() - t_exec,
                "path": db.interpreters.executor.last_path,
                "cache": out.metrics.get("cache"),
                "kernel": out.metrics.get("kernel"),
            })
            _check_answer(name, got, exp[name])
        results[name] = {"runs": runs, "calls": rec.take()}
    launches = {form: dict(arms) for form, arms in S.LAUNCHES.items()}
    plain_calls = dict(S.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    for name, res in results.items():
        paths = [r["path"] for r in res["runs"]]
        say(f"{name}: paths {paths} kernels {[r['kernel'] for r in res['runs']]}")
        check(all(p == "device-cached" for p in paths[2:]), f"{name}: not device-cached warm")
    counts = launches if DEV == "cuda" else {k: {"plain": v} for k, v in plain_calls.items()}
    for form in ("direct", "cached", "cached_selective"):
        check(sum(counts[form].values()) > 0, f"main path never launched {form}")
    if DEV == "cuda":
        check(not any(plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    say(f"main path launches: {launches}")
    for r in db.execute("SELECT table_name, column_name, encoding, dtype, bytes FROM "
                        "system.public.device WHERE component = 'column'").to_pylist():
        say(f"  resident {r['table_name']}.{r['column_name']}: {r['encoding']} "
            f"{r['dtype']} {r['bytes']} B")
    DETAIL["load_seconds"] = t_load - t0
    DETAIL["launches"] = launches
    DETAIL["peak_bytes"] = peak
    return {"db": db, "results": results, "launches": launches, "peak": peak, "rec": rec,
            "expected": exp,
            "raw_expected": raw_exp, "flood_expected": flood_exp, "hash_expected": hash_exp}


# ---- phase 5: timings ---------------------------------------------------------


def _device_ms(torch, fn, name: str, reps=20, flush=None):
    """Mean ms of the ``name`` kernel on the card by the profiler's device
    timeline (the launch alone, without the wrapper's host work), or None
    when the profiler records no such kernel in two traces (one trace of
    a run on the card recorded none of a kernel that had launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    if flush is not None:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:  # no CUPTI tracing on this machine
            say(f"profiler unavailable ({e}); kernel times from CUDA events")
            return None
        us = [e.time_range.elapsed_us() for e in prof.events() if name in e.name]
        # every launch of the window and the other kernels the card ran in
        # it (another thread's or stream's work shares the SMs)
        others = sorted({e.name[:80] for e in prof.events()
                         if name not in e.name and e.device_type == DeviceType.CUDA})
        DETAIL.setdefault("device_ms_windows", []).append(
            {"name": name, "us": us, "other_kernels": others})
        if us:
            return sum(us) / len(us) / 1e3
        say(f"the profiler recorded no {name} kernel in {reps} launches")
    return None


def _time_launch(torch, fn, reps=10, flush=None) -> float:
    """Mean ms of one launch by CUDA events, after warm-up; ``flush``
    evicts L2 before each launch where the caller would find it cold."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _queued_ms(torch, fn, reps=5, flush=None):
    """Mean device ms of one call of ``fn`` by CUDA events with the call
    queued behind a device sleep: the host enqueues the events and every
    launch while the card sleeps, so the events time the call's kernels
    back to back, every launch inside, without the host's launch work.
    Returns (ms, whether every enqueue ended before its sleep did)."""
    import time

    sleep = torch.cuda._sleep  # spins the card for a count of clock cycles
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sleep(1 << 20)
    b.record()
    b.synchronize()
    ms_a_cycle = a.elapsed_time(b) / (1 << 20)
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 2 * host_ms + 5.0
    total, hidden = 0.0, True
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s0 = torch.cuda.Event(enable_timing=True)
        s0.record()
        sleep(int(sleep_ms / ms_a_cycle))
        t = time.perf_counter()
        a.record()
        fn()
        b.record()
        enqueue_ms = (time.perf_counter() - t) * 1e3
        b.synchronize()
        # the sleep must still have been running when the last launch was queued
        hidden &= enqueue_ms < s0.elapsed_time(a)
        total += a.elapsed_time(b)
    return total / reps, hidden


def _bytes_of(t) -> int:
    return int(t.numel() * t.element_size())


def _kernel_bounds(form, args, kw, out_segments=None) -> tuple[float, str, dict]:
    """Least time for the work: the bytes it must move over HBM bandwidth,
    or its f32 operations over the f32 peak, whichever is larger. The
    output counts every segment, or only ``out_segments`` of them where
    the launch writes no others (its fill is a separate memset)."""
    if form == "direct":
        g, b, m, v, lits = args
        n = g.shape[0]
        # codes, buckets and mask of every row; values of unmasked rows
        nbytes = sum(_bytes_of(x) for x in (g, b, m, lits))
        nbytes += int(_bytes_of(v) * float(m.float().mean()))
        n_seg = kw["n_groups"] * kw["n_buckets"] if out_segments is None else out_segments
        nbytes += 4 * n_seg * (1 + 3 * kw["n_agg_fields"])
        rows = n
    else:
        from horaedb_tpu_torch.ops import encoding as E

        sp, tp, vals, session, dyn = args
        n_f = len(kw["numeric_filters"])
        n_rows = E.layout_rows(sp, kw["series_layout"])

        def share(parts, frac):
            # a stream's bytes for the rows read; dictionaries and block
            # bases (small) whole
            return sum(_bytes_of(p) if p.numel() < 65536 else int(_bytes_of(p) * frac)
                       for p in parts)

        nbytes = _bytes_of(session) + _bytes_of(dyn)
        if kw["selective"]:
            rows = dyn.shape[0] - n_f - 4
            frac = rows / n_rows
            nbytes += sum(share(parts, frac) for parts in (sp, tp, *vals))
        else:
            # every row's series code; timestamps of rows whose series the
            # session allows; values of allowed rows inside the time range
            rows = n_rows
            sc = E.decode_series(sp, kw["series_layout"], n_rows).long()
            tr = E.decode_ts(tp, kw["ts_layout"], n_rows)
            s1 = session.shape[0] // 2
            lo, hi = (int(x) for x in dyn[n_f:n_f + 2].tolist())
            allowed = session[s1:][sc] != 0
            in_range = allowed & (tr >= lo) & (tr < hi)
            nbytes += share(sp, 1.0) + share(tp, float(allowed.float().mean()))
            frac = float(in_range.float().mean())
            nbytes += sum(share(parts, frac) for parts in vals)
        planes = 3 if kw["need_minmax"] else 1
        n_seg = kw["n_groups"] * kw["n_buckets"] if out_segments is None else out_segments
        nbytes += 4 * n_seg * (1 + planes * kw["n_agg_fields"])
    ops = rows * (len(kw["numeric_filters"]) + 4 + 3 * kw["n_agg_fields"])
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), {
        "bytes": nbytes, "ops": ops, "rows": rows}


def _library_call(torch, S, form, args, kw):
    """One PyTorch call computing the nearest function: index_add_ of the
    rows' values into their segments (the sums plane; decode, filters and
    bucketing precomputed outside the timed call)."""
    from horaedb_tpu_torch.ops import encoding as E

    if form == "direct":
        g, b, m, v, lits = args
        kept = S._apply_filters(m, v, lits, kw["numeric_filters"])
        n_seg = kw["n_groups"] * kw["n_buckets"]
        seg = torch.where(kept, g.long() * kw["n_buckets"] + b.long(), n_seg)
        vals = v[: kw["n_agg_fields"]].contiguous()
    else:
        sp, tp, values, session, dyn = args
        n_f = len(kw["numeric_filters"])
        idx = dyn[n_f + 4:] if kw["selective"] else None
        sc, tr, vals = E.decode_layouts(sp, tp, values, kw["series_layout"], kw["ts_layout"],
                                        kw["value_layouts"], idx=idx)
        s1 = session.shape[0] // 2
        lo, hi, t0, width = (int(x) for x in dyn[n_f:n_f + 4].tolist())
        keep = (session[s1:][sc.long()] != 0) & (tr >= lo) & (tr < hi)
        keep = S._apply_filters(keep, vals, dyn[:n_f].view(torch.float32),
                                kw["numeric_filters"])
        d = ((tr.long() - t0 + (1 << 31)) % (1 << 32)) - (1 << 31)
        bucket = torch.div(d, width, rounding_mode="floor").clamp(0, kw["n_buckets"] - 1)
        n_seg = kw["n_groups"] * kw["n_buckets"]
        seg = torch.where(keep, session[:s1][sc.long()].long() * kw["n_buckets"] + bucket, n_seg)
        vals = torch.stack([x.float() for x in vals[: kw["n_agg_fields"]]]) if kw[
            "n_agg_fields"] else torch.zeros((1, seg.shape[0]), device=seg.device)
    out = torch.zeros((vals.shape[0], n_seg + 1), device=vals.device)
    return lambda: out.index_add_(1, seg, vals)


def phase_replay(torch, main) -> dict:
    """Each form's last main-path call of every query, replayed: the
    kernel once and its plain version once on the same tensors, which
    must agree as in phase 3. Returns the largest |sum difference| per
    form."""
    from horaedb_tpu_torch.ops import scan_agg as S

    rec = main["rec"]
    # restore the wrappers: the replays launch through them, after the
    # main path's counts were read
    S.fused_scan_agg = rec.orig_fused
    S.cached_scan_agg_packed = rec.orig_cached
    errs = {"direct": 0.0, "cached": 0.0, "cached_selective": 0.0}
    for name, res in main["results"].items():
        for form, (args, kw) in res["calls"].items():
            kind = f"main path {name} {form} ({kw['segment_impl']})"
            err, n_counted = _check_call(torch, form, args, kw, kind)
            errs[form] = max(errs[form], err)
            say(f"{kind}: kernel = plain, {n_counted} rows counted, max |sum diff| {err}")
    _sync(torch)
    DETAIL["main_path_max_abs_err"] = errs
    return errs


def phase_timings(torch, main, errs, card) -> list:
    from horaedb_tpu_torch.ops import scan_agg as S

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    per_query = {}
    for name, res in main["results"].items():
        runs = res["runs"]
        secs = [r["seconds"] for r in runs]
        warm = statistics.median(secs[2:])
        kernel_ms = {}
        for form, (args, kw) in res["calls"].items():
            fn = (lambda a=args, k=kw: S.cached_scan_agg_packed(*a, **k)) if form != "direct" \
                else (lambda a=args, k=kw: S.fused_scan_agg(*a, **k))
            kernel_ms[form] = _device_ms(torch, fn, KERNEL_NAMES[form].split("[")[0], flush=flush)
        # the rows each full scan read (the entry's real rows)
        visited = {form: kw.get("n_rows") for form, (_, kw) in res["calls"].items()
                   if form == "cached"}
        per_query[name] = {
            "runs_ms": [x * 1e3 for x in secs],
            "to_pylist_ms": [r["to_pylist_seconds"] * 1e3 for r in runs],
            "cold_ms": secs[0] * 1e3, "warm_median_ms": warm * 1e3, "kernel_ms": kernel_ms,
            "rows_visited": visited,
        }
        say(f"timing {name}: execute runs {[round(x * 1e3, 3) for x in secs]} ms; "
            f"cold {secs[0] * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms; "
            f"to_pylist median {statistics.median(per_query[name]['to_pylist_ms']):.3f} ms; "
            f"kernel (device) {kernel_ms} ms; rows visited {visited} [{card}]")
    say(f"peak device memory: {main['peak']} B (torch.cuda.max_memory_allocated) [{card}]")

    # the kernel table: each form at the main path's heaviest shape of it
    shapes = {"direct": "readme", "cached": "double-groupby-all",
              "cached_selective": "single-groupby-5-8-1"}
    kernels = []
    for form, qname in shapes.items():
        calls = main["results"][qname]["calls"]
        check(form in calls, f"{qname} did not launch {form}")
        args, kw = calls[form]
        launch = (lambda a=args, k=kw: S.fused_scan_agg(*a, **k)) if form == "direct" \
            else (lambda a=args, k=kw: S.cached_scan_agg_packed(*a, **k))
        if form == "direct":
            plain = lambda a=args, k=kw: S.scan_agg_body(  # noqa: E731
                *a, **{x: y for x, y in k.items()})
        else:
            plain = lambda a=args, k=kw: S._packed_body(*a, **k)  # noqa: E731
        launch_ms = _time_launch(torch, launch, flush=flush)
        device_ms = _device_ms(torch, launch, KERNEL_NAMES[form].split("[")[0], flush=flush)
        ms = device_ms if device_ms is not None else launch_ms
        plain_ms = _time_launch(torch, plain, reps=3, flush=flush)
        lib_ms = _time_launch(torch, _library_call(torch, S, form, args, kw), flush=flush)
        bound_ms, bound_by, work = _kernel_bounds(form, args, kw)
        kernels.append({
            "name": KERNEL_NAMES[form], "route": "cuda", "source": SRC,
            "replaces": REPLACES[form],
            "launches": int(sum(main["launches"][form].values())),
            "max_abs_err": errs[form], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
        visited = kw.get("n_rows") if form == "cached" else None
        say(f"kernel {KERNEL_NAMES[form]} at {qname} ({kw.get('segment_impl')}, "
            f"{work['rows']} rows, {work['bytes']} B"
            + (f", {visited} rows visited" if visited is not None else "")
            + f"): {ms:.4f} ms on the device timeline "
            f"({'profiler' if device_ms is not None else 'events'}), {launch_ms:.4f} ms "
            f"launch incl. wrapper, plain {plain_ms:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms ({ms / lib_ms:.2f}x index_add_), bound "
            f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
    DETAIL["per_query"] = per_query
    DETAIL["kernels"] = kernels
    return kernels


# ---- phase 7: the merge-dedup sort against its plain version ----------------

MERGE_SRC = "horaedb_tpu_torch/ops/csrc/merge_dedup.cu"
MERGE_REPLACES = {
    "rk": "horaedb_tpu/ops/merge_dedup.py:132",
    "f32": "horaedb_tpu/ops/merge_dedup.py:158",
    "f64": "horaedb_tpu/ops/merge_dedup.py:197",
    "gen": "horaedb_tpu/ops/merge_dedup.py:225",
}
# around the kernel's tile (md.TILE, 5120 rows), then 3,277 tiles
MERGE_SIZES = (1, 2, 5119, 5120, 5121, (1 << 20) + 13, (1 << 24) + 5)
MERGE_PAD_MAX = (1 << 20) + 13  # sizes up to this one also run with padded words
# the kind that sorts the sizes above MERGE_PAD_MAX (long look-back chains):
# the read merge's; the chains are the same in every kind's passes
MERGE_LARGE_KIND = "f32"
U32 = 0xFFFFFFFF


def _distinct(rng, space: int, k: int):
    """``k`` distinct integers drawn uniformly from [0, space), ascending."""
    import numpy as np

    if space <= 4 * k:
        return np.sort(rng.choice(space, k, replace=False))
    draws = k + k // 8 + 64
    while True:  # uniform draws, deduped, then a uniform subset of k
        u = np.unique(rng.integers(0, space, draws, dtype=np.int64))
        if len(u) >= k:
            return u[np.sort(rng.choice(len(u), k, replace=False))]
        draws += draws // 2


def _kind_words(rng, kind, n, dup=False):
    """Key word columns of ``kind`` for ``n`` real rows in random order,
    with the kind's pad fills and dedup masks. ``dup`` draws each word from
    three values (rk: composites that differ mostly in their 6 seq bits),
    so most keys repeat and many rows tie on every word."""
    import numpy as np

    def word():
        w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        return rng.choice(w[:3], n) if dup and n else w

    if kind == "rk":
        # unique composites below 2**63: the kind's precondition
        comp = rng.permutation(_distinct(rng, 2 * n + 64 if dup else 1 << 36, n))
        comp = comp.astype(np.uint64)
        return ((comp >> np.uint64(32)).astype(np.uint32), comp.astype(np.uint32)), \
            (U32, U32), (U32, U32 ^ 63)
    if kind == "f32":
        return (word(), word(), word()), (U32,) * 3, (U32, U32, U32 ^ 63)
    if kind == "f64":
        return (word(), word(), word(), word()), (U32,) * 4, (U32, U32, U32, U32 ^ 63)
    return ((np.zeros(n, np.uint32),) + tuple(word() for _ in range(6)),
            (1, 0, 0, 0, 0, 0, 0), (0, U32, U32, U32, U32, 0, 0))


def _upload_words(torch, cols, fills, n, pad=0):
    """The key words of ``n`` real rows on DEV, as the dispatcher stages
    them, followed by ``pad`` pad rows of the kind's ``fills``."""
    import numpy as np

    from horaedb_tpu_torch.ops import merge_dedup as md

    host = md.stage(cols, n, pinned=False)
    if pad:
        fill = np.array(fills, np.uint32)[:, None].repeat(pad, 1).view(np.int32)
        host = torch.cat([host, torch.from_numpy(fill)], 1)
    return host.to(DEV).unbind(0)


def _edge_words(kind, n, what):
    """Key words of ``kind`` for ``n`` rows, random over four values a word:
    ``const`` one value (every digit constant: no pass runs); ``top`` 0 and
    2**31 (only each word's top digit varies); ``boundary`` the bits on
    each side of the first digit boundary, DIGIT_BITS - 1 and DIGIT_BITS
    (two digits a word vary). gen's word 0 (is_pad) stays 0. Returns the
    words, the fills, the masks and the passes the card must take."""
    import numpy as np

    from horaedb_tpu_torch.ops import merge_dedup as md

    rng = np.random.default_rng(n + len(what) + len(kind))
    b = md.DIGIT_BITS
    values = {"const": [0x1234567], "top": [0, 1 << 31],
              "boundary": [0, 1 << (b - 1), 1 << b, (1 << b) | (1 << (b - 1))]}[what]
    n_words = md._SPEC[kind][0]
    cols = [np.array(values, np.uint32)[rng.integers(0, len(values), n)]
            for _ in range(n_words)]
    _, fills, masks = _kind_words(rng, kind, 1)
    varying = n_words - 1 if kind == "gen" else n_words
    if kind == "gen":
        cols[0][:] = 0
    passes = {"const": 0, "top": varying, "boundary": 2 * varying}[what]
    return cols, fills, masks, passes


def _merge_check(torch, kind, words, masks, n_valid, dedup, what) -> int:
    """The kernel of ``kind`` once and its plain version once on the same
    tensors; perm and keep must be bit-equal. Returns the radix passes the
    kernel took (0 on the CPU)."""
    from horaedb_tpu_torch.ops import merge_dedup as md

    out = md.sort_dedup(kind, words, masks, n_valid, dedup)
    perm, keep, passes = md.unpack(out, words[0].shape[0])
    _sync(torch)
    want = md._plain(kind, words, masks, n_valid, dedup)
    check(torch.equal(perm.cpu(), want[0].cpu()), f"{what}: perm differs from plain")
    check(torch.equal(keep.cpu(), want[1].cpu()), f"{what}: keep differs from plain")
    return int(passes.sum())


def _routing_cases(rng):
    """(name, tsid, ts, seq, kwargs, the kind the spans route to): the
    stress set, built as a merge builds it."""
    import numpy as np

    pool = np.sort(np.unique(rng.integers(0, 2**64, 1100, dtype=np.uint64))[:1000])
    n = 5003
    rank = rng.integers(0, 1000, n)
    cases = []
    key3 = rng.permutation(_distinct(rng, 1000 * (1 << 16) * 64, n))
    r3 = key3 // ((1 << 16) * 64)
    cases.append(("rk unique runs", pool[r3], (key3 // 64) % (1 << 16), (key3 % 64 + 1)
                  .astype(np.uint64), dict(tsid_rank=r3.astype(np.uint64), n_ranks=1000,
                                           unique=True), "rk"))
    for kind, ts_scale in (("f32", 1), ("f64", 2**31), ("gen", 2**62)):
        # heavy duplicate keys, and exact (key, seq) duplicates: 3 series,
        # 3 timestamps, 2 sequences
        tsid = pool[rng.integers(0, 3, n)]
        ts = rng.integers(-1, 2, n).astype(np.int64) * ts_scale
        seq = rng.integers(7, 9, n).astype(np.uint64)
        cases.append((f"{kind} duplicates", tsid, ts, seq, {}, kind))
    cases.append(("f32 wide", pool[rank], rng.integers(0, 2**20, n), rng.integers(
        1, 65, n).astype(np.uint64), {}, "f32"))
    cases.append(("f64 wide", pool[rank], rng.integers(0, 2**40, n), rng.integers(
        1, 65, n).astype(np.uint64), {}, "f64"))
    cases.append(("gen +-2**62, 64-bit seq", pool[rank], rng.integers(
        -(2**62), 2**62, n), rng.integers(0, 2**64, n, dtype=np.uint64), {}, "gen"))
    # a real row whose key words are all ones ties with the pads
    cases.append(("f32 all-ones row", np.array([5, 2**64 - 1, 9, 2**64 - 1], np.uint64),
                  np.array([3, 2**28 - 1, 0, 7]), np.array([15, 0, 1, 4], np.uint64), {},
                  "f32"))
    cases.append(("f64 all-ones row", np.array([5, 2**64 - 1, 9], np.uint64),
                  np.array([3, 2**60 - 1, 0]), np.array([15, 0, 1], np.uint64), {}, "f64"))
    cases.append(("gen extremes", np.array([0, 2**64 - 1, 2**63], np.uint64),
                  np.array([-(2**62), 2**62, 0]), np.array([1, 2, 3], np.uint64), {},
                  "gen"))
    return cases


def _replay_check(torch, kind, words, masks, n_valid, what) -> None:
    """One call twice on the same scratch: the second finds the first's
    words in it (status words and tile counters of the same passes, with
    the same tags); each answer bit-equal to the plain version."""
    from horaedb_tpu_torch.ops import merge_dedup as md

    held, orig = [], md._scratch

    def same(layout, dev):
        if not held:
            held.append(orig(layout, dev))
        return held[0]

    md._scratch = same
    try:
        for r in range(2):
            _merge_check(torch, kind, words, masks, n_valid, True, f"{what} replay {r}")
    finally:
        md._scratch = orig


def phase_merge_kernels(torch) -> None:
    import numpy as np

    from horaedb_tpu_torch.ops import merge_dedup as md

    check(md.TILE == 5120, f"MERGE_SIZES straddle a tile of 5120 rows, the kernel's is {md.TILE}")
    rng = np.random.default_rng(SEED)
    n_cases = 0
    passes: dict = {}
    for kind in md.KINDS:
        for n in MERGE_SIZES:
            if n > MERGE_PAD_MAX and kind != MERGE_LARGE_KIND:
                continue
            # the largest size once: unique keys, dedup
            for dup in (False, True) if n <= MERGE_PAD_MAX else (False,):
                cols, fills, masks = _kind_words(rng, kind, n, dup)
                for pad in (0, n // 3 + 1) if n <= MERGE_PAD_MAX else (0,):
                    words = _upload_words(torch, cols, fills, n, pad)
                    for dedup in (True, False) if n <= MERGE_PAD_MAX else (True,):
                        p = _merge_check(torch, kind, words, masks, n, dedup,
                                         f"merge {kind} n={n} pad={pad} dup={dup} "
                                         f"dedup={dedup}")
                        passes[f"{kind}/{n}/{'dup' if dup else 'uniq'}"] = p
                        n_cases += 1
        # keys constant in every digit, or varying only across the top bit
        # or a digit boundary: the skipped passes
        for what in ("const", "top", "boundary"):
            for pad in (0, 777):
                cols, fills, masks, want = _edge_words(kind, 3 * md.TILE + 7, what)
                words = _upload_words(torch, cols, fills, 3 * md.TILE + 7, pad)
                p = _merge_check(torch, kind, words, masks, 3 * md.TILE + 7, True,
                                 f"merge {kind} {what} pad={pad}")
                # (gen's pads vary word 0 and the fills' digits)
                check(DEV != "cuda" or (pad and kind == "gen") or p == want,
                      f"merge {kind} {what} pad={pad}: {p} passes, expected {want}")
                passes[f"{kind}/{what}"] = p
                n_cases += 1
        # n_valid 0: every row a pad
        cols, fills, masks = _kind_words(rng, kind, 0)
        words = _upload_words(torch, cols, fills, 0, 300)
        _merge_check(torch, kind, words, masks, 0, True, f"merge {kind} n_valid=0")
        # a replay on one scratch, at (1 << 20) + 13 rows
        cols, fills, masks = _kind_words(rng, kind, MERGE_PAD_MAX, True)
        words = _upload_words(torch, cols, fills, MERGE_PAD_MAX)
        _replay_check(torch, kind, words, masks, MERGE_PAD_MAX, f"merge {kind}")
        n_cases += 3
    # the stress set through the dispatcher: it reaches the kind its spans
    # route to (the counters), and agrees with the plain version
    counts = md.LAUNCHES if DEV == "cuda" else md.PLAIN_CALLS
    for name, tsid, ts, seq, kw, want_kind in _routing_cases(rng):
        ts = np.asarray(ts, np.int64)
        for dedup in (True, False):
            before = dict(counts)
            perm, keep = md.merge_dedup_dispatch(tsid, ts, seq, dedup=dedup, device=DEV,
                                                 **kw).get()
            ran = [k for k in md.KINDS if counts[k] != before[k]]
            check(ran == [want_kind], f"{name}: routed to {ran}, expected {want_kind}")
            kind, cols, masks = md.pack_inputs(tsid, ts, seq, **kw)
            words = _upload_words(torch, cols, None, len(tsid))
            want = md._plain(kind, words, masks, len(tsid), dedup)
            n = len(tsid)
            check(np.array_equal(perm, want[0][:n].cpu().numpy()), f"{name}: perm differs")
            check(np.array_equal(keep, want[1][:n].cpu().numpy()), f"{name}: keep differs")
            if dedup and "all-ones" in name:
                check(keep.all(), f"{name}: the all-ones row lost to a pad")
            n_cases += 1
    _sync(torch)
    n = MERGE_PAD_MAX
    say(f"merge kernels vs plain: {n_cases} cases bit-equal; radix passes taken at "
        f"n={n}: " + ", ".join(
            f"{k} {passes[f'{k}/{n}/uniq']}/{passes[f'{k}/{n}/dup']}" for k in md.KINDS)
        + f" (unique/dup), at n={MERGE_SIZES[-1]}: {MERGE_LARGE_KIND} "
        f"{passes[f'{MERGE_LARGE_KIND}/{MERGE_SIZES[-1]}/uniq']} (unique)")
    DETAIL["merge_cases"] = n_cases
    DETAIL["merge_case_passes"] = passes


# ---- phase 8: the main path of BASELINE config 5 -------------------------------

# BASELINE.json config 5: "analytic_engine L0->L1 compaction: 64 overlapping
# SSTs, 100M rows, k-way merge-dedup"; the table of bench.py's compaction
# config (1000 series in one 2 h segment window, seed 7).
COMPACTION_SSTS = 64
# cut from the config's 100M rows so the whole script ends well inside its
# time limit; the SSTs, series and collision share stay the config's
COMPACTION_ROWS = 40_000_000
COMPACTION_SERIES = 1000
COMPACTION_SEED = 7


class MergeRecorder:
    """Wraps the merge wrapper to keep the last main-path call of each
    kind (its device words, masks, n_valid and dedup), so the replay and
    the timings run the kernel on exactly the main path's inputs."""

    def __init__(self, md):
        self.md = md
        self.calls: dict = {}
        self.orig = md.sort_dedup

        def call(kind, words, masks, n_valid, dedup):
            self.calls[kind] = (words, masks, n_valid, dedup)
            return self.orig(kind, words, masks, n_valid, dedup)

        md.sort_dedup = call

    def restore(self) -> None:
        self.md.sort_dedup = self.orig


class Timers:
    """Inclusive wall seconds of the host stages of a merge, by patching
    the functions that do them; ``restore`` puts the originals back."""

    def __init__(self):
        self.seconds: dict = {}
        self._undo = []

    def wrap(self, owner, name: str, label: str) -> None:
        raw = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t

        setattr(owner, name, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
        self._undo.append((owner, name, raw))

    def take(self) -> dict:
        out, self.seconds = self.seconds, {}
        return out

    def restore(self) -> None:
        for owner, name, raw in reversed(self._undo):
            setattr(owner, name, raw)
        self._undo = []


def _merge_timers():
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.engine.compaction import Compactor
    from horaedb_tpu_torch.engine.sst.reader import SstReader
    from horaedb_tpu_torch.engine.sst.writer import SstStreamWriter
    from horaedb_tpu_torch.ops import merge_dedup as md

    t = Timers()
    t.wrap(SstReader, "read", "sst_read")
    t.wrap(RowGroup, "concat", "concat")
    t.wrap(Compactor, "_rank_tsids", "key_pack")
    t.wrap(md, "pack_ranked_key", "key_pack")
    t.wrap(md, "pack_composite", "key_pack")
    t.wrap(md, "pack_inputs", "key_pack")
    t.wrap(md, "stage", "stage_pinned")
    t.wrap(md, "_dispatch", "dispatch")
    t.wrap(md.MergeHandle, "get", "wait_device")
    t.wrap(RowGroup, "take", "take")
    t.wrap(SstStreamWriter, "append", "sst_encode")
    t.wrap(SstStreamWriter, "finalize", "sst_encode")
    t.wrap(SstStreamWriter, "upload", "sst_write")
    return t


def _build_compaction_table(rows_total: int):
    """BASELINE config 5's table (bench.py's _build_compaction_db, with
    each SST's (series, ts) keys drawn WITHOUT replacement, as a flushed
    SST holds them): COMPACTION_SSTS overlapping L0 runs in one window,
    written through the port's SstWriter and manifest. Returns the
    connection, the table and the generated rows (series index, ts step
    index, value; run i carries sequence i + 1)."""
    import numpy as np

    import horaedb_tpu_torch
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.common_types.dict_column import DictColumn
    from horaedb_tpu_torch.common_types.schema import compute_tsid
    from horaedb_tpu_torch.engine.instance import EngineConfig
    from horaedb_tpu_torch.engine.manifest import AddFile, Flushed
    from horaedb_tpu_torch.engine.sst.manager import FileHandle
    from horaedb_tpu_torch.engine.sst.writer import SstWriter, WriteOptions

    db = horaedb_tpu_torch.connect(None, device=DEV, engine_config=EngineConfig(
        compaction_l0_trigger=10**9, compaction_interval_s=0))
    db.execute("CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
               "ENGINE=Analytic WITH (segment_duration='2h')")
    table = db.catalog.open("demo").physical_datas()[0]
    seg_ms = table.options.segment_duration_ms
    n_per = rows_total // COMPACTION_SSTS
    rng = np.random.default_rng(COMPACTION_SEED)
    writer = SstWriter(table.store, WriteOptions(
        num_rows_per_row_group=table.options.num_rows_per_row_group,
        compression=table.options.compression))
    names_pool = np.array([f"host_{i}" for i in range(COMPACTION_SERIES)], dtype=object)
    tsid_pool = compute_tsid([names_pool])
    # the series in unsigned tsid order: keys drawn as (tsid rank, ts)
    # slots in ascending order are the (tsid, t) order an SST holds
    by_rank = np.argsort(tsid_pool)
    # ts from a pool sized so ~1/3 of keys collide across runs
    ts_space = max(1, (rows_total // COMPACTION_SERIES) * 3 // 4)
    ts_step = max(1, seg_ms // ts_space)
    check(ts_space * ts_step <= seg_ms, "the ts pool leaves the window")
    gen = {"sidx": np.empty(n_per * COMPACTION_SSTS, np.int32),
           "tsx": np.empty(n_per * COMPACTION_SSTS, np.int32),
           "value": np.empty(n_per * COMPACTION_SSTS, np.float64)}
    edits = []
    for i in range(COMPACTION_SSTS):
        keys = _distinct(rng, COMPACTION_SERIES * ts_space, n_per)
        sidx, tsx = by_rank[keys // ts_space].astype(np.int32), keys % ts_space
        value = rng.normal(10.0, 3.0, n_per)
        at = slice(i * n_per, (i + 1) * n_per)
        gen["sidx"][at], gen["tsx"][at], gen["value"][at] = sidx, tsx, value
        # already (tsid, t)-sorted; the tag as the engine holds it (codes
        # into the names), which parquet writes without per-row objects
        rows = RowGroup(table.schema, {
            "tsid": tsid_pool[sidx], "t": (tsx * ts_step).astype(np.int64),
            "name": DictColumn(sidx, names_pool), "value": value,
        })
        fid = table.alloc_file_id()
        path = table.sst_object_path(fid)
        meta = writer.write(path, fid, rows, max_sequence=i + 1)
        edits.append(AddFile(0, meta, path))
        table.version.levels.add_file(0, FileHandle(meta, path, 0))
    edits.append(Flushed(COMPACTION_SSTS))
    table.manifest.append_edits(edits)
    table.version.flushed_sequence = COMPACTION_SSTS
    gen.update(tsid_pool=tsid_pool, ts_space=ts_space, ts_step=ts_step, n_per=n_per)
    return db, table, gen


def _expected_merge(gen) -> dict:
    """Independent merge of the generated rows: a dense table over every
    (series, ts) key written run by run (later runs overwrite), read in
    (tsid, t) order. The survivors' series, ts and value."""
    import numpy as np

    tsid_pool, ts_space, n_per = gen["tsid_pool"], gen["ts_space"], gen["n_per"]
    # unsigned tsid order of the series
    rank = np.empty(COMPACTION_SERIES, np.int64)
    rank[np.argsort(tsid_pool)] = np.arange(COMPACTION_SERIES)
    slot = rank[gen["sidx"]] * ts_space + gen["tsx"]
    winner = np.full(COMPACTION_SERIES * ts_space, -1, np.int64)
    for i in range(COMPACTION_SSTS):
        at = slice(i * n_per, (i + 1) * n_per)
        winner[slot[at]] = np.arange(at.start, at.stop)
    surv = winner[winner >= 0]
    sidx = gen["sidx"][surv]
    return {"tsid": tsid_pool[sidx], "t": gen["tsx"][surv].astype(np.int64) * gen["ts_step"],
            "value": gen["value"][surv], "sidx": sidx}


def _check_select(name, got, exp) -> None:
    import numpy as np

    check(len(got) == 1 and got[0]["c"] == len(exp["value"]),
          f"{name}: count {got} vs {len(exp['value'])}")
    v = exp["value"].astype(np.float32).astype(np.float64)
    mean, scale = v.mean(), np.abs(v).mean()
    check(abs(got[0]["v"] - mean) <= SUM_RTOL * scale, f"{name}: avg {got[0]['v']} vs {mean}")


def phase_compaction(torch, rows_total: int) -> dict:
    """BASELINE config 5 through the port's entry points: the read merge
    of 64 overlapping SSTs (SELECT), Compactor.compact(), the SELECT again,
    and a GROUP BY, each checked against the independent merge."""
    import numpy as np

    from horaedb_tpu_torch.engine.compaction import Compactor, merge_chunk_count
    from horaedb_tpu_torch.engine.sst.reader import SstReader
    from horaedb_tpu_torch.ops import merge_dedup as md

    t0 = time.perf_counter()
    db, table, gen = _build_compaction_table(rows_total)
    t_build = time.perf_counter() - t0
    n_input = sum(h.meta.num_rows for h in table.version.levels.files_at(0))
    check(n_input == rows_total, f"{n_input} input rows")
    t = time.perf_counter()
    exp = _expected_merge(gen)
    t_exp = time.perf_counter() - t
    del gen
    n_surv = len(exp["value"])
    say(f"config 5: {COMPACTION_SSTS} L0 SSTs x {rows_total // COMPACTION_SSTS} rows "
        f"built in {t_build:.1f} s; independent merge {t_exp:.1f} s: {n_surv} survivors")
    Compactor(table).warm_device_merge()
    rec = MergeRecorder(md)
    timers = _merge_timers()
    _sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    md.reset_counts()  # the main path's merge launches start here
    out = {"rows": rows_total, "ssts": COMPACTION_SSTS, "survivors": n_surv}
    sql = "SELECT count(1) AS c, avg(value) AS v FROM demo"
    try:
        t = time.perf_counter()
        got = db.execute(sql).to_pylist()
        out["select_before_s"] = time.perf_counter() - t
        out["select_before_split_s"] = timers.take()
        _check_select("select before compaction", got, exp)
        out["launches_read"] = dict(md.LAUNCHES if DEV == "cuda" else md.PLAIN_CALLS)
        read_calls = dict(rec.calls)
        rec.calls = {}
        t = time.perf_counter()
        res = Compactor(table).compact()
        out["compact_s"] = time.perf_counter() - t
        out["compact_split_s"] = timers.take()
        launches = dict(md.LAUNCHES if DEV == "cuda" else md.PLAIN_CALLS)
        out["launches"] = launches
        out["launches_compact"] = {k: launches[k] - out["launches_read"][k] for k in md.KINDS}
        compact_calls = dict(rec.calls)
        t = time.perf_counter()
        got = db.execute(sql).to_pylist()
        out["select_after_s"] = time.perf_counter() - t
        _check_select("select after compaction", got, exp)
        got = db.execute("SELECT name, count(1) AS c, max(t) AS m FROM demo "
                         "GROUP BY name").to_pylist()
        timers.take()
    finally:
        timers.restore()
        rec.restore()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    check(out["launches_read"]["f32"] >= 1, f"the read merge never ran f32: {out['launches_read']}")
    n_chunks = merge_chunk_count(rows_total)
    check(out["launches_compact"]["rk"] == n_chunks and sum(out["launches_compact"].values())
          == n_chunks, f"compaction launches {out['launches_compact']}, expected {n_chunks} rk")
    if DEV == "cuda":
        check(not any(md.PLAIN_CALLS.values()), f"plain versions ran on the card: {md.PLAIN_CALLS}")
    # GROUP BY name against the survivors
    cnt = np.bincount(exp["sidx"], minlength=COMPACTION_SERIES)
    mx = np.full(COMPACTION_SERIES, -1, np.int64)
    np.maximum.at(mx, exp["sidx"], exp["t"])
    check(len(got) == int((cnt > 0).sum()), f"group by: {len(got)} groups")
    for r in got:
        i = int(r["name"][5:])
        check(r["c"] == cnt[i] and r["m"] == mx[i], f"group by {r['name']}: {r}")
    # the L1 SSTs: rows_written survivors, globally (tsid, t)-sorted, equal
    # to the independent merge
    check(res.rows_written == n_surv, f"rows_written {res.rows_written} vs {n_surv}")
    files = table.version.levels.files_at(1)
    check(len(table.version.levels.files_at(0)) == 0 and len(files) == 1,
          f"L0 {len(table.version.levels.files_at(0))} files, L1 {len(files)} files")
    back = SstReader(table.store, files[0].path).read(table.schema,
                                                      projection=["tsid", "t", "value"])
    tsid, ts, value = back.columns["tsid"], back.timestamps, back.columns["value"]
    check(np.array_equal(tsid, exp["tsid"]) and np.array_equal(ts, exp["t"]),
          "L1 (tsid, t) differ from the independent merge")
    check(np.array_equal(value, exp["value"]), "L1 values differ from the independent merge")
    out["input_rows_per_s"] = rows_total / out["compact_s"]
    say(f"config 5: select before {out['select_before_s']:.2f} s, compact "
        f"{out['compact_s']:.2f} s ({out['input_rows_per_s']:.0f} input rows/s), "
        f"select after {out['select_after_s']:.2f} s; launches read {out['launches_read']}, "
        f"compaction {out['launches_compact']}; peak device memory {out['peak_bytes']} B")
    say(f"  select split (inclusive host s): {_rounded(out['select_before_split_s'])}")
    say(f"  compact split (inclusive host s): {_rounded(out['compact_split_s'])}")
    DETAIL["compaction"] = out
    db.close()
    return {"out": out, "read_calls": read_calls, "compact_calls": compact_calls}


def _rounded(d: dict) -> dict:
    return {k: round(v, 3) for k, v in d.items()}


# ---- phase 9: merge replay and timings ----------------------------------------


def phase_merge_replay(torch, comp) -> dict:
    """The last main-path call of each kind that ran (the read merge's
    f32, the last compaction chunk's rk), the kernel against its plain
    version on the same tensors: bit-equal."""
    calls = {**comp["compact_calls"], **comp["read_calls"]}
    passes = {}
    for kind, (words, masks, n_valid, dedup) in calls.items():
        check(words[0].shape[0] == n_valid, f"main path {kind}: {words[0].shape[0]} rows "
              f"staged for {n_valid} real rows")
        passes[kind] = _merge_check(torch, kind, words, masks, n_valid, dedup,
                                    f"main path {kind} replay")
        say(f"main path {kind} ({words[0].shape[0]} rows, {n_valid} real): kernel = plain, "
            f"{passes[kind]} radix passes")
    DETAIL["merge_replay_passes"] = passes
    return passes


MERGE_KERNELS = ("Memset", "init_hist", "plan_passes", "sort_pass", "epilogue")


def _family_device_ms(torch, fn, names, reps=5, label=None, flush=None, lead=0):
    """Mean device ms of one call of ``fn``: the sum of its kernels (every
    event whose kernel name, without its signature and template arguments,
    is one of ``names``; a memset is "Memset", a copy from the host "HtoD")
    on the profiler's device timeline; None without
    CUPTI tracing or when two traces record none of them. With ``label``,
    the window's mean ms a call of each kernel goes to
    DETAIL["device_ms_windows"] and to the phase's output, with the
    launches a call of each; ``flush`` evicts L2 before each call.
    ``lead`` one-element fills run first in the traced window, so that
    records a trace loses at its start fall on them, not on the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    pad = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    for _ in range(2):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(lead):
                    pad.zero_()
                for _ in range(reps):
                    if flush is not None:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:
            say(f"profiler unavailable ({e}); times from CUDA events")
            return None
        split: dict = {}
        count: dict = {}
        for e in prof.events():
            # "void name<args, ...>(params)": the name without its template
            # arguments, whose ", " would split it
            base = e.name.split("(")[0].split("<")[0].strip().split(" ")[-1]
            if base in names:
                split[base] = split.get(base, 0.0) + e.time_range.elapsed_us() / reps / 1e3
                count[base] = count.get(base, 0) + 1 / reps
        if split:
            if label is not None:
                DETAIL.setdefault("device_ms_windows", []).append(
                    {"name": label, "ms_a_call": split, "launches_a_call": count})
                say(f"  device ms a call of {label}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in split.items()))
            return sum(split.values())
        say(f"the profiler recorded none of {names} in {reps} calls")
    return None


def _merge_bound(words, n_valid, kind) -> tuple[float, int]:
    """Least time of the function: the real rows' key words read once, and
    their perm (4 B) and keep (1 B) written once, over HBM. The pads of the
    bucket are padding, not work (callers cut the outputs to the real
    rows): rk/f32/f64 hold ``n_valid`` real rows, gen those with is_pad 0."""
    n_real = int((words[0] == 0).sum()) if kind == "gen" else n_valid
    nbytes = (4 * len(words) + 5) * n_real
    return nbytes / PEAK_BYTES_S * 1e3, nbytes


def _merge_design_bytes(kind, words, masks, n_valid, ran) -> int:
    """Bytes the sort's design moves for this call (ops/csrc/merge_dedup.cu),
    each array read or written once where the design touches it: init_hist
    reads the key words of the sorted rows; each pass that ran (``ran``, a
    flag a pass) reads the arrays it carries (the first from the input, its
    row index made, not read) and writes them with the index, and writes
    its look-back words; the epilogue reads the sorted index and each word
    the compare sees (gen's is_pad too; a dropped word gathered, 4 B), and
    writes perm and keep. The memset of the look-back words beside."""
    from horaedb_tpu_torch.ops import merge_dedup as md

    n_words, n = len(words), words[0].shape[0]
    n_sort = md.sort_rows(kind, n, n_valid)
    dpw = md.DIGITS_PER_WORD
    status = 8 * md.RADIX * -(-n_sort // md.TILE)

    def dropped(w):  # as the kernel's dropped()
        return w > 0 and sum(ran[(n_words - w) * dpw:]) >= md.DROP_AFTER

    total, first = 4 * n_words * n_sort + status, True
    for p, r in enumerate(ran):
        if not r:
            continue
        word = n_words - 1 - p // dpw
        carried = sum(1 for w in range(n_words) if w <= word or not dropped(w))
        total += (4 * carried + (0 if first else 4) + 4 * (carried + 1)) * n_sort + 2 * status
        first = False
    seen = sum(1 for m in masks if int(m) & U32) + (kind == "gen")
    return total + (4 + 4 * seen) * n_sort + 5 * n


def phase_merge_timings(torch, comp, replay_passes, card) -> list:
    import numpy as np

    from horaedb_tpu_torch.ops import merge_dedup as md

    out = comp["out"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    calls = {**comp["compact_calls"], **comp["read_calls"]}
    # f64 and gen do not run on this path (its spans fit f32 and rk):
    # time them at a compaction chunk's shape
    rng = np.random.default_rng(SEED + 1)
    chunk_rows = calls["rk"][2]
    for kind in ("f64", "gen"):
        cols, fills, masks = _kind_words(rng, kind, chunk_rows)
        calls[kind] = (_upload_words(torch, cols, fills, chunk_rows), masks, chunk_rows, True)
        replay_passes[kind] = _merge_check(torch, kind, *calls[kind], f"{kind} at chunk shape")
    kernels = []
    for kind in md.KINDS:
        words, masks, n_valid, dedup = calls[kind]
        n = words[0].shape[0]
        launch = lambda k=kind, w=words, m=masks, v=n_valid, d=dedup: md.sort_dedup(k, w, m, v, d)  # noqa: E731
        plain = lambda k=kind, w=words, m=masks, v=n_valid, d=dedup: md._plain(k, w, m, v, d)  # noqa: E731
        queued_ms, hidden = _queued_ms(torch, launch, reps=5, flush=flush)
        # 64 fills lead the trace: late in this script a trace has lost its
        # first 24-27 kernel records (whole calls of the sort)
        device_ms = _family_device_ms(torch, launch, MERGE_KERNELS, flush=flush, lead=64,
                                      label=f"merge_dedup[{kind}]")
        window = DETAIL["device_ms_windows"][-1] if device_ms is not None else {}
        launches_a_call = round(sum(window.get("launches_a_call", {}).values()), 2)
        # a trace that missed some of a call's kernels undercounts the call:
        # then the time is the events' around calls queued behind a sleep
        timed_by = "profiler, L2 flushed"
        if launches_a_call != md.launches_of(kind):
            say(f"  the trace holds {launches_a_call} of {md.launches_of(kind)} kernels a "
                "call: the time by CUDA events around calls queued behind a sleep")
            device_ms = None
            timed_by = "events behind a sleep, L2 flushed"
            check(hidden, f"merge_dedup[{kind}]: the host queued a call slower than the "
                  "card slept, so the events would time the host")
        ms = device_ms if device_ms is not None else queued_ms
        plain_ms = _time_launch(torch, plain, reps=2, flush=flush)
        lib_ms = None
        if kind == "rk":
            # one library call computes rk: a stable sort of the int64
            # composite of the real rows (below 2**63), then the compare
            comp64 = ((words[0][:n_valid].long() & U32) << 32) | (words[1][:n_valid].long() & U32)
            mask64 = (int(masks[0]) << 32) | int(masks[1])
            mask64 -= (1 << 64) if mask64 >= 1 << 63 else 0  # the same bits as int64

            def lib(c=comp64, m=mask64):
                s = torch.sort(c, stable=True)
                k = s.values & m
                return s.indices, torch.cat([k[:1] == k[:1], k[1:] != k[:-1]])

            lib_ms = _time_launch(torch, lib, reps=5, flush=flush)
        bound_ms, nbytes = _merge_bound(words, n_valid, kind)
        ran = md.unpack(launch(), n)[2][:md.passes_of(kind)].cpu().tolist()
        design_bytes = _merge_design_bytes(kind, words, masks, n_valid, ran)
        design_ms = design_bytes / PEAK_BYTES_S * 1e3
        # H2D of the words and D2H of the packed result, pinned, as the
        # dispatcher moves them: the n staged rows
        up_bytes, down_bytes = 4 * len(words) * n, 5 * n + md.MAX_PASSES
        host_in = torch.empty((len(words), n), dtype=torch.int32, pin_memory=True)
        up_ms = _time_launch(torch, lambda h=host_in: h.to("cuda", non_blocking=True), reps=3)
        dev_out = torch.empty(5 * n + md.MAX_PASSES, dtype=torch.uint8, device="cuda")
        host_out = torch.empty_like(dev_out, device="cpu").pin_memory()
        down_ms = _time_launch(torch, lambda: host_out.copy_(dev_out, non_blocking=True),
                               reps=3)
        launches = out["launches"][kind]
        kernels.append({
            "name": f"merge_dedup[{kind}]", "route": "cuda", "source": MERGE_SRC,
            "replaces": MERGE_REPLACES[kind], "launches": int(launches), "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms,
        })
        DETAIL.setdefault("merge_timings", {})[kind] = {
            "rows": n, "n_valid": n_valid, "passes": replay_passes[kind],
            "passes_of_kind": md.passes_of(kind), "launches_a_call": launches_a_call,
            "queued_ms": queued_ms, "queued_hidden": hidden,
            "device_ms": device_ms, "timed_by": timed_by, "upload_bytes": up_bytes,
            "upload_ms": up_ms, "download_bytes": down_bytes, "download_ms": down_ms,
            "bound_bytes": nbytes, "design_bytes": design_bytes, "design_floor_ms": design_ms,
        }
        say(f"kernel merge_dedup[{kind}] at {n} rows ({n_valid} real, "
            f"{replay_passes[kind]} of {md.passes_of(kind)} radix passes of "
            f"{md.DIGIT_BITS} bits, {launches_a_call} kernel launches a call, {launches} "
            f"main-path calls): {ms:.4f} ms ({timed_by}; {queued_ms:.4f} ms by events behind "
            f"a sleep), plain {plain_ms:.4f} ms, library "
            f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}, bound {bound_ms:.4f} ms "
            f"({nbytes} B); the design's traffic floor {design_ms:.4f} ms ({design_bytes} B); "
            f"upload {up_bytes} B in {up_ms:.4f} ms, download {down_bytes} B in "
            f"{down_ms:.4f} ms [{card}]")
    return kernels


# ---- phase 10: the live-window fold and gather against their plain versions ----

LW_SRC = "horaedb_tpu_torch/ops/csrc/livewindow.cu"
LW_REPLACES = {"fold": "horaedb_tpu/ops/livewindow.py:45",
               "gather": "horaedb_tpu/ops/livewindow.py:64"}
LW_DEPTHS = (8, 128)
LW_CAPS = (64, 4096)
LW_ROWS = (0, 1, 4000, 24_000, 1 << 20)
LW_GATHER_N = (1, 60, 128)
# group columns a gather reads, by cap: the whole ring, a half plus one, and
# at cap 4096 widths off 16 bytes (1, 3, 4001) and the main path's 4000
LW_GATHER_G = {64: (64, 33), 4096: (4096, 2049, 1, 3, 4000, 4001)}
# groups of states folded in one launch: (depth, cap, rows, one cell, reset,
# pairs) a state; cpu-live's five states at a head advance, mixed shapes
# with a state of no rows, and more states than one launch carries
LW_GROUPS = (
    [(128, 4096, 4000, False, "one", False)] * 5,
    [(8, 64, 4000, False, "one", True), (128, 4096, 24_000, True, "all", False),
     (16, 64, 0, False, "one", False), (128, 64, 1 << 20, True, "none", True),
     (8, 4096, 1, False, "all", True)],
    [(8, 64, 300, False, ("none", "one", "all")[i % 3], i % 2 == 0) for i in range(33)],
)


def _lw_batch(rng, depth, cap, n, one_cell, reset, pairs):
    """One fold's host inputs: rows on distinct cells (cycling through
    every cell) or all on one cell, with +-0 values, a masked row
    (slot == depth), negative indices that wrap and out-of-range ones that
    drop mixed in; the reset mask names no slot, one or all; pairs on the
    first half of the rows' cells, or none."""
    import numpy as np

    cells = depth * cap
    if one_cell:
        cell = np.full(n, int(rng.integers(cells)), dtype=np.int64)
    else:
        cell = rng.permutation(cells)[np.arange(n) % cells]
    slot = (cell // cap).astype(np.int32)
    grp = (cell % cap).astype(np.int32)
    val = rng.normal(0.0, 100.0, n).astype(np.float32)
    if n >= 16:
        val[:4] = (-0.0, 0.0, 0.0, -0.0)
        slot[4] = depth        # masked: dropped
        slot[5] -= depth       # wraps back to its slot
        grp[6] -= cap          # wraps back to its group
        slot[7] = -depth - 1   # dropped
        grp[8] = cap           # dropped
    mask = np.zeros(depth, dtype=np.bool_)
    if reset == "one":
        mask[int(slot[0]) % depth if n else 0] = True
    elif reset == "all":
        mask[:] = True
    m = n // 2 if pairs else 0
    pd = np.abs(rng.normal(0.0, 10.0, m)).astype(np.float32)
    return mask, slot, grp, val, slot[:m].copy(), grp[:m].copy(), pd


def _lw_words(torch, batch):
    """``pack_fold``'s words of a host batch, on the card."""
    from horaedb_tpu_torch.ops import livewindow as L

    words, r, n, m = L.pack_fold(*batch)
    return torch.from_numpy(words).to(DEV), r, n, m


def _lw_abs_words(torch, words, r, n, m):
    """The same words with |val| and |delta|: folded by the plain version
    into |ring|, they give each cell's scale for the sum tolerance."""
    w = words.clone()
    for lo, k in ((r + 2 * n, n), (r + 3 * n + 2 * m, m)):
        w[lo:lo + k] &= 0x7FFFFFFF
    return w


def _bits(torch, t):
    t = t.clone()
    t[torch.isnan(t)] = float("nan")
    return t.view(torch.int32)


def _lw_compare(torch, got, want, scale, what) -> float:
    """A folded ring against the plain version's: counts, mins and maxs
    bit-equal, sums and counter increments within SUM_RTOL of the |x|
    ring ``scale``. Returns the largest |sum or increment difference|."""
    from horaedb_tpu_torch.ops import livewindow as L

    gp, wp, sp = L.planes(got), L.planes(want), L.planes(scale)
    check(torch.equal(gp[0], wp[0]), f"{what}: counts differ")
    check(torch.equal(_bits(torch, gp[2]), _bits(torch, wp[2])), f"{what}: mins differ")
    check(torch.equal(_bits(torch, gp[3]), _bits(torch, wp[3])), f"{what}: maxs differ")
    err = 0.0
    for k, name in ((1, "sums"), (4, "inc")):
        d = (gp[k].double() - wp[k].double()).abs()
        check(not bool((d > SUM_RTOL * sp[k].double()).any()),
              f"{what}: {name} differ beyond {SUM_RTOL} of sum|x|")
        err = max(err, float(d.max()))
    return err


def _lw_group_check(torch, bases, words, spans, what) -> float:
    """One fold of a group (``pack_group``'s words on the card, its spans)
    against the plain version state by state, on clones of the rings: as
    ``_lw_compare``, each state's scale |the cell before| + the sum of |x|
    folded into it. Returns the largest |sum or increment difference|."""
    from horaedb_tpu_torch.ops import livewindow as L

    got = [b.clone() for b in bases]
    L.fold_group(got, words, spans)
    err = 0.0
    for i, (base, (at, r, n, m)) in enumerate(zip(bases, spans)):
        want, scale = base.clone(), base.clone()
        for k in (1, 4):
            scale[k] &= 0x7FFFFFFF
        w = words[at:at + r + 3 * n + 3 * m]
        L.fold_plain(want, w, r, n, m)
        L.fold_plain(scale, _lw_abs_words(torch, w, r, n, m), r, n, m)
        _sync(torch)
        err = max(err, _lw_compare(torch, got[i], want, scale, f"{what} state {i}"))
    return err


def _lw_fold_check(torch, base, words, r, n, m, what) -> float:
    """The fold kernel against its plain version on one state (a group of
    one: its two barrier words, then ``pack_fold``'s words)."""
    group = torch.cat([torch.zeros(2, dtype=torch.int32, device=words.device), words])
    return _lw_group_check(torch, [base], group, [(2, r, n, m)], what)


def _lw_gather_check(torch, rings, idx, g, what) -> float:
    """The gather kernel against its plain version: bit-equal words.
    Returns the largest |difference| of the five planes' values (0 where
    the words agree, inf where one side is not finite and they differ)."""
    from horaedb_tpu_torch.ops import livewindow as L

    got = L.gather(rings, idx, g)
    want = L.gather_plain(rings, idx, g)
    _sync(torch)

    def values(w):
        return torch.cat([w[:1].double(), w[1:].view(torch.float32).double()])

    d = (values(got) - values(want)).abs().nan_to_num(nan=float("inf"))
    d = torch.where(got == want, torch.zeros_like(d), d)
    err = float(d.max()) if d.numel() else 0.0
    check(torch.equal(got, want), f"{what}: gather differs from plain (max |diff| {err})")
    return err


def _lw_odd_rings(torch, base):
    """Two copies of ``base`` the gather's 16-byte path must not take: its
    first cap - 3 group columns (a cap off 16 bytes, sliced from the wider
    ring), and the whole ring at a base 4 bytes past a 16-byte boundary."""
    narrow = base[:, :, :base.shape[2] - 3].contiguous()
    flat = torch.empty(base.numel() + 1, dtype=torch.int32, device=base.device)
    shifted = flat[1:].view(base.shape)
    shifted.copy_(base)
    return (("sliced", narrow), ("shifted", shifted))


def _lw_gather_cases(torch, rng, base, what) -> tuple[float, int]:
    """``base`` gathered at every width of ``LW_GATHER_G`` and every count
    of ``LW_GATHER_N`` (from 4 slots on, slots past depth and below zero),
    and its odd copies (``_lw_odd_rings``) at their widest width and the
    main path's; each against the plain version. Returns the largest
    |difference| and the cases."""
    import numpy as np

    depth, cap = int(base.shape[1]), int(base.shape[2])
    err, cases = 0.0, 0
    rings = [("", base, LW_GATHER_G[cap])]
    rings += [(f" {name}", r, sorted({int(r.shape[2]), min(4000, int(r.shape[2]))}))
              for name, r in _lw_odd_rings(torch, base)]
    for label, ring, widths in rings:
        for g in widths:
            for nq in LW_GATHER_N:
                idx = rng.integers(0, depth, nq).astype(np.int32)
                if nq >= 4:
                    idx[:4] = (depth, depth + 7, -1, -depth - 3)
                err = max(err, _lw_gather_check(
                    torch, ring, torch.from_numpy(idx).to(base.device), g,
                    f"{what}{label} cap {int(ring.shape[2])} n {nq} g {g}"))
                cases += 1
    return err, cases


def phase_lw_kernels(torch) -> float:
    """Fold and gather on CUDA rings against their plain versions over
    depth x cap x rows x {distinct cells, one cell} x reset x pairs, and
    gathers at every width of ``LW_GATHER_G`` (also on a ring sliced to a
    cap off 16 bytes and one at a base off 16 bytes) with out-of-range
    slots. Returns the largest |sum diff|."""
    import numpy as np

    from horaedb_tpu_torch.ops import livewindow as L

    rng = np.random.default_rng(SEED + 2)
    n_cases, err, gather_err = 0, 0.0, 0.0
    t0 = time.perf_counter()
    for depth in LW_DEPTHS:
        for cap in LW_CAPS:
            base = L.alloc_rings(depth, cap, DEV)
            warm = _lw_batch(rng, depth, cap, 2 * depth * cap, False, "none", True)
            L.fold_plain(base, *_lw_words(torch, warm))  # a ring with values in it
            for n in LW_ROWS:
                for one_cell in (False, True):
                    for reset in ("none", "one", "all"):
                        for pairs in (False, True):
                            what = (f"fold depth {depth} cap {cap} rows {n} "
                                    f"{'one cell' if one_cell else 'distinct'} reset {reset} "
                                    f"pairs {pairs}")
                            batch = _lw_batch(rng, depth, cap, n, one_cell, reset, pairs)
                            err = max(err, _lw_fold_check(torch, base, *_lw_words(torch, batch),
                                                          what))
                            n_cases += 1
            e, cases = _lw_gather_cases(torch, rng, base, f"gather depth {depth}")
            gather_err = max(gather_err, e)
            n_cases += cases
    for g, states in enumerate(LW_GROUPS):
        bases, batches = [], []
        for depth, cap, n, one_cell, reset, pairs in states:
            base = L.alloc_rings(depth, cap, DEV)
            L.fold_plain(base, *_lw_words(torch, _lw_batch(rng, depth, cap, 2 * cap, False,
                                                           "none", True)))
            bases.append(base)
            batches.append(_lw_batch(rng, depth, cap, n, one_cell, reset, pairs))
        words, spans = L.pack_group(batches)
        err = max(err, _lw_group_check(torch, bases, torch.from_numpy(words).to(DEV), spans,
                                       f"group {g} of {len(states)} states"))
        n_cases += 1
    say(f"live-window kernels vs plain: {n_cases} cases passed in "
        f"{time.perf_counter() - t0:.1f} s; max |sum diff| {err}; gather max |diff| "
        f"{gather_err}")
    DETAIL["lw_kernel_cases"] = n_cases
    DETAIL["lw_kernel_max_abs_err"] = err
    DETAIL["lw_gather_max_abs_err"] = gather_err
    return err


# ---- phase 11: the live window's main path at 4000 hosts --------------------

LW_FIELDS = 5                    # per-field panels: the first five cpu fields
LW_HISTORY_MIN = 60              # one hour written before promotion
LW_LIVE_COMMITS = 540            # 90 min of 10 s scrapes, one commit each: 150 min > 128
LW_LATE_AT = 350                 # after this commit: a batch 30 min back (in the ring)
LW_OLD_AT = 450                  # after this commit: a batch 130 min back (below the tail)
LW_CHECKPOINTS = (1, 30, 61, 90)  # refresh minutes also rescanned
# commits [lo, hi) traced for the device's idle share: minutes 69-71, and
# minutes 71-73 only where the first trace kept no record of the path
LW_TRACE = ((414, 426), (426, 438))
LW_TRACE_LEAD = 128  # device spins opening a traced window (see _device_busy_ms)
LW_T0 = 1_786_000_000_000 // 3_600_000 * 3_600_000  # the simulated clock's start


class _Cells:
    """Independent answers of the panels: per (minute, host) count, and per
    field the sum and sum of |x| (float64 over the float32 values the
    columns and rings hold), min and max."""

    def __init__(self, minutes, hosts, fields):
        import numpy as np

        shape = (minutes, hosts)
        self.count = np.zeros(shape, np.int64)
        self.sum = {f: np.zeros(shape) for f in fields}
        self.abs = {f: np.zeros(shape) for f in fields}
        self.min = {f: np.full(shape, np.inf, np.float32) for f in fields}
        self.max = {f: np.full(shape, -np.inf, np.float32) for f in fields}

    def add(self, rows, host_ids):
        import numpy as np

        at = ((rows.columns["ts"] - LW_T0) // 60_000, host_ids)
        np.add.at(self.count, at, 1)
        for f in self.sum:
            v = rows.columns[f].astype(np.float32)
            np.add.at(self.sum[f], at, v.astype(np.float64))
            np.add.at(self.abs[f], at, np.abs(v).astype(np.float64))
            np.minimum.at(self.min[f], at, v)
            np.maximum.at(self.max[f], at, v)

    def check(self, res, f, mi_lo, host_index, what):
        """A panel's answer over minutes >= mi_lo equals these cells."""
        import numpy as np

        mi = (res.column("minute").astype(np.int64) - LW_T0) // 60_000
        host = np.fromiter(map(host_index.__getitem__, res.column("hostname")), np.int64,
                           count=res.num_rows)
        want = int((self.count[mi_lo:] > 0).sum())
        check(res.num_rows == want, f"{what}: {res.num_rows} rows, expected {want}")
        check(bool((mi >= mi_lo).all()), f"{what}: a row before the window")
        check(np.unique(mi * len(host_index) + host).size == res.num_rows, f"{what}: duplicates")
        c = res.column("c").astype(np.int64)
        check(np.array_equal(c, self.count[mi, host]), f"{what}: counts differ")
        check(np.array_equal(res.column("mn").astype(np.float32), self.min[f][mi, host]),
              f"{what}: mins differ")
        check(np.array_equal(res.column("mx").astype(np.float32), self.max[f][mi, host]),
              f"{what}: maxs differ")
        scale = self.abs[f][mi, host]
        d = np.abs(res.column("s").astype(np.float64) - self.sum[f][mi, host])
        check(bool((d <= SUM_RTOL * scale).all()), f"{what}: sums differ")
        d = np.abs(res.column("a").astype(np.float64) - self.sum[f][mi, host] / c)
        check(bool((d <= SUM_RTOL * scale / c).all()), f"{what}: avgs differ")
        return float(np.max(d)) if len(d) else 0.0


def _lw_panel(field: str, start: int) -> str:
    return (f"SELECT time_bucket(ts, '1m') AS minute, hostname, count({field}) AS c, "
            f"sum({field}) AS s, min({field}) AS mn, max({field}) AS mx, avg({field}) AS a "
            f"FROM cpu WHERE ts >= {start} GROUP BY time_bucket(ts, '1m'), hostname")


def _device_busy_ms(prof) -> tuple[float, int, int]:
    """The union of the device intervals (kernels, copies, memsets) of a
    profiler trace, in ms, how many there were, and how many lead spins
    (``torch.cuda._sleep``'s ``spin_kernel``) it kept. The spins open the
    window so that the records a trace loses at its start (24 to all 54 of
    this window's in runs on an H100) fall on them; they are not counted."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if "spin_kernel" not in e.name)
    n_lead = len(events) - len(spans)
    busy_us, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            if hi is not None:
                busy_us += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy_us += hi - lo
    return busy_us / 1e3, len(spans), n_lead


class LwRecorder:
    """Wraps the live-window wrappers and the store's write hook during the
    main path: keeps the last grouped fold with a reset and without one,
    the last gather (for the replay and the timings), and the host seconds
    of every write hook and of the launch path inside it."""

    def __init__(self):
        from horaedb_tpu_torch.ops import livewindow as L
        from horaedb_tpu_torch.state import livewindow as S

        self.L, self.S = L, S
        self.orig = (L.fold_group, L.gather, L.fold_batches)
        self.calls: dict = {}
        self.fold_s = self.launch_s = 0.0
        orig_group, orig_gather, orig_batches = self.orig
        orig_hook = S.STORE._fold_committed

        def fold_group(rings_list, words, spans):
            orig_group(rings_list, words, spans)
            reset = any(r for _, r, _, _ in spans)
            self.calls["fold_reset" if reset else "fold"] = (list(rings_list), words, spans)

        def fold_batches(rings_list, batches):
            t = time.perf_counter()
            orig_batches(rings_list, batches)
            self.launch_s += time.perf_counter() - t

        def gather(rings, idx, g):
            self.calls["gather"] = (rings, idx, g)
            return orig_gather(rings, idx, g)

        def hook(table_data, rows):
            t = time.perf_counter()
            orig_hook(table_data, rows)
            self.fold_s += time.perf_counter() - t

        L.fold_group, L.gather, L.fold_batches = fold_group, gather, fold_batches
        S.STORE._fold_committed = hook

    def restore(self):
        self.L.fold_group, self.L.gather, self.L.fold_batches = self.orig
        del self.S.STORE._fold_committed


def phase_lw_main(torch) -> dict:
    """Five per-field open-tail panels over the TSBS cpu table at 4000
    hosts: one hour of history, promotion at the default knobs, 90 minutes
    of live commits (the 128-bucket ring rolls over), one late batch in the
    ring and one below its tail, a refresh of every panel each simulated
    minute. Every answer equals the independent cells; at the checkpoints
    the kill-switch rescan gives the same."""
    import numpy as np

    import horaedb_tpu_torch
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.ops import livewindow as L
    from horaedb_tpu_torch.state import livewindow as S
    from horaedb_tpu_torch.tools import tsbs

    fields = tsbs.CPU_FIELDS[:LW_FIELDS]
    S.STORE.clear()
    db = horaedb_tpu_torch.connect(None, device=DEV)
    db.execute(_cpu_table_sql(tsbs).replace("segment_duration='2h'",
                                             "segment_duration='2h', update_mode='append'"))
    table = db.catalog.open("cpu")
    host_index = {f"host_{i}": i for i in range(HOSTS)}
    t_start = time.perf_counter()
    minutes = LW_HISTORY_MIN + LW_LIVE_COMMITS // 6 + 1
    cells = _Cells(minutes, HOSTS, fields)
    hosts = np.arange(HOSTS)
    history = tsbs.generate_cpu(HOSTS, LW_HISTORY_MIN * 60_000, t0=LW_T0, seed=SEED + 3)
    table.write(RowGroup(table.schema, dict(history.columns)))
    cells.add(history, np.tile(hosts, len(history) // HOSTS))
    live_t0 = LW_T0 + LW_HISTORY_MIN * 60_000
    live = tsbs.generate_cpu(HOSTS, LW_LIVE_COMMITS * tsbs.INTERVAL_MS, t0=live_t0,
                             seed=SEED + 4)
    check(len(live) == LW_LIVE_COMMITS * HOSTS, f"{len(live)} live rows")

    # promotion: three eligible reads of each panel at the default knobs
    for f in fields:
        for _ in range(S.promote_reads()):
            db.execute(_lw_panel(f, live_t0 - 60 * 60_000))
    states = S.STORE.stats()["states"]
    check(len(states) == LW_FIELDS, f"{len(states)} states promoted, expected {LW_FIELDS}")
    check(all(s["depth"] == 128 for s in states), "ring depth is not 128")
    say(f"live window: {len(history)} history rows, {LW_FIELDS} panels promoted "
        f"({S.STORE.total_bytes()} B of rings) in {time.perf_counter() - t_start:.1f} s")

    _sync(torch)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = LwRecorder()
    L.reset_counts()  # the main path's launches start here
    head = None
    advances = commits = refreshes = served = 0
    refresh_s, check_s, commit_s = [], [], []
    checkpoints = {}
    max_err = 0.0
    # a torch.profiler trace over a steady window (no late batch, no
    # checkpoint): the device's idle share of the wall time of the window's
    # commits and refreshes, the script's own checks left out
    prof, trace = None, None
    windows = list(LW_TRACE) if DEV == "cuda" else []
    try:
        for k in range(LW_LIVE_COMMITS):
            if prof is not None and k == windows[0][1]:
                _sync(torch)
                prof.stop()
                trace_wall_s = sum(commit_s[n_commit:]) + sum(refresh_s[n_refresh:])
                busy_ms, n_events, n_lead = _device_busy_ms(prof)
                lo, hi = windows.pop(0)
                trace = {"window": [lo, hi], "commits": len(commit_s) - n_commit,
                         "refreshes": len(refresh_s) - n_refresh,
                         "wall_ms": trace_wall_s * 1e3, "device_busy_ms": busy_ms,
                         "device_events": n_events, "lead_kept": n_lead,
                         "idle_share": 1.0 - busy_ms / (trace_wall_s * 1e3)}
                prof = None
                if n_events:
                    windows = []
                elif windows:
                    say(f"  the trace of commits {lo}-{hi - 1} kept no record of the path "
                        f"({n_lead} of {LW_TRACE_LEAD} lead spins); tracing commits "
                        f"{windows[0][0]}-{windows[0][1] - 1}")
            if windows and k == windows[0][0]:
                from torch.profiler import ProfilerActivity, profile

                _sync(torch)
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                for _ in range(LW_TRACE_LEAD):
                    torch.cuda._sleep(1000)
                _sync(torch)
                n_commit, n_refresh = len(commit_s), len(refresh_s)
            rows = live.slice(k * HOSTS, (k + 1) * HOSTS)
            batches = [rows]
            if k == LW_LATE_AT:
                batches.append(_shifted(RowGroup, rows, -30 * 60_000 + 5_000))
            elif k == LW_OLD_AT:
                batches.append(_shifted(RowGroup, rows, -130 * 60_000 + 5_000))
            for b in batches:
                t = time.perf_counter()
                table.write(RowGroup(table.schema, dict(b.columns)))
                commit_s.append(time.perf_counter() - t)
                commits += 1
                cells.add(b, hosts)
                bmax = int(b.columns["ts"].max()) // 60_000
                if head is not None and bmax > head:
                    advances += 1
                head = bmax if head is None else max(head, bmax)
            if k % 6 != 5:
                continue
            clock = live_t0 + (k + 1) * tsbs.INTERVAL_MS
            minute = (clock - live_t0) // 60_000
            start = clock - 60 * 60_000
            mi_lo = (start - LW_T0) // 60_000
            for f in fields:
                sql = _lw_panel(f, start)
                t = time.perf_counter()
                res = db.execute(sql)
                refresh_s.append(time.perf_counter() - t)
                path = db.interpreters.executor.last_path
                refreshes += 1
                served += path == "livewindow"
                t = time.perf_counter()
                max_err = max(max_err, cells.check(res, f, mi_lo, host_index,
                                                   f"refresh minute {minute} {f} ({path})"))
                check_s.append(time.perf_counter() - t)
                if minute in LW_CHECKPOINTS:
                    os.environ["HORAEDB_LIVEWINDOW"] = "0"
                    try:
                        t = time.perf_counter()
                        raw = db.execute(sql)
                        raw_s = time.perf_counter() - t
                        check(db.interpreters.executor.last_path != "livewindow",
                              "the kill switch still served from state")
                    finally:
                        os.environ.pop("HORAEDB_LIVEWINDOW", None)
                    cells.check(raw, f, mi_lo, host_index, f"rescan minute {minute} {f}")
                    _same_answer(res, raw, f"refresh minute {minute} {f}: state vs rescan")
                    checkpoints.setdefault(minute, {})[f] = {
                        "path": path, "served_s": refresh_s[-1], "rescan_s": raw_s}
        _sync(torch)
        launches = dict(L.LAUNCHES)
        plain_calls = dict(L.PLAIN_CALLS)
        fold_errors = L.FOLD_ERRORS
        folded = L.STATES_FOLDED
    finally:
        rec.restore()
        if prof is not None:
            prof.stop()
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    n_states = len(S.STORE.stats()["states"])
    check(n_states == LW_FIELDS, f"{n_states} states resident at the end")
    check(fold_errors == 0, f"{fold_errors} folds failed")
    counted = launches if DEV == "cuda" else plain_calls
    # one fold launch a commit carries every state of the table
    check(counted["fold"] == commits, f"fold launches {counted['fold']} != {commits} commits")
    check(folded == commits * LW_FIELDS,
          f"states folded {folded} != {commits} commits x {LW_FIELDS} states")
    if DEV == "cuda":
        check(not any(plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    check(counted["gather"] == served > 0, f"gathers {counted['gather']} for {served} serves")
    check(served >= 0.9 * refreshes, f"only {served} of {refreshes} refreshes served from state")
    check(len(checkpoints) == len(LW_CHECKPOINTS), f"checkpoints {sorted(checkpoints)}")
    host_fold_ms = (rec.fold_s - rec.launch_s) / commits * 1e3
    say(f"live window: {commits} commits x {HOSTS} rows, {advances} head advances, "
        f"{refreshes} refreshes ({served} served from state) checked against the cells; "
        f"launches {launches} ({counted['fold'] / commits:.2f} fold launches a commit), "
        f"{folded} states folded; fold errors {fold_errors}")
    say(f"  commit (write + {LW_FIELDS} folds) median {statistics.median(commit_s) * 1e3:.3f} ms; "
        f"write hook on the host {host_fold_ms:.3f} ms per commit in the states' preparation "
        f"({rec.launch_s / commits * 1e3:.3f} ms in the launch path); refresh median "
        f"{statistics.median(refresh_s) * 1e3:.3f} ms; answer check median "
        f"{statistics.median(check_s) * 1e3:.3f} ms; peak device memory {peak} B")
    if trace is not None:
        check(trace["device_events"] > 0, "the traced window ran nothing on the device")
        lo, hi = trace["window"]
        say(f"  traced commits {lo}-{hi - 1} ({trace['commits']} commits, "
            f"{trace['refreshes']} refreshes): device busy {trace['device_busy_ms']:.3f} ms "
            f"({trace['device_events']} kernels and copies; {trace['lead_kept']} of "
            f"{LW_TRACE_LEAD} lead spins kept) of {trace['wall_ms']:.3f} ms of "
            f"their wall time, idle share {trace['idle_share']:.6f}")
    out = {
        "db": db, "rec": rec, "launches": launches, "states_folded": folded,
        "commits": commits, "advances": advances,
        "refreshes": refreshes, "served": served, "checkpoints": checkpoints, "peak": peak,
        "commit_ms_median": statistics.median(commit_s) * 1e3,
        "refresh_ms_median": statistics.median(refresh_s) * 1e3,
        "host_fold_ms_per_commit": host_fold_ms,
        "launch_ms_per_commit": rec.launch_s / commits * 1e3,
        "max_abs_err": max_err, "seconds": time.perf_counter() - t_start, "trace": trace,
    }
    DETAIL["livewindow_main"] = {k: v for k, v in out.items() if k not in ("db", "rec")}
    return out


def _shifted(RowGroup, rows, dt_ms: int):
    cols = dict(rows.columns)
    cols["ts"] = cols["ts"] + dt_ms
    return RowGroup(rows.schema, cols)


def _same_answer(a, b, what) -> None:
    """Two answers of one panel: the same cells with the same counts, and
    mins and maxs equal as float32, the type the ring holds (a rescan of
    memtable rows reads the float64 values); their sums and avgs were
    each held to the cells already."""
    import numpy as np

    def ordered(r):
        o = np.lexsort((r.column("hostname").astype(str), r.column("minute")))
        cols = {n: r.column(n)[o] for n in ("minute", "hostname", "c")}
        cols.update({n: r.column(n)[o].astype(np.float32) for n in ("mn", "mx")})
        return cols

    x, y = ordered(a), ordered(b)
    for n in x:
        check(np.array_equal(x[n], y[n]), f"{what}: {n} differs")


# ---- phase 12: live-window replay and timings ----------------------------------


def _lw_fold_bound(rings, words, r, n, m) -> tuple[float, int]:
    """Least time of one fold: 12 B per row and per pair read, each distinct
    (slot, group) cell the rows touch read and written in 4 planes
    (8 B x 4), each distinct increment cell read and written (8 B), and
    each reset slot's 5 planes written (20 B x cap), over HBM."""
    import numpy as np

    depth, cap = int(rings.shape[1]), int(rings.shape[2])
    w = words.cpu().numpy()

    def distinct(lo, k):
        s = w[lo:lo + k].astype(np.int64)
        g = w[lo + k:lo + 2 * k].astype(np.int64)
        s = np.where(s < 0, s + depth, s)
        g = np.where(g < 0, g + cap, g)
        ok = (s >= 0) & (s < depth) & (g >= 0) & (g < cap)
        return np.unique(s[ok] * cap + g[ok]).size

    nbytes = 12 * n + 12 * m + 32 * distinct(r, n) + 8 * distinct(r + 3 * n, m)
    nbytes += 20 * cap * np.unique(w[:r]).size
    return nbytes / PEAK_BYTES_S * 1e3, int(nbytes)


def _lw_group_bound(rings_list, words, spans) -> tuple[float, int]:
    """``_lw_fold_bound`` summed over the states of one grouped fold."""
    total = 0
    for rings, (at, r, n, m) in zip(rings_list, spans):
        total += _lw_fold_bound(rings, words[at:at + r + 3 * n + 3 * m], r, n, m)[1]
    return total / PEAK_BYTES_S * 1e3, total


def phase_lw_timings(torch, main, card) -> list:
    """The main path's last grouped folds (with a reset and without one)
    and its last gather, replayed kernel against plain; then each kernel's
    device time, bound, plain and library times, the gather's copy back,
    and the refresh latency from state against the rescan in this call."""
    from horaedb_tpu_torch.ops import livewindow as L

    calls = main["rec"].calls
    err = 0.0
    for kind in ("fold_reset", "fold"):
        check(kind in calls, f"the main path made no {kind} call")
        rings_list, words, spans = calls[kind]
        err = max(err, _lw_group_check(torch, rings_list, words, spans,
                                       f"main path {kind} replay"))
    rings, idx, g = calls["gather"]
    gather_err = _lw_gather_check(torch, rings, idx, g, "main path gather replay")
    say(f"live-window replay: the last folds and gather equal their plain versions; "
        f"max |sum diff| {err}, gather max |diff| {gather_err}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rings_list, words, spans = calls["fold_reset"]
    scratch = [r.clone() for r in rings_list]
    fold = lambda: L.fold_group(scratch, words, spans)  # noqa: E731
    fold_dev_ms = _device_ms(torch, fold, "ring_fold", flush=flush)
    fold_events_ms = _time_launch(torch, fold, flush=flush)
    fold_ms = fold_dev_ms if fold_dev_ms is not None else fold_events_ms

    def plain():
        for ring, (at, r, n, m) in zip(scratch, spans):
            L.fold_plain(ring, words[at:], r, n, m)

    fold_plain_ms = _time_launch(torch, plain, reps=5, flush=flush)
    fold_bound, fold_bytes = _lw_group_bound(rings_list, words, spans)
    rings0, w0, spans0 = calls["fold"]
    scratch0 = [r.clone() for r in rings0]
    no_reset_ms = _device_ms(torch, lambda: L.fold_group(scratch0, w0, spans0), "ring_fold",
                             flush=flush)
    rings, idx, g = calls["gather"]
    gather = lambda: L.gather(rings, idx, g)  # noqa: E731
    gather_dev_ms = _device_ms(torch, gather, "ring_gather", flush=flush)
    gather_events_ms = _time_launch(torch, gather, flush=flush)
    gather_ms = gather_dev_ms if gather_dev_ms is not None else gather_events_ms
    gather_plain_ms = _time_launch(torch, lambda: L.gather_plain(rings, idx, g), flush=flush)
    idx_long = idx.long()
    lib_ms = _time_launch(torch, lambda: torch.index_select(rings[:, :, :g], 1, idx_long),
                          flush=flush)
    out = gather()
    # a yardstick for the gather's copy: one device-to-device copy of its bytes
    dup = torch.empty_like(out)
    copy_ms = _device_ms(torch, lambda: dup.copy_(out), "Memcpy DtoD", flush=flush)
    host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
    d2h_ms = _time_launch(torch, lambda: host.copy_(out, non_blocking=True))
    n_idx = int(idx.shape[0])
    gather_bytes = 2 * 20 * n_idx * g
    gather_bound = gather_bytes / PEAK_BYTES_S * 1e3
    cps = main["checkpoints"]
    served = [v["served_s"] * 1e3 for c in cps.values() for v in c.values()]
    rescan = [v["rescan_s"] * 1e3 for c in cps.values() for v in c.values()]
    launches = main["launches"]
    kernels = [
        {"name": "livewindow_fold", "route": "cuda", "source": LW_SRC,
         "replaces": LW_REPLACES["fold"], "launches": int(launches["fold"]),
         "max_abs_err": err, "ms": fold_ms, "plain_ms": fold_plain_ms, "bound_ms": fold_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "livewindow_gather", "route": "cuda", "source": LW_SRC,
         "replaces": LW_REPLACES["gather"], "launches": int(launches["gather"]),
         "max_abs_err": gather_err, "ms": gather_ms, "plain_ms": gather_plain_ms,
         "bound_ms": gather_bound, "bound_by": "bytes", "library_ms": lib_ms},
    ]
    rows = [n for _, _, n, _ in spans]
    detail = {
        "fold_states": len(spans), "fold_rows": rows, "fold_pairs": [m for *_, m in spans],
        "fold_reset_slots": [r for _, r, _, _ in spans], "fold_bound_bytes": fold_bytes,
        "fold_ms": fold_dev_ms, "fold_events_ms": fold_events_ms,
        "fold_ms_without_reset": no_reset_ms, "fold_plain_ms": fold_plain_ms,
        "states_folded": main["states_folded"],
        "host_fold_ms_per_commit": main["host_fold_ms_per_commit"],
        "launch_ms_per_commit": main["launch_ms_per_commit"],
        "gather_n": n_idx, "gather_g": g, "gather_ms": gather_ms,
        "gather_events_ms": gather_events_ms, "gather_plain_ms": gather_plain_ms,
        "index_select_ms": lib_ms, "dtod_copy_ms": copy_ms, "d2h_ms": d2h_ms,
        "gather_bound_bytes": gather_bytes,
        "refresh_served_ms": served, "refresh_rescan_ms": rescan, "peak_bytes": main["peak"],
    }
    DETAIL["livewindow_timings"] = detail
    say(f"kernel livewindow_fold at a head-advance commit ({len(spans)} states in one launch, "
        f"rows {rows}, reset slots {detail['fold_reset_slots']}; {launches['fold']} main-path "
        f"launches for {main['states_folded']} state folds): {fold_dev_ms} ms on the device "
        f"timeline ({fold_events_ms:.4f} ms by events incl. the launch); a commit without a "
        f"reset {no_reset_ms} ms; plain {fold_plain_ms:.4f} ms; bound {fold_bound:.6f} ms "
        f"({fold_bytes} B); host {main['host_fold_ms_per_commit']:.3f} ms per commit in the "
        f"states' preparation, {main['launch_ms_per_commit']:.3f} ms in the launch path "
        f"[{card}]")
    say(f"kernel livewindow_gather at n {n_idx} x g {g} ({launches['gather']} main-path "
        f"launches): {gather_ms:.4f} ms ({gather_events_ms:.4f} ms by events), plain "
        f"{gather_plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound {gather_bound:.6f} ms "
        f"({gather_bytes} B), a DtoD copy of its {gather_bytes // 2} B {copy_ms} ms; copy "
        f"back {d2h_ms:.4f} ms [{card}]")
    say(f"refresh at the checkpoints: from state median {statistics.median(served):.3f} ms, "
        f"kill-switch rescan median {statistics.median(rescan):.3f} ms; peak device memory "
        f"{main['peak']} B [{card}]")
    return kernels


# ---- phase 13: PromQL rate/increase and an alert over a counter table --------

CTR_HISTORY_MIN = 10
CTR_LIVE_COMMITS = 180   # 30 min of 10 s scrapes
CTR_RESET_AT = 72        # the live commit at which every host's counter restarts
CTR_STEP_MS = 5 * 60_000
CTR_FIRING = 100  # after the reset only the last 100 hosts stay above the threshold


def _ctr_values(k: int, hosts):
    """Counter value of every host at tick k: 10**7 + 1000 h + rate_h k
    before the reset, 1000 h + rate_h (k - reset) after it."""
    rate = 1 + hosts % 7
    k_reset = CTR_HISTORY_MIN * 6 + CTR_RESET_AT
    if k < k_reset:
        return 1e7 + 1000.0 * hosts + rate * k
    return 1000.0 * hosts + rate * (k - k_reset)


def _ctr_expected(t0, start, end, hosts, only=None):
    """increase per (host, step bucket) over the samples in [start, end]:
    consecutive deltas, a drop counting the new value (a reset), each
    delta in its later sample's bucket, as the reference's fold defines."""
    import numpy as np

    out = {}
    ticks = [k for k in range(CTR_HISTORY_MIN * 6 + CTR_LIVE_COMMITS)
             if start <= t0 + k * 10_000 <= end]
    vals = np.stack([_ctr_values(k, hosts) for k in ticks])
    d = vals[1:] - vals[:-1]
    d = np.where(d < 0, vals[1:], d)
    b = [((t0 + k * 10_000) // CTR_STEP_MS) * CTR_STEP_MS for k in ticks[1:]]
    for h in (hosts if only is None else [only]):
        series = {}
        for j, bj in enumerate(b):
            series[bj] = series.get(bj, 0.0) + float(d[j, h])
        out[(("hostname", f"host_{h}"),)] = series
    return out


def phase_lw_promql(torch) -> dict:
    """A counter table at 4000 hosts with 10 s scrapes and a counter reset
    on every host at one time: its all-tags state promoted, 30 min of live
    commits, then increase/rate over the last 30 min at step 5 m served
    from the state (the PromQL read counter moves), equal to the
    kill-switch fold at 1e-4 relative and to numpy; then one alert rule
    that fires from the state (route livewindow)."""
    import numpy as np

    import horaedb_tpu_torch
    from horaedb_tpu_torch.common_types import RowGroup
    from horaedb_tpu_torch.common_types.schema import compute_tsid
    from horaedb_tpu_torch.ops import livewindow as L
    from horaedb_tpu_torch.proxy.promql import evaluate_range, parse_promql
    from horaedb_tpu_torch.rules import RuleEngine
    from horaedb_tpu_torch.state import livewindow as S
    from horaedb_tpu_torch.utils.config import RulesSection

    S.STORE.clear()
    db = horaedb_tpu_torch.connect(None, device=DEV)
    db.execute("CREATE TABLE ctr (hostname string TAG, value double NOT NULL, "
               "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
               "WITH (segment_duration='2h', update_mode='append')")
    table = db.catalog.open("ctr")
    hosts = np.arange(HOSTS)
    names = np.array([f"host_{i}" for i in hosts], dtype=object)
    tsid = compute_tsid([names])
    # the simulated clock ends at the wall clock, so the alert's range is
    # the open tail
    end = (int(time.time() * 1000) // 60_000) * 60_000
    t0 = end - (CTR_HISTORY_MIN * 6 + CTR_LIVE_COMMITS) * 10_000

    def rows_at(ks):
        return RowGroup(table.schema, {
            "hostname": np.tile(names, len(ks)), "tsid": np.tile(tsid, len(ks)),
            "ts": np.repeat([t0 + k * 10_000 for k in ks], HOSTS).astype(np.int64),
            "value": np.concatenate([_ctr_values(k, hosts) for k in ks]),
        })

    table.write(rows_at(range(CTR_HISTORY_MIN * 6)))
    for _ in range(S.promote_reads()):
        db.execute("SELECT time_bucket(ts, '1m') AS b, hostname, sum(value) AS s, "
                   "count(value) AS c FROM ctr GROUP BY time_bucket(ts, '1m'), hostname")
    states = S.STORE.stats()["states"]
    check(len(states) == 1, f"{len(states)} counter states promoted")
    L.reset_counts()  # this phase's launches start here
    for k in range(CTR_HISTORY_MIN * 6, CTR_HISTORY_MIN * 6 + CTR_LIVE_COMMITS):
        table.write(rows_at([k]))
    _sync(torch)
    start = end - CTR_LIVE_COMMITS * 10_000
    out = {"queries": {}}

    def matrix(expr):
        res = evaluate_range(db, parse_promql(expr), start, end, CTR_STEP_MS)
        return {tuple(sorted((k, v) for k, v in s["metric"].items() if k != "__name__")):
                {int(round(t * 1000)): float(v) for t, v in s["values"]} for s in res}

    def close(got, want, what):
        check(set(got) == set(want), f"{what}: series differ")
        for key, pts in want.items():
            check(set(got[key]) == set(pts), f"{what}: {key} steps differ")
            for b, v in pts.items():
                check(abs(got[key][b] - v) <= 1e-4 * max(1.0, abs(v)),
                      f"{what}: {key} at {b}: {got[key][b]} vs {v}")

    for expr, only in (("increase(ctr[5m])", None), ("rate(ctr[5m])", None),
                       ('increase(ctr{hostname="host_7"}[5m])', 7)):
        before = S._M_READS_PROMQL.value
        t = time.perf_counter()
        got = matrix(expr)
        served_s = time.perf_counter() - t
        check(S._M_READS_PROMQL.value > before, f"{expr}: not served from state")
        want = _ctr_expected(t0, start, end, hosts, only)
        if expr.startswith("rate"):
            want = {k: {b: v / (CTR_STEP_MS / 1000.0) for b, v in s.items()}
                    for k, s in want.items()}
        close(got, want, f"{expr} vs numpy")
        os.environ["HORAEDB_LIVEWINDOW"] = "0"
        try:
            t = time.perf_counter()
            raw = matrix(expr)
            raw_s = time.perf_counter() - t
        finally:
            os.environ.pop("HORAEDB_LIVEWINDOW", None)
        close(got, raw, f"{expr} vs the kill switch")
        out["queries"][expr] = {"served_s": served_s, "rescan_s": raw_s, "series": len(got)}
        say(f"promql {expr}: {len(got)} series from state in {served_s * 1e3:.3f} ms, "
            f"kill-switch fold {raw_s * 1e3:.3f} ms; equal to numpy and to the rescan")

    (state_row,) = S.STORE.stats()["states"]
    threshold = 1000.0 * (HOSTS - CTR_FIRING) - 0.5
    eng = RuleEngine(db, RulesSection(alerts=[f"CtrHigh := ctr > {threshold}"])).load()
    eng.run_once(now_ms=int(time.time() * 1000))
    check(db.interpreters.executor.last_path == "livewindow",
          f"the alert read took {db.interpreters.executor.last_path}")
    (after,) = S.STORE.stats()["states"]
    check(after["reads_served"] > state_row["reads_served"], "the alert read no state")
    snap = eng.alerts_snapshot()
    fired = sorted(int(a["labels"]["hostname"][5:]) for a in snap if a["state"] == "firing")
    check(fired == list(range(HOSTS - CTR_FIRING, HOSTS)),
          f"alert fired for {fired[:5]}... ({len(fired)})")
    _sync(torch)
    launches, plain_calls = dict(L.LAUNCHES), dict(L.PLAIN_CALLS)
    check(L.FOLD_ERRORS == 0, f"{L.FOLD_ERRORS} counter folds failed")
    if DEV == "cuda":
        check(launches["fold"] == CTR_LIVE_COMMITS, f"counter folds {launches}")
        check(launches["gather"] > 0, "no gather")
        check(not any(plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    say(f"alert CtrHigh fired for {len(fired)} hosts from state (route livewindow); "
        f"launches {launches}")
    out.update(launches=launches, fired=len(fired))
    DETAIL["livewindow_promql"] = out
    db.close()
    S.STORE.clear()
    return out


# ---- phase 14: the raw-read kernels against their plain versions -------------

RAW_SRC = "horaedb_tpu_torch/ops/csrc/scan_topk.cu"
RAW_REPLACES = {
    "raw_topk": "horaedb_tpu/ops/scan_topk.py:244",
    "raw_select": "horaedb_tpu/ops/scan_topk.py:297",
}
# (series layout, ts layout, (key field kind, filter field kind)); "codes"
# is a dictionary field kept in code space, as raw reads keep the sort key
RAW_LAYOUTS = [
    ("raw", "raw", ("raw", "raw")),
    ("delta", "delta", ("codes", "raw")),
    ("delta", "dict", ("raw", "codes")),
    ("raw", "delta", ("bf16", "dict")),
    ("delta", "raw", ("dict", "bf16")),
]
RAW_SIZES = (0, 1, 1000, 1 << 20)
RAW_BIG = (1 << 25) + 4096
RAW_KS = (1, 16, 128, 4096)
# (key_is_ts, descending)
RAW_KEYS = ((True, True), (True, False), (False, True), (False, False))
MAX_WINDOW_RUNS = 20_000  # window sets of one window a run of passing rows


def _raw_values(rng, n, kind):
    """A value column of ``kind``: floats with ties (a tenth at 100.0),
    +-0, NaN and +-inf; or integer dictionary values (a dictionary holds
    neither NaN nor both zeros)."""
    import numpy as np

    if kind in ("dict", "codes"):
        vocab = rng.choice(np.arange(-500, 500), 300, replace=False).astype(np.float32)
        return vocab[rng.integers(0, len(vocab), n)]
    v = np.round(rng.normal(0, 50, n) * 2).astype(np.float32) / 2
    special = np.array([100.0, -0.0, 0.0, np.nan, np.inf, -np.inf], dtype=np.float32)
    pick = rng.random(n)
    v = np.where(pick < 0.10, special[0], v)
    for j, p in enumerate((0.03, 0.03, 0.02, 0.01, 0.01)):
        lo = 0.10 + sum((0.03, 0.03, 0.02, 0.01, 0.01)[:j])
        v = np.where((pick >= lo) & (pick < lo + p), special[j + 1], v)
    return v.astype(np.float32)


def _raw_columns(torch, rng, n, layout):
    """n resident rows sorted by (series, ts) in ``layout`` (delta layouts
    fall back to raw when n is not a multiple of 128), a masked pad tail
    on series S; returns (args without session/dyn, layout kwargs, S,
    the largest ts)."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E

    dev = torch.device(DEV)
    series_layout, ts_layout, kinds = layout
    if n % E.FOR_BLOCK:
        series_layout = "raw"
        ts_layout = "raw" if ts_layout == "delta" else ts_layout
    if n == 0:  # no dictionary of nothing
        ts_layout = "raw"
        kinds = tuple("raw" if k in ("dict", "codes") else k for k in kinds)
    S = max(1, n // 500)
    codes = np.sort(rng.integers(0, S, n)).astype(np.int32)
    codes[n - min(37, n // 10):] = S  # pad rows: the allow list masks them
    first = np.searchsorted(codes, codes, "left")
    rank = np.arange(n) - first
    jitter = 0 if ts_layout == "dict" else rng.integers(0, 9, n)
    ts = (rank * 10 + jitter).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int32) if a.dtype == np.uint32 else np.ascontiguousarray(a)).to(dev)

    if series_layout == "delta":
        d = E.delta_for_encode(codes, 8)
        sp, sl = (t(d.words), t(d.base)), ("delta", d.width)
    else:
        sp, sl = (t(codes),), ("raw",)
    if ts_layout == "delta":
        d = E.delta_for_encode(ts, 16)
        tp, tl = (t(d.words), t(d.base)), ("delta", d.width)
    elif ts_layout == "dict":
        d = E.dict_encode(ts, 4096)
        tp, tl = (t(d.words), t(d.dictionary)), ("dict", d.width)
    else:
        tp, tl = (t(ts),), ("raw",)
    values, vl = [], []
    for kind in kinds:
        col = _raw_values(rng, n, kind)
        if kind in ("dict", "codes"):
            d = E.dict_encode(col, 4096)
            values.append((t(d.words), t(d.dictionary)))
            vl.append(("dict", d.width, kind == "dict"))
        elif kind == "bf16":
            values.append((t(col).to(torch.bfloat16),))
            vl.append(("bf16",))
        else:
            values.append((t(col),))
            vl.append(("raw",))
    kw = dict(value_layouts=tuple(vl), ts_layout=tl, series_layout=sl)
    return (sp, tp, tuple(values)), kw, S, int(ts.max()) if n else 0


def _raw_inputs(torch, rng, S, allow_frac, lits, lo, hi, key_lo=0, key_hi=0):
    import numpy as np

    from horaedb_tpu_torch.ops import scan_topk as T

    dev = torch.device(DEV)
    allow = np.append(rng.random(S) < allow_frac, False).astype(np.int32)
    session = torch.from_numpy(allow).to(dev)
    dyn = torch.from_numpy(T.pack_raw_dyn(lits, lo, hi, key_lo, key_hi)).to(dev)
    return session, dyn


def _raw_check(torch, kind, cols, session, dyn, kw, what) -> int:
    """One launch of the ``kind`` kernel and its plain version on the same
    tensors; fails unless bit-equal (``windows`` reach only the kernel:
    the plain version scans every row). Returns the rows the answer
    holds."""
    import numpy as np

    from horaedb_tpu_torch.ops import scan_topk as T

    if kind == "raw_topk":
        # the slots alone, then with the keys they were ranked by (the
        # sharded top-k's form): the same slots, the keys as the plain ones;
        # given windows, the keys kernel counts their rows and tiles as it
        # runs, and no others
        if DEV == "cuda" and kw.get("windows") is not None:
            stats = torch.zeros(len(T.TOPK_STATS), dtype=torch.int64, device=DEV)
            alone = T.raw_topk_packed(*cols, session, dyn, stats=stats, **kw)
            w = np.asarray(kw["windows"]).reshape(-1, 2)
            want_rows = w[:, 1] - w[:, 0]
            want_stats = [int(want_rows.sum()), int(((want_rows + T.TILE - 1) // T.TILE).sum())]
            check(stats.tolist() == want_stats,
                  f"{what}: the keys kernel decoded and walked {stats.tolist()} rows and "
                  f"tiles, the windows hold {want_stats}")
        else:
            alone = T.raw_topk_packed(*cols, session, dyn, **kw)
        got = T.raw_topk_packed(*cols, session, dyn, with_keys=True, **kw)
        _sync(torch)
        want = T.raw_topk_plain(*cols, session, dyn, with_keys=True, **kw)
        check(torch.equal(got[0], alone), f"{what}: the slots with keys differ from alone")
    else:
        got = T.raw_select_packed(*cols, session, dyn, **kw)
        _sync(torch)
        want = T.raw_select_plain(*cols, session, dyn, **kw)
    check(got.shape == want.shape and torch.equal(got, want.to(got.device)),
          f"{what}: kernel {got[..., :12].tolist()} vs plain {want[..., :12].tolist()}")
    return int((got[1:] >= 0).sum()) if kind == "raw_select" else int((got[0] >= 0).sum())


def _runs(flags):
    """int64[W, 2]: the maximal [start, end) runs of True in ``flags``."""
    import numpy as np

    f = np.concatenate([[False], np.asarray(flags, dtype=bool), [False]])
    edges = np.flatnonzero(f[1:] != f[:-1])
    return edges.reshape(-1, 2).astype(np.int64)


def _in_windows(windows, n):
    """bool[n]: the rows inside the [start, end) ``windows``."""
    import numpy as np

    w = np.asarray(windows, dtype=np.int64).reshape(-1, 2)
    edge = np.zeros(n + 1, dtype=np.int64)
    np.add.at(edge, w[:, 0], 1)
    np.add.at(edge, w[:, 1], -1)
    return np.cumsum(edge)[:n] > 0


def _union(windows):
    """Sorted, merged [start, end) windows (overlapping or touching ones
    joined)."""
    import numpy as np

    w = np.asarray(windows, dtype=np.int64).reshape(-1, 2)
    w = w[np.argsort(w[:, 0], kind="stable")]
    out = []
    for a, b in w:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def _window_sets(torch, rng, cols, lay, session, dyn, filters, full: bool) -> dict:
    """Row windows that cover every row the selection's mask passes (the
    promise the executor's windows keep), by name: ``series`` the allowed
    series' in-range rows, as the executor builds them; ``real`` one
    window of every real row; ``exact`` the runs of passing rows (windows
    that end inside a tile and start inside a 128-row delta block);
    ``padded`` those widened by 0-150 rows a side; ``singles`` a window of
    one row for each of the first 3000 passing rows, then one over the
    rest; ``short`` the series windows cut into pieces of 1-300 rows;
    ``empty`` the empty list where no row passes. ``full``: every set,
    else ``series`` and ``real``; the sets built from the passing rows'
    runs only where there are at most MAX_WINDOW_RUNS runs (a tile each)."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E, scan_topk as T

    sp, tp, vals = cols
    n = E.layout_rows(sp, lay["series_layout"])
    sc, tr, dv = E.decode_layouts(sp, tp, vals, lay["series_layout"], lay["ts_layout"],
                                  lay["value_layouts"])
    lits, lo, hi, _, _ = T._unpack_dyn(dyn.cpu(), filters)
    allow = session.cpu().numpy() != 0
    codes, ts = sc.cpu().numpy().astype(np.int64), tr.cpu().numpy()
    base = allow[codes] & (ts >= lo) & (ts < hi)
    m = T._raw_mask(sc, tr, dv, session != 0, lits.to(sc.device), lo, hi, filters)
    m = m.cpu().numpy()
    n_real = int((codes < len(allow) - 1).sum())
    sets = {"series": _runs(base), "real": np.array([[0, n_real]] if n_real else [],
                                                   dtype=np.int64).reshape(-1, 2)}
    ex = _runs(m)
    if not m.any():
        sets["empty"] = np.empty((0, 2), dtype=np.int64)
    if full and len(ex) <= MAX_WINDOW_RUNS:
        sets["exact"] = ex
        grow = rng.integers(0, 151, ex.shape)
        sets["padded"] = _union(np.clip(ex + grow * np.array([-1, 1]), 0, n_real))
    if full:
        hit = np.flatnonzero(m)
        one = np.stack([hit[:3000], hit[:3000] + 1], axis=1)
        rest = [[int(hit[3000]), n_real]] if len(hit) > 3000 else []
        sets["singles"] = np.concatenate([one, np.array(rest, dtype=np.int64).reshape(-1, 2)])
        pieces = []
        for a, b in sets["series"]:
            cuts = np.cumsum(rng.integers(1, 301, (b - a) // 150 + 2)) + a
            edges = np.concatenate([[a], cuts[cuts < b], [b]])
            pieces.append(np.stack([edges[:-1], edges[1:]], axis=1))
        sets["short"] = (np.concatenate(pieces) if pieces
                         else np.empty((0, 2), dtype=np.int64))
    for name, w in sets.items():  # each covers every passing row
        check(bool(_in_windows(w, n)[m].all()), f"window set {name} misses a row")
    return sets


def _raw_window_cases(torch, rng, cols, lay, session, dyn, filters, what, full=True,
                      topk=None) -> int:
    """The selection over each of ``_window_sets``' window sets against its
    plain version (which scans every row), bit-equal, with as many slots
    as rows pass; the tiles a launch walks are the windows' tiles. With
    ``topk`` (the top-k's keyword arguments), the top-k over each set
    instead, its slots and keys bit-equal to the plain version's."""
    from horaedb_tpu_torch.ops import encoding as E, scan_topk as T

    n = E.layout_rows(cols[0], lay["series_layout"])
    count = int(T.raw_select_plain(*cols, session, dyn, select_slots=0,
                                   numeric_filters=filters, **lay)[0])
    n_cases = 0
    for name, w in _window_sets(torch, rng, cols, lay, session, dyn, filters, full).items():
        if topk is not None:
            _raw_check(torch, "raw_topk", cols, session, dyn, {**topk, "windows": w},
                       f"{what} k={topk['k']} windows={name} ({len(w)})")
            n_cases += 1
            continue
        tiles = T.TILES["raw_select"]
        _raw_check(torch, "raw_select", cols, session, dyn,
                   dict(select_slots=count, numeric_filters=filters, windows=w, **lay),
                   f"{what} windows={name} ({len(w)}) count {count}")
        if DEV == "cuda":
            walked = T.TILES["raw_select"] - tiles
            check(walked == len(T.select_tiles(w, n)) == int(
                ((w[:, 1] - w[:, 0] + T.TILE - 1) // T.TILE).sum()),
                  f"{what} windows={name}: {walked} tiles walked")
        n_cases += 1
    return n_cases


def _raw_cases(torch, rng, n, layout, ks, keys, op_at) -> int:
    """Top-k at every (key, k) and selections at three buffer sizes over one
    column set of n rows; the filter op rotates with ``op_at``."""
    from horaedb_tpu_torch.ops import scan_agg as S, scan_topk as T

    cols, lay, n_series, ts_max = _raw_columns(torch, rng, n, layout)
    n_cases = 0
    for j, (key_is_ts, desc) in enumerate(keys):
        op = OPS[(op_at + j) % len(OPS)]
        filters = ((1, S._FILTER_OPS[op]),)
        full = j % 2 == 0  # the whole time range, or a window inside it
        lo, hi = (0, ts_max + 1) if full else (15, max(ts_max - 25, 15))
        key_lo, key_hi = T.topk_key_bounds(desc, key_is_ts, lo, hi)
        session, dyn = _raw_inputs(torch, rng, n_series, 0.8, [5.0], lo, hi, key_lo, key_hi)
        big = n >= 1 << 24  # over 2^24 rows, the windows of one key's allow list
        for k in sorted({min(k, max(n, 1)) for k in ks} | {max(n, 1)}):
            kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
                      numeric_filters=filters, **lay)
            what = f"raw_topk n={n} {layout} ts={key_is_ts} desc={desc} {op}"
            _raw_check(torch, "raw_topk", cols, session, dyn, kw, f"{what} k={k}")
            n_cases += 1
            # over the window sets too, at the smallest k the executor gives
            # and at k = n: every set at the first key, else the executor's
            # (the allowed series' rows in range)
            if n and k in (min(16, n), n) and (j == 0 or not big):
                n_cases += _raw_window_cases(torch, rng, cols, lay, session, dyn, filters,
                                             what, full=j == 0 and not big, topk=kw)
        count = int(T.raw_select_plain(*cols, session, dyn, select_slots=0,
                                       numeric_filters=filters, **lay)[0])
        for slots in sorted({count, count + 3, max(count - 1, 0)}):
            _raw_check(torch, "raw_select", cols, session, dyn,
                       dict(select_slots=slots, numeric_filters=filters, **lay),
                       f"raw_select n={n} {layout} {op} slots={slots} (count {count})")
            n_cases += 1
        what = f"raw_select n={n} {layout} {op} [{lo}, {hi})"
        if j == 0 or not big:
            n_cases += _raw_window_cases(torch, rng, cols, lay, session, dyn, filters, what,
                                         full=not big)
        if j == 0:  # an allow list that passes no row: the empty window list
            none, _ = _raw_inputs(torch, rng, n_series, 0.0, [5.0], lo, hi)
            n_cases += _raw_window_cases(torch, rng, cols, lay, none, dyn, filters,
                                         what + " allow none", full=False)
    return n_cases


def _raw_traps(torch, rng) -> int:
    """The cases the reference's tests pin, at small n."""
    import numpy as np

    from horaedb_tpu_torch.ops import scan_agg as S, scan_topk as T

    dev = torch.device(DEV)
    n_cases = 0

    def table(v, w=None):
        n = len(v)
        v = np.asarray(v, dtype=np.float32)
        w = np.arange(n, dtype=np.float32) if w is None else np.asarray(w, np.float32)
        cols = ((torch.zeros(n, dtype=torch.int32, device=dev),),
                (torch.arange(n, dtype=torch.int32, device=dev),),
                ((torch.from_numpy(v).to(dev),), (torch.from_numpy(w).to(dev),)))
        return cols, n

    def topk(cols, n, k, desc, filters=(), lits=(), allow=1, lo=0, hi=None, key_is_ts=False):
        hi = n if hi is None else hi
        session = torch.tensor([allow, 0], dtype=torch.int32, device=dev)
        key_lo, key_hi = T.topk_key_bounds(desc, key_is_ts, lo, hi)
        dyn = torch.from_numpy(T.pack_raw_dyn(lits, lo, hi, key_lo, key_hi)).to(dev)
        kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
                  numeric_filters=filters, value_layouts=(("raw",), ("raw",)))
        what = f"trap n={n} k={k} desc={desc} filters={filters} allow={allow} [{lo},{hi})"
        _raw_check(torch, "raw_topk", cols, session, dyn, kw, what)
        for slots in (0, n):
            _raw_check(torch, "raw_select", cols, session, dyn,
                       dict(select_slots=slots, numeric_filters=filters,
                            value_layouts=(("raw",), ("raw",))), what + f" slots={slots}")
        return 3

    # +-0 at the threshold: the 12-row table of the reference's quirk
    pm0 = [-0.0, -0.0, -0.0, -0.0, -5.0, 0.0, -1.0, -2.0, -3.0, -4.0, -6.0, -7.0]
    cols, n = table(pm0)
    for k in (1, 2, 5, 12):
        for desc in (True, False):
            n_cases += topk(cols, n, k, desc)
    # 20 x -0.0, 20 x +0.0, 8 negatives
    cols, n = table([-0.0] * 20 + [0.0] * 20 + [-1.0 - i for i in range(8)])
    for k in (1, 16, 21, 48):
        n_cases += topk(cols, n, k, True) + topk(cols, n, k, False)
    # NaN last in both directions; fewer passing rows than k, with and
    # without NaN among them; +-inf
    v = np.arange(60, dtype=np.float32)
    v[::4] = np.nan
    v[5], v[6] = np.inf, -np.inf
    cols, n = table(v)
    ge = ((1, S._FILTER_OPS[">="]),)
    for desc in (True, False):
        for k in (8, 16, 60):
            n_cases += topk(cols, n, k, desc)
        n_cases += topk(cols, n, 32, desc, lo=40, hi=60)  # 20 rows pass, 5 of them NaN
        n_cases += topk(cols, n, 16, desc, ge, [52.0])  # 6 rows pass, none NaN
    # more ties at the k-th key than slots
    cols, n = table(np.where(rng.random(5000) < 0.7, 100.0,
                             rng.normal(50, 20, 5000)).astype(np.float32))
    for k in (1, 128, 4096):
        n_cases += topk(cols, n, k, True) + topk(cols, n, k, False)
    # an empty allow list and an empty time range
    n_cases += topk(cols, n, 16, True, allow=0)
    n_cases += topk(cols, n, 16, True, lo=50, hi=50)
    n_cases += topk(cols, n, 16, True, lo=50, hi=50, key_is_ts=True)
    return n_cases


def phase_raw_kernels(torch) -> None:
    """Both raw-read kernels against their plain versions, bit-equal: every
    resident layout (a dictionary-coded key, delta and dictionary
    timestamps, delta series codes, bf16), ts and f32 keys in both
    directions, k in RAW_KS and k = n, n in RAW_SIZES and RAW_BIG rows,
    every filter op, selections at the exact count, above and below it,
    and the trap cases."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    n_cases = _raw_traps(torch, rng)
    at = 0
    for n in RAW_SIZES:
        for layout in RAW_LAYOUTS:
            n_cases += _raw_cases(torch, rng, n, layout, RAW_KS, RAW_KEYS, at)
            at += 1
    for layout in (RAW_LAYOUTS[0], RAW_LAYOUTS[1]):
        n_cases += _raw_cases(torch, rng, RAW_BIG, layout, (16, 4096), RAW_KEYS, at)
        at += 1
    _sync(torch)
    say(f"raw kernels vs plain: {n_cases} cases bit-equal")
    DETAIL["raw_kernel_cases"] = n_cases


# ---- phase 15: raw reads on the cpu table (the raw main path) ----------------

H12 = 12 * 3_600_000
# TSBS devops high-cpu-1 reads one random host; this one, the first from
# host_42 on whose usage_user passes 90 in the first 12 h (host_42 itself
# never does at seed 123), so the selection has rows to return
HC_FROM = 42


def raw_queries(hc_host: int) -> list:
    """(name, SQL, kernel) of the raw main path; the cpu table's first
    timestamp is 0."""
    return [
        ("lastpoint-host",
         "SELECT * FROM cpu WHERE hostname = 'host_7' ORDER BY ts DESC LIMIT 10", "topk"),
        ("hottest-12h",
         f"SELECT hostname, ts, usage_user FROM cpu WHERE ts >= {H12} AND ts < {2 * H12} "
         "ORDER BY usage_user DESC LIMIT 100", "topk"),
        ("coolest-asc",
         "SELECT hostname, ts, usage_idle FROM cpu WHERE usage_system > 50 "
         "ORDER BY usage_idle ASC LIMIT 1000 OFFSET 10", "topk"),
        ("high-cpu-1",
         f"SELECT * FROM cpu WHERE hostname = 'host_{hc_host}' AND usage_user > 90 "
         f"AND ts >= 0 AND ts < {H12}", "select"),
        # the same over 16 hosts and 24 h
        ("high-cpu-16",
         "SELECT * FROM cpu WHERE hostname IN ("
         + ", ".join(f"'host_{i}'" for i in range(16))
         + f") AND usage_user > 50 AND ts >= 0 AND ts < {2 * H12}", "select"),
    ]


def _raw_expected(tsbs, rows) -> dict:
    """Independent answers of ``raw_queries`` from the generated rows: the
    rows that pass (numeric filters on the float32 values the device
    columns hold), ordered by the ORDER BY key and then by the resident
    order, which query/scan_cache.py defines as (series code, ts) with
    series codes the ranks of the sorted unique tsids; the LIMIT/OFFSET
    window of that. Rows without ORDER BY come in resident order. Each
    answer is its rows as dicts of every column."""
    import numpy as np

    ts = rows.columns["ts"]
    n_ticks = HOURS * 3_600_000 // tsbs.INTERVAL_MS
    host = np.tile(np.arange(HOSTS), n_ticks)  # generate_cpu's row order
    _, inv = np.unique(rows.columns["tsid"], return_inverse=True)
    order = np.lexsort((ts, inv))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    f32 = {f: rows.columns[f].astype(np.float32) for f in ("usage_user", "usage_system")}

    def window(sel, key, offset, limit):
        i = np.flatnonzero(sel)
        return i[np.lexsort((rank[i], key[i]))][offset:offset + limit]

    def in_order(sel):
        i = np.flatnonzero(sel)
        return i[np.argsort(rank[i], kind="stable")]

    hot = (f32["usage_user"] > 90) & (ts < H12)
    hc_host = next(h % HOSTS for h in range(HC_FROM, HC_FROM + HOSTS) if hot[host == h % HOSTS].any())
    picks = {
        "lastpoint-host": window(host == 7, -ts, 0, 10),
        "hottest-12h": window((ts >= H12) & (ts < 2 * H12), -rows.columns["usage_user"], 0,
                              100),
        "coolest-asc": window(f32["usage_system"] > 50, rows.columns["usage_idle"], 10, 1000),
        "high-cpu-1": in_order((host == hc_host) & hot),
        "high-cpu-16": in_order((host < 16) & (f32["usage_user"] > 50)),
    }
    names = [c.name for c in rows.schema.columns]
    out = {}
    for q, i in picks.items():
        out[q] = [{c: rows.columns[c][j] for c in names} for j in i]
    out["n_at_100_second_half"] = int(((ts >= H12) & (rows.columns["usage_user"] == 100.0)).sum())
    out["hc_host"] = hc_host
    return out


def _same_rows(got, want, what) -> None:
    check(len(got) == len(want), f"{what}: {len(got)} rows, expected {len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        for c, v in g.items():
            check(c in w and v == w[c], f"{what}: row {k} column {c}: {v!r} vs {w.get(c)!r}")


def _key_rows(rows, key):
    return [(r["hostname"], r["ts"]) for r in sorted(rows, key=key)]


def _select_geometry(T, kw, n_valid, walked, what) -> None:
    """The executor's windows of one selection: sorted, disjoint, inside
    the real rows [0, n_valid) (no pad row), as many rows as the buffer's
    slots; on the card the launch walked ceil(rows / TILE) tiles a window
    and no others."""
    import numpy as np

    w = np.asarray(kw["windows"], dtype=np.int64).reshape(-1, 2)
    rows = w[:, 1] - w[:, 0]
    tiles = int(((rows + T.TILE - 1) // T.TILE).sum())
    check(len(w) > 0 and bool((rows > 0).all() and (w[1:, 0] > w[:-1, 1]).all())
          and int(w[0, 0]) >= 0 and int(w[-1, 1]) <= n_valid,
          f"{what}: windows {w[:4].tolist()}... outside the {n_valid} real rows")
    check(int(rows.sum()) == kw["select_slots"],
          f"{what}: windows of {int(rows.sum())} rows, {kw['select_slots']} slots")
    check(DEV != "cuda" or walked == tiles,
          f"{what}: the launch walked {walked} tiles, the windows hold {tiles}")
    DETAIL.setdefault("select_geometry", {})[what] = {
        "windows": len(w), "rows": int(rows.sum()), "tiles": tiles, "walked": walked}


def _topk_geometry(T, kw, n_valid, walked, what) -> None:
    """The executor's windows of one top-k: sorted, disjoint, inside the
    real rows [0, n_valid); on the card the launch's keys kernel counted
    their rows and tiles as it ran, and no others (``walked``: the rows
    and tiles its ``stats`` got, and the kernels the launch sequence
    counted)."""
    import numpy as np

    w = np.asarray(kw["windows"], dtype=np.int64).reshape(-1, 2)
    rows = w[:, 1] - w[:, 0]
    tiles = int(((rows + T.TILE - 1) // T.TILE).sum())
    check(len(w) > 0 and bool((rows > 0).all() and (w[1:, 0] > w[:-1, 1]).all())
          and int(w[0, 0]) >= 0 and int(w[-1, 1]) <= n_valid,
          f"{what}: windows {w[:4].tolist()}... outside the {n_valid} real rows")
    check(DEV != "cuda" or walked[:2] == [int(rows.sum()), tiles],
          f"{what}: the keys kernel decoded {walked[0]} rows and walked {walked[1]} tiles, "
          f"the windows hold {int(rows.sum())} and {tiles}")
    DETAIL.setdefault("topk_geometry", {})[what] = {
        "windows": len(w), "rows": int(rows.sum()), "tiles": tiles, "visited": walked[0],
        "walked": walked[1], "kernels": walked[2], "n_valid": n_valid}


class RawRecorder:
    """Wraps the raw-read wrappers during the main path to keep, per query,
    the last main-path call of its kernel (args and kwargs) for phase 16.
    On the card each top-k call also gets ``stats``, which its keys kernel
    adds its row and tile counts to (``scan_topk.TOPK_STATS``)."""

    def __init__(self, T, torch=None):
        self.T = T
        self.orig = (T.raw_topk_packed, T.raw_select_packed)
        self.calls: dict = {}
        self.query = ""
        self.stats = (torch.zeros(len(T.TOPK_STATS), dtype=torch.int64, device=DEV)
                      if torch is not None and DEV == "cuda" else None)
        orig_topk, orig_select = self.orig

        def topk(*a, **k):
            self.calls[self.query] = ("raw_topk", a, k)
            if self.stats is not None:
                k = {**k, "stats": self.stats}
            return orig_topk(*a, **k)

        def select(*a, **k):
            self.calls[self.query] = ("raw_select", a, k)
            return orig_select(*a, **k)

        T.raw_topk_packed, T.raw_select_packed = topk, select

    def restore(self) -> None:
        self.T.raw_topk_packed, self.T.raw_select_packed = self.orig


def phase_raw_main(torch, main) -> dict:
    """At the default host-copy budget lastpoint-host takes the host route
    (no_host_rows); the budget is raised and the cpu entry evicted. Then
    ``raw_queries`` through ``Connection.execute`` on the resident cpu table,
    REPEATS times each: every run served by the device raw path with its
    kernel, every answer equal to the independent numpy answer; once per
    query the kill-switch host route (HORAEDB_RAW_DEVICE=0) too: the same
    rows where the order is total, the same ORDER BY keys where ties cross
    the LIMIT (the host reads rows in its merge order, not the resident
    order), the same row set where there is no ORDER BY. Then one unflushed
    tick and lastpoint-host again (hit+delta, the new row first), EXPLAIN,
    and the launch counters."""
    from horaedb_tpu_torch.ops import scan_topk as T
    from horaedb_tpu_torch.tools import tsbs

    db, exp = main["db"], main["raw_expected"]
    queries = raw_queries(exp["hc_host"])
    # Raw reads gather the rows they select from the cache entry's host
    # copy, which the default budget (HORAEDB_CACHE_HOST_ROWS_MB, 256 MB)
    # drops for a table this size: phases 4-6 ran with that default, and
    # there a raw read takes the host route. Then raise the budget on this
    # connection and evict the cpu entry, so the first query rebuilds it
    # with its host copy kept (its first run is that rebuild).
    name, sql, _ = queries[0]
    t = time.perf_counter()
    res = db.execute(sql)
    default_s = time.perf_counter() - t
    m = res.metrics
    check(m.get("path") == "host" and m.get("raw_host") == "no_host_rows",
          f"{name} at the default host-copy budget: path {m.get('path')} "
          f"({m.get('raw_host')})")
    _same_rows(res.to_pylist(), exp[name], f"{name} at the default budget vs numpy")
    cache = db.interpreters.executor.scan_cache
    cache.max_host_rows_bytes = 64 << 30
    cache.invalidate("cpu")
    say(f"raw {name} at the default host-copy budget: host route (no_host_rows) in "
        f"{default_s * 1e3:.3f} ms, equal to numpy; budget raised, cpu entry evicted")
    say(f"cpu rows at usage_user == 100.0 in the second 12 h: {exp['n_at_100_second_half']}; "
        f"high-cpu-1 reads host_{exp['hc_host']}")
    rec = RawRecorder(T, torch)
    _sync(torch)
    T.reset_counts()  # the raw main path's launches start here
    out = {"queries": {}}
    try:
        for name, sql, kernel in queries:
            rec.query = name
            runs = []
            for _ in range(REPEATS):
                tiles, kernels = T.TILES["raw_select"], T.KERNELS["raw_topk"]
                if rec.stats is not None:
                    rec.stats.zero_()
                t = time.perf_counter()
                res = db.execute(sql)
                secs = time.perf_counter() - t
                m = res.metrics
                check(m.get("path") == "raw_device" and m.get("raw_kernel") == kernel,
                      f"{name}: path {m.get('path')} kernel {m.get('raw_kernel')} "
                      f"({m.get('raw_host')})")
                if kernel == "select":
                    _select_geometry(T, rec.calls[name][2], cache._entries["cpu"].n_valid,
                                     T.TILES["raw_select"] - tiles, name)
                else:
                    stats = rec.stats.tolist() if rec.stats is not None else [None, None]
                    _topk_geometry(T, rec.calls[name][2], cache._entries["cpu"].n_valid,
                                   [*stats, T.KERNELS["raw_topk"] - kernels], name)
                got = res.to_pylist()
                _same_rows(got, exp[name], f"{name} vs numpy")
                runs.append({"seconds": secs, "cache": m.get("cache"),
                             "candidates": m.get("raw_candidates")})
            os.environ["HORAEDB_RAW_DEVICE"] = "0"
            try:
                t = time.perf_counter()
                host = db.execute(sql)
                host_s = time.perf_counter() - t
            finally:
                os.environ.pop("HORAEDB_RAW_DEVICE", None)
            check(host.metrics.get("path") == "host", f"{name}: kill switch took "
                  f"{host.metrics.get('path')}")
            href = host.to_pylist()
            if name in ("lastpoint-host", "high-cpu-1"):
                _same_rows(got, href, f"{name} vs the kill switch")
                how = "the same rows"
            elif kernel == "select":
                key = lambda r: (r["hostname"], r["ts"])  # noqa: E731
                check(_key_rows(got, key) == _key_rows(href, key),
                      f"{name}: row sets differ from the kill switch")
                how = "the same row set"
            else:
                col = sql.split("ORDER BY ")[1].split()[0]
                check([r[col] for r in got] == [r[col] for r in href],
                      f"{name}: ORDER BY keys differ from the kill switch")
                check(len({(r["hostname"], r["ts"]) for r in got}) == len(got),
                      f"{name}: duplicate rows")
                how = "the same ORDER BY keys"
            check(name in rec.calls, f"{name}: its kernel never launched")
            warm = statistics.median([r["seconds"] for r in runs[2:]])
            out["queries"][name] = {"runs": runs, "warm_s": warm, "host_s": host_s,
                                    "rows": len(got)}
            say(f"raw {name}: raw_device/{kernel}, {len(got)} rows equal to numpy; "
                f"execute runs {[round(r['seconds'] * 1e3, 3) for r in runs]} ms "
                f"(cache {[r['cache'] for r in runs]}); kill switch {host_s * 1e3:.3f} ms, "
                f"{how}")
        launches, plain_calls = dict(T.LAUNCHES), dict(T.PLAIN_CALLS)
        host_bytes = cache._entries["cpu"].host_bytes
        say(f"cpu entry rebuilt with its host copy: {host_bytes} B on the host")
        rec.query = "after a write"
        # one unflushed tick past the table's end: the delta rides the cache
        tick = tsbs.generate_cpu(HOSTS, tsbs.INTERVAL_MS, t0=2 * H12, seed=SEED + 1)
        db.catalog.open("cpu").write(tick)
        name, sql, _ = queries[0]
        res = db.execute(sql)
        m = res.metrics
        got = res.to_pylist()
        check(m.get("path") == "raw_device" and m.get("cache") == "hit+delta",
              f"{name} after a write: path {m.get('path')} cache {m.get('cache')}")
        check(got[0]["ts"] == 2 * H12 and got[0]["hostname"] == "host_7"
              and got[0]["usage_user"] == tick.columns["usage_user"][7],
              f"{name} after a write: first row {got[0]}")
        _same_rows(got[1:], exp[name][:9], f"{name} after a write")
        plan = db.execute("EXPLAIN " + queries[1][1]).column("plan")
        line = [p for p in plan if "Execution:" in p]
        check(line and "raw device" in line[0] and "top-k" in line[0],
              f"EXPLAIN of hottest-12h: {line}")
        say(f"raw {name} after one unflushed tick: raw_device, cache hit+delta, the new row "
            f"first; EXPLAIN: {line[0].strip()}")
    finally:
        rec.restore()
    if DEV == "cuda":
        check(launches["raw_topk"] > 0 and launches["raw_select"] > 0,
              f"raw main path launches {launches}")
        check(not any(plain_calls.values()), f"plain versions ran on the card: {plain_calls}")
    say(f"raw main path launches: {launches}")
    for what, g in DETAIL.get("select_geometry", {}).items():
        say(f"raw {what} selection geometry: {g['windows']} windows of {g['rows']} rows in "
            f"{g['tiles']} tiles (walked {g['walked']}), inside the real rows")
    for what, g in DETAIL.get("topk_geometry", {}).items():
        say(f"raw {what} top-k geometry: {g['windows']} windows of {g['rows']} rows in "
            f"{g['tiles']} tiles; its keys kernel counted {g['visited']} rows in "
            f"{g['walked']} tiles, {g['kernels']} kernels, of {g['n_valid']} real rows")
    out.update(launches=launches, calls=rec.calls, default_budget_s=default_s,
               host_bytes=host_bytes)
    DETAIL["raw_main"] = {k: v for k, v in out.items() if k != "calls"}
    return out


# ---- phase 16: raw-read replay and timings -----------------------------------

# the top-k's device work is its memset, the copy of its tile table and
# topk_keys, topk_refine and topk_write; the selection's, its memset, the
# copy of its tile table and the raw_select launch
RAW_KERNELS = ("topk_keys", "topk_refine", "topk_write", "raw_select", "Memset", "HtoD")


def _raw_bound(torch, kind, args, kw) -> tuple[float, str, dict]:
    """Least time for the work: each input read once (the series codes of
    the real rows, the timestamps of allowed rows, the filter fields of
    rows in range, the key field of masked-in rows, each at its resident
    width), each output written once, over HBM bandwidth. Rows past the
    cache entry's real rows are pads (series code S, the allow list's
    last entry, always 0) that no answer needs, so they count nothing. A
    selection given its row windows needs only their rows (no other row
    can pass) and reads its tile table once. No operation side: the
    kernels do a few integer compares per row, far below what the bytes
    cost, and no count of them is derived here."""
    from horaedb_tpu_torch.ops import encoding as E, scan_topk as T

    sp, tp, vals, session, dyn = args
    n = E.layout_rows(sp, kw["series_layout"])
    n_f = len(kw["numeric_filters"])
    sc = E.decode_series(sp, kw["series_layout"], n).long()
    tr = E.decode_ts(tp, kw["ts_layout"], n)
    lits = dyn[:n_f].view(torch.float32)
    lo, hi = (int(x) for x in dyn[n_f:n_f + 2].tolist())
    allowed = session[sc] != 0
    in_range = allowed & (tr >= lo) & (tr < hi)
    real = sc < session.numel() - 1
    nbytes = 0
    if kw.get("windows") is not None:
        inside = torch.from_numpy(_in_windows(kw["windows"], n)).to(sc.device)
        real, allowed, in_range = real & inside, allowed & inside, in_range & inside
        nbytes += 8 * len(T.select_tiles(kw["windows"], n))
    n_real = int(real.sum())

    def share(parts, frac):
        return sum(_bytes_of(p) if p.numel() < 65536 else int(_bytes_of(p) * frac)
                   for p in parts)

    nbytes += _bytes_of(session) + _bytes_of(dyn) + share(sp, n_real / n if n else 0.0)
    nbytes += share(tp, float(allowed.float().mean()) if n else 0.0)
    fields = {f for f, _ in kw["numeric_filters"]}
    frac = float(in_range.float().mean()) if n else 0.0
    nbytes += sum(share(vals[f], frac) for f in fields)
    if kind == "raw_topk":
        _, _, dv = E.decode_layouts(sp, tp, vals, kw["series_layout"], kw["ts_layout"],
                                    kw["value_layouts"])
        m = T._raw_mask(sc, tr, dv, session != 0, lits, lo, hi, kw["numeric_filters"])
        if not kw["key_is_ts"] and kw["key_field"] not in fields:
            nbytes += share(vals[kw["key_field"]], float(m.float().mean()) if n else 0.0)
        nbytes += 4 * kw["k"] * (2 if kw.get("with_keys") else 1)  # slots, keys
    else:
        nbytes += 4 * (1 + kw["select_slots"])
    return nbytes / PEAK_BYTES_S * 1e3, "bytes", {"bytes": nbytes, "rows": n, "real": n_real}


def _raw_library(torch, kind, args, kw):
    """One PyTorch call computing the same function from the same mask and
    keys (computed outside the timed call): ``torch.topk`` over the masked
    key tensor, or ``torch.nonzero`` over the mask."""
    from horaedb_tpu_torch.ops import encoding as E, scan_topk as T

    sp, tp, vals, session, dyn = args
    lits, lo, hi, _, _ = T._unpack_dyn(dyn, kw["numeric_filters"])
    sc, tr, dv = E.decode_layouts(sp, tp, vals, kw["series_layout"], kw["ts_layout"],
                                  kw["value_layouts"])
    m = T._raw_mask(sc, tr, dv, session != 0, lits, lo, hi, kw["numeric_filters"])
    if kind == "raw_select":
        return lambda: torch.nonzero(m)
    key = T._sort_key(tr, dv, m, descending=kw["descending"], key_is_ts=kw["key_is_ts"],
                      key_field=kw["key_field"])
    return lambda: torch.topk(key, kw["k"])


def phase_raw_timings(torch, raw, card) -> list:
    """Each query's last main-path call of its raw kernel, replayed: kernel
    against plain (bit-equal), then its device time, bound, plain and
    library times and the copy back of its slots; warm execute latency
    per query against the kill-switch route. The kernel line holds each
    kernel at its heaviest query: hottest-12h (topk over 17.28M candidate
    rows) and high-cpu-16 (the largest selection buffer)."""
    from horaedb_tpu_torch.ops import scan_topk as T

    fns = {"raw_topk": (T.raw_topk_packed, T.raw_topk_plain),
           "raw_select": (T.raw_select_packed, T.raw_select_plain)}
    heaviest = {"raw_topk": "hottest-12h", "raw_select": "high-cpu-16"}
    kernels = []
    for name in raw["queries"]:
        kind, args, kw = raw["calls"][name]
        launch_fn, plain_fn = fns[kind]
        got = launch_fn(*args, **kw)
        _sync(torch)
        want = plain_fn(*args, **kw)
        check(torch.equal(got, want), f"{name} replay: the {kind} kernel differs from plain")
        err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
        launch = lambda f=launch_fn, a=args, k=kw: f(*a, **k)  # noqa: E731
        plain = lambda f=plain_fn, a=args, k=kw: f(*a, **k)  # noqa: E731
        launch_ms = _time_launch(torch, launch)
        device_ms = _family_device_ms(torch, launch, RAW_KERNELS, reps=10,
                                      label=f"{kind} at {name}")
        ms = device_ms if device_ms is not None else launch_ms
        plain_ms = _time_launch(torch, plain, reps=3)
        lib_ms = _time_launch(torch, _raw_library(torch, kind, args, kw))
        bound_ms, bound_by, work = _raw_bound(torch, kind, args, kw)
        # the same bound over every real row, as if no window were given
        real_ms, _, _ = _raw_bound(torch, kind, args,
                                   {k: v for k, v in kw.items() if k != "windows"})
        kernels_before = T.KERNELS.get(kind, 0)
        if kind == "raw_topk":
            # the rows the keys kernel decoded, counted on the card
            stats = torch.zeros(len(T.TOPK_STATS), dtype=torch.int64, device=DEV)
            launch_fn(*args, **kw, stats=stats)
            visited = stats.tolist()[0]
        else:
            launch()
            w = kw.get("windows")  # the selection: its windows' rows
            visited = int(sum(b - a for a, b in w)) if w is not None else work["rows"]
        n_kernels = T.KERNELS.get(kind, 0) - kernels_before
        copies = []
        for _ in range(10):
            out = launch()
            _sync(torch)
            t = time.perf_counter()
            out.cpu()
            copies.append((time.perf_counter() - t) * 1e3)
        copy_ms = statistics.median(copies)
        slots = kw.get("k", kw.get("select_slots"))
        say(f"kernel {kind} at {name} ({work['rows']} rows, {work['real']} real, {slots} slots, "
            f"{work['bytes']} B; {visited} rows "
            + ("visited" if kind == "raw_topk" else "in its windows")
            + (f" by {n_kernels} kernels" if kind == "raw_topk" else "") + "): "
            f"{ms:.4f} ms on the device timeline "
            f"({'profiler' if device_ms is not None else 'events'}), {launch_ms:.4f} ms "
            f"launch incl. wrapper, plain {plain_ms:.4f} ms, "
            f"{'torch.topk' if kind == 'raw_topk' else 'torch.nonzero'} {lib_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}, the window rows; {real_ms:.6f} over every "
            f"real row), copy back {copy_ms:.4f} ms [{card}]")
        DETAIL.setdefault("raw_kernels", {})[name] = {
            "kernel": kind, "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_real_rows_ms": real_ms,
            "bytes": work["bytes"], "slots": slots, "copy_ms": copy_ms,
            "rows_visited": visited, "kernels": n_kernels}
        if heaviest[kind] == name:
            kernels.append({
                "name": kind, "route": "cuda", "source": RAW_SRC,
                "replaces": RAW_REPLACES[kind], "launches": int(raw["launches"][kind]),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
            })
    for name, q in raw["queries"].items():
        say(f"raw latency {name}: warm execute {q['warm_s'] * 1e3:.3f} ms (median of runs "
            f"3-{REPEATS}), kill-switch host route {q['host_s'] * 1e3:.3f} ms [{card}]")
    return kernels

# ---- phase 17: the cohort kernels against their plain versions --------------

COHORT_BS = (1, 2, 7, 32)
COHORT_REPLACES = {
    "cohort": "horaedb_tpu/ops/scan_agg.py:582",
    "raw_topk_cohort": "horaedb_tpu/ops/scan_topk.py:397",
    "selective": "horaedb_tpu/ops/scan_agg.py:423",
}
RAW_COHORT_BS = (1, 5, 32, 33)  # 33: two launch sequences
COHORT_WINDOWS = (None, "series", "padded")


def _cohort_abs_sums(torch, args, kw):
    """Per member, the plain version's sums of |x| over the rows it keeps
    (the scale of each sum's tolerance); the columns decode once."""
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    sp, tp, values, sessions, dyns = args
    n_agg = kw["n_agg_fields"]
    layouts = kw.get("value_layouts") or tuple(S._dense_layout(p) for p in values)
    sc, tr, vals = E.decode_layouts(sp, tp, values, kw.get("series_layout", ("raw",)),
                                    kw.get("ts_layout", ("raw",)), layouts)
    cols = [v.float().abs() for v in vals[:n_agg]] + [v.float() for v in vals]
    raw_kw = {**kw, "numeric_filters": tuple((n_agg + f, op) for f, op in kw["numeric_filters"]),
              "value_layouts": tuple(("raw",) for _ in cols),
              "ts_layout": ("raw",), "series_layout": ("raw",)}
    cols = tuple((c.contiguous(),) for c in cols)
    out = []
    for b in range(sessions.shape[0]):
        packed = S._packed_body((sc.contiguous(),), (tr.contiguous(),), cols, sessions[b],
                                dyns[b], **{**raw_kw, "selective": False})
        out.append(_split(torch, packed, kw)[1])
    return out


def _time_once(torch, fn):
    """(result, ms) of one call, without warm-up: for the plain versions
    at the real shape, which run once (by CUDA events on the card)."""
    if DEV != "cuda":
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _cohort_check(torch, args, kw, what) -> tuple[float, int, float]:
    """One launch of the cohort kernel and one run of its plain version on
    the same tensors; member by member as ``_compare``. Returns the
    largest |sum difference|, the rows counted and the plain run's ms."""
    from horaedb_tpu_torch.ops import scan_agg as S

    got = S.cached_scan_agg_cohort(*args, **kw)
    _sync(torch)
    want, plain_ms = _time_once(torch, lambda: S._cohort_body(*args, **kw))
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err, counted = 0.0, 0
    for b, abs_sums in enumerate(_cohort_abs_sums(torch, args, kw)):
        gb = _split(torch, got[b], kw)
        err = max(err, _compare(f"{what} member {b}", *gb, _split(torch, want[b], kw),
                                abs_sums, kw["need_minmax"]))
        counted += int(gb[0].sum())
    return err, counted, plain_ms


def _cohort_case(torch, rng, layout_case, arm, need_minmax, op, B, G, nb, special=False,
                 n_agg=None, n_series=40, per=3001):
    import numpy as np

    from horaedb_tpu_torch.convert import entry_from_reference
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    series_layout, ts_layout, kinds = layout_case
    arrays, layouts = _resident_case(rng, n_series, per, series_layout, ts_layout, kinds)
    if special:  # NaN and signed zeros in the first (raw) field
        for rows, val in ((slice(3, 9), np.nan), (slice(40, 52), -0.0), (slice(52, 60), 0.0),
                          (slice(per + 1, per + 4), -0.0)):
            arrays["value/0/0"][rows] = val
    entry = entry_from_reference(arrays, layouts, dev)
    if any(k == "bf16" for k in kinds):
        entry = _with_bf16(torch, entry, kinds)
    nf = len(kinds)
    n_agg = nf - 1 if n_agg is None else n_agg
    filters = ((nf - 1, S._FILTER_OPS[op]),)
    # literals the filter field holds (codes, for a field kept in code space)
    held = E.decode_value(entry.value_parts[nf - 1], entry.value_layouts[nf - 1],
                          n_series * per).cpu().numpy()[: n_series * per]
    sessions, dyns = [], []
    for b in range(B):
        gos = np.append(rng.integers(0, G, n_series), 0).astype(np.int32)
        allow = np.append(rng.random(n_series) < 0.8, False)
        allow[0] = True
        lo, hi = int(rng.integers(0, 400)), per * 10 - int(rng.integers(0, 400))
        if b == 1:
            allow[:] = False  # no series
        if b == 2:
            hi = lo  # no time
        t0 = lo - int(rng.integers(0, 50))
        width = max(1, (hi - t0) // max(nb - 1, 1))
        sessions.append(S.pack_session(gos, allow))
        dyns.append(S.pack_dyn([float(held[rng.integers(0, len(held))])], lo, hi, t0, width))
    args = (*entry.kernel_args().values(), torch.from_numpy(np.stack(sessions)).to(dev),
            torch.from_numpy(np.stack(dyns)).to(dev))
    kw = dict(n_groups=G, n_buckets=nb, n_agg_fields=n_agg, numeric_filters=filters,
              need_minmax=need_minmax, segment_impl=arm, **entry.layout_kwargs())
    err, counted, _ = _cohort_check(torch, args, kw, f"cohort/{arm}/B={B}/{layout_case}/{op}")
    check(counted > 0, f"cohort/{arm}/B={B}/{layout_case}: no row passed")
    return err


# The real-row prefix (full scans and the cohort read the first n_rows
# rows of the layout): an arm's (n_groups, n_buckets: one bucket takes
# the cohort's one-series path in most chunks); the cohort sizes,
# (agg fields, min/max) and prefixes the cases cycle through. "real" is the
# table's real rows (ending inside a 32-row step and inside a chunk at per
# = 5003; at a chunk's edge at per = 4096), "padded" the layout's rows,
# "zero" no row (its members allow no series).
PREFIX_ARMS = {"single": (1, 1), "shared": (16, 1), "scatter": (16, 64)}
PREFIX_BS = (1, 2, 31, 32, 33)
PREFIX_FIELDS = ((0, True), (1, True), (10, True), (1, False), (10, False))
PREFIX_KINDS = ("real", "padded", "zero")
PREFIX_SERIES = 11


def _prefix_inputs(torch, rng, n_agg, need_minmax, arm, B, prefix, per=5003, special=False,
                   op=">="):
    """A resident table of PREFIX_SERIES series x ``per`` rows sorted by
    (series, ts), 10 ms apart (delta series codes and timestamps, raw
    values: ``n_agg`` agg fields and an integer filter field), padded to
    its bucket as the scan cache pads; B members grouping by series x
    bucket, their time ranges cycling through the whole range, one that
    misses whole chunks, an empty one, a late one, one that allows no
    series and one over half of them. ``special``: NaN, +-0 and +-inf in
    the first field at series, bucket and chunk edges. Returns (args, kw)
    of a cohort launch whose kw holds ``n_rows``."""
    import numpy as np

    from horaedb_tpu_torch.convert import entry_from_reference
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    n_series = PREFIX_SERIES
    n = n_series * per
    arrays, layouts = _resident_case(rng, n_series, per, "delta", "delta",
                                     ("raw",) * (n_agg + 1))
    G, nb = PREFIX_ARMS[arm]
    width = -(-per * 10 // nb)
    if special and n_agg:
        col = arrays["value/0/0"]
        edges = [s * per for s in range(n_series)] + [c * 512 for c in range(1, n // 512)]
        edges += [s * per + (k * width) // 10 for s in range(n_series) for k in range(1, nb)]
        picks = (np.nan, -0.0, 0.0, np.inf, -np.inf)
        for j, e in enumerate(sorted(set(edges))):
            for d in (-1, 0):
                if 0 <= e + d < n:
                    col[e + d] = picks[(j + d) % len(picks)]
    entry = entry_from_reference(arrays, layouts, dev)
    held = arrays[f"value/{n_agg}/0"][:n]
    sessions, dyns = [], []
    for b in range(B):
        gos = np.append(np.arange(n_series) % G, 0).astype(np.int32)
        allow = np.append(rng.random(n_series) < 0.8, False)
        allow[0] = True
        lo, hi = 0, per * 10
        kind = b % 6
        if kind == 1:
            lo, hi = 9_000, 29_000  # misses whole chunks
        elif kind == 2:
            lo = hi = 5_000  # no time
        elif kind == 3:
            lo = 31_000
        elif kind == 4:
            allow[:] = False
        elif kind == 5:
            allow[n_series // 2:n_series] = False
            hi = 15_000
        if prefix == "zero":
            allow[:] = False
        # a held value for = and !=; else a literal every row passes
        lit = {"=": float(held[rng.integers(0, n)]), "!=": float(held[rng.integers(0, n)]),
               "<": 1e30, "<=": 1e30}.get(op, -1e30)
        sessions.append(S.pack_session(gos, allow))
        dyns.append(S.pack_dyn([lit], lo, hi, -7 if b % 2 else 0, width))
    rows = E.layout_rows(entry.series_parts, entry.series_layout)
    n_rows = {"real": n, "padded": rows, "zero": 0}[prefix]
    args = (*entry.kernel_args().values(), torch.from_numpy(np.stack(sessions)).to(dev),
            torch.from_numpy(np.stack(dyns)).to(dev))
    kw = dict(n_groups=G, n_buckets=nb, n_agg_fields=n_agg,
              numeric_filters=((n_agg, S._FILTER_OPS[op]),), need_minmax=need_minmax,
              segment_impl=arm, n_rows=n_rows, **entry.layout_kwargs())
    return args, kw


def _prefix_case(torch, rng, n_agg, need_minmax, arm, B, prefix, per=5003, special=False,
                 op=">=") -> tuple[float, str, list]:
    """The cohort over a real-row prefix against its plain version (which
    reads every row), with its launch statistics, and members 0 and 1 as
    solo full scans over the same prefix against theirs. Returns the
    largest |sum difference|, the arm the cohort took and its statistics
    (``scan_agg.COHORT_STATS``)."""
    from horaedb_tpu_torch.ops import scan_agg as S

    args, kw = _prefix_inputs(torch, rng, n_agg, need_minmax, arm, B, prefix, per, special, op)
    what = f"prefix {prefix} per={per} {arm} B={B} F={n_agg} minmax={need_minmax}" + (
        " specials" if special else "")
    n_seg = kw["n_groups"] * kw["n_buckets"]
    taken = S.cohort_arm(arm, B, len(args[2]), n_seg, n_agg, need_minmax)
    stats = None
    if DEV == "cuda":
        stats = torch.zeros(len(S.COHORT_STATS), dtype=torch.int64, device=DEV)
        S.cached_scan_agg_cohort(*args, **kw, stats=stats)
    err, counted, _ = _cohort_check(torch, args, kw, f"cohort {what}")
    check(prefix == "zero" or counted > 0, f"cohort {what}: no row passed")
    check(prefix != "zero" or counted == 0, f"cohort {what}: a row passed")
    sp, tp, vals, sessions, dyns = args
    solo_kw = {**kw, "selective": False}
    if arm == "shared" and not S.shared_fits(n_seg, n_agg, need_minmax):
        solo_kw["segment_impl"] = "scatter"
    for b in range(min(B, 2)):
        err = max(err, _check_call(torch, "cached", (sp, tp, vals, sessions[b], dyns[b]),
                                   solo_kw, f"full scan {what} member {b}")[0])
    got = stats.tolist() if stats is not None else []
    if got:
        chunks = S.cohort_chunks(kw["n_rows"], len(vals))[1]
        check(got[0] == chunks, f"cohort {what}: {got[0]} chunks decoded, {chunks} expected")
        check(got[1] + got[2] == chunks * B, f"cohort {what}: member-chunks {got[1:3]}")
        check(B < 2 or prefix == "zero" or got[2] > 0, f"cohort {what}: no chunk skipped")
    return err, taken, got


def _cohort_windows(rng, cols, lay, sessions, dyns, filters, kind):
    """Each member's row windows, covering every row its mask can pass:
    ``series`` its allowed series' in-range rows, as the executor builds
    them (none for a member that allows no series or no time); ``padded``
    those widened by 0-3000 rows a side, so that members' windows overlap
    and start inside a 128-row delta block."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E, scan_topk as T

    sp, tp, vals = cols
    sc, tr, _ = E.decode_layouts(sp, tp, vals, lay.get("series_layout", ("raw",)),
                                 lay.get("ts_layout", ("raw",)), lay["value_layouts"])
    codes, ts = sc.cpu().numpy().astype(np.int64), tr.cpu().numpy()
    out = []
    for b in range(sessions.shape[0]):
        allow = sessions[b].cpu().numpy() != 0
        _, lo, hi, _, _ = T._unpack_dyn(dyns[b].cpu(), filters)
        w = _runs(allow[codes] & (ts >= lo) & (ts < hi))
        if kind == "padded" and len(w):
            n_real = int((codes < len(allow) - 1).sum())
            grow = rng.integers(0, 3001, w.shape)
            w = _union(np.clip(w + grow * np.array([-1, 1]), 0, n_real))
        out.append(w.reshape(-1, 2))
    return out


def _raw_cohort_case(torch, rng, cols, lay, n_series, ts_max, B, k, key_is_ts, desc, op,
                     what, windows=None) -> int:
    """B4c against its plain version and against B solo top-k launches,
    bit-equal; member 1 allows no series, member 2 has no time. With
    ``windows`` (a ``_cohort_windows`` kind) the members' windows go to the
    cohort and to each member's solo launch; on the card the launch runs at
    most five kernels a sequence of 32 members."""
    import numpy as np

    from horaedb_tpu_torch.ops import scan_agg as S, scan_topk as T

    dev = torch.device(DEV)
    filters = ((1, S._FILTER_OPS[op]),)
    sessions, dyns = [], []
    for b in range(B):
        allow = np.append(rng.random(n_series) < 0.8, False).astype(np.int32)
        if b == 1:
            allow[:] = 0
        lo, hi = (0, ts_max + 1) if b % 2 == 0 else (15, max(ts_max - 25, 15))
        if b == 2:
            lo = hi = 50
        key_lo, key_hi = T.topk_key_bounds(desc, key_is_ts, lo, hi)
        sessions.append(allow)
        dyns.append(T.pack_raw_dyn([float(rng.integers(-20, 21))], lo, hi, key_lo, key_hi))
    sess = torch.from_numpy(np.stack(sessions)).to(dev)
    dyn = torch.from_numpy(np.stack(dyns)).to(dev)
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0, numeric_filters=filters,
              **lay)
    wins = (None if windows is None
            else _cohort_windows(rng, cols, lay, sess, dyn, filters, windows))
    before = T.KERNELS["raw_topk_cohort"]
    got = T.raw_topk_cohort(*cols, sess, dyn, windows=wins, **kw)
    _sync(torch)
    if DEV == "cuda":
        ran = T.KERNELS["raw_topk_cohort"] - before
        check(ran <= 5 * -(-B // T.MAX_COHORT), f"{what}: {ran} kernels for {B} members")
    want = T.raw_topk_cohort_plain(*cols, sess, dyn, **kw)
    check(torch.equal(got, want), f"{what} windows={windows}: cohort kernel differs from plain")
    for b in range(B):
        solo = T.raw_topk_packed(*cols, sess[b], dyn[b], windows=None if wins is None
                                 else wins[b], **kw)
        check(torch.equal(solo, got[b]), f"{what} windows={windows}: member {b} differs from "
                                         f"its solo launch")
    return 1


def phase_cohort_kernels(torch) -> None:
    """B1e, B4c and B1d on the card against their plain versions."""
    import numpy as np

    rng = np.random.default_rng(SEED + 17)
    err, n_b1e = 0.0, 0
    arms = (("single", 1, 1), ("shared", 16, 8), ("scatter", 512, 64))
    for i, (arm, G, nb) in enumerate(arms):
        for c, case in enumerate(LAYOUT_CASES):
            for need_minmax in (True, False):
                j = (i * len(LAYOUT_CASES) + c) * 2 + need_minmax
                err = max(err, _cohort_case(torch, rng, case, arm, need_minmax, OPS[j % 6],
                                            COHORT_BS[j % 4], G, nb))
                n_b1e += 1
        err = max(err, _cohort_case(torch, rng, LAYOUT_CASES[0], arm, True, ">=", 7, G, nb,
                                    special=True))
        err = max(err, _cohort_case(torch, rng, ("delta", "delta", ("raw",)), arm, True, "!=",
                                    32, G, nb, n_agg=0))
        n_b1e += 2
    # the real-row prefix: each arm over the real rows, the layout's and
    # none, (F, minmax) and B cycling; NaN, +-0 and +-inf at run and chunk
    # edges; members that skip whole chunks (the launch statistics check it)
    n_prefix = 0
    for a, arm in enumerate(PREFIX_ARMS):
        for p, prefix in enumerate(PREFIX_KINDS):
            F, need_minmax = PREFIX_FIELDS[(a + p) % len(PREFIX_FIELDS)]
            err = max(err, _prefix_case(torch, rng, F, need_minmax, arm,
                                        PREFIX_BS[(a + p + 2) % len(PREFIX_BS)], prefix,
                                        op=OPS[(a + p) % 6])[0])
            n_prefix += 1
        err = max(err, _prefix_case(torch, rng, 3, True, arm, 7, "real", per=4096,
                                    special=True)[0])
        n_prefix += 1
    n_b4c = 0
    for n in RAW_SIZES:
        for li, layout in enumerate(RAW_LAYOUTS):
            cols, lay, n_series, ts_max = _raw_columns(torch, rng, n, layout)
            for j, (key_is_ts, desc) in enumerate(RAW_KEYS):
                at = li * 4 + j + n
                k = min(RAW_KS[at % len(RAW_KS)], max(n, 1))
                n_b4c += _raw_cohort_case(
                    torch, rng, cols, lay, n_series, ts_max,
                    RAW_COHORT_BS[at % len(RAW_COHORT_BS)], k, key_is_ts, desc, OPS[at % 6],
                    f"raw_topk_cohort n={n} {layout} ts={key_is_ts} desc={desc}",
                    COHORT_WINDOWS[at % len(COHORT_WINDOWS)])
    # the +-0 trap at the threshold, three members
    pm0 = np.array([-0.0, -0.0, -0.0, -0.0, -5.0, 0.0, -1.0, -2.0, -3.0, -4.0, -6.0, -7.0],
                   dtype=np.float32)
    dev = torch.device(DEV)
    cols = ((torch.zeros(12, dtype=torch.int32, device=dev),),
            (torch.arange(12, dtype=torch.int32, device=dev),),
            ((torch.from_numpy(pm0).to(dev),), (torch.arange(12, dtype=torch.float32,
                                                             device=dev),)))
    for k in (1, 2, 5, 12):
        for desc in (True, False):
            n_b4c += _raw_cohort_case(
                torch, rng, cols, dict(value_layouts=(("raw",), ("raw",))), 1, 11, 3, k, False,
                desc, ">=", f"raw_topk_cohort +-0 k={k} desc={desc}",
                COHORT_WINDOWS[(k + desc) % len(COHORT_WINDOWS)])
    # B1d: the unpacked selective form against the packed SELECTIVE kernel
    n_b1d = 0
    for arm, G, nb in arms:
        for need_minmax in (True, False):
            _b1d_case(torch, rng, arm, G, nb, need_minmax)
            n_b1d += 1
    _sync(torch)
    say(f"cohort kernels vs plain: B1e {n_b1e} cases and {n_prefix} over a real-row prefix "
        f"(max |sum diff| {err}), B4c {n_b4c} cases bit-equal, B1d {n_b1d} cases")
    DETAIL["cohort_kernel_cases"] = {"b1e": n_b1e, "b1e_prefix": n_prefix, "b4c": n_b4c,
                                     "b1d": n_b1d, "b1e_max_abs_err": err}


def _b1d_inputs(torch, rng, n_series=40, per=3001):
    """Dense raw columns, a gather of five series' rows padded to its
    bucket, a session and the scalars of one selective query."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E

    dev = torch.device(DEV)
    n = n_series * per
    codes = np.append(np.repeat(np.arange(n_series), per), n_series).astype(np.int32)
    ts = np.append(np.tile(np.arange(per) * 10, n_series) + rng.integers(0, 9, n), -1)
    vals = rng.normal(0, 50, (3, n + 1)).astype(np.float32)
    vals[2] = np.round(vals[2])
    allow = np.append(rng.random(n_series) < 0.8, False)
    pick = np.nonzero(allow[:n_series])[0][:5]
    idx = np.concatenate([np.arange(s * per + 7, s * per + per - 9, dtype=np.int32)
                          for s in pick])
    idx = E.pad_to_bucket(idx, len(idx), fill=np.int32(n))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(idx), t(codes), t(ts.astype(np.int32)), t(vals), allow, t


def _b1d_case(torch, rng, arm, G, nb, need_minmax) -> None:
    import numpy as np

    from horaedb_tpu_torch.ops import scan_agg as S

    idx, codes, ts, vals, allow, t = _b1d_inputs(torch, rng)
    gos = np.append(rng.integers(0, G, len(allow) - 1), 0).astype(np.int32)
    lits = t(np.array([4.0], dtype=np.float32))
    lo, hi, t0 = 15, 29_000, -7
    width = max(1, 30_000 // max(nb - 1, 1))
    filters = ((2, S._FILTER_OPS[">="]),)
    kw = dict(n_groups=G, n_buckets=nb, n_agg_fields=2, numeric_filters=filters,
              need_minmax=need_minmax, segment_impl=arm)
    got = S.selective_cached_scan_agg(idx, codes, ts, vals, t(gos), t(allow), lits, lo, hi, t0,
                                      width, **kw)
    session = t(S.pack_session(gos, allow))
    dyn = t(S.pack_dyn([4.0], lo, hi, t0, width, idx.cpu().numpy()))
    pargs = ((codes,), (ts,), tuple((v.contiguous(),) for v in vals), session, dyn)
    pkw = {**kw, "selective": True, "value_layouts": (("raw",),) * 3, "ts_layout": ("raw",),
           "series_layout": ("raw",)}
    packed = _split(torch, S.cached_scan_agg_packed(*pargs, **pkw), pkw)
    _sync(torch)
    what = f"selective_cached_scan_agg/{arm}/minmax={need_minmax}"
    abs_sums = _abs_sums(torch, "cached_selective", pargs, pkw)
    flat = [g.reshape(-1) for g in got]
    # two launches sum with atomics in different orders: sums to SUM_RTOL
    _compare(f"{what} vs the SELECTIVE packed kernel", *flat, packed, abs_sums, need_minmax)
    want = _split(torch, S._packed_body(*pargs, **pkw), pkw)
    _compare(what, *flat, want, abs_sums, need_minmax)
    check(int(got[0].sum()) > 0, f"{what}: no row passed")


# ---- phase 18: the dashboard flood through the Proxy ---------------------------

FLOOD_THREADS = 32
# The batcher's window for the fused arm. A cohort holds the members whose
# host work (parse, plan, join) ends inside the window, so its size scales
# with the window over the host's speed under the GIL: the reference
# bench's 5 ms gave cohorts of up to 15-19 on one H100 host and of at most
# 5 on a host about 4x slower at the tail. 40 ms keeps cohorts of 8 on a
# host 8x slower than the first; a cohort still closes early at max_cohort.
FLOOD_WINDOW_S = 0.040
FLOOD_WARMUP = 64
FLOOD_MEASURED = 256
FLOOD_H3 = 3 * 3_600_000


def flood_queries() -> list:
    """The 32 texts of the flood: the reference's flood shape over the cpu
    schema, start t0 + (q % 8) * 3 h (the table starts at 0) and literal
    ((q // 8) % 4) * 20 + 0.5."""
    t_end = HOURS * 3_600_000
    return [
        f"SELECT hostname, count(usage_user), sum(usage_user), max(usage_user) FROM cpu "
        f"WHERE ts >= {(q % 8) * FLOOD_H3} AND ts < {t_end} "
        f"AND usage_user >= {((q // 8) % 4) * 20 + 0.5} GROUP BY hostname"
        for q in range(32)
    ]


def _flood_expected(tsbs, rows) -> list:
    """Per flood text, (count, sum, sum of |x|, max) per host from the
    generated rows (time-major: tick, then host), on the float32 values
    the device columns hold; sums in float64."""
    import numpy as np

    n_ticks = HOURS * 3_600_000 // tsbs.INTERVAL_MS
    per_slot = FLOOD_H3 // tsbs.INTERVAL_MS
    u = rows.columns["usage_user"].astype(np.float32).reshape(n_ticks // per_slot, per_slot,
                                                              HOSTS)
    by_lit = []
    for lit in range(4):
        keep = u >= np.float32(lit * 20 + 0.5)
        w = np.where(keep, u, 0).astype(np.float64)
        by_lit.append((keep.sum(axis=1), w.sum(axis=1), np.abs(w).sum(axis=1),
                       np.where(keep, u, -np.inf).max(axis=1)))
    out = []
    for q in range(32):
        c, s, a, m = by_lit[(q // 8) % 4]
        lo = q % 8
        out.append((c[lo:].sum(0), s[lo:].sum(0), a[lo:].sum(0), m[lo:].max(0)))
    return out


def _check_flood(res, exp, what) -> None:
    import numpy as np

    c, s, a, m = exp
    hosts = np.array([int(h[5:]) for h in res.columns[0]])
    check(len(hosts) == int((c > 0).sum()) and len(set(hosts.tolist())) == len(hosts),
          f"{what}: {len(hosts)} hosts")
    check(np.array_equal(np.asarray(res.columns[1]), c[hosts]), f"{what}: counts")
    got_s = np.asarray(res.columns[2], dtype=np.float64)
    check(bool((np.abs(got_s - s[hosts]) <= SUM_RTOL * a[hosts]).all()), f"{what}: sums")
    check(np.array_equal(np.asarray(res.columns[3], dtype=np.float64), m[hosts]),
          f"{what}: maxs")


class CohortRecorder:
    """Wraps the cohort wrapper to keep its last call (args and kwargs)
    for the replay."""

    def __init__(self, S):
        self.S = S
        self.orig = S.cached_scan_agg_cohort
        self.last = None

        def cohort(*a, **k):
            self.last = (a, k)
            return self.orig(*a, **k)

        S.cached_scan_agg_cohort = cohort

    def restore(self) -> None:
        self.S.cached_scan_agg_cohort = self.orig


def _flood_arm(torch, proxy, texts, n) -> dict:
    """The reference flood's closed loop (bench.py's ``flood``):
    FLOOD_THREADS threads take the next query number q from one shared
    counter, send texts[q % 32] and take another as soon as it is
    answered. Returns per-query latency and results."""
    import threading

    lat = [0.0] * n
    results = [None] * n
    errors = []
    idx = iter(range(n))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                q = next(idx, None)
            if q is None:
                return
            try:
                t0 = time.perf_counter()
                results[q] = proxy.handle_sql(texts[q % len(texts)])
                lat[q] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(f"query {q}: {e!r}")

    threads = [threading.Thread(target=worker) for _ in range(FLOOD_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    check(not errors, f"flood errors: {errors[:3]}")
    return {"lat": lat, "results": results, "wall": wall}


def _dispatch_total(S) -> int:
    """Cached scan-agg dispatches: launches on the card, plain versions in
    a CPU rehearsal (phase 18 checks that none ran on the card)."""
    forms = ("cached", "cached_selective", "cached_cohort")
    return sum(sum(S.LAUNCHES[f].values()) + S.PLAIN_CALLS[f] for f in forms)


def phase_flood(torch, main) -> dict:
    """The dashboard flood through ``Proxy.handle_sql`` on phase 4's
    connection: the fused arm ([wlm.batch] on), then the solo arm (off).
    Besides the gated numbers it records the garbage collector's runs by
    generation and the live threads during the fused arm."""
    import gc
    import threading

    from horaedb_tpu_torch.ops import scan_agg as S
    from horaedb_tpu_torch.proxy import Proxy
    from horaedb_tpu_torch.query import executor as X
    from horaedb_tpu_torch.utils.config import BatchSection
    from horaedb_tpu_torch.utils.metrics import REGISTRY

    def counter(name, **labels):
        return REGISTRY.counter(name, "", labels=labels).value

    db, exp = main["db"], main["flood_expected"]
    texts = flood_queries()
    rec = CohortRecorder(S)
    out = {}
    try:
        fused = Proxy(db, batch_cfg=BatchSection(enabled=True, window_s=FLOOD_WINDOW_S,
                                                  max_cohort=32))
        try:
            X.reset_counts()  # fallbacks count from the first warm-up query on
            _flood_arm(torch, fused, texts, FLOOD_WARMUP)
            _sync(torch)
            S.reset_counts()  # the flood's launches start here
            gc0 = [g["collections"] for g in gc.get_stats()]
            fused0 = counter("horaedb_batch_dispatch_total", kind="fused")
            buckets0 = {b: counter("horaedb_batch_cohort_total", size=b)
                        for b in ("1", "2", "4", "8", "16", "32+")}
            arm = _flood_arm(torch, fused, texts, FLOOD_MEASURED)
            launches = {f: dict(a) for f, a in S.LAUNCHES.items()}
            plain_calls = dict(S.PLAIN_CALLS)
            fallbacks = X.COHORT_FALLBACKS
            gc_runs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
            threads = threading.active_count()
            fused_cohorts = counter("horaedb_batch_dispatch_total", kind="fused") - fused0
            buckets = {b: counter("horaedb_batch_cohort_total", size=b) - v
                       for b, v in buckets0.items()}
        finally:
            fused.close()
        sizes = [r.metrics.get("batch_cohort", 0) for r in arm["results"]]
        out["fused"] = {**arm, "launches": launches, "dispatches": _dispatch_total(S),
                        "sizes": sizes, "fused_cohorts": fused_cohorts, "buckets": buckets,
                        "fallbacks": fallbacks, "plain_calls": plain_calls,
                        "gc_runs": gc_runs, "threads": threads}
        solo = Proxy(db)
        try:
            S.reset_counts()
            arm = _flood_arm(torch, solo, texts, FLOOD_MEASURED)
            out["solo"] = {**arm, "launches": {f: dict(a) for f, a in S.LAUNCHES.items()},
                           "dispatches": _dispatch_total(S)}
        finally:
            solo.close()
    finally:
        rec.restore()
    for name in ("fused", "solo"):
        for q, res in enumerate(out[name]["results"]):
            _check_flood(res, exp[q % 32], f"flood {name} query {q}")
    f, so = out["fused"], out["solo"]
    members = sum(1 for x in f["sizes"] if x)
    check(max(f["sizes"]) >= 8, f"no fused cohort reached 8 members: {sorted(set(f['sizes']))}")
    if DEV == "cuda":
        check(sum(f["launches"]["cached_cohort"].values()) > 0, "the cohort kernel never launched")
        check(f["plain_calls"]["cached_cohort"] == 0, "a cohort plain version ran on the card")
    check(f["fallbacks"] == 0, f"{f['fallbacks']} fused cohort dispatches fell back solo (warm-up included)")
    check(f["dispatches"] < so["dispatches"],
          f"fused arm dispatched {f['dispatches']}, solo arm {so['dispatches']}")
    summary = {}
    for name, a in (("fused", f), ("solo", so)):
        lat = sorted(a["lat"])
        summary[name] = {
            "dispatches_per_query": a["dispatches"] / FLOOD_MEASURED,
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "qps": FLOOD_MEASURED / a["wall"], "launches": a["launches"],
        }
    summary["fused"].update(
        window_ms=FLOOD_WINDOW_S * 1e3, fused_cohorts=f["fused_cohorts"], members_fused=members,
        mean_cohort=members / f["fused_cohorts"] if f["fused_cohorts"] else 0.0,
        max_cohort=max(f["sizes"]), cohort_buckets=f["buckets"],
        gc_runs_by_generation=f["gc_runs"], threads_alive=f["threads"])
    for name, d in summary.items():
        say(f"flood {name}: {d['dispatches_per_query']:.4f} dispatches a query, p50 "
            f"{d['p50_ms']:.3f} ms, p99 {d['p99_ms']:.3f} ms, {d['qps']:.1f} qps; launches "
            f"{d['launches']}")
    say(f"flood fused (window {FLOOD_WINDOW_S * 1e3:g} ms): {f['fused_cohorts']} fused "
        f"cohorts served {members} of "
        f"{FLOOD_MEASURED} queries (mean {summary['fused']['mean_cohort']:.2f}, largest "
        f"{summary['fused']['max_cohort']}; horaedb_batch_cohort_total {f['buckets']}); "
        f"every answer of both arms equals numpy; no fallback; gc runs by generation "
        f"{f['gc_runs']}, {f['threads']} threads alive")
    DETAIL["flood"] = summary
    return {"summary": summary, "last": rec.last,
            "launches": sum(f["launches"]["cached_cohort"].values())}


def _cohort_bound(torch, args, kw) -> tuple[float, str, dict]:
    """Least time for the cohort: the real rows' resident columns read
    once, plus each member's session, dyn and packed output, over HBM
    bandwidth; or its f32 operations, which grow with B, over the f32
    peak."""
    from horaedb_tpu_torch.ops import encoding as E

    sp, tp, vals, sessions, dyns = args
    n = E.layout_rows(sp, kw["series_layout"])
    sc = E.decode_series(sp, kw["series_layout"], n)
    n_real = int((sc < sessions.shape[1] // 2 - 1).sum())
    frac = n_real / n if n else 0.0

    def share(parts):
        return sum(_bytes_of(p) if p.numel() < 65536 else int(_bytes_of(p) * frac)
                   for p in parts)

    B = sessions.shape[0]
    planes = 3 if kw["need_minmax"] else 1
    out_bytes = 4 * B * kw["n_groups"] * kw["n_buckets"] * (1 + planes * kw["n_agg_fields"])
    nbytes = share(sp) + share(tp) + sum(share(v) for v in vals)
    nbytes += _bytes_of(sessions) + _bytes_of(dyns) + out_bytes
    ops = B * n_real * (len(kw["numeric_filters"]) + 4 + 3 * kw["n_agg_fields"])
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), {
        "bytes": nbytes, "ops": ops, "rows": n, "real": n_real}


def _cohort_library(torch, args, kw):
    """index_add_ of every member's kept rows into its own block of
    segments (decode, masks and segment ids of all members precomputed,
    int32 ids over the stacked [B * n_seg] segments): one call."""
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    sp, tp, values, sessions, dyns = args
    sc, tr, vals = E.decode_layouts(sp, tp, values, kw["series_layout"], kw["ts_layout"],
                                    kw["value_layouts"])
    sc = sc.long()
    n_f, nb = len(kw["numeric_filters"]), kw["n_buckets"]
    n_seg = kw["n_groups"] * nb
    B = sessions.shape[0]
    s1 = sessions.shape[1] // 2
    segs = []
    for b in range(B):
        lo, hi, t0, width = (int(x) for x in dyns[b, n_f:n_f + 4].tolist())
        keep = (sessions[b, s1:][sc] != 0) & (tr >= lo) & (tr < hi)
        keep = S._apply_filters(keep, vals, dyns[b, :n_f].contiguous().view(torch.float32),
                                kw["numeric_filters"])
        d = ((tr.long() - t0 + (1 << 31)) % (1 << 32)) - (1 << 31)
        bucket = torch.div(d, width, rounding_mode="floor").clamp(0, nb - 1)
        seg = sessions[b, :s1][sc].long() * nb + bucket + b * n_seg
        segs.append(torch.where(keep, seg, B * n_seg).to(torch.int32))
    seg = torch.cat(segs)
    del segs
    src = vals[0].float().repeat(B) if kw["n_agg_fields"] else torch.ones_like(seg,
                                                                               dtype=torch.float)
    out = torch.zeros(B * n_seg + 1, device=seg.device)
    return lambda: out.index_add_(0, seg, src)


def _time_cohort(torch, args, kw, what, flush, card) -> dict:
    """One cohort call on the resident columns: kernel against plain (the
    plain run once, timed), then the kernel's device time against B solo
    launches of the same members, its bound and index_add_."""
    from horaedb_tpu_torch.ops import scan_agg as S

    from horaedb_tpu_torch.ops import encoding as E

    B = args[3].shape[0]
    err, counted, plain_ms = _cohort_check(torch, args, kw, f"{what} (B={B})")
    # the rows, chunks and commits the launch visits (a launch of its own)
    rows = kw.get("n_rows")
    rows = E.layout_rows(args[0], kw["series_layout"]) if rows is None else rows
    stats = torch.zeros(len(S.COHORT_STATS), dtype=torch.int64, device=DEV)
    S.cached_scan_agg_cohort(*args, **kw, stats=stats)
    visits = dict(zip(S.COHORT_STATS, stats.tolist()), rows=rows,
                  chunk_rows=S.cohort_chunks(rows, len(args[2]))[0],
                  carry=S.cohort_carry(S.cohort_arm(kw["segment_impl"], B, len(args[2]),
                                                    kw["n_groups"] * kw["n_buckets"],
                                                    kw["n_agg_fields"], kw["need_minmax"]),
                                       B, len(args[2]), kw["n_groups"] * kw["n_buckets"],
                                       kw["n_agg_fields"], kw["need_minmax"]))
    launch = lambda: S.cached_scan_agg_cohort(*args, **kw)  # noqa: E731
    sp, tp, vals, sessions, dyns = args
    solo_kw = {**kw, "selective": False}
    solo = lambda: [S.cached_scan_agg_packed(sp, tp, vals, sessions[b], dyns[b],  # noqa: E731
                                             **solo_kw) for b in range(B)]
    ms = _device_ms(torch, launch, "scan_agg_cohort", reps=5, flush=flush)
    ms = ms if ms is not None else _time_launch(torch, launch, reps=5, flush=flush)
    solo_one = _device_ms(torch, lambda: S.cached_scan_agg_packed(
        sp, tp, vals, sessions[0], dyns[0], **solo_kw), "scan_agg_cached", reps=10, flush=flush)
    solo_ms = _time_launch(torch, solo, reps=3, flush=flush)
    lib = _cohort_library(torch, args, kw)
    lib_ms = _time_launch(torch, lib, reps=3)
    del lib
    if DEV == "cuda":
        torch.cuda.empty_cache()
    bound_ms, bound_by, work = _cohort_bound(torch, args, kw)
    arm = S.cohort_arm(kw["segment_impl"], B, len(vals), kw["n_groups"] * kw["n_buckets"],
                       kw["n_agg_fields"], kw["need_minmax"])
    solo_b = solo_one * B if solo_one is not None else None
    say(f"kernel scan_agg_cohort, {what} (B={B}, {arm}, {work['rows']} rows, {work['real']} "
        f"real, {counted} rows counted over the members): {ms:.4f} ms on the device "
        f"timeline; {B} solo launches {solo_ms:.4f} ms by events (one solo {solo_one} ms on "
        f"the device timeline, x{B} = {solo_b}); plain {plain_ms:.4f} ms (once); index_add_ "
        f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, {work['bytes']} B, "
        f"{work['ops']} ops); max |sum diff| {err}; visited {visits['rows']} rows in "
        f"{visits['chunks']} chunks of {visits['chunk_rows']}, {visits['member_chunks']} "
        f"member-chunks run and {visits['member_chunks_skipped']} skipped, "
        f"{visits['commits']} commits (carry {visits['carry']}) [{card}]")
    return {"B": B, "arm": arm, "ms": ms, "solo_events_ms": solo_ms, "solo_one_ms": solo_one,
            "solo_x_B_ms": solo_b, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "visits": visits,
            **work}


def phase_flood_timings(torch, main, flood, raw, card) -> list:
    """B1e: the flood's last fused call replayed (kernel against plain) and
    timed against B solo launches of the same members, its bound and
    index_add_. B4c: 32 lastpoint-host members on the resident columns,
    bit-equal to 32 solo top-k launches, timed against them and
    torch.topk. B1d: timed at single-groupby-5-8-1's gather."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S, scan_topk as T

    kernels = []
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    # ---- B1e: the last fused call, and the flood's 32 texts as one cohort
    args, kw = flood["last"]
    last = _time_cohort(torch, args, kw, "the last fused call", flush, card)
    kernels.append({
        "name": "scan_agg_cohort", "route": "cuda", "source": SRC,
        "replaces": COHORT_REPLACES["cohort"], "launches": int(flood["launches"]),
        "max_abs_err": last["max_abs_err"], "ms": last["ms"], "plain_ms": last["plain_ms"],
        "bound_ms": last["bound_ms"], "bound_by": last["bound_by"],
        "library_ms": last["library_ms"],
    })
    db = main["db"]
    ex, table = db.interpreters.executor, db.catalog.open("cpu")
    preps = [ex.prepare_cached_agg(db._cached_plan(t), table, {"table": "cpu"},
                                   allow_selective=False) for t in flood_queries()]
    dev = args[3].device
    full = (*args[:3],
            torch.from_numpy(np.stack([S.pack_session(p.gos, p.allow_scan)
                                       for p in preps])).to(dev),
            torch.from_numpy(np.stack([S.pack_dyn(p.literals, p.lo_rel, p.hi_rel, p.t0_rel,
                                                  p.width_i) for p in preps])).to(dev))
    whole = _time_cohort(torch, full, kw, "the 32 flood texts as one cohort", flush, card)
    DETAIL["cohort_kernel"] = {"last": last, "all_32": whole}
    # ---- B4c: 32 lastpoint-host members, hosts 0-31, each over its windows
    _, rargs, rkw = raw["calls"]["lastpoint-host"]
    sp, tp, vals, session, dyn = rargs
    from horaedb_tpu_torch.common_types.dict_column import as_values

    ex = main["db"].interpreters.executor
    entry = ex.scan_cache._entries["cpu"]
    names = np.asarray(as_values(entry.series_rows.columns["hostname"]), dtype=object)
    allow = np.zeros((32, session.shape[0]), dtype=np.int32)
    for h in range(32):
        allow[h, int(np.flatnonzero(names == f"host_{h}")[0])] = 1
    sess = torch.from_numpy(allow).to(session.device)
    dyns = dyn.repeat(32, 1)
    n_rows = E.layout_rows(sp, rkw["series_layout"])
    k = T.padded_k(n_rows, 10)
    n_f = len(rkw["numeric_filters"])
    lo, hi = (int(x) for x in dyn[n_f:n_f + 2].tolist())
    # each member's windows as the executor computes them for its top-k
    wins = [ex._raw_candidate_estimate(entry, allow[h, :-1] != 0, lo, hi, exact=False)[1]
            for h in range(32)]
    ckw = {**{n: v for n, v in rkw.items() if n != "windows"}, "k": k}
    before = T.KERNELS["raw_topk_cohort"]
    got = T.raw_topk_cohort(sp, tp, vals, sess, dyns, windows=wins, **ckw)
    _sync(torch)
    c_kernels = T.KERNELS["raw_topk_cohort"] - before
    check(c_kernels <= 5, f"raw_topk_cohort ran {c_kernels} kernels for 32 members")
    want, p_ms = _time_once(torch, lambda: T.raw_topk_cohort_plain(sp, tp, vals, sess, dyns,
                                                                    **ckw))
    check(torch.equal(got, want), "raw_topk_cohort over the members' windows differs from plain")
    c_err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    whole = T.raw_topk_cohort(sp, tp, vals, sess, dyns, **ckw)
    check(torch.equal(whole, want), "raw_topk_cohort over every row differs from plain")
    solos = torch.stack([T.raw_topk_packed(sp, tp, vals, sess[h], dyns[h], windows=wins[h],
                                           **ckw) for h in range(32)])
    check(torch.equal(got, solos), "raw_topk_cohort differs from 32 solo top-k launches")
    check(bool((got >= 0).all()), "raw_topk_cohort: a lastpoint member found no row")
    c_launch = lambda: T.raw_topk_cohort(sp, tp, vals, sess, dyns, windows=wins,  # noqa: E731
                                         **ckw)
    n_launch = lambda: T.raw_topk_cohort(sp, tp, vals, sess, dyns, **ckw)  # noqa: E731
    s_launch = lambda: [T.raw_topk_packed(sp, tp, vals, sess[h], dyns[h],  # noqa: E731
                                          windows=wins[h], **ckw) for h in range(32)]
    cohort_names = ("cohort_topk_keys", "cohort_topk_refine", "cohort_topk_write", "Memset",
                    "HtoD")
    # 64 fills lead each trace: a trace late in the process can lose its
    # first records (PERF.md §7)
    c_ms = _family_device_ms(torch, c_launch, cohort_names, reps=10, lead=64,
                             label="raw_topk_cohort, 32 members' windows")
    c_ms = c_ms if c_ms is not None else _time_launch(torch, c_launch, reps=10)
    n_ms = _family_device_ms(torch, n_launch, cohort_names, reps=3, lead=64,
                             label="raw_topk_cohort, every row")
    n_ms = n_ms if n_ms is not None else _time_launch(torch, n_launch, reps=3)
    c_ev = _time_launch(torch, c_launch, reps=10)
    s_ms = _family_device_ms(torch, s_launch, RAW_KERNELS, reps=3, lead=64)
    s_ms = s_ms if s_ms is not None else _time_launch(torch, s_launch, reps=3)
    # torch.topk of the members' masked keys over the rows of their windows
    union = _union(np.concatenate(wins))
    rows = torch.from_numpy(np.concatenate([np.arange(a, b) for a, b in union])).to(sess.device)
    lits = dyn[:n_f].contiguous().view(torch.float32)
    sc, tr, dv = E.decode_layouts(sp, tp, vals, rkw["series_layout"], rkw["ts_layout"],
                                  rkw["value_layouts"])
    sc, tr, dv = sc[rows], tr[rows], [v[rows] for v in dv]
    keys = torch.stack([
        T._sort_key(tr, dv, T._raw_mask(sc, tr, dv, sess[h] != 0, lits, lo, hi,
                                        rkw["numeric_filters"]),
                    descending=rkw["descending"], key_is_ts=rkw["key_is_ts"],
                    key_field=rkw["key_field"]) for h in range(32)])
    del sc, tr, dv, rows
    t_ms = _time_launch(torch, lambda: torch.topk(keys, k, dim=1), reps=10)
    del keys
    torch.cuda.empty_cache()
    # the bound: the union's rows read once, as the top-k's over its windows
    b_ms, b_by, b_work = _raw_bound(torch, "raw_topk", (sp, tp, vals, sess.amax(0), dyn),
                                    {**ckw, "k": 32 * k, "windows": union})
    b_ms += (_bytes_of(sess) + _bytes_of(dyns) - _bytes_of(session) - _bytes_of(dyn)) \
        / PEAK_BYTES_S * 1e3
    w_rows = [int((w[:, 1] - w[:, 0]).sum()) for w in wins]
    say(f"kernel raw_topk_cohort, 32 lastpoint-host members (k {k}, {n_rows} rows, windows of "
        f"{min(w_rows)}-{max(w_rows)} rows a member, {int((union[:, 1] - union[:, 0]).sum())} "
        f"in their union; {c_kernels} kernels): {c_ms:.4f} ms on the device timeline, "
        f"{c_ev:.4f} ms by events with the wrapper; over every row {n_ms:.4f} ms; 32 solo "
        f"top-k launches over their windows {s_ms:.4f} ms; plain {p_ms:.4f} ms; torch.topk of "
        f"the [32, window rows] masked keys {t_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by}, the "
        f"window rows); bit-equal to plain, to every row's answer and to the solo launches "
        f"[{card}]")
    DETAIL["raw_topk_cohort"] = {"ms": c_ms, "events_ms": c_ev, "every_row_ms": n_ms,
                                 "solo_ms": s_ms, "plain_ms": p_ms, "library_ms": t_ms,
                                 "bound_ms": b_ms, "k": k, "kernels": c_kernels,
                                 "window_rows": w_rows, "bound_work": b_work}
    kernels.append({
        "name": "raw_topk_cohort", "route": "cuda", "source": RAW_SRC,
        "replaces": COHORT_REPLACES["raw_topk_cohort"], "launches": 0,
        "max_abs_err": c_err, "ms": c_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": t_ms,
    })
    # ---- B1d at single-groupby-5-8-1's gather, on decoded raw columns
    pargs, pkw = main["results"]["single-groupby-5-8-1"]["calls"]["cached_selective"]
    sp, tp, vals, session, dyn = pargs
    n_f = len(pkw["numeric_filters"])
    sc, tr, dv = E.decode_layouts(sp, tp, vals, pkw["series_layout"], pkw["ts_layout"],
                                  pkw["value_layouts"])
    sc, tr = sc.to(torch.int32).contiguous(), tr.to(torch.int32).contiguous()
    dense = torch.stack([v.float() for v in dv])
    del dv
    s1 = session.shape[0] // 2
    lo, hi, t0, width = (int(x) for x in dyn[n_f:n_f + 4].tolist())
    idx = dyn[n_f + 4:]
    bkw = {x: pkw[x] for x in ("n_groups", "n_buckets", "n_agg_fields", "numeric_filters",
                               "need_minmax", "segment_impl")}
    b1d = lambda: S.selective_cached_scan_agg(  # noqa: E731
        idx, sc, tr, dense, session[:s1], session[s1:] != 0,
        dyn[:n_f].contiguous().view(torch.float32), lo, hi, t0, width, **bkw)
    got = b1d()
    ref_packed = _split(torch, S.cached_scan_agg_packed(*pargs, **pkw), pkw)
    _sync(torch)
    dargs = ((sc,), (tr,), tuple((v.contiguous(),) for v in dense), session, dyn)
    dkw = {**pkw, "value_layouts": (("raw",),) * dense.shape[0], "ts_layout": ("raw",),
           "series_layout": ("raw",)}
    d_err = _compare("selective_cached_scan_agg vs the main path's SELECTIVE launch",
                     *(g.reshape(-1) for g in got), ref_packed,
                     _abs_sums(torch, "cached_selective", dargs, dkw), pkw["need_minmax"])
    d_err = max(d_err, _compare("selective_cached_scan_agg vs plain at single-groupby-5-8-1",
                                *(g.reshape(-1) for g in got),
                                _split(torch, S._packed_body(*dargs, **dkw), dkw),
                                _abs_sums(torch, "cached_selective", dargs, dkw),
                                pkw["need_minmax"]))
    d_ms = _device_ms(torch, b1d, "scan_agg_cached", reps=20, flush=flush)
    d_ms = d_ms if d_ms is not None else _time_launch(torch, b1d, flush=flush)
    dp_ms = _time_launch(torch, lambda: S._packed_body(*dargs, **dkw), reps=3, flush=flush)
    dl_ms = _time_launch(torch, _library_call(torch, S, "cached_selective", dargs, dkw),
                         flush=flush)
    d_bound, d_by, d_work = _kernel_bounds("cached_selective", dargs, dkw)
    say(f"kernel selective_cached_scan_agg at single-groupby-5-8-1 ({d_work['rows']} gathered "
        f"rows of decoded f32 columns): {d_ms:.4f} ms on the device timeline; plain "
        f"{dp_ms:.4f} ms; index_add_ {dl_ms:.4f} ms ({d_ms / dl_ms:.2f}x index_add_); bound "
        f"{d_bound:.6f} ms ({d_by}); equal to "
        f"the main path's SELECTIVE launch and to plain (largest |difference| {d_err}) [{card}]")
    kernels.append({
        "name": "selective_cached_scan_agg", "route": "cuda", "source": SRC,
        "replaces": COHORT_REPLACES["selective"], "launches": 0, "max_abs_err": d_err,
        "ms": d_ms, "plain_ms": dp_ms, "bound_ms": d_bound, "bound_by": d_by,
        "library_ms": dl_ms,
    })
    del sc, tr, dense
    torch.cuda.empty_cache()
    return kernels


# ---- phases 19-20: the hash arm (B2d) ------------------------------------------

HASH_REPLACES = "horaedb_tpu/ops/hash_agg.py:83"
HASH_ROWS = 1 << 18
# bench.py's BENCH_CONFIG=groupby shapes: (label, domain, live groups present)
GROUPBY_SHAPES = (
    ("uniform-8", 8, 8),
    ("uniform-64", 64, 64),
    ("uniform-512", 512, 512),
    ("uniform-4k", 4096, 4096),
    ("uniform-32k", 32768, 32768),
    ("uniform-256k", 262144, 262144),
    ("skew-64k-live4", 65536, 4),
    ("skew-256k-live16", 262144, 16),
)


def sparse_queries() -> list:
    """(name, hosts, hours) of the sparse-domain panels on the cpu table:
    TSBS single-groupby-5-8-1 grouped by host as well, and the same over
    16 hosts spread across the table and 12 h."""
    return [("sparse-8x1h", list(range(8)), 1),
            ("sparse-16x12h", [i * (HOSTS // 16) for i in range(16)], HC_HOURS)]


def sparse_sql(hosts, hours: int) -> str:
    from horaedb_tpu_torch.tools import tsbs

    fields = ", ".join(f"max({f}) AS max_{f}" for f in tsbs.CPU_FIELDS[:5])
    host_list = ", ".join(f"'host_{h}'" for h in hosts)
    return (f"SELECT hostname, time_bucket(ts, '1m') AS minute, {fields} FROM cpu "
            f"WHERE hostname IN ({host_list}) AND ts >= 0 AND ts < {hours * 3_600_000} "
            "GROUP BY hostname, time_bucket(ts, '1m') ORDER BY hostname, minute")


def _hash_expected(tsbs, rows) -> dict:
    """Per sparse query, the per-(host, minute) max of the first five fields
    from the generated rows (time-major: tick, then host), on the float32
    values the device columns hold: f32[5, minutes, hosts]."""
    import numpy as np

    n_ticks = HOURS * 3_600_000 // tsbs.INTERVAL_MS
    per_min = 60_000 // tsbs.INTERVAL_MS
    out = {}
    for name, hosts, hours in sparse_queries():
        ticks = hours * 3_600_000 // tsbs.INTERVAL_MS
        out[name] = np.stack([
            rows.columns[f].reshape(n_ticks, HOSTS)[:ticks, hosts].astype(np.float32)
            .reshape(ticks // per_min, per_min, len(hosts)).max(axis=1)
            for f in tsbs.CPU_FIELDS[:5]])
    return out


def _check_sparse(name, res, hosts, exp) -> None:
    """Every (host, minute) of the panel once, each max bit-equal to numpy."""
    import numpy as np

    from horaedb_tpu_torch.tools import tsbs

    _, minutes, nh = exp.shape
    check(res.num_rows == minutes * nh, f"{name}: {res.num_rows} rows, want {minutes * nh}")
    pos = {h: i for i, h in enumerate(hosts)}
    hi = np.array([pos[int(h[5:])] for h in res.column("hostname")])
    mi = np.asarray(res.column("minute")) // 60_000
    check(len(set(zip(hi.tolist(), mi.tolist()))) == minutes * nh, f"{name}: repeated groups")
    for k, f in enumerate(tsbs.CPU_FIELDS[:5]):
        got = np.asarray(res.column(f"max_{f}"), dtype=np.float32)
        check(np.array_equal(got, exp[k][mi, hi]), f"{name}: max_{f} differs from numpy")


def _same_result(a, b, what) -> None:
    """Two ResultSets with the same names and bit-equal columns."""
    import numpy as np

    check(a.names == b.names, f"{what}: columns {a.names} vs {b.names}")
    for n, x, y in zip(a.names, a.columns, b.columns):
        check(np.array_equal(np.asarray(x), np.asarray(y)), f"{what}: column {n} differs")


def _hash_check(torch, form, args, kw, kind, rounds=2) -> tuple[float, int, int, int]:
    """The hash arm's kernel against its plain version on the same tensors
    (``_compare``), both with ``rounds`` probe rounds
    (HORAEDB_HASH_PROBE_ROUNDS); returns the largest |sum difference|, the
    kernel's and the plain version's overflow rows (the kernel's tables
    are per block, the plain version's one global table) and the rows
    counted."""
    from horaedb_tpu_torch.ops import scan_agg as S

    dev = args[3].device if form != "direct" else args[0].device
    ov_k = torch.zeros(1, dtype=torch.int64, device=dev)
    ov_p = torch.zeros(1, dtype=torch.int64, device=dev)
    before = os.environ.get("HORAEDB_HASH_PROBE_ROUNDS")
    os.environ["HORAEDB_HASH_PROBE_ROUNDS"] = str(rounds)
    try:
        if form == "direct":
            got = S.fused_scan_agg(*args, overflow=ov_k, **kw)
            _sync(torch)
            want = S.scan_agg_body(*args, overflow=ov_p, **kw)
        else:
            got = _split(torch, S.cached_scan_agg_packed(*args, overflow=ov_k, **kw), kw)
            _sync(torch)
            want = _split(torch, S._packed_body(*args, overflow=ov_p, **kw), kw)
    finally:
        if before is None:
            del os.environ["HORAEDB_HASH_PROBE_ROUNDS"]
        else:
            os.environ["HORAEDB_HASH_PROBE_ROUNDS"] = before
    abs_sums = _abs_sums(torch, form, args, {**kw, "segment_impl": "scatter"})
    err = _compare(kind, *got, want, abs_sums, kw["need_minmax"])
    return err, int(ov_k.item()), int(ov_p.item()), int(got[0].sum())


def _groupby_inputs(torch, rng, n, domain, live, F=1, op=None, need_minmax=True, sort=False,
                    special=False, empty=False, every_row=False):
    """bench.py's groupby batch: ``n`` rows over ``live`` groups scattered
    across a ``domain``-wide dense encoding (all of it when live ==
    domain; each live group on one row at least), one bucket; 3% of the
    rows masked (none with ``every_row``, all with ``empty``); (args, kw)
    of a direct launch, hash arm."""
    import numpy as np

    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    dev = torch.device(DEV)
    if live < domain:
        groups = np.sort(rng.choice(domain, size=live, replace=False))
        pick = np.concatenate([np.arange(live), rng.integers(0, live, n - live)])
        codes = groups[rng.permutation(pick)].astype(np.int32)
    else:
        codes = rng.integers(0, domain, n).astype(np.int32)
    if sort:
        codes = np.sort(codes)
    m = np.zeros(n, bool) if empty else (rng.random(n) < 0.97) | every_row
    n_fields = F + (op is not None)
    vals = rng.normal(0, 50, (n_fields, n)).astype(np.float32)
    vals[F:] = np.round(vals[F:])
    if special:
        # NaN and signed zeros on kept rows of a few segments
        m[:64] = True
        vals[:, 1:64:7], vals[:, 2:64:7], vals[:, 3:64:7] = np.nan, -0.0, 0.0
    batch = E.build_padded_batch(codes, np.zeros(n, np.int32), m, list(vals))
    filters = ((F, S._FILTER_OPS[op]),) if op is not None else ()
    lits = torch.tensor([3.0] * len(filters), dtype=torch.float32, device=dev)
    args = tuple(torch.from_numpy(x).to(dev) for x in (batch.group_codes, batch.bucket_ids,
                                                      batch.mask, batch.values)) + (lits,)
    kw = dict(n_groups=E.next_pow2(domain, floor=8), n_buckets=1, n_agg_fields=F,
              numeric_filters=filters, need_minmax=need_minmax, segment_impl="hash")
    return args, kw


def phase_hash_kernels(torch) -> None:
    """B2d against hash_segment_agg_plain on the card: the direct, cached
    and SELECTIVE forms, every layout, F in {0, 1, 5, 10} with and
    without min/max, H in {16, 2048, 4096}, rounds in {1, 2, 4}, a block
    at load 1.0 and blocks that overflow, NaN and +-0, empty masks, and
    bench.py's groupby shapes at 2**18 rows."""
    import numpy as np

    from horaedb_tpu_torch.ops.hash_agg import hash_slots_for

    rng = np.random.default_rng(SEED + 8)
    cases = []

    def run(form, args, kw, what, rounds):
        kind = f"hash {form} {what} (H {kw['hash_slots']}, rounds {rounds})"
        err, ov_k, ov_p, counted = _hash_check(torch, form, args, kw, kind, rounds)
        cases.append({"case": kind, "err": err, "overflow": ov_k, "plain_overflow": ov_p,
                      "counted": counted})
        return ov_k

    for label, domain, live in GROUPBY_SHAPES:
        args, kw = _groupby_inputs(torch, rng, HASH_ROWS, domain, live)
        run("direct", args, {**kw, "hash_slots": hash_slots_for(domain, live)}, label, 2)
    slots, rounds = (16, 2048, 4096), (1, 2, 4)
    for i, F in enumerate((0, 1, 5, 10)):
        for need_minmax in (True, False):
            j = 2 * i + need_minmax
            args, kw = _groupby_inputs(torch, rng, 100_003, 65536, 1000, F, OPS[j % 6],
                                       need_minmax, sort=bool(j % 2))
            run("direct", args, {**kw, "hash_slots": slots[j % 3]}, f"F={F} minmax={need_minmax}",
                rounds[j % 3])
    # 2048 real rows (the rest of the launch pads) over exactly H distinct
    # segments, probed in full: no block's table may overflow
    for H in (16, 2048):
        args, kw = _groupby_inputs(torch, rng, 2048, 65536, H, sort=H == 16, every_row=True)
        ov = run("direct", args, {**kw, "hash_slots": H}, f"one block at load 1.0 ({H} segments)",
                 H)
        check(ov == 0, f"a full probe of {H} slots left {ov} rows of {H} segments unplaced")
    # a 16-slot table that every block of 256 rows fills: 16 segments in
    # unsorted rows, probed in full
    args, kw = _groupby_inputs(torch, rng, 4096, 65536, 16, every_row=True)
    ov = run("direct", args, {**kw, "hash_slots": 16}, "every block at load 1.0 (16 segments)",
             16)
    check(ov == 0, f"a full probe of 16 slots left {ov} rows of 16 segments unplaced")
    args, kw = _groupby_inputs(torch, rng, 50_000, 65536, 300, F=3, special=True)
    run("direct", args, {**kw, "hash_slots": 2048}, "NaN and +-0", 2)
    args, kw = _groupby_inputs(torch, rng, 50_000, 65536, 300, F=2, empty=True)
    run("direct", args, {**kw, "hash_slots": 16}, "empty mask", 1)
    for c, case in enumerate(LAYOUT_CASES):
        for selective in (False, True):
            j = 2 * c + selective
            args, kw, kind, form = _cached_inputs(torch, rng, case, "hash", selective,
                                                  bool(j % 2), OPS[j % 6], 4096, 64)
            kw["hash_slots"] = slots[j % 3]
            run(form, args, kw, kind, rounds[j % 3])
    # short sorted runs, and a 16-slot table probed once: rows overflow and
    # the answers still equal the plain version's
    n_runs, run_err = _run_cases(torch, ("hash",))
    for form in ("direct", "cached", "cached_selective"):
        _, ov = _run_case(torch, rng, 6, "hash", form, 5, True, hash_slots=16, rounds=1)
        check(ov > 0, f"hash {form}: 16 slots probed once left no row unplaced")
        cases.append({"case": f"hash {form} runs of 6 (H 16, rounds 1)", "err": 0.0,
                      "overflow": ov, "plain_overflow": None, "counted": None})
    _sync(torch)
    DETAIL["hash_run_cases"] = {"cases": n_runs, "max_abs_err": run_err}
    say(f"hash short runs vs plain: {n_runs} cases passed, max |sum diff| {run_err}")
    check(any(c["overflow"] > 0 for c in cases), "no hash case overflowed a block's table")
    errs = {f: max((c["err"] for c in cases if f" {f} " in c["case"]), default=0.0)
            for f in ("direct", "cached", "cached_selective")}
    say(f"hash kernels vs plain: {len(cases)} cases passed; max |sum diff| {errs}; overflow "
        f"rows (kernel / plain) " + ", ".join(
            f"{c['case'].split(' (')[0][5:]}: {c['overflow']}/{c['plain_overflow']}"
            for c in cases[:len(GROUPBY_SHAPES)]))
    DETAIL["hash_kernel_cases"] = cases


def _live_segments(torch, form, args, kw) -> int:
    """Segments a launch counts rows into: the only ones its output
    writes (the rest keep the fill, a memset before the kernel)."""
    from horaedb_tpu_torch.ops import scan_agg as S

    if form == "direct":
        counts = S.fused_scan_agg(*args, **kw)[0]
    else:
        counts = _split(torch, S.cached_scan_agg_packed(*args, **kw), kw)[0]
    return int((counts != 0).sum())


def _hash_bound(torch, form, args, kw) -> tuple[float, str, dict]:
    """Least time of a hash launch: the real rows' bytes (pad slots of a
    gather left out) plus the output of the segments it writes (the live
    ones), over HBM bandwidth, or its f32 operations over the f32 peak."""
    live = _live_segments(torch, form, args, kw)
    if form != "cached_selective":
        bound, by, work = _kernel_bounds(form, args, kw, live)
        return bound, by, {**work, "live": live}
    from horaedb_tpu_torch.ops import encoding as E

    sp, tp, vals, session, dyn = args
    n_f = len(kw["numeric_filters"])
    idx = dyn[n_f + 4:].long()
    # the gather's pad slots point at the pad row, whose series code is the
    # session's last (n_series)
    sc = E.decode_series(sp, kw["series_layout"], E.layout_rows(sp, kw["series_layout"]))
    real = int((sc[idx] < session.shape[0] // 2 - 1).sum())
    bound, by, work = _kernel_bounds(form, (sp, tp, vals, session, dyn[:n_f + 4 + real]), kw,
                                     live)
    return bound, by, {**work, "real": real, "live": live}


def _arm_ms(torch, form, args, kw, arm, flush, reps=10):
    """Device ms of one launch of ``arm`` on the inputs of a hash call."""
    from horaedb_tpu_torch.ops import scan_agg as S

    k = {**kw, "segment_impl": arm}
    fn = (lambda: S.fused_scan_agg(*args, **k)) if form == "direct" \
        else (lambda: S.cached_scan_agg_packed(*args, **k))
    name = "scan_agg_direct" if form == "direct" else "scan_agg_cached"
    ms = _device_ms(torch, fn, name, reps=reps, flush=flush)
    return ms if ms is not None else _time_launch(torch, fn, reps=reps, flush=flush)


def _hash_geometry(torch, form, args, kw) -> tuple:
    """(rows a block takes, slots of its table) of a hash launch on these
    inputs, as the wrapper sets them; (None, None) off the card."""
    from horaedb_tpu_torch.ops import encoding as E, scan_agg as S

    if DEV != "cuda":
        return None, None
    n_f = len(kw["numeric_filters"])
    n_rows = args[4].shape[0] - n_f - 4 if form == "cached_selective" else (
        args[0].shape[0] if form == "direct" else E.layout_rows(args[0], kw["series_layout"]))
    out = S._Out(0, 0, 0, 0, kw["n_groups"] * kw["n_buckets"], kw["n_agg_fields"],
                 int(kw["need_minmax"]))
    S._set_launch(out, "hash", kw.get("hash_slots", 0), None, torch.device("cuda"), n_rows, form)
    return out.block_rows, out.hash_slots


def _time_hash(torch, form, args, kw, what, flush, card) -> dict:
    """A hash call's device ms against the scatter and shared arms (shared
    where its partials fit), its bound, index_add_ and the plain version."""
    from horaedb_tpu_torch.ops import scan_agg as S

    n_seg = kw["n_groups"] * kw["n_buckets"]
    ms = {"hash": _arm_ms(torch, form, args, kw, "hash", flush),
          "scatter": _arm_ms(torch, form, args, kw, "scatter", flush),
          "shared": (_arm_ms(torch, form, args, kw, "shared", flush)
                     if S.shared_fits(n_seg, kw["n_agg_fields"], kw["need_minmax"]) else None)}
    plain = (lambda: S.scan_agg_body(*args, **kw)) if form == "direct" \
        else (lambda: S._packed_body(*args, **kw))
    plain_ms = _time_launch(torch, plain, reps=3, flush=flush)
    lib_ms = _time_launch(torch, _library_call(torch, S, form, args, kw), reps=5, flush=flush)
    bound_ms, bound_by, work = _hash_bound(torch, form, args, kw)
    rows_a_block, H = _hash_geometry(torch, form, args, kw)
    say(f"hash {what} ({form}, n_seg {n_seg}, H {kw.get('hash_slots')} -> {H} a block of "
        f"{rows_a_block} rows, {work['rows']} rows, {work['live']} live segments): hash "
        f"{ms['hash']:.4f} ms ({ms['hash'] / lib_ms:.2f}x index_add_), scatter "
        f"{ms['scatter']:.4f} ms, "
        f"shared {ms['shared'] if ms['shared'] is None else round(ms['shared'], 4)} ms on "
        f"the device timeline; plain {plain_ms:.4f} ms; index_add_ {lib_ms:.4f} ms; bound "
        f"{bound_ms:.6f} ms ({bound_by}, {work['bytes']} B) [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "block_slots": H, **work}


def phase_hash_main(torch, main, card) -> list:
    """The sparse-domain panels through ``Connection.execute`` on phase
    4's resident cpu table: each REPEATS times unrouted (the router seeds
    the hash arm; the first cached call must report it), once pinned to
    scatter; every answer bit-equal to numpy and to the scatter answer.
    Then each query's hash call replayed (kernel against plain, overflow
    rows) and timed against the scatter and shared arms, its bound,
    index_add_ and plain; for sparse-16x12h the packed output's memset,
    copy back and host unpack apart; then bench.py's groupby shapes
    timed the same way (direct form, 2**18 rows)."""
    import numpy as np

    from horaedb_tpu_torch.ops import scan_agg as S
    from horaedb_tpu_torch.ops.hash_agg import hash_slots_for

    db = main["db"]
    exp = main["hash_expected"]
    rec = Recorder(S)
    results = {}
    S.reset_counts()  # the hash path's launches start here
    try:
        for name, hosts, hours in sparse_queries():
            sql = sparse_sql(hosts, hours)
            runs = []
            first_cached = None
            for r in range(REPEATS):
                t = time.perf_counter()
                out = db.execute(sql)
                secs = time.perf_counter() - t
                path = db.interpreters.executor.last_path
                runs.append({"seconds": secs, "path": path, "kernel": out.metrics.get("kernel"),
                             "cache": out.metrics.get("cache")})
                _check_sparse(name, out, hosts, exp[name])
                calls = rec.take()
                if path == "device-cached" and first_cached is None:
                    first_cached = out.metrics.get("kernel")
                    check(first_cached == "hash",
                          f"{name}: first cached call served by {first_cached}, not hash")
                    call = calls.get("cached_selective") or calls["cached"]
                if r == 0:
                    answer = out
            check(first_cached is not None, f"{name}: never served from the cache")
            os.environ["HORAEDB_SEGMENT_IMPL"] = "scatter"
            try:
                t = time.perf_counter()
                pinned = db.execute(sql)
                pinned_s = time.perf_counter() - t
            finally:
                del os.environ["HORAEDB_SEGMENT_IMPL"]
            check(pinned.metrics.get("kernel") == "scatter", f"{name}: pin not honoured")
            _same_result(answer, pinned, f"{name}: hash vs scatter-pinned answer")
            say(f"{name}: runs {[round(x['seconds'] * 1e3, 3) for x in runs]} ms, paths "
                f"{[x['path'] for x in runs]}, kernels {[x['kernel'] for x in runs]}; "
                f"scatter-pinned {pinned_s * 1e3:.3f} ms; every answer equals numpy "
                f"({answer.num_rows} rows)")
            results[name] = {"runs": runs, "pinned_scatter_s": pinned_s, "call": call}
    finally:
        S.fused_scan_agg, S.cached_scan_agg_packed = rec.orig_fused, rec.orig_cached
    launches = {form: dict(arms) for form, arms in S.LAUNCHES.items()}
    n_hash = sum(arms["hash"] for arms in launches.values())
    if DEV == "cuda":
        check(launches["cached_selective"]["hash"] + launches["cached"]["hash"] > 0,
              f"the sparse panels never launched the hash arm: {launches}")
        check(not any(S.PLAIN_CALLS.values()), f"plain versions ran: {S.PLAIN_CALLS}")
    say(f"hash main path launches: {launches}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    timings, err = {}, 0.0
    for name, res in results.items():
        args, kw = res["call"]
        form = "cached_selective" if kw.get("selective") else "cached"
        e, ov_k, ov_p, counted = _hash_check(torch, form, args, kw, f"main path {name}")
        err = max(err, e)
        tm = _time_hash(torch, form, args, kw, name, flush, card)
        tm.update(overflow=ov_k, plain_overflow=ov_p, counted=counted,
                  warm_ms=statistics.median([x["seconds"] for x in res["runs"][2:]]) * 1e3)
        n_seg = kw["n_groups"] * kw["n_buckets"]
        spec = S.ScanAggSpec(n_groups=kw["n_groups"], n_buckets=kw["n_buckets"],
                             n_agg_fields=kw["n_agg_fields"], need_minmax=kw["need_minmax"])
        packed = S.cached_scan_agg_packed(*args, **kw)
        memset_ms = _time_launch(torch, lambda: S._packed_out(
            1, n_seg, kw["n_agg_fields"], kw["need_minmax"], packed.device), reps=3)
        t = time.perf_counter()
        host = packed.cpu().numpy()
        t_copy = time.perf_counter() - t
        t = time.perf_counter()
        S.unpack_packed_state(host, spec)
        t_unpack = time.perf_counter() - t
        tm.update(out_bytes=_bytes_of(packed), memset_ms=memset_ms,
                  copy_back_ms=t_copy * 1e3, unpack_ms=t_unpack * 1e3)
        del packed, host
        say(f"hash {name}: kernel = plain (max |sum diff| {e}, {counted} rows counted), "
            f"overflow rows {ov_k} (per-block tables) / {ov_p} (one table of "
            f"{kw.get('hash_slots')}); warm execute {tm['warm_ms']:.3f} ms; packed output "
            f"{tm['out_bytes']} B: memset {tm['memset_ms']:.4f} ms, copy back "
            f"{tm['copy_back_ms']:.3f} ms, host unpack {tm['unpack_ms']:.3f} ms [{card}]")
        timings[name] = tm
    rng = np.random.default_rng(SEED + 9)
    shapes = {}
    for label, domain, live in GROUPBY_SHAPES:
        args, kw = _groupby_inputs(torch, rng, HASH_ROWS, domain, live)
        kw["hash_slots"] = hash_slots_for(domain, live)
        shapes[label] = _time_hash(torch, "direct", args, kw, label, flush, card)
    del flush
    if DEV == "cuda":
        torch.cuda.empty_cache()
    DETAIL["hash_main"] = {"launches": launches, "queries": {
        n: {k: v for k, v in r.items() if k != "call"} for n, r in results.items()},
        "timings": timings, "groupby": shapes}
    head, small = timings["sparse-16x12h"], timings["sparse-8x1h"]
    return [{
        "name": "hash_segment_agg", "route": "cuda", "source": SRC, "replaces": HASH_REPLACES,
        "launches": int(n_hash), "max_abs_err": err, "ms": head["ms"]["hash"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        # the same kernel at sparse-8x1h, beside index_add_ on its inputs
        "sparse_8x1h_ms": small["ms"]["hash"], "sparse_8x1h_library_ms": small["library_ms"],
        "sparse_8x1h_bound_ms": small["bound_ms"],
    }]


# ---- phase 21: mesh_combine against its plain version -------------------------

MESH_REPLACES = {
    "combine": "horaedb_tpu/parallel/dist_agg.py:61",
    "raw_topk": "horaedb_tpu/parallel/dist_raw.py:53",
    "raw_select": "horaedb_tpu/parallel/dist_raw.py:86",
    "merge": "horaedb_tpu/parallel/dist_merge.py:20",
}
MESH_SHARDS = 4                 # the logical mesh's shards on one card
MESH_SIZES = (1, 2, 3, 4, 8)
MESH_SEGMENTS = 4096 + 13       # a ragged segment count
SPARSE_SEGMENTS = 4096 * 1024   # sparse-16x12h's n_seg: 268 MB a packed partial at F = 5
MERGE_CHUNK_ROWS = 6_299_325    # a compaction chunk of config 5 at 100M rows


def _combine_parts(torch, S, n_seg, F, need_minmax, special, seed):
    """S shards' packed partials f32[packed_len] on the card: random counts,
    sums, mins and maxs, a fifth of the segments empty (0, +inf, -inf) in
    each shard; with ``special``, element 0 and 1 of the min and max planes
    hold -0.0 and +0.0 split across the shards both ways, and element 2 of
    shard S // 2's sum, min and max planes a NaN."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    fs = F * n_seg
    parts = []
    for d in range(S):
        c = torch.randint(0, 1000, (n_seg,), dtype=torch.int32, device=DEV, generator=g)
        s = torch.randn(fs, device=DEV, generator=g) * 100
        mn = torch.randn(fs, device=DEV, generator=g) * 20 - 50
        mx = torch.randn(fs, device=DEV, generator=g) * 20 + 50
        empty = torch.rand(n_seg, device=DEV, generator=g) < 0.2
        c[empty] = 0
        e = empty.repeat(F)
        s[e], mn[e], mx[e] = 0.0, float("inf"), float("-inf")
        if special and fs >= 3:
            mn[0] = mx[0] = -0.0 if d == 0 else 0.0
            mn[1] = mx[1] = 0.0 if d == 0 else -0.0
            if d == S // 2:
                s[2] = mn[2] = mx[2] = float("nan")
        planes = [c.view(torch.float32), s] + ([mn, mx] if need_minmax else [])
        parts.append(torch.cat(planes))
    return parts


def _combine_compare(torch, S_mod, got, parts, n_seg, F, need_minmax, what) -> float:
    """The kernel's packed result against the plain version on the same
    partials: counts and (canonical) mins and maxs bit-equal, sums within
    SUM_RTOL of the shards' sum of |partial sum|. Returns max |sum diff|."""
    split = [S_mod._packed_planes(p, n_seg, F, need_minmax) for p in parts]
    planes = [[s[p] for s in split] if split[0][p] is not None else [] for p in range(4)]
    want = S_mod.combine_planes_plain(planes)
    mine = S_mod._packed_planes(got, n_seg, F, need_minmax)
    check(torch.equal(mine[0].view(torch.int32), want[0].view(torch.int32)), f"{what}: counts")
    err = 0.0
    if F:
        scale = torch.stack([t.abs() for t in planes[1]]).sum(0)
        d = (mine[1].double() - want[1].double()).abs()
        both_nan = torch.isnan(mine[1]) & torch.isnan(want[1])
        check(bool(((d <= SUM_RTOL * scale.double()) | both_nan).all()), f"{what}: sums")
        err = float(torch.where(both_nan, torch.zeros_like(d), d).max())
    if need_minmax and F:
        for p, name in ((2, "mins"), (3, "maxs")):
            check((_canon(mine[p]) == _canon(want[p])).all(), f"{what}: {name}")
    return err


# the combine's edges: n_seg % 4 of 0-3 (a packed plane after the counts
# starts off 16 bytes unless n_seg % 4 == 0; stacked rows then sit at
# other offsets), planes shorter than a float4, and S up to MAX_SHARDS
COMBINE_EDGE_SEGMENTS = (1, 2, 3, 4, 4096, 4097, 4098, 4099)
COMBINE_EDGE_SHARDS = (1, 2, 3, 8, 64)


def _combine_forms(torch, S_mod, parts, n_seg, F, need_minmax, what) -> float:
    """mesh_combine of ``parts`` as a list and as one stacked tensor, and
    mesh_combine_state of the same planes as (G, B) = (n_seg, 1) states,
    each against the plain version; returns max |sum diff|."""
    kw = dict(n_seg=n_seg, n_agg_fields=F, need_minmax=need_minmax)
    err = 0.0
    for form, src in (("list", parts), ("stacked", torch.stack(parts))):
        got = S_mod.mesh_combine(src, **kw)
        err = max(err, _combine_compare(torch, S_mod, got, parts, n_seg, F, need_minmax,
                                        f"{what} {form}"))
    split = [S_mod._packed_planes(p, n_seg, F, need_minmax) for p in parts]
    fs_shape = (F, n_seg, 1)
    zero = torch.zeros(fs_shape, device=parts[0].device)
    states = [(sp[0].view(torch.int32).view(n_seg, 1), sp[1].view(fs_shape),
               sp[2].view(fs_shape) if need_minmax else zero,
               sp[3].view(fs_shape) if need_minmax else zero) for sp in split]
    c, s, mn, mx = S_mod.mesh_combine_state(states, need_minmax=need_minmax)
    packed = torch.cat([c.reshape(-1).view(torch.float32), s.reshape(-1)]
                       + ([mn.reshape(-1), mx.reshape(-1)] if need_minmax else []))
    return max(err, _combine_compare(torch, S_mod, packed, parts, n_seg, F, need_minmax,
                                     f"{what} state"))


def _combine_edges(torch, n_seg, seed) -> tuple[int, float]:
    """``_combine_forms`` at ``n_seg`` over every S of COMBINE_EDGE_SHARDS
    (F = 1 and F = 3, min/max, +-0 split across the shards both ways and a
    NaN in one shard where there are three elements a plane; F = 2 without
    min/max). Returns (cases, max |sum diff|)."""
    from horaedb_tpu_torch.ops import scan_agg as S

    n_cases, err = 0, 0.0
    for n_shards in COMBINE_EDGE_SHARDS:
        for F, need_minmax in ((1, True), (3, True), (2, False)):
            seed += 1
            special = need_minmax and F * n_seg >= 3
            parts = _combine_parts(torch, n_shards, n_seg, F, need_minmax, special, seed)
            err = max(err, _combine_forms(torch, S, parts, n_seg, F, need_minmax,
                                          f"combine edge n_seg={n_seg} S={n_shards} F={F}"))
            n_cases += 3
    return n_cases, err


def phase_mesh_kernels(torch) -> float:
    """mesh_combine (B7a) against its plain version on the card: S in
    MESH_SIZES, the packed form (S buffers and one [S, L] buffer) and the
    state form, F in {0, 1, 10}, need_minmax both ways, empty segments in
    some shards, +-0 split across shards both ways and NaN in one shard's
    sum, min and max; the edges of ``_combine_edges`` (n_seg % 4 of 0-3,
    planes shorter than a float4, S up to 64); then sparse-16x12h's packed
    size (4,194,304 segments, F = 5, min/max: 268 MB a shard) over
    MESH_SHARDS shards."""
    from horaedb_tpu_torch.ops import scan_agg as S

    n_cases, err, seed = 0, 0.0, SEED + 21
    for n_shards in MESH_SIZES:
        for F in (0, 1, 10):
            for need_minmax in (True, False):
                for special in ((False, True) if F and need_minmax else (False,)):
                    seed += 1
                    parts = _combine_parts(torch, n_shards, MESH_SEGMENTS, F, need_minmax,
                                           special, seed)
                    what = f"combine S={n_shards} F={F} minmax={need_minmax} special={special}"
                    err = max(err, _combine_forms(torch, S, parts, MESH_SEGMENTS, F,
                                                  need_minmax, what))
                    n_cases += 3
                    if special and n_shards > 1:
                        got = S.mesh_combine(parts, n_seg=MESH_SEGMENTS, n_agg_fields=F,
                                             need_minmax=True)
                        mins = S._packed_planes(got, MESH_SEGMENTS, F, True)[2]
                        maxs = S._packed_planes(got, MESH_SEGMENTS, F, True)[3]
                        check(_canon(mins[:2]).tolist() == _canon(
                            torch.tensor([-0.0, -0.0])).tolist(), f"{what}: -0 is the min")
                        check(_canon(maxs[:2]).tolist() == _canon(
                            torch.tensor([0.0, 0.0])).tolist(), f"{what}: +0 is the max")
                        check(bool(torch.isnan(mins[2]) and torch.isnan(maxs[2])),
                              f"{what}: NaN wins")
    for n_seg in COMBINE_EDGE_SEGMENTS:
        cases, e = _combine_edges(torch, n_seg, SEED + 1000 * n_seg)
        n_cases += cases
        err = max(err, e)
    parts = _combine_parts(torch, MESH_SHARDS, SPARSE_SEGMENTS, 5, True, True, SEED + 299)
    kw = dict(n_seg=SPARSE_SEGMENTS, n_agg_fields=5, need_minmax=True)
    got = S.mesh_combine(parts, **kw)
    err = max(err, _combine_compare(torch, S, got, parts, SPARSE_SEGMENTS, 5, True,
                                    "combine at sparse-16x12h's size"))
    n_cases += 1
    _sync(torch)
    del parts, got
    say(f"mesh_combine: kernel = plain in {n_cases} cases (S {MESH_SIZES}, both forms, "
        f"F 0/1/10, +-0 and NaN across shards, n_seg {COMBINE_EDGE_SEGMENTS} at S "
        f"{COMBINE_EDGE_SHARDS}, {4 * S.packed_len(1, SPARSE_SEGMENTS, 5, True)} "
        f"B a shard at sparse-16x12h's size); max |sum diff| {err}")
    DETAIL["mesh_kernels"] = {"cases": n_cases, "max_abs_err": err}
    return err


# ---- phase 22: the sharded main path ------------------------------------------


class MeshRecorder:
    """Keeps the last mesh_combine call, each sharded full scan's
    ``dist_cached_step`` call and, while ``keep_raw`` is set, the global
    row windows the executor hands the sharded top-k and selection
    (``windows``) and their per-shard calls, by wrapping the module
    functions the sharded steps call; ``restore`` puts them back. On the
    card each kept top-k shard call also gets a ``stats`` of its own
    (``topk_stats``), which its keys kernel adds its row and tile counts
    to."""

    def __init__(self, torch, S, T):
        from horaedb_tpu_torch.parallel import dist_agg, dist_raw

        self.S, self.T, self.D, self.R = S, T, dist_agg, dist_raw
        self.orig = (S.mesh_combine, T.raw_topk_packed, T.raw_select_packed)
        self.orig_step = dist_agg.dist_cached_step
        self.orig_dist = (dist_raw.dist_raw_topk, dist_raw.dist_raw_select)
        self.combine = None
        self.steps: list = []
        self.raw: dict = {"raw_topk": [], "raw_select": []}
        self.windows: dict = {}
        self.topk_stats: list = []
        self.keep_raw = False
        orig_combine, orig_topk, orig_select = self.orig

        def combine(parts, **kw):
            self.combine = (list(parts), kw)
            return orig_combine(parts, **kw)

        def step(*a, **k):
            self.steps.append((a, k))
            return self.orig_step(*a, **k)

        dist_agg.dist_cached_step = step

        def keep(kind, orig):
            def call(*a, **k):
                if self.keep_raw:
                    self.raw[kind].append((a, k))
                    if kind == "raw_topk" and DEV == "cuda":
                        stats = torch.zeros(len(T.TOPK_STATS), dtype=torch.int64,
                                            device=a[3].device)
                        self.topk_stats.append(stats)
                        k = {**k, "stats": stats}
                return orig(*a, **k)
            return call

        def keep_windows(kind, orig):
            def call(*a, **k):
                if self.keep_raw:
                    self.windows[kind] = k.get("windows")
                return orig(*a, **k)
            return call

        S.mesh_combine = combine
        T.raw_topk_packed = keep("raw_topk", orig_topk)
        T.raw_select_packed = keep("raw_select", orig_select)
        dist_raw.dist_raw_topk = keep_windows("raw_topk", self.orig_dist[0])
        dist_raw.dist_raw_select = keep_windows("raw_select", self.orig_dist[1])

    def restore(self) -> None:
        self.S.mesh_combine, self.T.raw_topk_packed, self.T.raw_select_packed = self.orig
        self.D.dist_cached_step = self.orig_step
        self.R.dist_raw_topk, self.R.dist_raw_select = self.orig_dist


def _bits_equal(a, b, what) -> None:
    """Two ResultSets with the same columns; every column bit-equal except
    the avgs (sums differ by summation order; held to numpy instead)."""
    import numpy as np

    check(a.names == b.names, f"{what}: columns {a.names} vs {b.names}")
    for n, x, y in zip(a.names, a.columns, b.columns):
        if n.startswith("avg_"):
            continue
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind == "f":
            x, y = x.astype(np.float64).view(np.int64), y.astype(np.float64).view(np.int64)
        check(x.shape == y.shape and np.array_equal(x, y), f"{what}: column {n} differs")


def _mesh_counts(S, T, md) -> dict:
    """The kernels' launch counters, counted where each kernel launches, that
    the sharded path moves (on a CPU rehearsal the plain versions' calls;
    the hash arm's then unknown)."""
    card = DEV == "cuda"
    agg = (lambda f: sum(S.LAUNCHES[f].values())) if card else S.PLAIN_CALLS.__getitem__
    comb = S.COMBINE_LAUNCHES if card else S.COMBINE_PLAIN_CALLS
    raw = T.LAUNCHES if card else T.PLAIN_CALLS
    merge = md.LAUNCHES if card else md.PLAIN_CALLS
    return {"direct": agg("direct"), "cached": agg("cached"),
            "cached_hash": S.LAUNCHES["cached"]["hash"] if card else None,
            "cached_selective": agg("cached_selective"),
            "combine_state": comb["state"], "combine_packed": comb["packed"],
            "raw_topk": raw["raw_topk"], "raw_select": raw["raw_select"],
            "select_tiles": T.TILES["raw_select"] if card else None,
            "merge_f32": merge["f32"]}


def _merge_chunk(n: int):
    """A compaction chunk of config 5: 1000 series, keys drawn from a space
    of three quarters of the rows (about a third of the rows collide), the
    run's sequence 1..64."""
    import numpy as np

    rng = np.random.default_rng(SEED + 22)
    ts_space = (n // COMPACTION_SERIES) * 3 // 4
    tsid_pool = rng.integers(0, 2**63, COMPACTION_SERIES, dtype=np.uint64)
    key = rng.integers(0, COMPACTION_SERIES * ts_space, n)
    return (tsid_pool[key // ts_space], (key % ts_space).astype(np.int64),
            rng.integers(1, COMPACTION_SSTS + 1, n).astype(np.uint64))


def phase_mesh_main(torch, main, card) -> list:
    """The sharded main path on phase 4's connection and cpu table (34.56M
    rows, 10 fields; the host-copy budget phase 15 raised): each query's
    single-device answer first, then the cpu entry evicted and a mesh
    installed (MESH_SHARDS logical shards on the card, or every card where
    there are two or more). Through ``Connection.execute``: the first cold
    query (high-cpu-all) on the sharded direct path; the BASELINE queries
    (the first builds the sharded entry), sparse-16x12h (its hash arm per
    shard, then a 268 MB combine), and the raw reads lastpoint-host and
    high-cpu-1. Every answer equals numpy and the single-device answer
    (counts, mins and maxs bit-equal, raw rows in order); every run reports
    the mesh and moves the counters by one launch a shard and one
    mesh_combine an aggregate, and a raw read by one launch a shard whose
    clipped windows hold rows (each over its part, as its keys kernel or
    tile count shows on the card). Then dist_merge_dedup at a compaction
    chunk's shape against the single-device f32 merge; the last combine,
    the last top-k's and selection's shard launches and the merge's shard
    launches replayed against their plain versions and timed against their
    bounds and library calls; warm executes against the single-device
    ones."""
    import numpy as np

    from horaedb_tpu_torch.ops import merge_dedup as md, scan_agg as S, scan_topk as T
    from horaedb_tpu_torch.parallel import dist_merge, dist_raw
    from horaedb_tpu_torch.parallel.mesh import Mesh, on_device, use_mesh
    from horaedb_tpu_torch.query.path_router import KERNEL_ROUTER
    from horaedb_tpu_torch.tools import tsbs

    db = main["db"]
    exp, raw_exp, hash_exp = main["expected"], main["raw_expected"], main["hash_expected"]
    cache = db.interpreters.executor.scan_cache
    n_cards = torch.cuda.device_count() if DEV == "cuda" else 1
    if n_cards >= 2:
        mesh = Mesh([torch.device("cuda", i) for i in range(n_cards)])
    else:
        mesh = Mesh.logical(torch.device(DEV, 0) if DEV == "cuda" else "cpu", MESH_SHARDS)
    n_sh = mesh.size
    raw_q = {name: (sql, kernel) for name, sql, kernel in raw_queries(raw_exp["hc_host"])}
    sparse = {name: (hosts, hours) for name, hosts, hours in sparse_queries()}
    queries = [
        ("high-cpu-all", tsbs.high_cpu_all(HC_HOURS).sql, "agg"),
        ("single-groupby-5-8-1", tsbs.single_groupby(5, 8, 1).sql, "agg"),
        ("double-groupby-all", tsbs.double_groupby_all(HOURS).sql, "agg"),
        ("sparse-16x12h", sparse_sql(*sparse["sparse-16x12h"]), "agg"),
        ("lastpoint-host", raw_q["lastpoint-host"][0], "topk"),
        ("high-cpu-1", raw_q["high-cpu-1"][0], "select"),
    ]
    # the single-device answers, on phase 4's warm entry: the second run warm
    single = {}
    for name, sql, kind in queries:
        for _ in range(2):
            t = time.perf_counter()
            res = db.execute(sql)
            secs = time.perf_counter() - t
        check("mesh_devices" not in res.metrics, f"{name}: single-device run on a mesh")
        single[name] = {"res": res, "warm_s": secs}
    cache.invalidate("cpu")
    cache._candidate.pop("cpu", None)  # the next read is a first sighting: the direct path
    # the mesh starts the kernel router afresh: each shape's first sharded
    # runs take its seed arm (sparse-16x12h: hash on every shard), not
    # whichever arm phase 20's host-dominated dispatch times favoured
    KERNEL_ROUTER.reset()

    rec = MeshRecorder(torch, S, T)
    results = {}
    _sync(torch)
    for mod in (S, T, md):
        mod.reset_counts()  # the sharded main path's launches start here
    t_path = time.perf_counter()
    try:
        with use_mesh(mesh):
            for i, (name, sql, kind) in enumerate(queries):
                runs = []
                for r in range(1 if i == 0 else REPEATS_MESH):
                    before = _mesh_counts(S, T, md)
                    rec.keep_raw = kind != "agg" and r == REPEATS_MESH - 1
                    t = time.perf_counter()
                    res = db.execute(sql)
                    secs = time.perf_counter() - t
                    after = _mesh_counts(S, T, md)
                    moved = {k: after[k] - before[k] for k in after
                             if after[k] is not None and after[k] != before[k]}
                    m = res.metrics
                    path = db.interpreters.executor.last_path
                    check(m.get("mesh_devices") == n_sh,
                          f"{name} run {r}: mesh_devices {m.get('mesh_devices')} ({path})")
                    if i == 0:
                        check(path == "device-dist" and moved.get("direct") == n_sh
                              and moved.get("combine_state") == 1,
                              f"{name}: cold run {path}, launches {moved}")
                    elif kind == "agg":
                        check(path == "device-cached" and moved.get("cached") == n_sh
                              and moved.get("combine_packed") == 1
                              and not moved.get("cached_selective"),
                              f"{name} run {r}: {path}, launches {moved}")
                    else:
                        # a shard whose clipped windows hold no row is not
                        # launched: checked against the windows after the runs
                        check(path == "raw_device" and m.get("raw_kernel") == kind
                              and 1 <= moved.get(f"raw_{kind}", 0) <= n_sh,
                              f"{name} run {r}: {path}, launches {moved}")
                    _bits_equal(res, single[name]["res"], f"{name} run {r} vs single-device")
                    runs.append({"seconds": secs, "path": path, "cache": m.get("cache"),
                                 "kernel": m.get("kernel") or m.get("raw_kernel"),
                                 "launches": moved})
                if name in exp:
                    _check_answer(name, res.to_pylist(), exp[name])
                elif name in hash_exp:
                    check(DEV != "cuda" or any(x["launches"].get("cached_hash") == n_sh
                                               for x in runs),
                          f"{name}: no run launched the hash arm on every shard")
                    _check_sparse(name, res, sparse[name][0], hash_exp[name])
                elif name == "lastpoint-host":
                    # phase 15's unflushed tick is the newest row
                    got = res.to_pylist()
                    check(got[0]["ts"] == 2 * H12, f"{name}: first row {got[0]}")
                    _same_rows(got[1:], raw_exp[name][:9], f"{name} vs numpy")
                else:
                    _same_rows(res.to_pylist(), raw_exp[name], f"{name} vs numpy")
                results[name] = {"runs": runs, "single_warm_s": single[name]["warm_s"]}
        path_s = time.perf_counter() - t_path
        launches = _mesh_counts(S, T, md)  # the sharded main path's, from reset_counts on
        entry = cache._entries["cpu"]
        check(entry.mesh is mesh, "the cpu entry is not on the mesh")
        per = entry.padded_rows // n_sh
        real = [max(0, min(per, entry.n_valid - d * per)) for d in range(n_sh)]
        # dist_merge_dedup at a compaction chunk's shape, against one device
        tsid, ts, seq = _merge_chunk(MERGE_CHUNK_ROWS)
        f32_before = _mesh_counts(S, T, md)["merge_f32"]
        perm, keep = md.merge_dedup_permutation(tsid, ts, seq, device=mesh.first)
        f32_one = _mesh_counts(S, T, md)["merge_f32"]
        check(f32_one == f32_before + 1, "the one-device merge did not sort with the f32 kind")
        want = perm[keep]
        t = time.perf_counter()
        got = dist_merge.dist_merge_dedup(mesh, tsid, ts, seq)
        merge_s = time.perf_counter() - t
        launches["dist_merge_f32"] = _mesh_counts(S, T, md)["merge_f32"] - f32_one
        check(np.array_equal(got, want), "dist_merge_dedup differs from the one-device merge")
        n_collide = MERGE_CHUNK_ROWS - len(want)
        full = sum(1 for i in dist_merge.shard_words(mesh, tsid, ts, seq)[0] if len(i))
        check(launches["dist_merge_f32"] == full, f"merge shard launches {launches}, {full} "
                                                  f"shards hold rows")
        # fewer tsids than shards: an empty shard launches nothing
        few = tsid[:MERGE_CHUNK_ROWS // 8] % np.uint64(max(n_sh - 1, 1))
        few_args = (few, ts[:len(few)], seq[:len(few)])
        perm, keep = md.merge_dedup_permutation(*few_args, device=mesh.first)
        f32_before = _mesh_counts(S, T, md)["merge_f32"]
        few_got = dist_merge.dist_merge_dedup(mesh, *few_args)
        few_launches = _mesh_counts(S, T, md)["merge_f32"] - f32_before
        few_full = sum(1 for i in dist_merge.shard_words(mesh, *few_args)[0] if len(i))
        check(np.array_equal(few_got, perm[keep]),
              "dist_merge_dedup with an empty shard differs from the one-device merge")
        check(few_launches == few_full < max(n_sh, 2),
              f"dist_merge_dedup with an empty shard: {few_launches} launches, {few_full} "
              f"shards hold rows of {n_sh}")
        launches["dist_merge_f32_empty_shard"] = few_launches
        plain = {"scan_agg": dict(S.PLAIN_CALLS), "combine": dict(S.COMBINE_PLAIN_CALLS),
                 "scan_topk": dict(T.PLAIN_CALLS), "merge_dedup": dict(md.PLAIN_CALLS)}
    finally:
        rec.restore()
    if DEV == "cuda":
        check(not any(v for d in plain.values() for v in d.values()),
              f"plain versions ran: {plain}")
    # each sharded raw read's shards: the executor's global windows clipped
    # to each shard; only the shards whose part holds a row launched, each
    # over its part inside its real rows, in every run
    shard_parts = {}
    for kind, query in (("raw_topk", "lastpoint-host"), ("raw_select", "high-cpu-1")):
        glob = rec.windows.get(kind)
        check(glob is not None, f"{query}: the executor handed the mesh no windows")
        parts = [(d, dist_raw.shard_windows(glob, d * per, per)) for d in range(n_sh)]
        parts = [(d, w) for d, w in parts if int((w[:, 1] - w[:, 0]).sum())]
        calls = rec.raw[kind]
        check(len(calls) == len(parts) >= 1,
              f"{query}: {len(calls)} shard launches recorded, {len(parts)} shards hold "
              f"window rows")
        check(launches[kind] == REPEATS_MESH * len(parts),
              f"{kind} launches {launches}: {REPEATS_MESH} runs x {len(parts)} shards with "
              f"window rows")
        for (d, want), (a, k) in zip(parts, calls):
            w = np.asarray(k["windows"], dtype=np.int64).reshape(-1, 2)
            check(np.array_equal(w, want) and int(w[0, 0]) >= 0 and int(w[-1, 1]) <= real[d],
                  f"{query} shard {d}: windows {w.tolist()} are not its clipped part "
                  f"{want.tolist()} inside its {real[d]} real rows")
        shard_parts[kind] = parts
    # on the card the last runs walked the windows' rows and tiles and no
    # others: the selection's tiles, and each top-k shard's keys kernel's
    # rows and tiles as it counted them
    tiles = sum(len(T.select_tiles(w, per)) for _, w in shard_parts["raw_select"])
    walked = results["high-cpu-1"]["runs"][-1]["launches"].get("select_tiles", 0)
    check(DEV != "cuda" or walked == tiles,
          f"high-cpu-1 on the mesh walked {walked} tiles, its shard windows hold {tiles}")
    topk_walked = [s.tolist() for s in rec.topk_stats]
    for (d, w), got in zip(shard_parts["raw_topk"], topk_walked):
        rows_w = w[:, 1] - w[:, 0]
        want = [int(rows_w.sum()), int(((rows_w + T.TILE - 1) // T.TILE).sum())]
        check(got == want, f"lastpoint-host shard {d}: the keys kernel counted rows and "
                           f"tiles {got}, its windows hold {want}")
    DETAIL["mesh_raw_shards"] = {
        kind: [{"shard": d, "windows": w.tolist()} for d, w in parts]
        for kind, parts in shard_parts.items()}
    DETAIL["mesh_raw_shards"]["topk_walked"] = topk_walked
    say(f"mesh: {mesh} ({n_sh} shards); real rows per shard {real} of {per} "
        f"(the last shard{' is' if real[-1] == 0 else ' is not'} all padding); "
        f"main path {path_s:.1f} s; launches {launches}")
    check(sum(real) == entry.n_valid, f"real rows {real} vs {entry.n_valid}")
    for name, res in results.items():
        runs = res["runs"]
        warm = statistics.median([x["seconds"] for x in runs[1:]]) if len(runs) > 1 else None
        res["warm_s"] = warm
        phase4 = main["results"].get(name)
        p4 = (statistics.median([x["seconds"] for x in phase4["runs"][2:]]) * 1e3
              if phase4 else None)
        say(f"mesh {name}: runs {[round(x['seconds'] * 1e3, 3) for x in runs]} ms "
            f"({[x['cache'] for x in runs]}); warm {warm * 1e3 if warm else 0:.3f} ms against "
            f"one device {res['single_warm_s'] * 1e3:.3f} ms here"
            + (f", {p4:.3f} ms in phase 4" if p4 else "") + f"; equal to numpy and to one "
            f"device [{card}]")
    say(f"dist_merge_dedup: {MERGE_CHUNK_ROWS} rows ({n_collide} collide) over {n_sh} shards "
        f"in {merge_s:.2f} s, bit-equal to the one-device f32 merge")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    rows = []
    # B7a: the last combine (sparse-16x12h's), replayed and timed
    parts, kw = rec.combine
    got = S.mesh_combine(parts, **kw)
    err = _combine_compare(torch, S, got, parts, kw["n_seg"], kw["n_agg_fields"],
                           kw["need_minmax"], "the last combine")
    fn = lambda: S.mesh_combine(parts, **kw)  # noqa: E731
    ms = _device_ms(torch, fn, "mesh_combine", reps=10) or _time_launch(torch, fn)
    split = [S._packed_planes(p, kw["n_seg"], kw["n_agg_fields"], kw["need_minmax"])
             for p in parts]
    planes = [[s[p] for s in split] if split[0][p] is not None else [] for p in range(4)]
    plain_ms = _time_launch(torch, lambda: S.combine_planes_plain(planes), reps=3)
    stacked = torch.stack(parts)
    n_seg, fs = kw["n_seg"], kw["n_seg"] * kw["n_agg_fields"]

    def library():
        stacked[:, :n_seg].view(torch.int32).sum(0, dtype=torch.int32)
        stacked[:, n_seg:n_seg + fs].sum(0)
        stacked[:, n_seg + fs:n_seg + 2 * fs].amin(0)
        stacked[:, n_seg + 2 * fs:].amax(0)

    lib_ms = _time_launch(torch, library)
    nbytes = (len(parts) + 1) * _bytes_of(parts[0])
    bound = nbytes / PEAK_BYTES_S * 1e3
    del stacked, got
    rows.append({"name": "mesh_combine", "route": "cuda", "source": SRC,
                 "replaces": MESH_REPLACES["combine"],
                 "launches": launches["combine_state"] + launches["combine_packed"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": "bytes", "library_ms": lib_ms})
    say(f"kernel mesh_combine at sparse-16x12h ({len(parts)} x {_bytes_of(parts[0])} B): "
        f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
        f"torch.sum/amin/amax {lib_ms:.4f} ms ({nbytes / lib_ms / 1e6:.1f} GB/s), bound "
        f"{bound:.4f} ms (bytes), kernel = plain (max |sum diff| {err}) [{card}]")
    del parts, planes, split
    # the shards' full scans at double-groupby-all (10 fields), each over
    # its part of the real rows: their launches' device ms a query
    step = next((c for c in reversed(rec.steps) if c[0][1].n_agg_fields == 10), None)
    check(step is not None, "no sharded full scan of double-groupby-all was recorded")
    a, k = step
    check(k.get("n_valid") == entry.n_valid, f"dist_cached_step got n_valid {k.get('n_valid')}")
    shard_ms = _family_device_ms(torch, lambda: rec.orig_step(*a, **k), ("scan_agg_cached",),
                                 reps=5, label="the shards' full scans at double-groupby-all")
    DETAIL["mesh_full_scans"] = {"ms_a_query": shard_ms, "real_rows": real}
    say(f"kernel scan_agg_cached on {n_sh} shards at double-groupby-all (real rows a shard "
        f"{real}, each launch over its own): {shard_ms} ms a query for the {n_sh} launches on "
        f"the device timeline [{card}]")
    def every_card(fn):
        """``fn``, then on a mesh of several cards a wait for each, so that
        the first card's events time every shard's work."""
        if len(set(mesh.devices)) == 1:
            return fn
        return lambda: [fn(), *(torch.cuda.synchronize(d) for d in mesh.devices)]

    # B7b: the last run's per-shard top-k (lastpoint-host) and selection
    # (high-cpu-1) launches, the shards whose windows hold rows, replayed
    # (each on its shard's card) and timed
    for kind, query, plain_fn, lib_name in (
            ("raw_topk", "lastpoint-host", T.raw_topk_plain, "torch.topk"),
            ("raw_select", "high-cpu-1", T.raw_select_plain, "torch.nonzero")):
        calls, launch = rec.raw[kind], getattr(T, f"{kind}_packed")

        def shards(fn, calls=calls):
            out = []
            for a, k in calls:
                with on_device(a[3].device):
                    out.append(fn(*a, **k))
            return out

        for got, want in zip(shards(launch), shards(plain_fn)):
            check(torch.equal(got, want), f"{query} shard {kind}: kernel != plain")
        ms_b = _time_launch(torch, every_card(lambda: shards(launch)), flush=flush)
        # the same launches on the device timeline: the events above also
        # hold the wrappers' host work between the shards' launches
        dev_b = (_family_device_ms(torch, lambda: shards(launch), RAW_KERNELS, reps=10,
                                   label=f"dist_{kind} at {query}")
                 if DEV == "cuda" else None)
        plain_b = _time_launch(torch, every_card(lambda: shards(plain_fn)), reps=3)
        libs = [_raw_library(torch, kind, a, k) for a, k in calls]
        lib_b = _time_launch(torch, every_card(lambda: [f() for f in libs]), flush=flush)
        bound_b = sum(_raw_bound(torch, kind, a, k)[0] for a, k in calls)
        rows.append({"name": f"dist_{kind} ({kind} per shard)", "route": "cuda",
                     "source": RAW_SRC, "replaces": MESH_REPLACES[kind],
                     "launches": launches[kind], "max_abs_err": 0.0, "ms": ms_b,
                     "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": "bytes",
                     "library_ms": lib_b, "device_ms": dev_b})
        size = (f"k {calls[0][1]['k']}, keys out" if kind == "raw_topk"
                else f"{[k['select_slots'] for _, k in calls]} slots a shard")
        dev_text = f"{dev_b:.4f} ms" if dev_b is not None else "not measured"
        say(f"kernel dist_{kind} at {query} ({len(calls)} shard launches of {n_sh} shards, "
            f"the shards whose windows hold rows; {size}): {ms_b:.4f} ms (events, wrappers "
            f"included), {dev_text} on the device timeline, plain {plain_b:.4f} ms, "
            f"{lib_name} x{len(calls)} {lib_b:.4f} ms, bound {bound_b:.6f} ms (bytes, the "
            f"window rows), kernel = plain [{card}]")
        del libs
    # B7c: the merge's per-shard sorts, replayed and timed: one after another
    # on the current stream, then each on its own stream as the call queues
    # them, and the whole call from the host arrays to the answer
    idxs, host, masks = dist_merge.shard_words(mesh, tsid, ts, seq, pinned=DEV == "cuda")
    shards = [(i, h, d) for i, h, d in zip(idxs, host, mesh.devices) if len(i)]
    words = []
    for idx, h, dev in shards:
        w = h.to(dev).unbind(0)
        words.append(w)
        with on_device(dev):
            kp, kk = md.unpack(md.sort_dedup("f32", w, masks, len(idx), True), len(idx))[:2]
        pp, pk = md._plain("f32", w, masks, len(idx), True)
        check(torch.equal(kp, pp) and torch.equal(kk, pk), "a shard's merge sort: kernel != plain")

    def one_by_one():
        for (idx, _, dev), w in zip(shards, words):
            with on_device(dev):
                md.sort_dedup("f32", w, masks, len(idx), True)

    streams, slots = [], {}  # the call's shard streams, a card's in turn
    for _, _, dev in shards if DEV == "cuda" else ():
        slots[dev] = slots.get(dev, -1) + 1
        streams.append(dist_merge.shard_stream(dev, slots[dev]))

    def side_by_side():
        """Each shard's sort on a stream of its own, as dist_merge_dedup
        queues them; the current stream waits for all of them."""
        if DEV != "cuda":
            return one_by_one()
        for (idx, _, dev), w, st in zip(shards, words, streams):
            st.wait_stream(torch.cuda.current_stream(dev))
            with on_device(dev), torch.cuda.stream(st):
                md.sort_dedup("f32", w, masks, len(idx), True)
        for (_, _, dev), st in zip(shards, streams):
            torch.cuda.current_stream(dev).wait_stream(st)

    ms_c = _time_launch(torch, every_card(one_by_one), flush=flush)
    ms_s = _time_launch(torch, every_card(side_by_side), flush=flush)
    call_ms = []
    for _ in range(5):
        _sync(torch)
        t = time.perf_counter()
        dist_merge.dist_merge_dedup(mesh, tsid, ts, seq)
        call_ms.append((time.perf_counter() - t) * 1e3)
    plain_c = _time_launch(torch, every_card(lambda: [md._plain("f32", w, masks, len(i), True)
                                                       for (i, _, _), w in zip(shards, words)]),
                           reps=3)
    bound_c = sum(_merge_bound(w, len(i), "f32")[0] for (i, _, _), w in zip(shards, words))
    rows.append({"name": "dist_merge_dedup (merge_dedup f32 per shard)", "route": "cuda",
                 "source": MERGE_SRC, "replaces": MESH_REPLACES["merge"],
                 "launches": launches["dist_merge_f32"], "max_abs_err": 0.0, "ms": ms_s,
                 "plain_ms": plain_c, "bound_ms": bound_c, "bound_by": "bytes",
                 "library_ms": None})
    say(f"kernel dist_merge_dedup at {MERGE_CHUNK_ROWS} rows ({[len(i) for i in idxs]} a "
        f"shard, {len(shards)} sorted): {ms_s:.4f} ms with each shard's sort on its own "
        f"stream, {ms_c:.4f} ms one after another (events, L2 flushed); the whole call from the host arrays {statistics.median(call_ms):.3f} ms "
        f"(host clock, median of 5); plain {plain_c:.4f} ms, bound {bound_c:.4f} ms (bytes, "
        f"the real rows), kernel = plain [{card}]")
    DETAIL["dist_merge"] = {"side_by_side_ms": ms_s, "one_by_one_ms": ms_c, "call_ms": call_ms,
                            "shard_rows": [len(i) for i in idxs], "plain_ms": plain_c,
                            "bound_ms": bound_c}
    del idxs, host, words, shards, streams, flush
    if DEV == "cuda":
        torch.cuda.empty_cache()
    DETAIL["mesh_main"] = {"mesh": str(mesh), "real_rows": real, "shard_rows": per,
                           "launches": launches, "path_s": path_s, "merge_s": merge_s,
                           "queries": results, "rows": rows}
    return rows


def every_phase(torch, timed, card) -> list:
    """Phases 3-22 and the later ones in order; returns the kernel table."""
    timed(phase_kernels, torch)
    timed(phase_merge_kernels, torch)
    timed(phase_lw_kernels, torch)
    main_out = timed(phase_main, torch)
    errs = timed(phase_replay, torch, main_out)
    kernels = timed(phase_timings, torch, main_out, errs, card)
    timed(phase_raw_kernels, torch)
    raw = timed(phase_raw_main, torch, main_out)
    kernels += timed(phase_raw_timings, torch, raw, card)
    timed(phase_cohort_kernels, torch)
    flood = timed(phase_flood, torch, main_out)
    kernels += timed(phase_flood_timings, torch, main_out, flood, raw, card)
    timed(phase_hash_kernels, torch)
    kernels += timed(phase_hash_main, torch, main_out, card)
    timed(phase_mesh_kernels, torch)
    kernels += timed(phase_mesh_main, torch, main_out, card)
    del raw, flood
    main_out["db"].close()
    del main_out
    comp = timed(phase_compaction, torch, COMPACTION_ROWS)
    passes = timed(phase_merge_replay, torch, comp)
    kernels += timed(phase_merge_timings, torch, comp, passes, card)
    del comp
    lw_main = timed(phase_lw_main, torch)
    kernels += timed(phase_lw_timings, torch, lw_main, card)
    lw_main["db"].close()
    del lw_main
    timed(phase_lw_promql, torch)
    return kernels


def mesh_only(torch, timed, card) -> list:
    """``--mesh-only``: the sharded main path (phase 22) and what it is held
    to, phases 4 and 15 (the cpu table, its single-device answers and the
    raised host-copy budget), for a host of several cards, where phase 22
    shards over every card. Returns phase 22's kernel rows."""
    main_out = timed(phase_main, torch)
    timed(phase_raw_main, torch, main_out)
    kernels = timed(phase_mesh_main, torch, main_out, card)
    main_out["db"].close()
    return kernels


def main(argv) -> int:
    global MESH_ONLY
    if argv not in ([], ["--mesh-only"]):
        print(f"usage: python3 chip_smoke.py [--mesh-only] (got {argv})", file=sys.stderr)
        return 2
    MESH_ONLY = argv == ["--mesh-only"]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import horaedb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the horaedb_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    DETAIL["phase_seconds"] = {}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        DETAIL["phase_seconds"][fn.__name__] = time.perf_counter() - t
        return out

    from horaedb_tpu_torch.parallel.mesh import use_mesh

    # every phase serves from one card (phase 22 installs its own mesh), on
    # a host of several cards too
    with use_mesh(None):
        card = timed(phase_card, torch)
        timed(phase_build)
        if MESH_ONLY:
            kernels = mesh_only(torch, timed, card)
        else:
            kernels = every_phase(torch, timed, card)
    say("phase seconds: " + json.dumps({k: round(v, 1)
                                         for k, v in DETAIL["phase_seconds"].items()}))
    DETAIL["run_seconds"] = time.perf_counter() - t_run
    say(f"chip_smoke: every phase{' of --mesh-only' if MESH_ONLY else ''} passed in "
        f"{DETAIL['run_seconds']:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    name = "chip_smoke_mesh.json" if MESH_ONLY else "chip_smoke.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(DETAIL, f, indent=1, default=str)
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
