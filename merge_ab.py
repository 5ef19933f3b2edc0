#!/usr/bin/env python3
"""Time two checkouts' merge-dedup sort (B5) in turns on one NVIDIA card:
this checkout and another one, in the order other, this, this, other,
each turn a process of its own that imports that checkout's
``horaedb_tpu_torch`` (ab_turns.py).

    mkdir -p chip_proof/parent
    git archive HEAD~1 horaedb_tpu_torch | tar -x -C chip_proof/parent
    python3 merge_ab.py --other chip_proof/parent [--compaction] [--shapes read,chunk,dist]

Each turn builds the keys of the two main-path calls of chip_smoke.py's
phase 8 (BASELINE config 5: 64 overlapping runs of 1000 series in one 2 h
window, COMPACTION_ROWS rows, seed 7, run i carrying sequence i + 1) from
the same generator, and dispatches each once through the checkout's own
entry point, which packs, stages and launches it as the main path does:

- read: the read merge's f32 call over every row (``merge_dedup_dispatch``);
- chunk: the last compaction chunk's rk call (``merge_dedup_dispatch_packed``
  on ``pack_ranked_key`` over dense tsid ranks, the rows of the last of
  ``merge_chunk_count`` rank ranges balanced by rows, as the compactor
  splits them).

The host tensor the dispatch staged and the sort it launched (kind,
device words, masks, real rows) are caught on the way. For each: the
upload of the staged words and the copy back of the sort's output
(pinned, CUDA events, bytes beside), the sort's device time on the
profiler's timeline with L2 flushed before each call, split by kernel,
with its kernel launches a call and the radix passes it took, the
dispatch's host wall time, and a digest of perm and keep over the real
rows, which must be the same in every turn. The kernel is also held
against the checkout's plain version on the same words (bit-equal).
``--shapes`` picks the calls (read and chunk by default); ``dist`` is the
sharded merge (B7c) of chip_smoke.py's phase 22: a compaction chunk of
MERGE_CHUNK_ROWS rows over MESH_SHARDS logical shards of the card, through
the checkout's own ``dist_merge_dedup``, its shards' launches, the host wall
time of the whole call (median of 5) and of its split and staging, and in
one traced call the span of its device work (copies and kernels, the first
start to the last end; shards sorted side by side shorten it) and the sum
of its sort kernels' times.
``--compaction`` adds chip_smoke.py's phase 8 to each turn (the table of
64 SSTs written, the SELECT that runs the read merge, ``compact()``, the
SELECT after, each checked against numpy), for its wall times and host
stage splits.

Prints every time with the card's name and power limit; writes
chiprun_out/merge_ab.json. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import sys
import time

from ab_turns import REPO, emit, enter, events_ms, run_turns, say, write_report

# every kernel either checkout's sort launches, by base name
NAMES = ("Memset", "init_hist", "plan_passes", "tile_hist", "digit_scan", "tile_scatter",
         "sort_pass", "epilogue")
SHAPES = ("read", "chunk", "dist")


def config5_keys(C):
    """(tsid, ts, seq) of config 5's rows in run order, as chip_smoke.py's
    _build_compaction_table writes them, without the SSTs; the first turn
    keeps them under chip_proof/ for the next ones."""
    import numpy as np

    rows = C.COMPACTION_ROWS
    path = os.path.join(REPO, "chip_proof", f"config5_keys_{rows}.npy")
    if os.path.exists(path):
        keys = np.load(path)
        return keys[0], keys[1].view(np.int64), keys[2]
    tsid, ts, seq = _config5_keys(C)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.stack([tsid, ts.view(np.uint64), seq]))
    return tsid, ts, seq


def _config5_keys(C):
    import numpy as np

    from horaedb_tpu_torch.common_types.schema import compute_tsid

    rows = C.COMPACTION_ROWS
    n_per = rows // C.COMPACTION_SSTS
    rng = np.random.default_rng(C.COMPACTION_SEED)
    names = np.array([f"host_{i}" for i in range(C.COMPACTION_SERIES)], dtype=object)
    tsid_pool = compute_tsid([names])
    by_rank = np.argsort(tsid_pool)
    ts_space = max(1, (rows // C.COMPACTION_SERIES) * 3 // 4)
    ts_step = max(1, 2 * 3_600_000 // ts_space)  # the table's 2 h segment window
    tsid = np.empty(n_per * C.COMPACTION_SSTS, np.uint64)
    ts = np.empty(n_per * C.COMPACTION_SSTS, np.int64)
    seq = np.empty(n_per * C.COMPACTION_SSTS, np.uint64)
    for i in range(C.COMPACTION_SSTS):
        keys = C._distinct(rng, C.COMPACTION_SERIES * ts_space, n_per)
        rng.normal(10.0, 3.0, n_per)  # the run's values: keeps the draws in step
        at = slice(i * n_per, (i + 1) * n_per)
        tsid[at] = tsid_pool[by_rank[keys // ts_space]]
        ts[at] = (keys % ts_space) * ts_step
        seq[at] = i + 1
    return tsid, ts, seq


def main_path_calls(C, md):
    """shape -> the dispatch of the call, through the checkout's own entry
    point: the read merge's f32 call and the last compaction chunk's rk
    call."""
    import numpy as np

    from horaedb_tpu_torch.engine.compaction import merge_chunk_count

    tsid, ts, seq = config5_keys(C)
    n = len(tsid)
    calls = {"read": lambda: md.merge_dedup_dispatch(tsid, ts, seq, device="cuda")}
    uniq, rank = np.unique(tsid, return_inverse=True)
    rank = rank.astype(np.uint64)
    comp, mask_hi, mask_lo = md.pack_ranked_key(rank, ts, seq, len(uniq))
    n_chunks = merge_chunk_count(n)
    cum = np.cumsum(np.bincount(rank.astype(np.int64), minlength=len(uniq)))
    split = np.searchsorted(cum, [(n * (i + 1)) // n_chunks for i in range(n_chunks - 1)],
                            side="left")
    chunk_of_rank = np.searchsorted(split, np.arange(len(uniq)), side="right")
    chunk = comp[chunk_of_rank[rank.astype(np.int64)] == n_chunks - 1]
    calls["chunk"] = lambda: md.merge_dedup_dispatch_packed(chunk, mask_hi, mask_lo,
                                                            device="cuda")
    return calls


def caught(md, dispatch):
    """Run one dispatch to its end; returns the host tensor it staged and
    the sort it launched: (kind, device words, masks, real rows, dedup)."""
    got = {}
    stage, sort = md.stage, md.sort_dedup

    def staged(*args, **kw):
        got["host"] = stage(*args, **kw)
        return got["host"]

    def launched(*args):
        got["sort"] = args
        return sort(*args)

    md.stage, md.sort_dedup = staged, launched
    try:
        dispatch().get()
    finally:
        md.stage, md.sort_dedup = stage, sort
    return got["host"], got["sort"]


def arm_shape(torch, C, md, card, shape, dispatch, flush) -> dict:
    host, (kind, words, masks, n, dedup) = caught(md, dispatch)
    up_ms = events_ms(torch, lambda: host.to("cuda", non_blocking=True))
    out = md.sort_dedup(kind, words, masks, n, dedup)
    back = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    down_ms = events_ms(torch, lambda: back.copy_(out, non_blocking=True))
    perm, keep, passes = md.unpack(out, words[0].shape[0])
    want = md._plain(kind, words, masks, n, dedup)
    if not (torch.equal(perm, want[0]) and torch.equal(keep, want[1])):
        raise AssertionError(f"{shape}: the kernel differs from the plain version")
    digest = hashlib.sha1(perm[:n].cpu().numpy().tobytes()
                          + keep[:n].cpu().numpy().tobytes()).hexdigest()
    fn = lambda: md.sort_dedup(kind, words, masks, n, dedup)  # noqa: E731
    ms = C._family_device_ms(torch, fn, NAMES, reps=10, flush=flush, lead=64,
                             label=f"{shape} sort")
    window = C.DETAIL["device_ms_windows"][-1]
    wall = []
    for _ in range(3):
        t = time.perf_counter()
        dispatch().get()
        wall.append((time.perf_counter() - t) * 1e3)
    res = {
        "kind": kind, "rows": n, "staged_rows": int(words[0].shape[0]),
        "passes": int(passes.sum()), "device_ms": ms, "split_ms": window["ms_a_call"],
        "launches_a_call": window["launches_a_call"],
        "upload_bytes": int(host.numel() * 4), "upload_ms": up_ms,
        "download_bytes": int(back.numel()), "download_ms": down_ms,
        "dispatch_ms": statistics.median(wall), "digest": digest,
    }
    say(f"{shape} ({kind}, {n} rows, {res['staged_rows']} staged, {res['passes']} passes): "
        f"sort {ms:.4f} ms on the device timeline, L2 flushed; split " + ", ".join(
            f"{k} {v:.4f} ({window['launches_a_call'][k]:.0f}x)"
            for k, v in window["ms_a_call"].items())
        + f"; upload {res['upload_bytes']} B {up_ms:.4f} ms, download {res['download_bytes']} "
        f"B {down_ms:.4f} ms; dispatch wall {res['dispatch_ms']:.1f} ms [{card}]")
    return res


def base_name(e) -> str:
    """A profiler event's kernel name without its signature and template
    arguments."""
    return e.name.split("(")[0].split("<")[0].strip().split(" ")[-1]


def arm_dist(torch, C, card) -> dict:
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from horaedb_tpu_torch.ops import merge_dedup as md
    from horaedb_tpu_torch.parallel import dist_merge
    from horaedb_tpu_torch.parallel.mesh import Mesh

    tsid, ts, seq = C._merge_chunk(C.MERGE_CHUNK_ROWS)
    mesh = Mesh.logical(torch.device("cuda", 0), C.MESH_SHARDS)
    before = md.LAUNCHES["f32"]
    got = dist_merge.dist_merge_dedup(mesh, tsid, ts, seq)
    launches = md.LAUNCHES["f32"] - before
    perm, keep = md.merge_dedup_permutation(tsid, ts, seq, device="cuda")
    if not np.array_equal(got, perm[keep]):
        raise AssertionError("dist: the sharded merge differs from the one-device merge")
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist_merge.dist_merge_dedup(mesh, tsid, ts, seq)
        wall.append((time.perf_counter() - t) * 1e3)
    stage = []
    for _ in range(3):  # the host split and staging alone (the parent's uploads too)
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist_merge.shard_words(mesh, tsid, ts, seq)
        torch.cuda.synchronize()
        stage.append((time.perf_counter() - t) * 1e3)
    spans, sums = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dist_merge.dist_merge_dedup(mesh, tsid, ts, seq)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:  # every kernel and copy of the call, first start to last end
            spans.append((max(e.time_range.end for e in dev)
                          - min(e.time_range.start for e in dev)) / 1e3)
            sums.append(sum(e.time_range.elapsed_us() for e in dev
                            if base_name(e) in NAMES) / 1e3)
    res = {"rows": len(tsid), "launches": launches, "call_ms": statistics.median(wall),
           "stage_ms": statistics.median(stage),
           "span_ms": statistics.median(spans) if spans else None,
           "sum_ms": statistics.median(sums) if sums else None,
           "digest": hashlib.sha1(got.tobytes()).hexdigest()}
    say(f"dist ({len(tsid)} rows, {C.MESH_SHARDS} logical shards, {launches} sorts): the "
        f"call {res['call_ms']:.1f} ms by the host clock, its split and staging "
        f"{res['stage_ms']:.1f} ms; the call's device work (copies and kernels) spans "
        f"{res['span_ms']} ms on the device timeline, its sorts' kernels {res['sum_ms']} ms "
        f"summed [{card}]")
    return res


def arm(opt) -> int:
    """One turn: this process imports the checkout ``opt.arm``."""
    enter(opt.arm)
    import torch

    import chip_smoke as C
    from horaedb_tpu_torch.ops import merge_dedup as md

    C.DEV = "cuda"
    card = C.phase_card(torch)
    md._kernels()
    shapes = opt.shapes.split(",")
    res = {"dir": opt.arm, "card": card}
    if "dist" in shapes:
        res["dist"] = arm_dist(torch, C, card)
    calls = None
    if {"read", "chunk"} & set(shapes):
        t = time.perf_counter()
        calls = main_path_calls(C, md)
        say(f"config 5 keys and packing: {time.perf_counter() - t:.1f} s")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        for shape in ("read", "chunk"):
            if shape in shapes:
                res[shape] = arm_shape(torch, C, md, card, shape, calls[shape], flush)
    if opt.compaction:
        del calls
        out = C.phase_compaction(torch, C.COMPACTION_ROWS)["out"]
        res["compaction"] = {k: out[k] for k in (
            "select_before_s", "compact_s", "select_after_s", "input_rows_per_s",
            "select_before_split_s", "compact_split_s")}
    emit(res)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout of the other commit")
    ap.add_argument("--compaction", action="store_true",
                    help="each turn also runs chip_smoke.py's phase 8")
    ap.add_argument("--shapes", default="read,chunk",
                    help=f"comma-separated, of {', '.join(SHAPES)}")
    ap.add_argument("--arm", help="(internal) run one turn with this checkout")
    opt = ap.parse_args(argv)
    shapes = opt.shapes.split(",")
    if not set(shapes) <= set(SHAPES):
        ap.error(f"--shapes takes some of {', '.join(SHAPES)}")
    if opt.arm:
        return arm(opt)
    turns = run_turns(__file__, opt.other, ["--shapes", opt.shapes]
                      + (["--compaction"] if opt.compaction else []))
    card = write_report("merge_ab.json", turns)
    same = True
    if "dist" in shapes:
        equal = len({t["dist"]["digest"] for t in turns}) == 1
        same &= equal
        say("dist: the call's device span ms " + " / ".join(
            f"{t['label']} {t['dist']['span_ms']}" for t in turns)
            + "; its sorts' kernels summed ms " + " / ".join(str(t["dist"]["sum_ms"])
                                                            for t in turns)
            + "; the call ms " + " / ".join(f"{t['dist']['call_ms']:.1f}" for t in turns)
            + "; its staging ms " + " / ".join(f"{t['dist']['stage_ms']:.1f}" for t in turns)
            + "; sorts " + " / ".join(str(t["dist"]["launches"]) for t in turns)
            + f"; the same rows in every turn: {equal} [{card}]")
    for shape in (x for x in ("read", "chunk") if x in shapes):
        equal = len({t[shape]["digest"] for t in turns}) == 1
        same &= equal
        say(f"{shape}: sort ms " + " / ".join(
            f"{t['label']} {t[shape]['device_ms']:.4f}" for t in turns)
            + "; passes " + " / ".join(str(t[shape]["passes"]) for t in turns)
            + "; launches a call " + " / ".join(
                f"{sum(t[shape]['launches_a_call'].values()):.0f}" for t in turns)
            + "; staged rows " + " / ".join(str(t[shape]["staged_rows"]) for t in turns)
            + "; upload ms " + " / ".join(f"{t[shape]['upload_ms']:.3f}" for t in turns)
            + "; download ms " + " / ".join(f"{t[shape]['download_ms']:.3f}" for t in turns)
            + "; dispatch wall ms " + " / ".join(f"{t[shape]['dispatch_ms']:.1f}"
                                                 for t in turns)
            + f"; perm and keep equal in every turn: {equal} [{card}]")
    if opt.compaction:
        say("config 5: select before s " + " / ".join(
            f"{t['compaction']['select_before_s']:.3f}" for t in turns) + "; compact s "
            + " / ".join(f"{t['compaction']['compact_s']:.3f}" for t in turns)
            + "; input rows/s " + " / ".join(
                f"{t['compaction']['input_rows_per_s']:.0f}" for t in turns)
            + "; select after s " + " / ".join(
                f"{t['compaction']['select_after_s']:.3f}" for t in turns) + f" [{card}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
