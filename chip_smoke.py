#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horaedb_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the CUDA kernels from ``horaedb_tpu_torch/ops/csrc`` with nvcc.
3. Kernel vs plain: every entry point (direct, cached full, cached
   selective) and arm (single, shared, scatter) against its plain PyTorch
   version on the same CUDA tensors, over every resident layout, all six
   filter ops, both need_minmax values, F = 0, ragged N, NaN and signed
   zeros, and one segment of more than 2**24 rows. Counts, mins and maxs
   must be bit-equal; sums within SUM_RTOL of the segment's sum of |x|.
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
    from horaedb_tpu_torch.ops import scan_agg

    t0 = time.perf_counter()
    lib = scan_agg._kernels()  # builds and loads the library, checks its struct layouts
    secs = time.perf_counter() - t0
    say(f"build: scan_agg.cu in {lib.build_seconds:.2f} s of nvcc, {secs:.2f} s with loading")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas scan_agg: {line.strip()}")
    DETAIL["build_seconds"] = secs
    DETAIL["build_log"] = lib.build_log


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
    both_nan = np.isnan(g) & np.isnan(w)
    with np.errstate(invalid="ignore"):
        diff = np.where(both_nan, 0.0, np.abs(g - w))
    with np.errstate(invalid="ignore"):
        bad = ~(both_nan | (diff <= SUM_RTOL * a))
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
    err, n_counted = _check_call(torch, form, (*entry.kernel_args().values(), session, dyn),
                                 kw, kind)
    check(n_counted > 0, f"{kind}: no row passed")
    return err


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
    _sync(torch)
    say(f"kernels vs plain: {n_cases} cases passed; max |sum diff| {errs}")
    DETAIL["kernel_cases"] = n_cases
    DETAIL["kernel_cases_max_abs_err"] = errs


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
    # high-cpu-all: usage_user > 90 in the first 12 h
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
    return {"db": db, "results": results, "launches": launches, "peak": peak, "rec": rec}


# ---- phase 5: timings ---------------------------------------------------------


def _device_ms(torch, fn, name: str, reps=20, flush=None):
    """Mean ms of the ``name`` kernel on the card by the profiler's device
    timeline (the launch alone, without the wrapper's host work), or None
    when the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
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
    return sum(us) / len(us) / 1e3 if us else None


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


def _bytes_of(t) -> int:
    return int(t.numel() * t.element_size())


def _kernel_bounds(form, args, kw) -> tuple[float, str, dict]:
    """Least time for the work: the bytes it must move over HBM bandwidth,
    or its f32 operations over the f32 peak, whichever is larger."""
    if form == "direct":
        g, b, m, v, lits = args
        n = g.shape[0]
        # codes, buckets and mask of every row; values of unmasked rows
        nbytes = sum(_bytes_of(x) for x in (g, b, m, lits))
        nbytes += int(_bytes_of(v) * float(m.float().mean()))
        n_out = kw["n_groups"] * kw["n_buckets"] * (1 + 3 * kw["n_agg_fields"])
        nbytes += 4 * n_out
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
        nbytes += 4 * kw["n_groups"] * kw["n_buckets"] * (1 + planes * kw["n_agg_fields"])
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
        per_query[name] = {
            "runs_ms": [x * 1e3 for x in secs],
            "to_pylist_ms": [r["to_pylist_seconds"] * 1e3 for r in runs],
            "cold_ms": secs[0] * 1e3, "warm_median_ms": warm * 1e3, "kernel_ms": kernel_ms,
        }
        say(f"timing {name}: execute runs {[round(x * 1e3, 3) for x in secs]} ms; "
            f"cold {secs[0] * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms; "
            f"to_pylist median {statistics.median(per_query[name]['to_pylist_ms']):.3f} ms; "
            f"kernel (device) {kernel_ms} ms [{card}]")
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
        say(f"kernel {KERNEL_NAMES[form]} at {qname} ({kw.get('segment_impl')}, "
            f"{work['rows']} rows, {work['bytes']} B): {ms:.4f} ms on the device timeline "
            f"({'profiler' if device_ms is not None else 'events'}), {launch_ms:.4f} ms "
            f"launch incl. wrapper, plain {plain_ms:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    DETAIL["per_query"] = per_query
    DETAIL["kernels"] = kernels
    return kernels


def main() -> int:
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
    card = phase_card(torch)
    phase_build()
    phase_kernels(torch)
    main_out = phase_main(torch)
    errs = phase_replay(torch, main_out)
    kernels = phase_timings(torch, main_out, errs, card)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(DETAIL, f, indent=1, default=str)
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
