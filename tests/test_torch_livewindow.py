"""The port's live window against the JAX package's.

- The ring fold and gather (``horaedb_tpu_torch.ops.livewindow``) against
  the reference's jitted ``_fold_body``/``_gather_body`` on the same
  arrays: counts, mins and maxs bit-equal (signed zeros, NaN, dropped and
  wrapped indices, clamped gathers, resets with rows in the reset slot,
  cap growth), sums and counter increments within SUM_RTOL of the cell's
  sum of |x|.
- A JAX state carried into the port (``convert.livestate_from_reference``)
  folds the next batch like the reference.
- The reference's live-window properties (``tests/test_livewindow.py``)
  through ``horaedb_tpu_torch.connect(None, device="cpu")``, every answer
  held to the JAX package on the same writes, and the alert route of
  ``tests/test_rules.py::TestAlertsThroughLivewindow``.
"""

from __future__ import annotations

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.ops import livewindow as ref_ops
from horaedb_tpu.proxy.promql import evaluate_range as ref_evaluate_range
from horaedb_tpu.proxy.promql import parse_promql as ref_parse_promql
from horaedb_tpu.state import livewindow as ref_lw
from horaedb_tpu_torch.common_types import RowGroup
from horaedb_tpu_torch.convert import LIVESTATE_FIELDS, livestate_from_reference
from horaedb_tpu_torch.ops import livewindow as ops
from horaedb_tpu_torch.proxy.promql import evaluate_range, parse_promql
from horaedb_tpu_torch.rules import RuleEngine
from horaedb_tpu_torch.state import livewindow as lw
from horaedb_tpu_torch.utils.config import RulesSection
from horaedb_tpu_torch.utils.querystats import STATS_STORE, finish_ledger, start_ledger

from torch_livewindow_cases import grouped_commit, two_writers_in_one_group
from torch_parity import assert_bit_equal, assert_sums_close, rows_match

MIN = 60_000
END = (1_786_000_000_000 // MIN) * MIN
NAN = np.float32("nan")


# ---- the kernels' plain versions against the reference's programs ---------


class Rings:
    """The same ring in both packages, plus the reference's ring of |x|
    (folded with |val| and |delta|) as the scale of the sum tolerance."""

    def __init__(self, depth: int, cap: int):
        self.ref = ref_ops.alloc_rings(depth, cap)
        self.abs = ref_ops.alloc_rings(depth, cap)
        self.port = ops.alloc_rings(depth, cap, "cpu")

    def fold(self, reset, slot, grp, val, ps=(), pg=(), pd=()):
        reset, arrs = self.fold_reference(reset, slot, grp, val, ps, pg, pd)
        port = self.port
        ops.fold_batches([port], [ops.FoldBatch(reset, *arrs)])
        assert self.port is port  # in place
        self.check()

    def fold_reference(self, reset, slot, grp, val, ps=(), pg=(), pd=()):
        """The reference's fold alone; returns the batch as the port takes it."""
        depth = self.port.shape[1]
        reset = np.asarray(reset, dtype=np.bool_).reshape(depth)
        arrs = (np.asarray(slot, np.int32), np.asarray(grp, np.int32),
                np.asarray(val, np.float32), np.asarray(ps, np.int32),
                np.asarray(pg, np.int32), np.asarray(pd, np.float32))
        # the reference's own padding (dropped rows), so its program
        # compiles once per power of two
        s, g, v = ref_ops._pad_rows(depth, *arrs[:3])
        a, b, d = ref_ops._pad_rows(depth, *arrs[3:])
        self.ref = ref_ops._fold_body(*self.ref, jnp.asarray(reset), s, g, v, a, b, d)
        self.abs = ref_ops._fold_body(*self.abs, jnp.asarray(reset), s, g,
                                      np.abs(v), a, b, np.abs(d))
        return reset, arrs

    def grow(self, cap: int):
        extra = cap - self.port.shape[2]

        def pad(rings):  # the reference's growth (state/livewindow._add_group)
            c, s, mn, mx, inc = rings
            p = lambda a, v: jnp.pad(a, ((0, 0), (0, extra)), constant_values=v)  # noqa: E731
            return (p(c, 0), p(s, 0.0), p(mn, jnp.inf), p(mx, -jnp.inf), p(inc, 0.0))

        self.ref, self.abs = pad(self.ref), pad(self.abs)
        self.port = ops.grow_rings(self.port, cap)
        self.check()

    def check(self):
        got = [p.numpy() for p in ops.planes(self.port)]
        want = [np.asarray(a) for a in self.ref]
        scale = [np.asarray(a) for a in self.abs]
        assert_bit_equal(got[0], want[0], "counts")
        assert_sums_close(got[1], want[1], scale[1], "sums")
        assert_bit_equal(got[2], want[2], "mins")
        assert_bit_equal(got[3], want[3], "maxs")
        assert_sums_close(got[4], want[4], scale[4], "inc")

    def gather(self, idx, g=None):
        g = self.port.shape[2] if g is None else g
        got = ops.gather_buckets(self.port, idx, g)
        jidx = jnp.asarray(np.asarray(idx, np.int32))
        want = [np.asarray(a)[:, :g] for a in ref_ops._gather_body(*self.ref, jidx)]
        scale = [np.asarray(a)[:, :g] for a in ref_ops._gather_body(*self.abs, jidx)]
        for k in (0, 2, 3):
            assert_bit_equal(got[k], want[k], f"gather plane {k}")
        for k in (1, 4):
            assert_sums_close(got[k], want[k], scale[k], f"gather plane {k}")


def _none(depth):
    return np.zeros(depth, dtype=np.bool_)


def test_signed_zeros_fold_like_the_reference():
    r = Rings(4, 8)
    # min of {-0.0, +0.0} is -0.0 and max +0.0, in either order and
    # against a cell that already holds a zero
    r.fold(_none(4), [0, 0, 1, 1, 2], [0, 0, 1, 1, 2], [-0.0, 0.0, 0.0, -0.0, 0.0])
    r.fold(_none(4), [2, 0, 1], [2, 0, 1], [-0.0, 0.0, -0.0])
    assert np.signbit(ops.planes(r.port)[2][2, 2].item())
    assert not np.signbit(ops.planes(r.port)[3][0, 0].item())


def test_nan_propagates_like_the_reference():
    """The state layer never folds a NaN (a batch carrying one drops the
    state); what the fold gives for one is pinned all the same."""
    r = Rings(4, 8)
    r.fold(_none(4), [0, 0, 1, 1], [0, 0, 1, 1], [NAN, 1.0, 2.0, NAN])
    r.fold(_none(4), [0, 2], [0, 2], [5.0, NAN])
    assert np.isnan(ops.planes(r.port)[2][0, 0].item())


def test_out_of_range_indices_drop_and_negative_ones_wrap():
    depth, cap = 4, 8
    r = Rings(depth, cap)
    slot = [depth, depth + 3, -1, -depth, -depth - 1, 0, 1, 2, 2**30, -(2**30)]
    grp = [0, 1, 2, 3, 4, cap, -1, -cap - 1, 5, 6]
    r.fold(_none(depth), slot, grp, np.arange(10, dtype=np.float32) + 1,
           ps=[depth, -1, 0, -depth - 1], pg=[0, -cap, cap, 0], pd=[1.0, 2.0, 3.0, 4.0])
    counts = ops.planes(r.port)[0]
    assert counts[depth - 1, 2].item() == 1  # slot -1 wrapped to depth - 1
    assert counts[0, 3].item() == 1  # slot -depth wrapped to 0
    assert counts[1, cap - 1].item() == 1  # group -1 wrapped to cap - 1
    assert counts.sum().item() == 3  # every other row dropped


@pytest.mark.parametrize("depth,cap", [(4, 8), (8, 64)])
def test_reset_with_rows_in_the_reset_slot(depth, cap):
    rng = np.random.default_rng(depth + cap)
    r = Rings(depth, cap)
    for step in range(6):
        n = int(rng.integers(1, 300))
        slot = rng.integers(0, depth + 1, n)
        grp = rng.integers(0, cap, n)
        val = rng.normal(0, 10, n)
        reset = rng.random(depth) < 0.4
        # rows into the slots this batch resets must survive the reset
        slot[: depth] = np.arange(depth)[: min(depth, n)] if n >= depth else slot[: depth]
        m = int(rng.integers(0, 40))
        r.fold(reset, slot, grp, val, rng.integers(-1, depth + 1, m),
               rng.integers(0, cap, m), rng.normal(0, 3, m))
    r.fold(np.ones(depth, dtype=np.bool_), [1], [2], [7.0])  # reset all


@pytest.mark.parametrize("seed", range(3))
def test_random_batches_and_one_hot_cell(seed):
    rng = np.random.default_rng(100 + seed)
    depth, cap = 8, 16
    r = Rings(depth, cap)
    for _ in range(4):
        n = int(rng.integers(0, 2000))
        r.fold(rng.random(depth) < 0.2, rng.integers(-depth - 1, depth + 2, n),
               rng.integers(-cap - 1, cap + 2, n),
               rng.choice(np.float32([-0.0, 0.0, 1.5, -2.25, 1e30, -1e30]), n))
    n = 5000  # every row on one cell
    r.fold(_none(depth), np.full(n, 3), np.full(n, 5), rng.normal(0, 1, n),
           np.full(n, 3), np.full(n, 5), rng.normal(0, 1, n))


def test_gather_clamps_like_the_reference():
    depth, cap = 4, 8
    rng = np.random.default_rng(7)
    r = Rings(depth, cap)
    r.fold(_none(depth), rng.integers(0, depth, 200), rng.integers(0, cap, 200),
           rng.normal(0, 1, 200))
    r.gather([0, 1, 2, 3])
    r.gather([depth, depth + 5, 9, -1, -depth, -depth - 1, -20, 0], g=3)
    r.gather([2], g=1)


def test_cap_growth_keeps_the_ring_and_initialises_new_columns():
    rng = np.random.default_rng(3)
    depth = 8
    r = Rings(depth, 4)
    r.fold(_none(depth), rng.integers(0, depth, 100), rng.integers(0, 4, 100),
           rng.normal(0, 1, 100))
    r.grow(8)
    r.fold(_none(depth), rng.integers(0, depth, 100), rng.integers(0, 8, 100),
           rng.normal(0, 1, 100))
    r.gather(list(range(depth)), g=6)


@pytest.mark.parametrize("n_states", [1, 6, 33])
def test_grouped_fold_equals_the_reference_fold_of_each_state(n_states):
    """One fold of a commit over several states (tests/torch_livewindow_cases.py:
    a reset slot that the same commit's rows land in, every slot reset,
    counter pairs, a long run on one cell, a state without rows; more
    states than one launch carries) equals the reference's ``_fold_body``
    over each state, and counts one fold and every state folded."""
    rings, batches = [], []
    for depth, cap, warm, batch in grouped_commit(seed=n_states, n_states=n_states):
        r = Rings(depth, cap)
        r.fold(*warm)
        r.fold_reference(*batch)
        rings.append(r)
        batches.append(batch)
    ops.reset_counts()
    ports = [r.port for r in rings]
    ops.fold_batches(ports, batches)
    assert ops.PLAIN_CALLS["fold"] == 1 and ops.STATES_FOLDED == n_states
    for r, port in zip(rings, ports):
        assert r.port is port  # in place
        r.check()


def test_pack_group_lays_out_one_barrier_a_launch_then_each_state():
    """``pack_group``: two zero barrier words a launch of MAX_GROUP states,
    then each state's ``pack_fold`` words at the offsets its spans give."""
    cases = grouped_commit(seed=3, n_states=ops.MAX_GROUP + 1)
    batches = [b for _, _, _, b in cases]
    words, spans = ops.pack_group(batches)
    assert list(words[:4]) == [0, 0, 0, 0] and spans[0][0] == 4
    for b, (at, r, n, m) in zip(batches, spans):
        want, r2, n2, m2 = ops.pack_fold(*b)
        assert (r, n, m) == (r2, n2, m2)
        assert np.array_equal(words[at:at + len(want)], want)
    assert len(words) == 4 + sum(ops.fold_words(*b) for b in batches)


class _OnCard:
    """Stands in for a CUDA tensor (this machine has no card): what the
    wrappers check before they launch."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.dtype, self.shape = t.dtype, t.shape
        self._dim = t.dim()

    def dim(self):
        return self._dim

    def is_contiguous(self):
        return True


def test_a_cuda_ring_launches_or_raises_and_never_runs_plain(monkeypatch, tmp_path):
    """A CUDA ring goes to the kernel: where the kernel cannot be built the
    wrappers raise, and the plain versions never run in its place."""
    from horaedb_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "missing" / "nvcc"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(ops, "_lib", None)
    rings = _OnCard(ops.alloc_rings(4, 8, "cpu"))
    words = _OnCard(torch.zeros(5, dtype=torch.int32))
    idx = _OnCard(torch.zeros(2, dtype=torch.int32))
    before = dict(ops.PLAIN_CALLS)
    with pytest.raises(OSError):
        ops.fold_group([rings], words, [(2, 0, 1, 0)])
    with pytest.raises(OSError):
        ops.gather(rings, idx, 8)
    assert ops.PLAIN_CALLS == before and not any(ops.LAUNCHES.values())


# ---- a JAX state carried into the port --------------------------------------


def _create(db, name):
    db.execute(
        f"CREATE TABLE {name} (host string TAG, value double NOT NULL, "
        "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
        "WITH (segment_duration='2h', update_mode='append')"
    )


def _insert(db, name, rows):
    vals = ",".join(f"('{h}', {v!r}, {t})" for h, v, t in rows)
    db.execute(f"INSERT INTO {name} (host, value, ts) VALUES {vals}")


def _panel(name, where=""):
    w = f"WHERE {where} " if where else ""
    return (
        "SELECT time_bucket(ts, '1m') AS b, host, sum(value) AS s, "
        f"count(value) AS c, min(value) AS mn, max(value) AS mx, avg(value) AS a "
        f"FROM {name} {w}GROUP BY time_bucket(ts, '1m'), host"
    )


@pytest.fixture(autouse=True)
def _fresh_stores():
    ref_lw.STORE.clear()
    lw.STORE.clear()
    yield
    ref_lw.STORE.clear()
    lw.STORE.clear()


def _state_fields(s) -> dict:
    out = {f: getattr(s, f) for f in LIVESTATE_FIELDS}
    out["rings"] = tuple(np.asarray(a) for a in s.rings)
    return out


def _assert_states_equal(port, ref):
    got = [p.numpy() for p in ops.planes(port.rings)]
    want = [np.asarray(a) for a in ref.rings]
    # every value and increment written is >= 0: a cell's sum is its sum of |x|
    assert_bit_equal(got[0], want[0], "counts")
    assert_sums_close(got[1], want[1], np.abs(want[1]), "sums")
    assert_bit_equal(got[2], want[2], "mins")
    assert_bit_equal(got[3], want[3], "maxs")
    assert_sums_close(got[4], want[4], np.abs(want[4]), "inc")
    for f in LIVESTATE_FIELDS:
        if f == "key":
            continue
        a, b = getattr(port, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f
        else:
            assert a == b, f


def test_carried_state_folds_the_next_batches_like_the_reference(monkeypatch):
    ref = horaedb_tpu.connect(None)
    port = horaedb_tpu_torch.connect(None, device="cpu")
    try:
        _create(ref, "lw_carry")
        rng = np.random.default_rng(11)
        seed = [(f"h{h}", float(rng.normal(100, 5)), END - k * 20_000)
                for k in range(30) for h in range(3)]
        _insert(ref, "lw_carry", seed)
        q = ("SELECT time_bucket(ts, '1m') AS b, host, sum(value) AS s, "
             "count(value) AS c FROM lw_carry GROUP BY time_bucket(ts, '1m'), host")
        for _ in range(3):
            ref.execute(q)
        (ref_state,) = [ref_lw.STORE.get(s["key"]) for s in ref_lw.STORE.stats()["states"]]
        assert ref_state.all_tags
        _insert(ref, "lw_carry", [("h0", 200.0, END + 5_000), ("h1", 300.0, END + 7_000)])
        state = livestate_from_reference(_state_fields(ref_state), "cpu")
        _assert_states_equal(state, ref_state)

        folded = []
        orig = ref_lw.on_write
        monkeypatch.setattr(ref_lw, "on_write",
                            lambda td, rows: (folded.append(rows), orig(td, rows)))
        _create(port, "lw_carry")
        port_schema = port.catalog.open("lw_carry").schema
        batches = [
            # in order, the same bucket (counter pairs) and the next ones
            [("h0", 205.0, END + 15_000), ("h0", 207.0, END + 25_000),
             ("h1", 301.0, END + 65_000), ("h2", 50.0, END + 130_000)],
            # 70 new series: the ring grows past 64 groups
            [(f"n{i}", float(i), END + 140_000 + i) for i in range(70)],
            # a counter reset, a late-but-in-ring row, an out-of-order pair
            [("h0", 1.0, END + 150_000), ("h1", 9.0, END - 3 * MIN),
             ("h2", 40.0, END + 100_000)],
            # a head advance past the whole ring: every slot resets
            [("h0", 3.0, END + 200 * MIN), ("h1", 4.0, END + 200 * MIN + 10)],
        ]
        for rows in batches:
            folded.clear()
            _insert(ref, "lw_carry", rows)
            (rg,) = folded
            batch = state.prepare(RowGroup(port_schema, dict(rg.columns), dict(rg.validity)))
            assert batch is not False
            if batch is not None:
                ops.fold_batches([state.rings], [batch])
            _assert_states_equal(state, ref_state)
        assert state.cap == ref_state.cap == 128
    finally:
        ref.close()
        port.close()


# ---- the reference's live-window properties, both packages side by side ----


class Both:
    """The same writes into both packages; every answer of the port held
    to the JAX package's on the same writes (and paths compared)."""

    def __init__(self):
        self.ref = horaedb_tpu.connect(None)
        self.port = horaedb_tpu_torch.connect(None, device="cpu")
        self.rows: dict = {}

    def close(self):
        self.ref.close()
        self.port.close()

    def create(self, name):
        for db in (self.ref, self.port):
            _create(db, name)
        self.rows[name] = []

    def insert(self, name, rows):
        for db in (self.ref, self.port):
            _insert(db, name, rows)
        self.rows[name] += rows

    def seed(self, name, minutes=200, step_s=20, n_hosts=3, seed=5):
        self.create(name)
        rng = np.random.default_rng(seed)
        start = END - minutes * MIN
        self.insert(name, [(f"h{h}", float(rng.normal(10, 3)), t)
                           for t in range(start, END, step_s * 1000)
                           for h in range(n_hosts)])

    def _abs_sums(self, name, where):
        out: dict = {}
        for h, v, t in self.rows[name]:
            if where == "host = 'h1'" and h != "h1" or where == "host != 'h2'" and h == "h2":
                continue
            k = ((t // MIN) * MIN, h)
            out[k] = out.get(k, 0.0) + abs(float(np.float32(v)))
        return out

    def query(self, name, where=""):
        """The panel in both packages: the port's rows (sorted), its path,
        after checking them against the reference's rows and path."""
        q = _panel(name, where)
        key = lambda r: (r["b"], r["host"])  # noqa: E731
        got = sorted(self.port.execute(q).to_pylist(), key=key)
        path = self.port.interpreters.executor.last_path
        want = sorted(self.ref.execute(q).to_pylist(), key=key)
        assert path == self.ref.interpreters.executor.last_path, q
        abs_sums = self._abs_sums(name, where)

        def scale(row, col):
            if col == "s":
                return abs_sums[(row["b"], row["host"])]
            if col == "a":
                return abs_sums[(row["b"], row["host"])] / row["c"]
            return None

        rows_match(want, got, scale)
        return got, path, scale

    def raw(self, name, where=""):
        """The port's kill-switch rescan of the panel."""
        os.environ["HORAEDB_LIVEWINDOW"] = "0"
        try:
            return sorted(self.port.execute(_panel(name, where)).to_pylist(),
                          key=lambda r: (r["b"], r["host"]))
        finally:
            os.environ.pop("HORAEDB_LIVEWINDOW", None)

    def promote(self, name):
        for _ in range(3):
            self.query(name)
        keys = [s["key"] for s in lw.STORE.stats()["states"]]
        assert keys and keys == [s["key"] for s in ref_lw.STORE.stats()["states"]]
        return keys[0]


@pytest.fixture()
def both():
    b = Both()
    yield b
    b.close()


def test_randomized_interleaved_ingest(both):
    """Randomized rounds of ingest (fresh, late-but-in-ring, older than
    the tail) interleaved with panel reads under random tag filters: every
    answer equals the JAX package's and the port's kill-switch rescan, and
    the state serves."""
    both.seed("lw_rand", minutes=140)
    key = both.promote("lw_rand")
    rng = np.random.default_rng(17)
    cursor = END
    served = 0
    for trial in range(12):
        batch = []
        for _ in range(int(rng.integers(5, 40))):
            cursor += int(rng.integers(1_000, 30_000))
            batch.append((f"h{int(rng.integers(0, 3))}", float(rng.normal(10, 3)), cursor))
        if rng.random() < 0.5:
            batch.append(("h1", float(rng.normal(10, 3)),
                          cursor - int(rng.integers(2, 100)) * MIN))
        if rng.random() < 0.3:
            batch.append(("h0", float(rng.normal(10, 3)), cursor - 160 * MIN))
        both.insert("lw_rand", batch)
        where = ["", "host = 'h1'", "host != 'h2'"][int(rng.integers(0, 3))]
        got, path, scale = both.query("lw_rand", where)
        rows_match(both.raw("lw_rand", where), got, scale)
        served += path == "livewindow"
    assert served >= 4, f"state served only {served}/12 reads"
    assert key in [s["key"] for s in lw.STORE.stats()["states"]]


def test_ring_rollover(both, monkeypatch):
    monkeypatch.setenv("HORAEDB_LIVEWINDOW_DEPTH", "8")
    both.seed("lw_roll", minutes=30)
    both.promote("lw_roll")
    cursor = END
    for _ in range(30):  # ~30 buckets >> depth 8
        cursor += MIN
        both.insert("lw_roll", [("h0", 1.5, cursor), ("h1", 2.5, cursor + 900)])
    got, path, scale = both.query("lw_roll")
    assert path == "livewindow"
    rows_match(both.raw("lw_roll"), got, scale)
    both.insert("lw_roll", [("h0", 99.0, cursor - 20 * MIN)])  # off the tail
    got, _, scale = both.query("lw_roll")
    rows_match(both.raw("lw_roll"), got, scale)


def test_eviction_mid_query(both):
    """A dropper thread evicts the port's states while the panel is read:
    a read may fall back to raw, never answer wrong; then the shape
    re-promotes and serves."""
    both.seed("lw_evict", minutes=60)
    both.promote("lw_evict")
    both.insert("lw_evict", [("h0", 3.0, END + MIN), ("h1", 4.0, END + 2 * MIN)])
    want = both.raw("lw_evict")
    abs_sums = both._abs_sums("lw_evict", "")
    scale = lambda r, c: (abs_sums[(r["b"], r["host"])] / (r["c"] if c == "a" else 1)  # noqa: E731
                          if c in ("s", "a") else None)
    stop = threading.Event()

    def dropper():
        while not stop.is_set():
            for s in lw.STORE.stats()["states"]:
                lw.STORE.drop(s["key"], outcome="evict")
            time.sleep(0.001)

    th = threading.Thread(target=dropper, daemon=True)
    th.start()
    try:
        for _ in range(15):
            got = sorted(both.port.execute(_panel("lw_evict")).to_pylist(),
                         key=lambda r: (r["b"], r["host"]))
            rows_match(want, got, scale)
    finally:
        stop.set()
        th.join(timeout=5)
    ref_lw.STORE.clear()
    key = both.promote("lw_evict")
    both.insert("lw_evict", [("h2", 5.0, END + 3 * MIN)])
    got, path, scale = both.query("lw_evict")
    assert path == "livewindow"
    rows_match(both.raw("lw_evict"), got, scale)
    assert key in [s["key"] for s in lw.STORE.stats()["states"]]


def test_kill_switch(both):
    both.seed("lw_kill", minutes=60)
    both.promote("lw_kill")
    both.insert("lw_kill", [("h0", 1.0, END + MIN)])
    _, path, _ = both.query("lw_kill")
    assert path == "livewindow"
    os.environ["HORAEDB_LIVEWINDOW"] = "0"
    try:
        assert not lw.livewindow_enabled()
        _, path, _ = both.query("lw_kill")
        assert path != "livewindow"
        q = _panel("lw_kill")
        plan = "\n".join(r["plan"] for r in both.port.execute(f"EXPLAIN {q}").to_pylist())
        assert "LiveWindow:" not in plan
        both.insert("lw_kill", [("h0", 2.0, END + 2 * MIN)])
        assert not lw.STORE.stats()["states"]
    finally:
        os.environ.pop("HORAEDB_LIVEWINDOW", None)


def test_promql_counter_fold(both):
    """rate()/increase() fold the write-time increments and the first/last
    sidecar across a counter reset: served from state, equal to the port's
    kill-switch fold and to the JAX package's answer."""
    both.create("lw_ctr")
    rows, t = [], END - 30 * MIN
    while t < END:
        for h, slope in (("h0", 2.0), ("h1", 5.0)):
            v = 100.0 + slope * ((t - (END - 30 * MIN)) // 10_000)
            if h == "h0" and t == END - 10 * MIN:
                v = 1.0  # counter reset
            rows.append((h, v, t))
        t += 10_000
    both.insert("lw_ctr", rows)
    for db in (both.ref, both.port):
        for _ in range(3):
            db.execute("SELECT time_bucket(ts, '1m') AS b, host, sum(value) AS s, "
                       "count(value) AS c FROM lw_ctr GROUP BY time_bucket(ts, '1m'), host")
    assert lw.STORE.stats()["states"]
    more, t = [], END
    while t < END + 10 * MIN:
        for h, slope in (("h0", 2.0), ("h1", 5.0)):
            more.append((h, 500.0 + slope * ((t - END) // 10_000), t))
        t += 10_000
    both.insert("lw_ctr", more)

    def matrix(evaluate, parse, db, expr):
        out = evaluate(db, parse(expr), END - 20 * MIN, END + 10 * MIN, 2 * MIN)
        return {tuple(sorted(s["metric"].items())): [(ts, float(v)) for ts, v in s["values"]]
                for s in out}

    def close(got, want, what):
        assert set(got) == set(want), what
        for k in want:
            assert len(got[k]) == len(want[k]), (what, k)
            for (t1, v1), (t2, v2) in zip(got[k], want[k]):
                assert t1 == t2 and abs(v1 - v2) <= 1e-4 * max(1.0, abs(v2)), (what, k, t1, v1, v2)

    for expr in ("increase(lw_ctr[2m])", "rate(lw_ctr[2m])", 'increase(lw_ctr{host="h0"}[2m])'):
        before = lw._M_READS_PROMQL.value
        got = matrix(evaluate_range, parse_promql, both.port, expr)
        assert lw._M_READS_PROMQL.value > before, f"{expr}: not served from state"
        close(got, matrix(ref_evaluate_range, ref_parse_promql, both.ref, expr), expr)
        os.environ["HORAEDB_LIVEWINDOW"] = "0"
        try:
            close(got, matrix(evaluate_range, parse_promql, both.port, expr), expr)
        finally:
            os.environ.pop("HORAEDB_LIVEWINDOW", None)


def test_explain_and_ledger_route(both):
    """The one eligibility predicate drives EXPLAIN's promise and the
    serve: ``LiveWindow:`` and route=livewindow in the plan text,
    route=livewindow and state_buckets in the query_stats ledger."""
    both.seed("lw_ledger", minutes=60)
    both.promote("lw_ledger")
    both.insert("lw_ledger", [("h0", 7.0, END + MIN), ("h1", 8.0, END + MIN + 500)])
    q = _panel("lw_ledger")
    plans = ["\n".join(r["plan"] for r in db.execute(f"EXPLAIN {q}").to_pylist())
             for db in (both.port, both.ref)]
    assert "LiveWindow:" in plans[0] and "route=livewindow" in plans[0]
    assert [p for p in plans[0].splitlines() if "LiveWindow:" in p] == \
        [p for p in plans[1].splitlines() if "LiveWindow:" in p]
    ledger, token = start_ledger(None, q)
    t0 = time.perf_counter()
    both.port.execute(q)
    finish_ledger(ledger, token, time.perf_counter() - t0)
    assert both.port.interpreters.executor.last_path == "livewindow"
    mine = [e for e in STATS_STORE.list() if "lw_ledger" in e.get("sql", "")]
    served = [e for e in mine if e.get("route") == "livewindow"]
    assert served and any(int(e.get("state_buckets") or 0) > 0 for e in served)
    rows = both.port.execute(
        "SELECT component, bytes FROM system.public.device WHERE component = 'state'"
    ).to_pylist()
    assert rows and rows[0]["bytes"] == ops.rings_nbytes(128, 64)


def test_alert_promotes_then_serves_from_state():
    """tests/test_rules.py::TestAlertsThroughLivewindow in the port: a
    bare-selector alert promotes its shape, and an over-threshold burst
    that is only in the memtable fires on the next round, served from the
    ring."""
    db = horaedb_tpu_torch.connect(None, device="cpu")
    try:
        db.execute(
            "CREATE TABLE lw_alert (host string TAG, value double NOT "
            "NULL, ts timestamp NOT NULL, TIMESTAMP KEY(ts)) "
            "ENGINE=Analytic WITH (segment_duration='2h', update_mode='append')"
        )
        now = int(time.time() * 1000)
        rows = ",".join(f"('h{h}', 10.0, {now - k * 20000})" for k in range(12) for h in range(2))
        db.execute(f"INSERT INTO lw_alert (host, value, ts) VALUES {rows}")
        eng = RuleEngine(db, RulesSection(alerts=["LwHot := lw_alert > 50"])).load()
        eval_at = now + 90_000
        for i in range(lw.promote_reads()):
            eng.run_once(now_ms=eval_at + i)
        assert [s["table"] for s in lw.STORE.stats()["states"]] == ["lw_alert"]
        assert eng.alerts_snapshot() == []
        burst_ts = (now // MIN + 1) * MIN + 1000
        db.execute("INSERT INTO lw_alert (host, value, ts) VALUES "
                   f"('h0', 100.0, {burst_ts}), ('h1', 100.0, {burst_ts})")
        eng.run_once(now_ms=eval_at + lw.promote_reads())
        assert db.interpreters.executor.last_path == "livewindow"
        served = [s["reads_served"] for s in lw.STORE.stats()["states"]]
        assert served and served[0] >= 1, served
        snap = eng.alerts_snapshot()
        assert sorted(a["labels"]["host"] for a in snap) == ["h0", "h1"]
        assert all(a["state"] == "firing" and float(a["value"]) == 100.0 for a in snap)
        alerts = db.execute("SELECT rule, state FROM system.public.alerts").to_pylist()
        assert sorted(a["state"] for a in alerts) == ["firing", "firing"]
    finally:
        db.close()


def test_a_failed_fold_drops_the_state_and_the_write_succeeds(both, monkeypatch):
    """A fold that raises (a kernel that cannot build or launch) never
    fails the write: the state is dropped, the error counted, and the next
    reads are raw and exact."""
    both.seed("lw_fail", minutes=30)
    both.promote("lw_fail")

    def broken(*a, **k):
        raise RuntimeError("livewindow fold launch failed")

    monkeypatch.setattr(ops, "fold_batches", broken)
    errors = ops.FOLD_ERRORS
    both.insert("lw_fail", [("h0", 1.0, END + MIN)])
    assert ops.FOLD_ERRORS == errors + 1
    assert not lw.STORE.stats()["states"]
    got = sorted(both.port.execute(_panel("lw_fail")).to_pylist(),
                 key=lambda r: (r["b"], r["host"]))
    assert both.port.interpreters.executor.last_path != "livewindow"
    rows_match(both.raw("lw_fail"), got, lambda r, c: None)


def test_a_failed_write_hook_drops_every_state_of_the_table(both, monkeypatch):
    """A failure in the write hook outside any one state's fold (here the
    lookup of the table's states) never fails the write either: every
    state of the table is dropped and counted, and the next reads are raw
    and exact."""
    both.seed("lw_hook", minutes=30)
    both.promote("lw_hook")

    def broken(*a, **k):
        raise RuntimeError("state lookup failed")

    errors = ops.FOLD_ERRORS
    with monkeypatch.context() as m:
        m.setattr(lw.STORE, "states_for_table", broken)
        both.insert("lw_hook", [("h0", 1.0, END + MIN)])
    assert ops.FOLD_ERRORS == errors + 1
    assert not lw.STORE.stats()["states"]
    got = sorted(both.port.execute(_panel("lw_hook")).to_pylist(),
                 key=lambda r: (r["b"], r["host"]))
    assert both.port.interpreters.executor.last_path != "livewindow"
    rows_match(both.raw("lw_hook"), got, lambda r, c: None)


# ---- one fold launch a commit for every state of the table -------------------

GROUP_PANELS = [
    "SELECT time_bucket(ts, '1m') AS b, host, sum(value) AS s, count(value) AS c, "
    "min(value) AS mn, max(value) AS mx FROM {t} GROUP BY time_bucket(ts, '1m'), host",
    "SELECT time_bucket(ts, '5m') AS b, host, sum(value) AS s, count(value) AS c "
    "FROM {t} GROUP BY time_bucket(ts, '5m'), host",
    "SELECT time_bucket(ts, '1m') AS b, sum(value) AS s, count(value) AS c "
    "FROM {t} GROUP BY time_bucket(ts, '1m')",
]


def _promote_group(dbs, name, panels=GROUP_PANELS):
    for q in panels:
        for _ in range(3):
            for db in dbs:
                db.execute(q.format(t=name))


def test_one_commit_folds_every_state_like_the_reference(both):
    """Three states of one table (two windows, grouped by host and not)
    fold each commit in one grouped fold, through a ring growth in the
    preparation (70 new hosts) and head advances: each state equals the
    reference's, which folds state by state with ``_fold_body``; one fold
    a commit carries all three."""
    both.seed("lw_grp", minutes=30)
    _promote_group([both.port, both.ref], "lw_grp")
    keys = sorted(s["key"] for s in lw.STORE.stats()["states"])
    assert len(keys) == 3 and keys == sorted(s["key"] for s in ref_lw.STORE.stats()["states"])
    rng = np.random.default_rng(4)
    batches = [
        [(f"h{h}", float(abs(rng.normal(10, 3))), END + 5_000 + h) for h in range(3)],
        [(f"n{i}", float(i), END + 70_000 + i) for i in range(70)],
        [("h0", 2.0, END + 6 * MIN), ("h1", 0.0, END + 6 * MIN + 1), ("h2", 5.0, END - 2 * MIN)],
        [("h0", 3.0, END + 300 * MIN), ("n5", 4.0, END + 300 * MIN + 10)],
    ]
    for rows in batches:
        ops.reset_counts()
        both.insert("lw_grp", rows)
        assert ops.PLAIN_CALLS["fold"] == 1 and ops.STATES_FOLDED == 3
        for k in keys:
            _assert_states_equal(lw.STORE.get(k), ref_lw.STORE.get(k))
    assert sorted(lw.STORE.get(k).cap for k in keys) == [64, 128, 128]


def _two_column_table():
    db = horaedb_tpu_torch.connect(None, device="cpu")
    db.execute("CREATE TABLE lw_two (host string TAG, value double NOT NULL, other double, "
               "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
               "WITH (segment_duration='2h', update_mode='append')")
    db.execute("INSERT INTO lw_two (host, value, other, ts) VALUES "
               + ",".join(f"('h{h}', 1.0, 2.0, {END - k * 20_000 + h})"
                          for k in range(30) for h in range(3)))
    panels = [f"SELECT time_bucket(ts, '1m') AS b, host, sum({c}) AS s FROM {{t}} "
              f"GROUP BY time_bucket(ts, '1m'), host" for c in ("value", "other")]
    _promote_group([db], "lw_two", panels)
    by_col = {s.value_col: s for s in lw.STORE.states_for_table("lw_two")}
    assert sorted(by_col) == ["other", "value"]
    return db, by_col


def test_a_state_that_cannot_fold_is_dropped_alone():
    """In one grouped fold, a state whose preparation refuses the batch (a
    NULL in its column) is dropped as unfoldable, and one whose
    preparation raises is dropped and counted in FOLD_ERRORS; the other
    state of the table folds the batch."""
    db, by_col = _two_column_table()
    try:
        ops.reset_counts()
        db.execute(f"INSERT INTO lw_two (host, value, ts) VALUES ('h0', 3.0, {END + MIN})")
        assert [s.value_col for s in lw.STORE.states_for_table("lw_two")] == ["value"]
        assert ops.FOLD_ERRORS == 0 and ops.STATES_FOLDED == 1
        assert by_col["value"].head == (END + MIN) // MIN
    finally:
        db.close()
    lw.STORE.clear()
    db, by_col = _two_column_table()
    try:
        def broken(rows):
            raise RuntimeError("preparation failed")

        by_col["other"].prepare = broken
        ops.reset_counts()
        db.execute(f"INSERT INTO lw_two (host, value, other, ts) VALUES ('h0', 3.0, 4.0, "
                   f"{END + MIN})")
        assert [s.value_col for s in lw.STORE.states_for_table("lw_two")] == ["value"]
        assert ops.FOLD_ERRORS == 1 and ops.STATES_FOLDED == 1
        assert by_col["value"].head == (END + MIN) // MIN
    finally:
        db.close()


def test_a_failed_group_launch_drops_every_state_of_the_group(both, monkeypatch):
    """A grouped fold launch that fails drops every state it carried, each
    counted in FOLD_ERRORS; the write succeeds and the next reads are raw
    and exact."""
    both.seed("lw_gfail", minutes=30)
    _promote_group([both.port, both.ref], "lw_gfail")
    assert len(lw.STORE.states_for_table("lw_gfail")) == 3

    def broken(*a, **k):
        raise RuntimeError("livewindow fold launch failed")

    monkeypatch.setattr(ops, "fold_batches", broken)
    errors = ops.FOLD_ERRORS
    both.insert("lw_gfail", [("h0", 1.0, END + MIN)])
    assert ops.FOLD_ERRORS == errors + 3
    assert not lw.STORE.states_for_table("lw_gfail")
    got = sorted(both.port.execute(_panel("lw_gfail")).to_pylist(),
                 key=lambda r: (r["b"], r["host"]))
    assert both.port.interpreters.executor.last_path != "livewindow"
    rows_match(both.raw("lw_gfail"), got, lambda r, c: None)


class _OrderedLock:
    """A state's lock that logs who takes it."""

    def __init__(self, key, log):
        self.key, self.log, self.lock = key, log, threading.RLock()

    def __enter__(self):
        self.lock.acquire()
        self.log.append(self.key)
        return self

    def __exit__(self, *exc):
        self.lock.release()


def test_the_fold_takes_the_state_locks_in_key_order(both):
    """The grouped fold holds every state's lock from its preparation to
    the launch, taken in key order, so two writers of one table cannot
    deadlock; two concurrent writers both fold."""
    both.seed("lw_lock", minutes=30)
    _promote_group([both.port], "lw_lock")
    log: list = []
    states = lw.STORE.states_for_table("lw_lock")
    for s in states:
        s.lock = _OrderedLock(s.key, log)
    _insert(both.port, "lw_lock", [("h0", 1.0, END + MIN)])
    assert log == sorted(s.key for s in states)
    ops.reset_counts()
    writers = [threading.Thread(target=_insert, args=(both.port, "lw_lock",
                                                      [("h1", 2.0, END + MIN + k)]))
               for k in range(2)]
    for t in writers:
        t.start()
    for t in writers:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in writers)
    assert ops.FOLD_ERRORS == 0 and ops.STATES_FOLDED == 6


def test_writers_of_one_group_commit_read_their_rows_from_state():
    """Two writers acknowledged from one group commit each read, right
    after the acknowledgement, a panel served from state that holds both
    writers' rows (tests/torch_livewindow_cases.py)."""
    two_writers_in_one_group("cpu")
