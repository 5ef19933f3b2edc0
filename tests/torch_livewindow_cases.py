"""Live-window scenarios shared by the CPU tests and the card tests.

They import nothing of JAX, so ``tests/test_torch_cuda.py`` runs them on
the card as ``tests/test_torch_livewindow.py`` runs them on the CPU.
"""

from __future__ import annotations

import threading
import time

T0 = 1_786_000_000_000 // 60_000 * 60_000
HOSTS = 50


def _values(ts0: int, value: float) -> str:
    return ",".join(f"('h{h}', {value}, {ts0 + h})" for h in range(HOSTS))


def two_writers_in_one_group(device: str) -> None:
    """Two writers that ride one group commit are acknowledged only after
    their rows are folded: a refresh each writer makes right after its
    acknowledgement, served from state, counts both writers' rows.

    A third writer leads and holds its commit until both are queued
    behind it, so they commit as one group; the fold is slowed so that an
    acknowledgement sent before it would be seen."""
    import horaedb_tpu_torch
    from horaedb_tpu_torch.ops import livewindow as L
    from horaedb_tpu_torch.state import livewindow as S

    S.STORE.clear()
    db = horaedb_tpu_torch.connect(None, device=device)
    inst = db.instance
    try:
        db.execute("CREATE TABLE lw_group (host string TAG, value double NOT NULL, "
                   "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
                   "WITH (segment_duration='2h', update_mode='append')")
        db.execute(f"INSERT INTO lw_group (host, value, ts) VALUES {_values(T0 - 60_000, 1.0)}")
        panel = ("SELECT time_bucket(ts, '1m') AS b, host, count(value) AS c FROM lw_group "
                 f"WHERE ts >= {T0} GROUP BY time_bucket(ts, '1m'), host")
        for _ in range(S.promote_reads()):
            db.execute(panel)
        states = S.STORE.states_for_table("lw_group")
        assert len(states) == 1
        served0 = states[0].reads_served

        leading = threading.Event()
        groups: list[int] = []
        real_stall, real_commit, real_hook = (
            inst._stall_for_flush, inst._commit_write_group, S.on_write)

        def stall(table):
            if not leading.is_set():
                leading.set()
                deadline = time.monotonic() + 60
                while len(table.pending_writes) < 2 and time.monotonic() < deadline:
                    time.sleep(0.002)
            real_stall(table)

        def commit(table, batch):
            groups.append(len(batch))
            return real_commit(table, batch)

        def slow_hook(table, rows):
            time.sleep(0.2)
            real_hook(table, rows)

        counted: dict = {}
        errors: list = []

        def write(name: str, ts0: int, read: bool) -> None:
            try:
                db.execute(f"INSERT INTO lw_group (host, value, ts) VALUES {_values(ts0, 2.0)}")
                if read:
                    counted[name] = sum(r["c"] for r in db.execute(panel).to_pylist())
            except Exception as e:  # surfaced by the assertion below
                errors.append(f"{name}: {e!r}")

        inst._stall_for_flush, inst._commit_write_group, S.on_write = stall, commit, slow_hook
        L.reset_counts()
        try:
            leader = threading.Thread(target=write, args=("leader", T0, False))
            leader.start()
            assert leading.wait(60)
            followers = [threading.Thread(target=write, args=(n, T0 + k * 1_000, True))
                         for k, n in ((1, "a"), (2, "b"))]
            for t in followers:
                t.start()
            for t in [leader, *followers]:
                t.join(timeout=120)
        finally:
            del inst._stall_for_flush, inst._commit_write_group
            S.on_write = real_hook
        assert not errors, errors
        assert groups == [1, 2], groups
        assert counted == {"a": 3 * HOSTS, "b": 3 * HOSTS}, counted
        assert states[0].reads_served - served0 == 2
        assert L.FOLD_ERRORS == 0
    finally:
        S.STORE.clear()
        db.close()


def grouped_commit(seed: int, n_states: int = 6):
    """One commit's fold over ``n_states`` states of one table, as
    ``(depth, cap, warm, batch)`` per state: ``warm`` an earlier batch that
    leaves the ring non-empty, ``batch`` this commit's ``FoldBatch``. The
    states cover a head advance whose rows all land in the slot it resets,
    one reset slot among many cells with counter pairs, every slot reset
    with masked, wrapped and dropped indices, a long run on one cell, a
    state with no rows that resets, and +-0 and NaN values."""
    import numpy as np

    from horaedb_tpu_torch.ops.livewindow import FoldBatch

    rng = np.random.default_rng(seed)

    def batch(depth, cap, n, reset=(), slots=None, one_cell=False, pairs=0):
        mask = np.zeros(depth, dtype=np.bool_)
        mask[list(reset)] = True
        if one_cell:
            slot, grp = np.full(n, 3, np.int32), np.full(n, 5, np.int32)
        else:
            slot = (rng.integers(-depth - 1, depth + 2, n) if slots is None
                    else np.asarray(slots)[rng.integers(0, len(slots), n)]).astype(np.int32)
            grp = rng.integers(-cap, cap + 1, n).astype(np.int32)
        val = rng.normal(0, 10, n).astype(np.float32)
        if n >= 8:
            val[:4] = np.array([-0.0, 0.0, np.nan, 0.0], np.float32)
        ps = rng.integers(0, depth, pairs).astype(np.int32)
        pg = rng.integers(0, cap, pairs).astype(np.int32)
        pd = np.abs(rng.normal(0, 1, pairs)).astype(np.float32)
        return FoldBatch(mask, slot, grp, val, ps, pg, pd)

    shapes = [
        (8, 64, dict(n=4000, reset=(2,), slots=(2,))),
        (128, 4096, dict(n=4000, reset=(7,), pairs=500)),
        (16, 64, dict(n=1000, reset=range(16))),
        (8, 64, dict(n=24_000, one_cell=True)),
        (128, 64, dict(n=0, reset=(0,))),
        (32, 128, dict(n=3000, reset=(1, 9), slots=(1, 9, 10), pairs=40)),
    ]
    out = []
    for i in range(n_states):
        depth, cap, kw = shapes[i % len(shapes)]
        warm = batch(depth, cap, 2000, slots=range(depth), pairs=100)
        out.append((depth, cap, warm, batch(depth, cap, **kw)))
    return out
