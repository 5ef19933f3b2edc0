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
