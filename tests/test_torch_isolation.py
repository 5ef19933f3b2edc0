"""The port stands alone: no JAX, nothing of the JAX package, an explicit
device, and no quiet fallback to the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

import horaedb_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "horaedb_tpu_torch")


def _port_sources() -> list[str]:
    out = [os.path.join(REPO, f)
           for f in ("ab_turns.py", "chip_smoke.py", "flood_timeline.py", "merge_ab.py",
                     "scan_agg_ab.py", "topk_fold_ab.py")]
    for root, _, files in os.walk(PORT_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_source_imports_neither_jax_nor_the_reference(path):
    roots = _imported_roots(path)
    assert "jax" not in roots and "jaxlib" not in roots, path
    assert "horaedb_tpu" not in roots, path


_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of JAX now fails
import horaedb_tpu_torch
db = horaedb_tpu_torch.connect(None, device="cpu")
db.execute("CREATE TABLE t (h string TAG, v double, ts timestamp NOT NULL, "
           "TIMESTAMP KEY(ts)) ENGINE=Analytic")
db.execute("INSERT INTO t (h, v, ts) VALUES ('a', 1.5, 1), ('b', 2.5, 2), ('a', 3.5, 3)")
for _ in range(3):
    rows = db.execute("SELECT h, sum(v) AS s FROM t GROUP BY h ORDER BY h").to_pylist()
assert rows == [{"h": "a", "s": 5.0}, {"h": "b", "s": 2.5}], rows
assert db.interpreters.executor.last_path == "device-cached"
leaked = sorted(m for m in sys.modules if m == "horaedb_tpu" or m.startswith("horaedb_tpu."))
assert not leaked, leaked
print("OK")
"""


def test_answers_sql_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        horaedb_tpu_torch.connect(None, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        horaedb_tpu_torch.connect(None)  # the default device is the card


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        horaedb_tpu_torch.connect(None, device="meta")


def test_cpu_connection_places_the_cache_on_cpu():
    db = horaedb_tpu_torch.connect(None, device="cpu")
    assert db.device == torch.device("cpu")
    assert db.interpreters.executor.device == db.device
    assert db.interpreters.executor.scan_cache.device == db.device


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py fails, and prints no result, where torch sees no card
    (here), and also in a directory holding nothing else of the repo."""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run(
        [sys.executable, str(alone)], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
