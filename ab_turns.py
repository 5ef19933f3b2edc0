"""The turns of an in-turns timing script (merge_ab.py, topk_fold_ab.py):
the other checkout and this one in the order other, this, this, other,
each turn a process of its own, ``SCRIPT --arm DIR ...``, that imports the
checkout DIR's ``horaedb_tpu_torch`` (``enter``) and prints its result as
one ``ARM {json}`` line (``emit``). ``run_turns`` runs the four turns and
returns their results; ``write_report`` keeps them under chiprun_out/.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out")


def say(*parts) -> None:
    print(*parts, flush=True)


def enter(checkout: str) -> None:
    """Import the package of ``checkout`` from here on, and chip_smoke.py
    of this repo (a checkout unpacked from ``git archive`` may hold only
    the package)."""
    sys.path.insert(0, os.path.abspath(checkout))
    sys.path.insert(1, REPO)


def emit(res: dict) -> None:
    print("ARM " + json.dumps(res), flush=True)


def run_turns(script: str, other: str, args: list[str]) -> list[dict]:
    """Run ``script --arm DIR *args`` for DIR = other, this repo, this repo,
    other; echo each turn's output; return each turn's ARM result with its
    ``label``. Exits with the turn's code where a turn fails, and with 1
    where torch sees no card."""
    import torch

    if not torch.cuda.is_available():
        say("no CUDA card: torch.cuda.is_available() is False")
        raise SystemExit(1)
    other = os.path.abspath(other)
    turns = []
    for label, d in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        say(f"---- turn {label}: {d}")
        p = subprocess.run([sys.executable, os.path.abspath(script), "--arm", d, *args],
                           capture_output=True, text=True, cwd=REPO)
        for line in p.stdout.splitlines():
            if not line.startswith("ARM "):
                say(f"  {line}")
        if p.returncode != 0:
            say(p.stderr[-4000:])
            raise SystemExit(p.returncode)
        res = json.loads([x for x in p.stdout.splitlines() if x.startswith("ARM ")][-1][4:])
        res["label"] = label
        turns.append(res)
    return turns


def write_report(name: str, turns: list[dict]) -> str:
    """Write the turns to chiprun_out/``name``; returns the card's name and
    power limit as the first turn read them."""
    card = turns[0]["card"]
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, name), "w") as f:
        json.dump({"card": card, "turns": turns}, f, indent=1)
    return card


def events_ms(torch, fn, reps=5) -> float:
    """Median ms of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b))
    return statistics.median(runs)
