"""The program's own tracing (its timed search programs and the serving
round's phase marks, ``repro_torch/obs/phases.py``) stays off in every run
of the benchmark, traced or not: the harness gives the program no tracer,
so ``step_us``, ``round_ms``, ``occupancy``, ``queue_p95_ms``,
``evals_per_query`` and ``search_mfu`` read the untimed code path, and
none of the program's phase or stage marks is taken."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, manifest  # noqa: E402
from portbench.tests.tiny_run import TINY  # noqa: E402

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_runs_take_no_program_marks(cell, trace, monkeypatch):
    torch = pytest.importorskip("torch")
    from repro_torch.core.engine import ExpansionEngine
    from repro_torch.obs.phases import Marks

    def refuse(self, name):
        raise AssertionError(f"a program mark ({name!r}) was taken")
    timed = []
    search_program = ExpansionEngine.search_program

    def recorded(self, *args, **kw):
        timed.append(bool(kw.get("timed", False)))
        return search_program(self, *args, **kw)
    monkeypatch.setattr(Marks, "enter", refuse)
    monkeypatch.setattr(ExpansionEngine, "search_program", recorded)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = harness.run_cell(cell, 2**33 + 11, 1.0, bool(trace), "cpu",
                                  time.time(), shrink=TINY)
    finally:
        torch.set_num_threads(n)
    assert result["correct"] is True
    assert not any(timed)
    run = result["_run"]
    if run["kind"] == "bulk":
        assert timed and run["steps"] > 0
    else:
        assert run["rounds"] > 0
