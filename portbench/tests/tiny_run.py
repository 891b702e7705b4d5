"""A cell's whole run at a CPU size, through the kernels' plain versions
(no card is looked for): prints the result's JSON line, then the modules
of JAX or the JAX package the process loaded.

    python portbench/tests/tiny_run.py <cell> <trace 0|1>"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import guard, harness  # noqa: E402

TINY = {"n_items": 3000, "pool": 512, "batch": 64, "sample": 96,
        "trace_batches": 1, "rate_qps": 40.0, "n_lanes": 16, "trace_s": 0.5}


def tiny_run(cell: str, trace: bool, seed: int = 2**33 + 7,
             seconds: float = 1.5) -> dict:
    result = harness.run_cell(cell, seed, seconds, trace, "cpu",
                              time.time(), shrink=TINY)
    result.pop("_run")
    return result


if __name__ == "__main__":
    out = tiny_run(sys.argv[1], sys.argv[2] == "1")
    print(json.dumps(out))
    print(json.dumps(guard.loaded()))
