"""Each cell's whole run at a CPU size, through the kernels' plain
versions: a well-formed last line, and no JAX, jaxlib or JAX package
(``repro``) loaded. Each runs in its own process, so that nothing another
test imported is counted."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import guard, manifest  # noqa: E402

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def tiny(cell: str, trace: int):
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "tests" / "tiny_run.py"),
         cell, str(trace)], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_a_well_formed_line(cell, trace):
    result, loaded = tiny(cell, trace)
    assert loaded == []
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    group = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m["unit"]
             for m in manifest.metrics_of(MAN, cell, group)}
    assert set(result["metrics"]) <= set(names)
    for name, m in result["metrics"].items():
        assert m["unit"] == names[name]
        assert isinstance(m["value"], float)
    if not trace:
        # every end-to-end metric is host-clock and reads on the CPU too
        assert set(result["metrics"]) == set(names)
    else:
        assert "index_build_s" in result["metrics"]
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    for c in result["checks"].values():
        assert set(c) == {"value", "limit", "op"}


def test_reference_imports_nothing_of_the_program():
    fams = sorted(p.stem for p in (ROOT / "portbench" / "families")
                  .glob("*.py")
                  if p.stem != "__init__" and not p.stem.endswith("_port"))
    assert {"deepfm", "mlp"} <= set(fams)
    code = ("import sys, importlib; sys.path[:0] = [sys.argv[1]]; "
            "import portbench.reference.judge, portbench.reference.control,"
            " portbench.roofline.stages, json; "
            "[importlib.import_module('portbench.families.' + f) "
            "for f in sys.argv[2:]]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), *fams],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_guard_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1,
            "reproducible": 1, "jax.numpy": 1, "repro.core": 1, "flax": 1}
    assert guard.loaded(modules=mods) == ["flax", "jax.numpy", "repro.core"]


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
