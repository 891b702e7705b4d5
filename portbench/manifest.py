"""``BENCHMARK.json`` and the files it names: the cells, their
configuration and traffic files, and each metric's reader
(``metrics/<name>.py``), all found by name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
MANIFEST = BENCH.parent / "BENCHMARK.json"



def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in manifest['workloads']]})")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((BENCH.parent / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell_name: str, group: str) -> list:
    """The metrics of ``group`` ('end_to_end' | 'per_layer') that the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in manifest[group]
            if cell_name in m.get("workloads", [cell_name])]


def reader_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def reader(name: str):
    """The ``read(run)`` function of a metric's reader file."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"metric {name!r}: no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metric(name: str, run: dict) -> Optional[float]:
    value = reader(name)(run)
    return None if value is None else float(value)
