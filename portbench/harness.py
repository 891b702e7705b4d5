"""One run of one cell: inputs from the seed, the system set up, the window
driven, the answers judged against the plain reference, and the cell's
metrics read by their readers. ``run.py`` is the command around it."""
from __future__ import annotations

import copy
import sys
import time
from collections import defaultdict
from typing import Optional

import torch

from portbench import data as data_lib
from portbench import manifest as manifest_lib
from portbench.reference import judge as judge_lib
from portbench.traffic import generator


class Setup:
    """Set-up time: from ``t_start`` (the process's start, wall clock) to
    the first timed query, with the seconds of each step."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.parts = defaultdict(float)
        self.parts["process_start_and_imports"] = time.time() - t_start
        self._last = time.perf_counter()
        self._inner = 0.0
        self.total: Optional[float] = None

    def add(self, name: str, seconds: float) -> None:
        """A step timed inside the next ``mark``'s span."""
        self.parts[name] += seconds
        self._inner += seconds

    def mark(self, name: str) -> None:
        """The time since the last mark, less the steps ``add``ed in it."""
        now = time.perf_counter()
        self.parts[name] += now - self._last - self._inner
        self._last, self._inner = now, 0.0

    def finish(self) -> float:
        self.total = time.time() - self.t_start
        self.parts["other"] = self.total - sum(
            v for k, v in self.parts.items() if k != "other")
        return self.total


def shrunk(config: dict, mix: dict, shrink: Optional[dict]):
    """A CPU-sized copy of a cell (the tests' tiny runs): ``shrink`` sets
    ``n_items`` and any of the mix's keys."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    for key, value in (shrink or {}).items():
        if key == "n_items":
            config["n_items"] = value
        elif key in mix.get("runtime", {}):
            mix["runtime"][key] = value
        else:
            mix[key] = value
    return config, mix


def query_count(mix: dict, seconds: float) -> int:
    """Queries a run draws: the pool, or every request of the window and
    of the traced stretch after it (the same count traced or not, so that
    both draw the same queries)."""
    if mix["kind"] == "bulk":
        return mix["pool"]
    rate = float(mix["rate_qps"])
    return (max(1, int(round(rate * seconds)))
            + max(1, int(round(rate * mix["trace_s"]))))


def window_queries(mix: dict, seconds: float) -> Optional[int]:
    """Of the queries a run draws, those the window serves first: an
    online window's requests (None for a bulk pool, all of it)."""
    if mix["kind"] == "bulk":
        return None
    return max(1, int(round(float(mix["rate_qps"]) * seconds)))


def device_info(device, n_chips: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": n_chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, shrink: Optional[dict] = None,
             manifest: Optional[dict] = None, log=sys.stderr) -> dict:
    """One run; returns the result object (the last line's JSON) and, under
    ``'_run'``, what the readers saw."""
    setup = Setup(t_start)
    from portbench import drivers
    from portbench.system import System
    setup.mark("import_program")

    manifest = manifest or manifest_lib.load()
    cell = manifest_lib.cell(manifest, cell_name)
    config, mix = shrunk(manifest_lib.config(manifest, cell["config"]),
                         generator.load(cell["traffic"]), shrink)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    inputs = data_lib.make_inputs(config, query_count(mix, seconds), seed,
                                  dev, head=window_queries(mix, seconds))
    system = System(config, inputs.corpus, inputs.weights, dev, setup)
    run = drivers.DRIVERS[mix["kind"]](system, inputs, mix, seconds, trace,
                                       seed, setup)
    device_block = device_info(dev, cell["chips"])
    lanes = mix.get("runtime", {}).get("n_lanes", mix.get("batch"))
    print("[portbench] setup_s %.3f: %s; plan %s" % (
        setup.total, ", ".join(f"{k} {v:.3f}" for k, v in
                               sorted(setup.parts.items())),
        system.plan(lanes)), file=log)
    run.update(config=config, mix=mix, seed=seed,
               build=system.build_stats, mean_degree=system.mean_degree)
    system.release()

    judged = run.pop("judged")
    verdict = judge_lib.judge(config, inputs.weights, inputs.corpus,
                              judged["queries"], judged["ids"],
                              judged["scores"], missing=run["missing"])
    run["recall"] = verdict["recall"]

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest_lib.metrics_of(manifest, cell_name, group):
        value = manifest_lib.read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(verdict["correct"]),
              "attempted": int(run["attempted"]),
              "failed": int(run["failed"]),
              "metrics": metrics, "device": device_block}
    if trace and run["trace"]:
        t = run["trace"]
        device_block.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit, "op": op}
                        for name, value, limit, op in verdict["checks"]}
    result["_run"] = run
    return result
