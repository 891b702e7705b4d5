"""The grad, rank and measure stages' least time on H100 peaks (their
work counted from the traced batches' evaluations, gradients and
expansions, ``roofline/stages.py``) over the device time of the kernels
that did that work (matched by ``roofline/kernels.json``), in %."""
import json
from pathlib import Path

from portbench.roofline import stages
from portbench.trace import matching_seconds

KERNELS = json.loads((Path(stages.__file__).resolve().parent
                      / "kernels.json").read_text())


def read(run):
    t = run.get("trace")
    if run["kind"] != "bulk" or not t or "n_eval" not in t:
        return None
    patterns = [p for ps in KERNELS["stages"].values() for p in ps]
    spent = matching_seconds(t["kernel_s"], patterns)
    if spent <= 0:
        return None
    work = stages.stage_work(run["config"], t["n_eval"], t["n_grad"],
                             t["n_iters"], run["mean_degree"])
    return 100.0 * stages.least_seconds(work) / spent
