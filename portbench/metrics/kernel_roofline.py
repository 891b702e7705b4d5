"""The grad, rank and measure stages' least time on H100 peaks (their
work counted from the traced batches' evaluations, gradients and
expansions, ``roofline/stages.py``) over the device time of the kernels
that did that work (matched by ``roofline/stages.stage_kernels``: the
family's grad and measure kernels, ``kernels.json``'s rank kernel), in %.
None where a stage with counted work matched no kernel: its work ran in
kernels the lists do not name, so the share would read too high."""
from portbench.roofline import stages
from portbench.trace import matching_seconds


def read(run):
    t = run.get("trace")
    if run["kind"] != "bulk" or not t or "n_eval" not in t:
        return None
    config = run["config"]
    work = stages.stage_work(config, t["n_eval"], t["n_grad"],
                             t["n_iters"], run["mean_degree"])
    kernels = stages.stage_kernels(config)
    if any(sum(work[s]) > 0 and matching_seconds(t["kernel_s"], ps) <= 0
           for s, ps in kernels.items()):
        return None
    spent = matching_seconds(t["kernel_s"],
                             [p for ps in kernels.values() for p in ps])
    if spent <= 0:
        return None
    return 100.0 * stages.least_seconds(work) / spent
