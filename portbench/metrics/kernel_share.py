"""The port's kernels' device time over the device's busy time in the
traced stretch, in % (``roofline/kernels.json``'s list and the kernels
the cell's measure family adds)."""
from portbench.roofline import stages
from portbench.trace import matching_seconds


def read(run):
    t = run.get("trace")
    if not t or t.get("busy_s", 0) <= 0:
        return None
    spent = matching_seconds(t["kernel_s"],
                             stages.port_kernels(run["config"]))
    return 100.0 * spent / t["busy_s"] if spent > 0 else None
