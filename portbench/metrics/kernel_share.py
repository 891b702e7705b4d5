"""The port's kernels' device time over the device's busy time in the
traced stretch, in %."""
import json
from pathlib import Path

from portbench.roofline import stages
from portbench.trace import matching_seconds

KERNELS = json.loads((Path(stages.__file__).resolve().parent
                      / "kernels.json").read_text())


def read(run):
    t = run.get("trace")
    if not t or t.get("busy_s", 0) <= 0:
        return None
    spent = matching_seconds(t["kernel_s"], KERNELS["port"])
    return 100.0 * spent / t["busy_s"] if spent > 0 else None
