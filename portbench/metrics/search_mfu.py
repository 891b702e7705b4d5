"""The whole search's share of the card's float32 peak: the window's
counted evaluations and gradients times the measure's operations at its
widths (``roofline/stages.py``), over the window's seconds, over 67
TFLOP/s, in %."""
from portbench.roofline import stages


def read(run):
    if run["kind"] != "bulk" or run["window_s"] <= 0:
        return None
    flops = stages.search_flops(run["config"], run["n_eval"], run["n_grad"])
    return 100.0 * flops / run["window_s"] / stages.PEAKS["fp32_flops"]
