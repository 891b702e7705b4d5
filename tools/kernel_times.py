#!/usr/bin/env python3
"""Device times of the port's ten search-path kernels (DeepFM score and
grad, rank, MLP score and grad; each pre-gathered and index-fused at
float32, bfloat16 and int8), printed as one JSON line, with the launch
floor (an in-place add on a one-element tensor) under the same graph
replay; with ``--library`` also the library kernels (embedding_bag,
decode_attention, flash_attention at each shape of the smoke's library
phase, ~36 GB of device memory). The kernels are driven through this
checkout's ``chip_smoke`` phases (``check_kernels``,
``check_fused_kernels``, ``check_mlp_kernels``,
``check_library_kernels``), so each is held against its plain version
before it is timed, at the shapes those phases time it (µs per call; the
fused scores also at the adaptive M = 512, masked and not), and each
kernel's largest error against it (per net where the phase reports it).

Times the port of the checkout this file sits in. To compare two commits
on one card, unpack the other with ``git archive`` into a directory that
``.gitignore`` lists, copy this file into its ``tools/``, and run the two
in turns, each in its own process (parent, change, change, parent, ...).

    python3 tools/kernel_times.py [--library]
    python3 tools/kernel_times.py --compare DIR

``--compare`` needs no card: it reads the JSON lines of such turns from
DIR (files ``<n>.p.json`` for the parent, ``<n>.c.json`` for the change)
and prints, per kernel and residency, the parent's range and spread, the
change's range and the change of the median, marked ``OUT`` beyond ±3%,
or ``UNRESOLVED`` there if the parent's own spread is wider than 3%.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def compare(turns_dir: str) -> int:
    """Print the parent-and-change summary of the turns in turns_dir."""
    import glob
    import statistics

    def flat(r):
        out = {"floor": r["floor_us"]}
        for name, v in r["us"].items():
            if isinstance(v, dict):
                out.update({f"{name} {dt}": t for dt, t in v.items()})
            else:
                out[name] = v
        return out

    runs = {"p": [], "c": []}
    for f in sorted(glob.glob(os.path.join(turns_dir, "*.json"))):
        with open(f) as fh:
            runs[os.path.basename(f).split(".")[1]].append(
                flat(json.load(fh)))
    print(f"{len(runs['p'])} parent and {len(runs['c'])} change runs (us)")
    for k in runs["p"][0]:
        ps = [r[k] for r in runs["p"]]
        cs = [r[k] for r in runs["c"] if k in r]
        if not cs:
            continue
        pm, cm = statistics.median(ps), statistics.median(cs)
        spread = (max(ps) - min(ps)) / pm * 100
        d = (cm - pm) / pm * 100
        flag = "" if abs(d) <= 3 else ("UNRESOLVED" if spread > 3 else "OUT")
        print(f"{k:44s} parent {min(ps):10.3f}-{max(ps):10.3f} median "
              f"{pm:10.3f} (spread {spread:4.1f}%)  change {min(cs):10.3f}-"
              f"{max(cs):10.3f} median {cm:10.3f} ({d:+6.1f}%) {flag}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--library", action="store_true",
                    help="also time the library kernels")
    ap.add_argument("--compare", metavar="DIR", default=None,
                    help="summarise parent and change turns saved in DIR")
    opts = ap.parse_args()
    if opts.compare:
        return compare(opts.compare)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import make_family_measure
    from repro_torch.kernels import _lib

    dev = torch.device("cuda", 0)
    _lib.load()
    one = torch.zeros(1, device=dev)
    out = {"device": chip_smoke.nvidia_smi_line(), "root": ROOT,
           "floor_us": chip_smoke.time_ms(lambda: one.add_(1.0)) * 1e3,
           "us": {}, "err": {}}
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device=dev)
    reports = (chip_smoke.check_kernels(torch, dev, measure, measure.meta[1]),
               chip_smoke.check_fused_kernels(torch, dev, measure,
                                              measure.meta[1]),
               chip_smoke.check_mlp_kernels(torch, dev))
    for report in reports:
        for name, r in report.items():
            ms = r["ms"]
            out["us"][name] = ({dt: t * 1e3 for dt, t in ms.items()}
                               if isinstance(ms, dict) else ms * 1e3)
            out["err"][name] = r.get("err_by_net", r["err"])
            if "adaptive_int8" in r:    # the adaptive M = 512 masked call
                a = r["adaptive_int8"]
                out["us"][f"{name} adaptive_int8"] = {
                    "masked": a["ms"] * 1e3,
                    "unmasked": a["ms_unmasked"] * 1e3}
    if opts.library:
        for name, r in chip_smoke.check_library_kernels(torch, dev).items():
            for label, e in r["shapes"].items():
                out["us"][f"{name} {label}"] = e["ms"] * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
