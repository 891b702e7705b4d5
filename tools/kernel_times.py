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
before it is timed, at the shapes those phases time it (µs per call).

Times the port of the checkout this file sits in. To compare two commits
on one card, unpack the other with ``git archive`` into a directory that
``.gitignore`` lists, copy this file into its ``tools/``, and run the two
in turns, each in its own process (parent, change, change, parent, ...).

    python3 tools/kernel_times.py [--library]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--library", action="store_true",
                    help="also time the library kernels")
    opts = ap.parse_args()
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
           "us": {}}
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
    if opts.library:
        for name, r in chip_smoke.check_library_kernels(torch, dev).items():
            for label, e in r["shapes"].items():
                out["us"][f"{name} {label}"] = e["ms"] * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
