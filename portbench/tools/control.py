"""The controls' readings at a configuration's own size, on the card:

    python3 portbench/tools/control.py --config twitch-deepfm \
        --seeds 1,2,3 [--sample 8192]

For each seed: the inputs as a run makes them (the corpus, the weights
and ``--sample`` queries), each control of the configuration
(``reference/control.py``) in the program's place, and the judge's
numbers; one JSON line per seed and control."""
from __future__ import annotations

import argparse
import json
import time

import _common

_common.prepare()

import torch  # noqa: E402

from portbench import data as data_lib  # noqa: E402
from portbench import manifest  # noqa: E402
from portbench.reference import control  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sample", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    config = manifest.config(manifest.load(), args.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = data_lib.make_inputs(config, args.sample, seed,
                                      args.device)
        for mode in control.controls_for(config):
            t0 = time.perf_counter()
            v = control.run_control(config, inputs.weights, inputs.corpus,
                                    inputs.queries, mode)
            print(json.dumps({"config": args.config, "seed": seed,
                              "control": mode, "correct": v["correct"],
                              "seconds": time.perf_counter() - t0,
                              "checks": v["checks"]}), flush=True)
    if args.device == "cuda":
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()
