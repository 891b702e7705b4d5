"""Find the rate an online cell's runtime sustains, once, on the card:

    python3 portbench/tools/sweep.py --workload twitch-deepfm.poisson \
        --seed 5 --fractions 0.5,0.7,0.8,0.9,1.0 --seconds 8

One set-up of the cell's configuration; then a backlog (every request
due at once: completions per second is the capacity) and, at each offered
share of that capacity, an open-loop window of the cell's traffic at
that rate: p50 / p95 / p99 and whether the backlog grew (the late
requests' queue time against the early ones'). Prints one JSON line per
rate."""
from __future__ import annotations

import argparse
import json
import time

import _common

_common.prepare()

import torch  # noqa: E402

from portbench import data as data_lib  # noqa: E402
from portbench import drivers, manifest  # noqa: E402
from portbench.stats import percentile  # noqa: E402
from portbench.system import System  # noqa: E402
from portbench.traffic import generator  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--fractions", default="0.5,0.7,0.8,0.9,1.0",
                    help="offered rates as shares of the backlog's "
                         "capacity")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--backlog", type=int, default=20000)
    args = ap.parse_args()
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, cell["config"])
    mix = generator.load(cell["traffic"])
    fractions = [float(r) for r in args.fractions.split(",")]
    n = max(args.backlog, 80000)
    inputs = data_lib.make_inputs(config, n, args.seed, "cuda")
    system = System(config, inputs.corpus, inputs.weights, "cuda",
                    _common.NoSetup())
    # the backlog: every request due at once
    from repro_torch.serving import ContinuousRuntime
    rt = ContinuousRuntime(system.engine, system.params, system.store,
                           system.neighbors,
                           query_dim=inputs.queries.shape[1],
                           entry=system.entry, device=system.device,
                           **mix["runtime"])
    q = inputs.queries.cpu().numpy()
    rt.warmup(q[0])
    t0 = time.perf_counter()
    for i in range(args.backlog):
        rt.submit(q[i], rid=i, t_arrive=t0)
    done = 0
    while rt.queue or rt.in_flight:
        done += len([c for c in rt.step_once() if c.status == "ok"])
    dt = time.perf_counter() - t0
    capacity = done / dt
    print(json.dumps({"backlog": args.backlog, "seconds": dt,
                      "capacity_qps": capacity}), flush=True)
    for rate in (f * capacity for f in fractions):
        if rate * (args.seconds + mix["trace_s"]) + 2 > n:
            break
        m = dict(mix, rate_qps=rate)
        out = drivers.run_online(system, inputs, m, args.seconds, False,
                                 args.seed, _common.NoSetup())
        lat = out["latency_ms"]
        half = len(lat) // 2
        qm = out["queue_ms"]
        print(json.dumps({
            "rate_qps": rate, "requests": len(lat),
            "missing": out["missing"],
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99),
            "queue_p95_first_half": percentile(qm[:half], 95),
            "queue_p95_last_tenth": percentile(qm[-len(qm) // 10:], 95),
            "occupancy": out["occupancy"],
            "round_ms": 1e3 * args.seconds / max(out["rounds"], 1)}),
            flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
