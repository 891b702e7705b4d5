"""One-card dry run of every (architecture x input shape) cell: the port's
counterpart of the JAX package's ``launch/dryrun.py``.

Each cell's step (``launch/steps.py``) is built on ``meta`` tensors and run
there once under the op counter (``launch/op_analysis.py``), in place of
JAX's lowering on fake devices and its HLO parse: a shape mismatch or an
op with no meaning shows up here as an error, and the report gives the
cell's argument, output and aliased (updated in place) bytes, its dot
FLOPs and bytes by op, its static cost model and whether its arguments fit
one card. With ``--device cuda`` each cell whose arguments fit is also
drawn on the card (``steps.materialize``) and run once there at its own
size: the step's seconds between CUDA events and its temporary bytes (the
peak of allocated memory less the arguments). Without a card
``--device cuda`` fails, as ``serve`` and ``train`` do.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape long_500k            # on the card
Outputs one JSON per cell under reports/dryrun_torch/h100/.

The ``guitar-serve`` cells cannot run on ``meta``: the search's loop ends
on data and its programs are captured CUDA graphs. Their reports give the
arguments and the static cost model, with ``op_analysis`` null.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.launch.steps import build_job, list_cells, materialize
from repro_torch.tree import tree_leaves

MESH_NAME = "h100"
# ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
# 80GB HBM3, for ``fits_one_card`` on a machine without the card
H100_TOTAL_MEMORY = 85_017_493_504
NO_OPS = ("the search's loop ends on data and its programs are captured "
          "CUDA graphs: it cannot run on meta")


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _search_result_bytes(job) -> int:
    """A SearchResult's bytes: ids int64 and scores float32 (Q, k), three
    int32 (Q,) counters."""
    Q, k = job.args[5].shape[0], 10
    return Q * k * (8 + 4) + 3 * Q * 4


def _layers_of(arch: str) -> int:
    return get_arch(arch).make_config().n_layers


def trace(job) -> tuple:
    """(OpReport, seconds) of one run of ``job``'s step on its meta args."""
    t0 = time.perf_counter()
    rep = analyze_ops(job.step_fn, *job.args)
    return rep, time.perf_counter() - t0


def trace_scaled(build, full_layers: int, n_layers: int):
    """An LM cell traced at ``n_layers`` and ``n_layers + 1`` layers
    (``build(n)`` builds its job at depth n, the published widths), its
    counts scaled to ``full_layers`` by the difference (every layer past
    the cut is the last one's kind: DeepSeek's MoE layers): (counts dict,
    output bytes at the cut depth, seconds, depth note)."""
    reps, sec = [], 0.0
    for n in (n_layers, n_layers + 1):
        rep, s = trace(build(n))
        reps.append(rep)
        sec += s
    a, b = (r.to_dict() for r in reps)
    scaled = dict(a)
    for key in ("flops", "bytes_accessed", "bytes_bf16eq"):
        scaled[key] = a[key] + (full_layers - n_layers) * (b[key] - a[key])
    note = {"traced_layers": [n_layers, n_layers + 1],
            "full_layers": full_layers, "flops_at_cut": a["flops"],
            "flops_per_layer": b["flops"] - a["flops"]}
    return scaled, tree_nbytes(reps[0].output), sec, note


def run_on_card(job, dev, seed: int = 0) -> dict:
    """Draw the cell's arguments on the card and run its step once: step
    seconds between CUDA events, temporary bytes (peak less arguments)."""
    args = materialize(job, dev, seed)
    arg_bytes = tree_nbytes(args)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = job.step_fn(*args)
    t1.record()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del out, args
    return {"step_sec": t0.elapsed_time(t1) / 1e3, "peak_bytes": int(peak),
            "temp_bytes": int(peak - arg_bytes)}


def run_cell(arch: str, shape: str, out_dir: str, device: str = "meta",
             variant: str = "base", save_hlo: bool = False,
             n_layers: Optional[int] = None,
             card_bytes: Optional[int] = None) -> dict:
    mesh_name = MESH_NAME if variant == "base" else f"{MESH_NAME}_{variant}"
    t0 = time.perf_counter()
    job = build_job(arch, shape, variant=variant)
    t_build = time.perf_counter() - t0
    arg_bytes = tree_nbytes(job.args)
    alias_bytes = sum(tree_nbytes(job.args[i]) for i in job.donate)
    ops, depth = None, None
    if arch == "guitar-serve":
        out_bytes, t_trace = _search_result_bytes(job), 0.0
    elif n_layers and get_arch(arch).family == "lm" \
            and n_layers < _layers_of(arch):
        op_dict, out_bytes, t_trace, depth = trace_scaled(
            lambda n: build_job(arch, shape, variant, n_layers=n),
            _layers_of(arch), n_layers)
    else:
        rep, t_trace = trace(job)
        op_dict, out_bytes, ops = rep.to_dict(), tree_nbytes(rep.output), rep
    card_bytes = card_bytes or H100_TOTAL_MEMORY
    report = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "n_devices": 1,
        "mesh_shape": {}, "device": device,
        "build_sec": round(t_build, 3), "trace_sec": round(t_trace, 3),
        "memory_analysis": {
            "argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
            "temp_bytes": None, "alias_bytes": int(alias_bytes)},
        "cost_analysis": None if arch == "guitar-serve" else {
            "flops_body_once": op_dict["flops"],
            "bytes_body_once": op_dict["bytes_accessed"]},
        "op_analysis": None if arch == "guitar-serve" else op_dict,
        "static_meta": job.static_meta,
        "fits_one_card": bool(arg_bytes <= card_bytes),
        "card_bytes": int(card_bytes),
    }
    if arch == "guitar-serve":
        report["op_analysis_note"] = NO_OPS
    if depth is not None:
        report["depth"] = depth
    if device == "cuda" and report["fits_one_card"]:
        dev = resolve_device("cuda")
        try:
            run = run_on_card(job, dev)
            report["memory_analysis"]["temp_bytes"] = run["temp_bytes"]
            report["card_run"] = run
        except torch.OutOfMemoryError as e:
            report["card_run"] = {"error": f"out of memory: {e}"[:300]}
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    if save_hlo and ops is not None:
        with open(path.replace(".json", ".ops.json"), "w") as f:
            json.dump({"flops_by_op": ops.flops_by_op,
                       "op_counts": ops.op_counts}, f, indent=1)
    flops = report["op_analysis"]["flops"] if report["op_analysis"] \
        else float("nan")
    run = report.get("card_run", {})
    print(f"[dryrun] {mesh_name} {arch}:{shape}  trace={t_trace:.1f}s "
          f"flops={flops:.3e} model_flops="
          f"{job.static_meta['model_flops']:.3e}  "
          f"args={arg_bytes / 2**30:.2f}GiB fits={report['fits_one_card']}"
          + (f"  card step={run['step_sec']:.3f}s temp="
             f"{run['temp_bytes'] / 2**30:.2f}GiB" if "step_sec" in run
             else f"  card: {run['error'][:60]}" if "error" in run else ""),
          flush=True)
    del job, ops
    gc.collect()
    return report


def cells_of(args) -> list:
    if args.all:
        return list_cells()
    if args.arch == "guitar-serve":
        return [("guitar-serve", args.shape or "guitar")]
    if not args.arch:
        raise SystemExit("--arch required unless --all")
    arch = get_arch(args.arch)
    shapes = [args.shape] if args.shape else [s.name for s in arch.shapes]
    return [(args.arch, s) for s in shapes]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write each cell's FLOPs and counts by op "
                         "(the counterpart of the HLO text) beside it")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--variant", default="base",
                    help="perf variant: microbatchN | w8 | bf16 | bf16model "
                         "| sl2g, or the sharding-only fsdp | shardnodes | "
                         "repltable (no change on one card)")
    ap.add_argument("--device", choices=["meta", "cuda"], default="cuda",
                    help="meta: trace only; cuda (the default): trace, then "
                         "run each cell whose arguments fit on the card")
    ap.add_argument("--layers", type=int, default=None,
                    help="trace the LM cells at this depth and the next "
                         "(published widths) and scale the counts to the "
                         "full depth")
    args = ap.parse_args(argv)
    card_bytes = None
    if args.device == "cuda":
        dev = resolve_device("cuda")
        card_bytes = torch.cuda.get_device_properties(dev).total_memory
    cells = cells_of(args)
    failures = []
    for a, s in cells:
        try:
            run_cell(a, s, args.out, device=args.device,
                     variant=args.variant, save_hlo=args.save_hlo,
                     n_layers=args.layers, card_bytes=card_bytes)
        except Exception as e:  # noqa: BLE001
            failures.append((a, s, repr(e)))
            print(f"[dryrun] FAIL {a}:{s}: {e}", flush=True)
            if not args.continue_on_error:
                traceback.print_exc()
                raise
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        raise SystemExit(1)
    print(f"[dryrun] all {len(cells)} cells traced OK")


if __name__ == "__main__":
    main()
