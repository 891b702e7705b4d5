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

``--mesh single|multi|both`` builds JAX's production meshes instead, (16,
16) ("data", "model") and (2, 16, 16) ("pod", "data", "model"), over a
fake process group of 256 and 512 ranks in this one process (``--mesh
DxM``: the test mesh (D, M) over D x M ranks, e.g. ``2x4``)
(``torch.testing._internal.distributed.fake_pg``, torch's own simulator of
a large group: internal to torch, so it is imported here, by the dry run,
and nowhere in the package). Each cell's job gets JAX's shardings
(``steps.build_job(..., mesh=)``), and its report (under
``reports/dryrun_torch/<mesh>/``, the mesh named as JAX names it:
``single``, ``multi``, ``single_fsdp``, ...) gives per-device figures: every
argument leaf's shard shape (DTensor's local shape on rank 0, the
ceiling of an uneven split, as JAX pads it), ``argument_bytes`` and
``alias_bytes`` from those shapes, ``output_bytes`` where the step names
its out shardings (null with a note where JAX leaves them to the
compiler), ``n_devices`` and ``mesh_shape``. Nothing is traced under the
mesh: per-device op counts and collective bytes need the steps run on
DTensors under a traced step, and are not given (``op_analysis`` null).
The one-card ``h100`` report is the default and unchanged.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.launch.steps import build_job, list_cells, materialize
from repro_torch.sharding import NamedSharding, P
from repro_torch.tree import flatten_with_paths, tree_leaves

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


MESHES = {"single": False, "multi": True}
WORLD = {"single": 256, "multi": 512}
NO_MESH_OPS = ("nothing is traced under the mesh: per-device op counts "
               "and collective bytes need the step run on DTensors under a "
               "traced step")
NO_OUT = ("the step names no out shardings for {what}: JAX leaves them to "
          "the compiler")


def parse_test_mesh(kind: str):
    """(n_data, n_model) of a test-mesh name "DxM", else None."""
    parts = kind.split("x")
    if len(parts) == 2 and all(p.isdigit() for p in parts):
        return int(parts[0]), int(parts[1])
    return None


@contextlib.contextmanager
def fake_mesh(kind: str):
    """The production mesh ``kind`` ("single" or "multi"), or the test mesh
    "DxM" (``make_test_mesh(D, M)``), over a fake process group of its
    ranks, in this process (rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    dm = parse_test_mesh(kind)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(dm) if dm else WORLD[kind])
    try:
        yield (make_test_mesh(*dm, device="cpu") if dm else
               make_production_mesh(multi_pod=MESHES[kind], device="cpu"))
    finally:
        dist.destroy_process_group()


def shard_leaves(tree, specs, mesh, prefix: str) -> list:
    """[(path, shape, shard shape, dtype, shard bytes)] of ``tree``'s
    leaves under the spec tree ``specs``."""
    leaves = flatten_with_paths(tree, prefix)
    sp = [s for _, s in flatten_with_paths(
        specs, is_leaf=lambda x: isinstance(x, P))]
    if len(sp) != len(leaves):
        raise ValueError(f"{prefix}: {len(leaves)} leaves, {len(sp)} specs")
    out = []
    for (path, t), spec in zip(leaves, sp):
        shard = NamedSharding(mesh, spec).shard_shape(t.shape)
        out.append((path, list(t.shape), list(shard),
                    str(t.dtype).replace("torch.", ""),
                    math.prod(shard) * t.element_size()))
    return out


def run_mesh_cell(arch: str, shape: str, mesh, kind: str, out_dir: str,
                  variant: str = "base") -> dict:
    """One cell's per-device report under ``mesh`` (see the module
    docstring)."""
    mesh_name = kind if variant == "base" else f"{kind}_{variant}"
    t0 = time.perf_counter()
    job = build_job(arch, shape, variant=variant, mesh=mesh)
    t_build = time.perf_counter() - t0
    args = [shard_leaves(a, s, mesh, str(i))
            for i, (a, s) in enumerate(zip(job.args, job.in_specs))]
    arg_bytes = sum(r[-1] for a in args for r in a)
    alias = sum(r[-1] for i in job.donate for r in args[i])
    single = job.out_specs is None or isinstance(job.out_specs, P)
    outs = (job.out_specs,) if single else job.out_specs
    named = job.out_specs is not None and all(o is not None for o in outs)
    out_bytes, note = None, None
    if named:
        like = (job.out_like,) if single else job.out_like
        out_bytes = sum(r[-1] for i, (o, s) in enumerate(zip(like, outs))
                        for r in shard_leaves(o, s, mesh, str(i)))
    else:
        what = "its outputs" if job.out_specs is None else \
            "output " + ", ".join(str(i) for i, o in enumerate(outs)
                                  if o is None)
        note = NO_OUT.format(what=what)
    names = list(mesh.mesh_dim_names)
    report = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "n_devices": int(mesh.size()),
        "mesh_shape": {a: int(n) for a, n in zip(names, mesh.mesh.shape)},
        "device": "meta", "build_sec": round(t_build, 3),
        "memory_analysis": {
            "argument_bytes": int(arg_bytes), "output_bytes": out_bytes,
            "temp_bytes": None, "alias_bytes": int(alias)},
        "cost_analysis": None, "op_analysis": None,
        "op_analysis_note": NO_MESH_OPS,
        "static_meta": job.static_meta,
        "fits_one_card": bool(arg_bytes <= H100_TOTAL_MEMORY),
        "card_bytes": H100_TOTAL_MEMORY,
        "shard_shapes": [list(r[:4]) for a in args for r in a],
    }
    if note:
        report["output_bytes_note"] = note
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    with open(os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(f"[dryrun] {mesh_name} {arch}:{shape}  args/dev="
          f"{arg_bytes / 2**30:.3f}GiB alias/dev={alias / 2**30:.3f}GiB "
          f"fits={report['fits_one_card']}", flush=True)
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
    ap.add_argument("--mesh", default=None,
                    help="single | multi | both: the production mesh(es) "
                         "on a fake process group (per-device shard "
                         "figures, nothing traced) in place of the one-card "
                         "h100 report; DxM (e.g. 2x4): make_test_mesh(D, M) "
                         "the same way")
    ap.add_argument("--device", choices=["meta", "cuda"], default="cuda",
                    help="meta: trace only; cuda (the default): trace, then "
                         "run each cell whose arguments fit on the card")
    ap.add_argument("--layers", type=int, default=None,
                    help="trace the LM cells at this depth and the next "
                         "(published widths) and scale the counts to the "
                         "full depth")
    args = ap.parse_args(argv)
    if args.mesh:
        return main_mesh(args)
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


def main_mesh(args) -> None:
    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for kind in kinds:
        if kind not in MESHES and parse_test_mesh(kind) is None:
            raise SystemExit(f"--mesh {kind}: not single, multi, both or "
                             f"DxM")
    cells = cells_of(args)
    failures = []
    for kind in kinds:
        with fake_mesh(kind) as mesh:
            for a, s in cells:
                try:
                    run_mesh_cell(a, s, mesh, kind, args.out, args.variant)
                except Exception as e:  # noqa: BLE001
                    failures.append((a, s, kind, repr(e)))
                    print(f"[dryrun] FAIL {a}:{s} {kind}: {e}", flush=True)
                    if not args.continue_on_error:
                        traceback.print_exc()
                        raise
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        raise SystemExit(1)
    print(f"[dryrun] all {len(cells) * len(kinds)} cells sharded OK")


if __name__ == "__main__":
    main()
