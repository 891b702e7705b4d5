"""Index-build launcher of the port: construct a GUITAR/SL2G index once,
persist it with ``repro_torch.graph.io`` (the JAX package's format), and
serve it with ``serve --index``. Construction and serving are separate
jobs at scale.

    # single-partition index over a saved (N, D) .npy corpus
    PYTHONPATH=src python -m repro_torch.launch.build_index \
        --base corpus.npy --m 24 --out runs/index [--device cpu]

    # corpus-sharded index (4 partitions) over a synthetic corpus
    PYTHONPATH=src python -m repro_torch.launch.build_index \
        --items 20000 --dim 32 --shards 4 --out runs/sharded-index

    # measure-aware (BEGIN) index under the measure serve.py builds for
    # that family and dim (seed 0)
    PYTHONPATH=src python -m repro_torch.launch.build_index \
        --items 10000 --dim 32 --graph begin --measure deepfm --out runs/bg

The JAX launcher's flags with its defaults, plus ``--device`` (the card
unless told otherwise). ``--residency paged`` verifies the saved files
after the build: a paged store over the memory-mapped payload gathers the
first 256 rows equal to the whole store's gather, bit for bit.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.begin import build_begin_graph
from repro_torch.core.measures import MEASURE_FAMILIES, make_family_measure
from repro_torch.core.sharded import build_sharded_index
from repro_torch.core.corpus import ResidencyPolicy
from repro_torch.graph import build_l2_graph, load_corpus_store, save_index


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="build and save a GUITAR index (PyTorch port)")
    ap.add_argument("--base", type=str, default=None,
                    help="path to an (N, D) .npy corpus; synthetic if unset")
    ap.add_argument("--items", type=int, default=10000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--m", type=int, default=24)
    ap.add_argument("--k-construction", type=int, default=64)
    ap.add_argument("--shards", type=int, default=0,
                    help="0 = single partition, else corpus-sharded build")
    ap.add_argument("--impl", choices=["blocked", "ref"], default="blocked")
    ap.add_argument("--graph", choices=["l2", "begin"], default="l2",
                    help="l2 = SL2G construction; begin = measure-aware "
                         "adjacency from offline measure evaluations "
                         "(core/begin.py)")
    ap.add_argument("--measure", choices=sorted(MEASURE_FAMILIES),
                    default="deepfm",
                    help="measure family for --graph begin (built from "
                         "seed 0, as serve.py builds it)")
    ap.add_argument("--train-queries", type=int, default=256,
                    help="--graph begin: sampled training queries (the "
                         "offline evaluation budget is T x N)")
    ap.add_argument("--corpus-dtype",
                    choices=["float32", "bfloat16", "int8"],
                    default="float32",
                    help="stored corpus residency (bf16 halves, int8 with "
                         "row scales quarters the payload)")
    ap.add_argument("--page-rows", type=int, default=4096,
                    help="rows per page of the saved (v3) payload layout, "
                         "recorded in meta")
    ap.add_argument("--residency", choices=["whole", "paged"],
                    default="whole",
                    help="post-build verification residency: 'paged' "
                         "checks a paged gather of the saved files against "
                         "the whole gather (single partition)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True,
                    help="output index directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the build; the default needs a "
                         "CUDA card")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Build, save, and return the path of the index's meta file."""
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[build_index] {e}")
    if args.base:
        base = np.load(args.base).astype(np.float32)
    else:
        rng = np.random.default_rng(args.seed)
        base = rng.normal(size=(args.items, args.dim)).astype(np.float32)

    t0 = time.perf_counter()
    if args.shards > 0:
        if args.graph == "begin":
            raise SystemExit("--graph begin is single-partition only "
                             "(partition-local entries would not survive "
                             "the measure-aware two-hop construction)")
        index = build_sharded_index(base, n_shards=args.shards, m=args.m,
                                    k_construction=args.k_construction,
                                    seed=args.seed, impl=args.impl,
                                    device=device)
        desc = (f"{args.shards} shards x {index.base.shape[1]} rows, "
                f"max degree {index.neighbors.shape[2]}")
    elif args.graph == "begin":
        measure = make_family_measure(args.measure,
                                      torch.Generator().manual_seed(0),
                                      base.shape[1], device=device)
        rng = np.random.default_rng(args.seed + 1)
        train_q = rng.normal(size=(args.train_queries,
                                   base.shape[1])).astype(np.float32)
        index = build_begin_graph(measure, base, train_q, m=args.m,
                                  seed=args.seed, device=device)
        desc = (f"{index.n} nodes (BEGIN/{args.measure}, "
                f"T={args.train_queries}), avg degree "
                f"{index.avg_degree:.1f}")
    else:
        index = build_l2_graph(base, m=args.m,
                               k_construction=args.k_construction,
                               seed=args.seed, impl=args.impl, device=device)
        desc = f"{index.n} nodes, avg degree {index.avg_degree:.1f}"
    dt = time.perf_counter() - t0
    # construction provenance: serve warns when a measure-aware (BEGIN)
    # index is served under another measure family
    extra = {"graph_kind": args.graph}
    if args.graph == "begin":
        extra["measure_family"] = args.measure
    meta_path = save_index(args.out, index, corpus_dtype=args.corpus_dtype,
                           extra_meta=extra, page_rows=args.page_rows)
    print(f"[build_index] {base.shape[0]} items dim={base.shape[1]}: {desc}, "
          f"built in {dt:.1f}s on {device} -> {args.out} "
          f"(corpus_dtype={args.corpus_dtype}, page_rows={args.page_rows})")
    if args.residency == "paged" and args.shards == 0:
        verify_paged(args.out, index.n, device)
    return meta_path


def verify_paged(path: str, n: int, device) -> None:
    """A paged store over the saved (memory-mapped) payload gathers the
    first 256 rows equal to the whole store's gather, bit for bit."""
    paged = load_corpus_store(path, residency=ResidencyPolicy("paged"),
                              device=device)
    whole = load_corpus_store(path, device=device)
    probe = torch.arange(min(256, n), device=device)
    if not torch.equal(paged.take(probe), whole.take(probe)):
        raise SystemExit("[build_index] paged-residency verification "
                         "FAILED: paged gather != whole gather")
    st = paged.stats_snapshot()
    print(f"[build_index] paged verification ok: page_rows="
          f"{paged.cache.page_rows}, faults={st.faults}, "
          f"resident_bytes={st.resident_bytes}")


if __name__ == "__main__":
    main()
