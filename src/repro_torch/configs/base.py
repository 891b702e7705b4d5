"""Arch/shape registry used by ``launch/train.py --arch`` (the JAX
package's ``configs/base.py``; plain data, copied so the port stands
alone)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval
    dims: Mapping[str, int]

    def __getitem__(self, key: str) -> int:
        return self.dims[key]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str               # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: Tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


_REGISTRY: Dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> ArchDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


# Shared shape sets -----------------------------------------------------------

LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", {"seq": 4096, "batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    # decode against a 512k cache is O(seq) per token — runs on full-attention
    # archs too (see DESIGN.md §5 shape notes)
    ShapeSpec("long_500k", "decode", {"seq": 524288, "batch": 1}),
)

RECSYS_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_classes": 7}),
    ShapeSpec("minibatch_lg", "train",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout0": 15, "fanout1": 10, "d_feat": 602, "n_classes": 41,
               # padded static shapes the jitted step sees:
               "max_nodes": 262144, "max_edges": 262144}),
    ShapeSpec("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_classes": 47}),
    ShapeSpec("molecule", "train",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
               "n_classes": 2}),
)
