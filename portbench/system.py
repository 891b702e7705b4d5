"""The system under test, set up for one configuration: the port's index
build, corpus store, measure and engine, fed the benchmark's inputs. This,
``drivers.py`` and each family's ``families/<family>_port.py`` are the
only files of the benchmark that import the program (``repro_torch``)."""
from __future__ import annotations

import torch

from portbench import families
from repro_torch.core import (EngineOptions, SearchConfig, build_engine,
                              make_corpus_store)
from repro_torch.graph import build_l2_graph


class System:
    """One configuration of the port on ``device``. ``setup`` (a
    ``harness.Setup``) records the seconds of each set-up step."""

    def __init__(self, config: dict, corpus: torch.Tensor, weights: dict,
                 device, setup):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        g = config["graph"]
        n = corpus.shape[0]
        base = corpus.cpu().numpy()
        setup.mark("data")
        stats = {}
        graph = build_l2_graph(
            base, m=g["m"], k_construction=g["k_construction"],
            exact_threshold=n if g["exact"] else 60_000,
            device=self.device, stats=stats)
        setup.add("knn", stats["knn_s"])
        setup.add("prune", stats["prune_s"])
        setup.add("symmetrize", stats["symmetrize_s"])
        setup.mark("graph_other")
        self.build_stats = {k: stats[k]
                            for k in ("knn_s", "prune_s", "symmetrize_s")}
        self.entry = graph.entry
        self.mean_degree = graph.avg_degree
        self.neighbors = torch.as_tensor(graph.neighbors, device=self.device)
        self.store = make_corpus_store(
            corpus, config["engine"]["corpus_dtype"], device=self.device)
        self.measure = families.port(config["measure"]).make_measure(
            config["measure"], weights, self.device)
        self.engine = build_engine(self.measure,
                                   SearchConfig(**config["search"]),
                                   EngineOptions(**config["engine"]))
        setup.mark("store")
        if self.device.type == "cuda":
            from repro_torch.kernels import _lib
            _lib.load()
            setup.add("kernel_build", _lib.BUILD_INFO.get("seconds", 0.0))
            setup.mark("kernel_library_load")

    @property
    def params(self):
        return self.measure.params

    def entries(self, n: int) -> torch.Tensor:
        return torch.full((n,), self.entry, dtype=torch.int64,
                          device=self.device)

    def search(self, queries: torch.Tensor, entries: torch.Tensor):
        """One one-shot batch: ``ExpansionEngine.search`` (captured programs
        on the card), which returns once every lane has converged."""
        return self.engine.search(self.params, self.store, self.neighbors,
                                  queries, entries)

    def plan(self, n_lanes: int) -> str:
        tile = self.engine.plan_for(n_lanes, self.neighbors.shape[1],
                                    self.config["dim"], self.device.type,
                                    False)
        return "tile" if tile else "rowwise"

    def release(self) -> None:
        """Free the program's state (its captured programs and buffers)
        before the reference runs."""
        self.engine.__dict__.get("_programs", {}).clear()
        self.store = self.neighbors = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
