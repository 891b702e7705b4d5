"""Graph construction of the port: exact kNN, occlusion pruning,
symmetrization."""
from repro_torch.graph.build import (GraphIndex, brute_force_knn,  # noqa: F401
                                     build_l2_graph, medoid)
from repro_torch.graph.prune import occlusion_prune, symmetrize  # noqa: F401
