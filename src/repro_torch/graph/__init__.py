"""Graph construction of the port (exact kNN and NN-descent, occlusion
pruning, symmetrization) and the index files (``graph/io.py``)."""
from repro_torch.graph.build import (GraphIndex, brute_force_knn,  # noqa: F401
                                     build_l2_graph, knn_recall, medoid,
                                     nn_descent,
                                     occlusion_prune_ref, symmetrize_ref)
from repro_torch.graph.io import (FORMAT_VERSION,  # noqa: F401
                                  load_corpus_store, load_index,
                                  load_index_meta, save_index)
from repro_torch.graph.prune import occlusion_prune, symmetrize  # noqa: F401
