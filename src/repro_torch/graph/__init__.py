"""Graph construction of the port (exact kNN and NN-descent, occlusion
pruning, symmetrization), the index files (``graph/io.py``) and streaming
index mutation (``graph/mutate.py``)."""
from repro_torch.graph.build import (GraphIndex, brute_force_knn,  # noqa: F401
                                     build_l2_graph, knn_recall, medoid,
                                     nn_descent,
                                     occlusion_prune_ref, symmetrize_ref)
from repro_torch.graph.io import (FORMAT_VERSION,  # noqa: F401
                                  load_corpus_store, load_index,
                                  load_index_meta, save_index)
from repro_torch.graph.mutate import (DurableIndex,  # noqa: F401
                                      MutationJournal, append_journal,
                                      apply_op, compact, delete_rows,
                                      insert_rows, load_journal,
                                      recover_index, save_journal)
from repro_torch.graph.prune import (occlusion_prune,  # noqa: F401
                                     occlusion_prune_nodes, symmetrize)
