"""Search core of the port: measures, corpus residency (whole and paged),
the bundle registry, the expansion engine (and the captured programs it
runs as, ``core/program.py``), the search API, corpus-sharded search, the
BEGIN graph, the paper-faithful numpy searcher, and (re-exported from
``graph``) streaming index mutation."""
from repro_torch.core.bundles import (MeasureKernelBundle, get_bundle,  # noqa: F401
                                      list_families, register_bundle,
                                      resolve_stages)
from repro_torch.core.corpus import (CORPUS_DTYPES,  # noqa: F401
                                     WHOLE, CorpusStore,
                                     CorpusUnavailableError, PageCacheStats,
                                     PagedCorpusStore, ResidencyPolicy,
                                     as_corpus_store, make_corpus_store,
                                     make_paged_store, pack_bitmap,
                                     store_from_arrays, unpack_bitmap)
from repro_torch.core.engine import (EngineOptions, EngineState,  # noqa: F401
                                     ExpansionEngine, SearchConfig,
                                     SearchResult, build_engine,
                                     build_engine_from_fn, engine_search)
from repro_torch.core.measures import (MEASURE_FAMILIES, Measure,  # noqa: F401
                                       deepfm_measure, deepfm_numpy_fns,
                                       inner_product_measure,
                                       l2_measure, make_family_measure,
                                       mlp_measure, params_from_jax)
from repro_torch.core.program import StateProgram  # noqa: F401
from repro_torch.core.search import (brute_force_topk,  # noqa: F401
                                     rank_and_prune, recall, search,
                                     search_legacy, search_measure)
from repro_torch.core.begin import begin_adjacency, build_begin_graph  # noqa: F401
from repro_torch.core.faithful import (FaithfulStats,  # noqa: F401
                                       faithful_search,
                                       faithful_search_batch)
from repro_torch.core.sharded import (ShardedIndex,  # noqa: F401
                                      build_sharded_index, empty_topk,
                                      make_sharded_search, merge_topk,
                                      shard_stores,
                                      sharded_search_host,
                                      sharded_search_stores)
from repro_torch.graph.mutate import (DurableIndex,  # noqa: F401
                                      MutationJournal, append_journal,
                                      apply_op, compact, delete_rows,
                                      insert_rows, load_journal,
                                      recover_index, save_journal)
from repro_torch.graph.prune import occlusion_prune_nodes  # noqa: F401
