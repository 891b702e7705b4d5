"""Search core of the port: measures, corpus residency, the bundle
registry, the expansion engine (and the captured programs it runs as,
``core/program.py``) and the search API."""
from repro_torch.core.bundles import (MeasureKernelBundle, get_bundle,  # noqa: F401
                                      list_families, register_bundle,
                                      resolve_stages)
from repro_torch.core.corpus import (CORPUS_DTYPES,  # noqa: F401
                                     CorpusStore, as_corpus_store,
                                     make_corpus_store, store_from_arrays)
from repro_torch.core.engine import (EngineOptions, EngineState,  # noqa: F401
                                     ExpansionEngine, SearchConfig,
                                     SearchResult, build_engine,
                                     build_engine_from_fn, engine_search)
from repro_torch.core.measures import (MEASURE_FAMILIES, Measure,  # noqa: F401
                                       deepfm_measure, inner_product_measure,
                                       l2_measure, make_family_measure,
                                       mlp_measure, params_from_jax)
from repro_torch.core.program import StateProgram  # noqa: F401
from repro_torch.core.search import (brute_force_topk, recall,  # noqa: F401
                                     search_measure)
