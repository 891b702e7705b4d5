"""Data of the port: the synthetic generators and the GNN fanout sampler
(numpy copies of the JAX package's, array for array) and the batching
pipeline."""
from repro_torch.data.synthetic import (  # noqa: F401
    make_batched_molecules, make_graph, make_interactions, make_recsys_batch,
    make_token_batch,
)
from repro_torch.data.sampler import NeighborSampler, SampledBatch  # noqa: F401
from repro_torch.data.pipeline import BatchIterator, host_shard  # noqa: F401
