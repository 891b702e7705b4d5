"""Data of the port: the synthetic generators (numpy copies of the JAX
package's, array for array) and the batching pipeline."""
from repro_torch.data.synthetic import (  # noqa: F401
    make_interactions, make_recsys_batch,
)
from repro_torch.data.pipeline import BatchIterator, host_shard  # noqa: F401
