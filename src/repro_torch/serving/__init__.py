"""Serving pieces of the port: the batch-size ladder and latency
accounting."""
from repro_torch.serving.batching import (BATCH_BUCKETS, bucket_pad,  # noqa: F401
                                          bucket_size)
from repro_torch.serving.metrics import latency_summary, percentile  # noqa: F401
