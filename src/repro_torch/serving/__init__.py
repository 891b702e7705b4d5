"""Serving pieces of the port: the batch-size ladder, the SLA metrics and
tiers, and the continuous-batching runtime."""
from repro_torch.serving.batching import (BATCH_BUCKETS, bucket_pad,  # noqa: F401
                                          bucket_size)
from repro_torch.serving.metrics import (RequestRecord,  # noqa: F401
                                         ServingMetrics, latency_summary,
                                         percentile)
from repro_torch.serving.runtime import (Completion,  # noqa: F401
                                         ContinuousRuntime, Request,
                                         poisson_arrivals)
from repro_torch.serving.sla import (SLAClass, SLAPolicy,  # noqa: F401
                                     default_policy, load_policy,
                                     policy_from_spec, resolve_tier)
