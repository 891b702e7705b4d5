"""Serving pieces of the port: the batch-size ladder, the SLA metrics and
tiers, the continuous-batching runtimes (single and sharded, each shard a
fault domain), shard health and the fault-injection harness."""
from repro_torch.serving.batching import (BATCH_BUCKETS, bucket_pad,  # noqa: F401
                                          bucket_size)
from repro_torch.serving.faults import (FaultEvent, FaultPlan,  # noqa: F401
                                        InjectedFault, InjectedKill)
from repro_torch.serving.health import ShardHealthTracker  # noqa: F401
from repro_torch.serving.metrics import (RequestRecord,  # noqa: F401
                                         ServingMetrics, latency_summary,
                                         percentile)
from repro_torch.serving.runtime import (Completion,  # noqa: F401
                                         ContinuousRuntime, Request,
                                         ShardedContinuousRuntime,
                                         poisson_arrivals)
from repro_torch.serving.sla import (SLAClass, SLAPolicy,  # noqa: F401
                                     default_policy, load_policy,
                                     policy_from_spec, resolve_tier)
