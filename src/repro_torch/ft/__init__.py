"""Fault-tolerance primitives of the port: the straggler monitor and the
circuit breaker that ``serving/health.py`` composes per shard. The JAX
package's ``checkpoint.py`` and ``elastic.py`` belong to training and wait
for its port (ROADMAP.md)."""
from repro_torch.ft.straggler import (CircuitBreaker,  # noqa: F401
                                      StragglerAction, StragglerMonitor)
