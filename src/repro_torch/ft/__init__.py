"""Fault-tolerance primitives of the port: checkpoints in the JAX
package's layout (``checkpoint``), the straggler monitor and the circuit
breaker that ``serving/health.py`` composes per shard. The JAX package's
``elastic.py`` (remeshing) waits for the LM family (ROADMAP.md)."""
from repro_torch.ft.checkpoint import (latest_step,  # noqa: F401
                                       prune_old_checkpoints,
                                       restore_checkpoint, save_checkpoint)
from repro_torch.ft.straggler import (CircuitBreaker,  # noqa: F401
                                      StragglerAction, StragglerMonitor)
