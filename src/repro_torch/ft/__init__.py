"""Fault-tolerance primitives of the port: checkpoints in the JAX
package's layout (``checkpoint``), the straggler monitor and the circuit
breaker that ``serving/health.py`` composes per shard, and ``elastic``'s
remesh plan."""
from repro_torch.ft.checkpoint import (latest_step,  # noqa: F401
                                       prune_old_checkpoints,
                                       restore_checkpoint, save_checkpoint)
from repro_torch.ft.straggler import (CircuitBreaker,  # noqa: F401
                                      StragglerAction, StragglerMonitor)
from repro_torch.ft.elastic import remesh_plan  # noqa: F401
