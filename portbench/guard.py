"""The import guard: names what, of JAX and the JAX package, a process
has loaded. Modules are compared by their top-level name (the part before
the first dot) as a whole word: ``repro_torch``, the port, begins with
``repro``, the JAX package, and is not it."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded(names=FORBIDDEN, modules=None) -> list:
    """The loaded modules whose top-level name is one of ``names``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in names)
