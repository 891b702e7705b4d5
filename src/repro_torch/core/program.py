"""Static buffers and the routines that run over them: the port's
counterpart of the JAX package's compiled search and runtime programs
(``_run_jit``'s ``lax.while_loop``, the runtime's jitted reset and tick).

A ``StateProgram`` owns a state (a NamedTuple of tensors, the engine's
``EngineState``) and named buffers. A routine is
``fn(buffers, state) -> (new_state, outputs)``: it reads the buffers and
the state, and the program copies ``new_state`` back into the state's own
tensors and each of ``outputs`` into the buffer of its name, so the next
run reads them in place. The host writes new inputs into the buffers
(``load``, ``fill``) and new state values (``assign``) between runs;
nothing else changes a buffer's storage.

On a CUDA device with ``capture=True`` a routine's first run warms it up
(one eager run on a side stream over a clone of the state, so the kernel
library's build, first-call attributes and allocations happen outside the
capture; its launches go to the kernels' ``warmup_launches``), then
captures it into a ``torch.cuda.CUDAGraph`` (the capture's own launches do
not count); every run, the first included, is then one replay, which adds
the captured launches to the kernels' counts. A capture that fails raises;
nothing falls back to the eager path. Elsewhere (the CPU, or
``capture=False``) each run calls the routine eagerly through the same
copy-in and copy-back, which is what the CPU tests hold.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import kernels

Routine = Callable[[Dict[str, torch.Tensor], NamedTuple],
                   Tuple[NamedTuple, Dict[str, torch.Tensor]]]


class StateProgram:
    """Routines over one static state and its buffers (module docstring).
    ``runs`` counts each routine's runs (replays on the card)."""

    def __init__(self, state: NamedTuple, buffers: Dict[str, torch.Tensor],
                 capture: bool = True):
        ptrs = [t.data_ptr() for t in state]
        if len(set(ptrs)) != len(ptrs):
            raise ValueError("the state's fields must not share storage")
        self.state = state
        self.buffers = dict(buffers)
        self.device = state[0].device
        self.capture = bool(capture) and self.device.type == "cuda"
        self.runs: collections.Counter = collections.Counter()
        # a paged program's host side (core.engine.PagedFeed), else None
        self.feed = None
        self._routines: Dict[str, Routine] = {}
        self._graphs: Dict[str, tuple] = {}

    def add(self, name: str, fn: Routine) -> None:
        self._routines[name] = fn

    def load(self, **values) -> None:
        """Copy each value (a tensor on any device, or an array) into the
        buffer of its name, converting its dtype."""
        for name, value in values.items():
            self.buffers[name].copy_(torch.as_tensor(value))

    def fill(self, **values) -> None:
        for name, value in values.items():
            self.buffers[name].fill_(value)

    def assign(self, state: NamedTuple) -> None:
        """Copy ``state`` into the program's state tensors in place (the
        captured routines keep reading the same storage)."""
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    @property
    def captured(self) -> tuple:
        """The names of the routines captured so far (on the card)."""
        return tuple(self._graphs)

    def run(self, name: str) -> None:
        self.runs[name] += 1
        if not self.capture:
            self._apply(name, self.state)
            return
        if name not in self._graphs:
            self._graphs[name] = self._capture(name)
        graph, captured = self._graphs[name]
        graph.replay()
        kernels.add_launches(captured)

    def captured_launches(self, name: str) -> dict:
        """The kernel launches one replay of ``name`` makes ({} before its
        capture or without one)."""
        return dict(self._graphs[name][1]) if name in self._graphs else {}

    def _apply(self, name: str, state: NamedTuple) -> None:
        new, outputs = self._routines[name](self.buffers, state)
        for dst, src in zip(state, new):
            if dst is not src:
                dst.copy_(src)
        for key, src in outputs.items():
            self.buffers[key].copy_(src)

    def _capture(self, name: str) -> tuple:
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            before = kernels.launch_counts()
            with torch.cuda.stream(side):
                scratch = type(self.state)(*(t.clone() for t in self.state))
                self._apply(name, scratch)
            main.wait_stream(side)
            kernels.move_to_warmup(kernels.launches_since(before))
            graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            with torch.cuda.graph(graph):
                self._apply(name, self.state)
            captured = kernels.launches_since(before)
            kernels.add_launches(captured, -1)
        return graph, captured
