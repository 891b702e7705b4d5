"""Op counter for the roofline: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``, over the aten ops a step dispatches
instead of compiled HLO text (CUDA has none).

``analyze_ops(fn, *args)`` runs ``fn`` once under two dispatch modes and
counts the same terms as ``analyze_hlo``:

- ``flops``: dot FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products, batched products, convolutions, attention; 2 x M x N
  x K a product, the backward's products included), matrix-vector and
  vector products (``VECTOR_PRODUCTS``: HLO counts them as dots, the
  counter's table has none), and the port's attention ops by the
  formulas they register (``flash_flops``, ``decode_flops``);
- ``bytes_accessed``: operand plus result bytes of every op that is not a
  view (a view moves nothing; each other op is taken to read its operands
  and write its results once: nothing is fused in eager PyTorch);
- ``bytes_bf16eq``: the same with float32 and float64 widths capped at 2
  bytes, as ``_nbytes(cap_float=2)`` does;
- ``collective_bytes`` (``{}``) and ``total_collective_bytes`` (0.0): one
  device runs no collective;
- ``trip_counts`` (``{}``): eager PyTorch dispatches every layer of a
  Python loop, so every trip is counted already.

It runs on any device: on ``meta`` tensors nothing is computed or
allocated, so a step of a 671B model is counted in seconds. What it
cannot see: a kernel launched through ``ctypes`` outside a ``torch.library``
custom op (the search path's kernels; the attention kernels are custom
ops and are counted), and the replay of a captured CUDA graph (the ops
ran once, at capture).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

_FLOAT_WIDE = (torch.float32, torch.float64)
aten = torch.ops.aten


def _mv_flops(a_shape, x_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _addmv_flops(bias_shape, a_shape, x_shape, *args, out_shape=None,
                 **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


VECTOR_PRODUCTS = {aten.mv: _mv_flops, aten.addmv: _addmv_flops,
                   aten.dot: _dot_flops, aten.vdot: _dot_flops}


def nbytes(t: torch.Tensor, cap_float=None) -> int:
    """Bytes of ``t``'s elements; ``cap_float=2`` counts float32 and
    float64 elements at 2 bytes (the bf16-equivalent width)."""
    size = t.element_size()
    if cap_float is not None and t.dtype in _FLOAT_WIDE:
        size = min(size, cap_float)
    return t.numel() * size


def _returns_view(func) -> bool:
    """An op whose results alias an operand without writing it (view,
    reshape, expand, slice, transpose, ...): it moves no bytes."""
    schema = getattr(func, "_schema", None)
    if schema is None or not schema.returns:
        return False
    for r in schema.returns:
        info = r.alias_info
        if info is None or info.is_write:
            return False
    return True


class _ByteCounter(TorchDispatchMode):
    """Operand and result bytes of every op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.bytes_eq = 0
        self.ops = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[str(func.overloadpacket)] += 1
        if not _returns_view(func):
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += nbytes(t)
                    self.bytes_eq += nbytes(t, cap_float=2)
        return out


@dataclasses.dataclass
class OpReport:
    flops: float
    bytes_accessed: float
    bytes_bf16eq: float
    collective_bytes: Dict[str, float]
    total_collective_bytes: float
    trip_counts: Dict[str, int]
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    output: Any = dataclasses.field(default=None, repr=False)

    def to_dict(self) -> dict:
        """The keys of ``HLOReport.to_dict``."""
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "bytes_bf16eq": self.bytes_bf16eq,
            "collective_bytes": dict(self.collective_bytes),
            "total_collective_bytes": self.total_collective_bytes,
            "trip_counts": dict(self.trip_counts),
        }


def analyze_ops(fn, *args, **kwargs) -> OpReport:
    """Run ``fn(*args, **kwargs)`` once and count its ops (see the module
    docstring). The report keeps ``fn``'s return value in ``output``."""
    counter = _ByteCounter()
    with FlopCounterMode(display=False,
                         custom_mapping=VECTOR_PRODUCTS) as flop_mode, \
            counter:
        out = fn(*args, **kwargs)
    by_op = {str(k): float(v) for k, v in
             flop_mode.get_flop_counts().get("Global", {}).items()}
    return OpReport(
        flops=float(flop_mode.get_total_flops()),
        bytes_accessed=float(counter.bytes),
        bytes_bf16eq=float(counter.bytes_eq),
        collective_bytes={}, total_collective_bytes=0.0, trip_counts={},
        flops_by_op=by_op, op_counts=dict(counter.ops), output=out)
