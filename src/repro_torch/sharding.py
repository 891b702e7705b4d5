"""Logical-axis sharding system: the JAX package's ``sharding.py`` on
``torch.distributed`` (``DeviceMesh`` + DTensor).

Every parameter and activation is annotated with a tuple of *logical* axis
names (e.g. ``("layers", "embed", "heads")``). A :class:`ShardingRules`
table maps logical names to physical mesh axes; the same model code then
runs on any mesh (single pod ``(data, model)``, multi-pod ``(pod, data,
model)``, or one device, where the rules map everything to ``None``).

- :class:`PartitionSpec` (``P``) holds the same tuple as JAX's: one entry
  per tensor dim, ``None``, a mesh axis name, or a tuple of names (a
  one-name tuple is the name, an empty one ``None``, as JAX normalises
  them), so spec trees compare entry for entry.
- :func:`placements` turns a spec into DTensor placements over a mesh: a
  tensor dim named by a mesh dim is ``Shard(dim)`` on it, every other mesh
  dim ``Replicate()``. A tuple entry such as ``("pod", "data")`` shards
  one tensor dim over two mesh dims, pod-major as in JAX (DTensor shards a
  dim over mesh dims in mesh order, so the names must come in that order).
- :func:`constrain` is JAX's ``with_sharding_constraint`` by logical axes:
  a DTensor is redistributed to the placements; a plain tensor, or rules
  without a mesh, pass through unchanged (JAX's is a no-op without a mesh).
- :func:`mesh_scope` is the context a forward runs in under a mesh: plain
  tensors made inside it (positions, masks, rope angles) join DTensor ops
  as replicated (``implicit_replication``); without a mesh it does nothing.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Union

import torch

from repro_torch.tree import tree_map

Axes = Sequence[Optional[str]]
PhysAxis = Union[None, str, tuple]


# Logical axis vocabulary (documented; not enforced: new subsystems may add
# names as long as they add a rule entry).
#   batch       global example batch               -> data (+pod)
#   seq         sequence/time                      -> usually unsharded
#   embed       d_model / hidden                   -> unsharded (activations)
#   heads       attention query heads              -> model
#   kv_heads    attention kv heads                 -> model (if divisible)
#   head_dim    per-head dim                       -> unsharded
#   mlp         feed-forward hidden                -> model
#   vocab       vocabulary                         -> model
#   layers      stacked layers                     -> unsharded
#   experts     MoE expert axis                    -> model
#   capacity    MoE per-expert capacity            -> data
#   q_lora/kv_lora  MLA latent dims                -> unsharded
#   table_rows  recsys embedding table rows        -> model
#   table_dim   recsys embedding dim               -> unsharded
#   edges       GNN edge list                      -> data
#   nodes       GNN node table                     -> unsharded (replicated)
#   corpus      ANN base-vector corpus             -> model
#   queries     ANN query batch                    -> data (+pod)
#   zero        ZeRO-1 optimizer-state dim         -> data


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if len(e) == 0:
            return None
        if len(e) == 1:
            return e[0]
    return e


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple of per-dim entries (``None``, a
    mesh axis name, or a tuple of names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class ShardingRules:
    table: Mapping[str, PhysAxis] = field(default_factory=dict)
    mesh: Any = None   # the ambient DeviceMesh (moe_ffn_ep needs it)

    def spec(self, axes: Optional[Axes]) -> P:
        if axes is None:
            return P()
        return P(*[self.table.get(a, None) if a is not None else None
                   for a in axes])

    def with_overrides(self, **overrides: PhysAxis) -> "ShardingRules":
        t = dict(self.table)
        t.update(overrides)
        return ShardingRules(t, self.mesh)


def single_device_rules() -> ShardingRules:
    """Everything replicated: one device, tests, CPU smoke runs."""
    return ShardingRules({})


def mesh_rules(mesh) -> ShardingRules:
    """Default production rules for the (pod,)data,model meshes."""
    has_pod = "pod" in mesh.mesh_dim_names
    batch: PhysAxis = ("pod", "data") if has_pod else ("data",)
    return ShardingRules(
        {
            "batch": batch,
            "queries": batch,
            "heads": "model",
            # kv heads (2-8) never divide the 16-wide model axis; k/v are
            # replicated across TP ranks (the Megatron GQA fallback)
            "kv_heads": None,
            # sequence-parallel residual stream (Megatron SP): activations
            # between blocks shard their seq dim on the TP axis
            "act_seq": "model",
            "mlp": "model",
            "vocab": "model",
            "experts": "model",
            "capacity": "data",
            "table_rows": "model",
            "edges": batch,
            "corpus": "model",
            "zero": "data",
        },
        mesh=mesh,
    )


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(spec: P, mesh, ndim: Optional[int] = None) -> tuple:
    """DTensor placements of ``spec`` over ``mesh`` (one per mesh dim).
    ``ndim``, where given, checks the spec is no longer than the tensor."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec}")
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a mesh and a spec."""
    mesh: Any
    spec: P

    def placements(self, ndim: Optional[int] = None) -> tuple:
        return placements(self.spec, self.mesh, ndim)

    def shard_shape(self, shape) -> tuple:
        """The shape this rank holds of a ``shape`` tensor (DTensor's local
        shape: an uneven dim's first shards take the ceiling, so on rank 0
        it is JAX's ``shard_shape``, the size JAX pads every shard to)."""
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        shape = tuple(int(s) for s in shape)
        local, _ = compute_local_shape_and_global_offset(
            shape, self.mesh, self.placements(len(shape)))
        return tuple(int(s) for s in local)


def logical_sharding(mesh, rules: ShardingRules, axes: Optional[Axes]):
    if mesh is None:
        return None
    return NamedSharding(mesh, rules.spec(axes))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, rules: Optional[ShardingRules],
              *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of ``rules.spec(axes)``;
    the identity on a plain tensor or without a mesh."""
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    want = placements(rules.spec(axes), rules.mesh, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its middle dims (neither the first nor the last)
    replicated: the sequence-parallel gather before a product that
    flattens (B, S) (Megatron SP's all-gather before a column-parallel
    linear; a product over a seq-sharded DTensor is not partitioned by
    every torch release). The identity on a plain tensor, or where no
    middle dim is sharded."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if isinstance(p, Shard)
                 and 0 < p.dim % x.ndim < x.ndim - 1 else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _GatherInnerGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def gather_inner_grad(y: torch.Tensor) -> torch.Tensor:
    """``y`` unchanged, its gradient through ``gather_inner``: for a
    product's output that joins the seq-sharded residual stream, so that
    the product's backward meets no seq-sharded gradient either. The
    identity on a plain tensor."""
    return _GatherInnerGrad.apply(y) if is_dtensor(y) else y


def per_shard(fn, args, roles, out_roles):
    """``fn(*args)`` on each rank's shards, for a function that is
    independent along some named dims (attention: the batch and the
    heads), with DTensors among ``args``.

    ``roles[i]`` maps a role name to the dim of ``args[i]`` that carries
    it (None for an argument passed as it is: a plain tensor, a number).
    The first DTensor argument decides, for each mesh dim, which role it
    shards (the role whose dim it is sharded on; none otherwise); every
    DTensor argument is then redistributed so that each such mesh dim
    shards that role's dim, Replicate where the argument lacks the role,
    and every other mesh dim is Replicate (a sharded sequence or channel
    dim gathered first, as XLA does around what it cannot partition).
    Plain tensor arguments with roles are taken as replicated. The result
    (one tensor) is a DTensor with ``out_roles``'s dims sharded the same
    way. Without a DTensor among ``args``, ``fn(*args)``."""
    i_lead = next((i for i, a in enumerate(args) if is_dtensor(a)), None)
    if i_lead is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lead, lead_roles = args[i_lead], roles[i_lead]
    mesh = lead.device_mesh
    by_dim = {d % lead.ndim: r for r, d in lead_roles.items()}
    mesh_roles = [by_dim.get(p.dim % lead.ndim)
                  if isinstance(p, Shard) else None
                  for p in lead.placements]

    def want(role_dims, ndim):
        return [Shard(role_dims[r] % ndim) if r in role_dims else Replicate()
                for r in mesh_roles]

    local = []
    for a, r in zip(args, roles):
        if r is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(a.redistribute(mesh, want(r, a.ndim)).to_local())
    out = fn(*local)
    return DTensor.from_local(out, mesh, want(out_roles, out.ndim),
                              run_check=False)


def mesh_scope(rules: Optional[ShardingRules]):
    """The context a forward runs in: under a mesh, plain tensors made in
    it join DTensor ops as replicated; otherwise nothing."""
    if rules is None or rules.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def tensors_scope(tensors):
    """``mesh_scope`` for code that has tensors, not rules: implicit
    replication when any of ``tensors`` is a DTensor (a backward through a
    forward that ran under a mesh)."""
    if not any(is_dtensor(t) for t in tensors):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and not isinstance(x, P)
                         and all(isinstance(e, (str, type(None)))
                                 for e in x))


def specs_for_tree(axes_tree: Any, rules: ShardingRules) -> Any:
    """Map a tree of logical-axes tuples to a tree of PartitionSpecs."""
    return tree_map(rules.spec, axes_tree, is_leaf=_is_axes_leaf)


def shardings_for_tree(axes_tree: Any, mesh, rules: ShardingRules) -> Any:
    return tree_map(lambda spec: NamedSharding(mesh, spec),
                    specs_for_tree(axes_tree, rules),
                    is_leaf=lambda x: isinstance(x, P))


def zero1_axes(param_axes: Any, mesh) -> Any:
    """ZeRO-1 axes for optimizer moments: the params' own logical axes
    (``zero1_spec_tree`` adds the data-axis shard)."""
    return param_axes


def zero1_spec_tree(params: Any, axes_tree: Any, mesh,
                    rules: ShardingRules) -> Any:
    """PartitionSpecs for optimizer state with ZeRO-1: for each param,
    start from its own spec and additionally shard the largest replicated
    dim along the data axis when divisible. ``mesh`` needs only
    ``mesh_dim_names`` and sizes (a DeviceMesh, or any object with
    ``axis_names`` and a ``shape`` mapping, as JAX's AbstractMesh)."""
    sizes = (mesh_axis_sizes(mesh) if hasattr(mesh, "mesh_dim_names")
             else dict(mesh.shape))
    data_size = sizes.get("data", 1)

    def _uses_data(entry) -> bool:
        return "data" in _entry_axes(entry)

    def _leaf(p, axes):
        spec = list(rules.spec(axes)) if axes is not None else [None] * p.ndim
        while len(spec) < p.ndim:
            spec.append(None)
        if data_size > 1 and not any(_uses_data(e) for e in spec):
            cand = [(p.shape[i], i) for i in range(p.ndim)
                    if spec[i] is None and p.shape[i] % data_size == 0
                    and p.shape[i] >= data_size]
            if cand:
                _, i = max(cand)
                spec[i] = "data"
        return P(*spec)

    return tree_map(_leaf, params, axes_tree, is_leaf=_is_axes_leaf)


def distribute(x: torch.Tensor, sharding: Optional[NamedSharding]):
    """``x`` (the whole tensor, the same on every rank) as a DTensor with
    ``sharding``'s placements (each rank keeps its shard; no
    communication); ``x`` itself when ``sharding`` is None."""
    if sharding is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements(x.ndim),
                             src_data_rank=None)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """``distribute`` over a tree and its matching tree of shardings (JAX's
    ``device_put(tree, shardings)``)."""
    return tree_map(distribute, tree, shardings,
                    is_leaf=lambda x: x is None
                    or isinstance(x, NamedSharding))
