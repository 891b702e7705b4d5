"""AdamW, the warmup + cosine schedule and global-norm clipping: the JAX
package's ``train/optimizer.py`` as plain PyTorch over parameter trees.

The same update as the JAX one, in the same order, which
``torch.optim.AdamW`` is not: every tensor of ``ndim >= 2`` is decayed
(embedding tables included) and no vector is; the step count is taken up
before the learning rate is read; the clip scale multiplies every
gradient leaf. Every row of every table is updated every step (the
moments decay and weight decay applies where the gradient is zero): the
update is dense, never lazy.

The update runs in place on the parameters and the moments (the JAX step
donates their buffers), one flat chunk of ``CHUNK`` elements at a time, so
a table of billions of elements needs only a chunk's temporaries.

DTensor leaves (a mesh): each rank updates its shard of the moments in
their own placements (ZeRO-1: ``sharding.zero1_spec_tree`` shards them
over ``data`` where the param is replicated there), with the gradient
and the param redistributed to those placements, then writes the new
param back into its own placements (an all-gather over ``data``). The
global norm sums each leaf's squares over the mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.sharding import is_dtensor
from repro_torch.tree import tree_leaves, tree_map

# elements per in-place update chunk (64 MB of float32): the temporaries of
# one chunk stay small next to a table of billions of elements, and a chunk
# is long enough that its ~17 eager ops keep the card busy (at 16 MB a
# DLRM-RM2 step issued ~11,300 device events and the card idled 57%)
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


def cosine_schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine to 0 at ``total_steps``;
    float32 throughout, as in JAX."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _chunks(t: torch.Tensor):
    """Flat views of ``CHUNK`` elements (``view``: an update written to a
    chunk lands in ``t``; a gradient that is not contiguous is copied)."""
    flat = t.view(-1) if t.is_contiguous() else t.reshape(-1)
    for s in range(0, flat.numel(), CHUNK):
        yield flat[s: s + CHUNK]


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (a leaf above ``CHUNK`` elements summed chunk by chunk)."""
    total = 0
    for g in tree_leaves(grads):
        if is_dtensor(g):
            total = total + torch.sum(torch.square(
                g.to(torch.float32))).full_tensor()
            continue
        for c in _chunks(g):
            total = total + torch.sum(torch.square(c.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling). ``adamw_update`` applies the same scale inside its
    update instead of materialising the scaled tree."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gnorm


def adamw_init(params: Any, cfg: OptimizerConfig) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        if is_dtensor(p):     # the param's placements
            return torch.zeros_like(p, dtype=cfg.moment_dtype)
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _update_chunk(p, g, m, v, scale, lr, bc1, bc2, cfg, decay):
    """One chunk of the JAX ``upd``, operation for operation, writing p, m
    and v in place."""
    b1, b2 = cfg.betas
    gf = g.to(torch.float32)
    if scale is not None:
        gf = gf * scale
        if g.dtype != torch.float32:   # JAX's clip rounds to g's dtype
            gf = gf.to(g.dtype).to(torch.float32)
    m32, v32, p32 = (t.to(torch.float32) for t in (m, v, p))
    m32.mul_(b1).add_(gf * (1 - b1))
    t = gf * (1 - b2)
    v32.mul_(b2).add_(t.mul_(gf))
    denom = (v32 / bc2).sqrt_().add_(cfg.eps)
    u = (m32 / bc1).div_(denom)
    if decay:
        u.add_(cfg.weight_decay * p32)
    p32.sub_(u.mul_(lr))
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if src is not dst:
            dst.copy_(src)


def _update_sharded(p, g, m, v, scale, lr, bc1, bc2, cfg, decay):
    """One DTensor leaf: the update on this rank's shard of the moments,
    the param written back in its own placements."""
    from torch.distributed.tensor import DTensor
    mesh, place = m.device_mesh, m.placements
    pl = p.redistribute(mesh, place).to_local()
    gl = g.redistribute(mesh, place).to_local()
    ml, vl = m.to_local(), v.to_local()
    for pc, gc, mc, vc in zip(_chunks(pl), _chunks(gl), _chunks(ml),
                              _chunks(vl)):
        _update_chunk(pc, gc, mc, vc, scale, lr, bc1, bc2, cfg, decay)
    if tuple(p.placements) != tuple(place):
        new = DTensor.from_local(pl, mesh, place, run_check=False,
                                 shape=p.shape, stride=p.stride())
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState,
                 cfg: OptimizerConfig):
    """One AdamW step: (params, new state, {'lr', 'grad_norm'}). The
    parameter and moment tensors are updated in place; the returned trees
    are the ones passed in."""
    if cfg.grad_clip > 0:
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=state.step.device)
        scale = None
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    b1, b2 = cfg.betas
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        decay = cfg.weight_decay > 0 and p.ndim >= 2   # matrices only
        if is_dtensor(p):
            _update_sharded(p, g, m, v, scale, lr, bc1, bc2, cfg, decay)
            continue
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                  _chunks(v)):
            _update_chunk(pc, gc, mc, vc, scale, lr, bc1, bc2, cfg, decay)
    return params, AdamWState(step, state.m, state.v), {
        "lr": lr, "grad_norm": gnorm}
