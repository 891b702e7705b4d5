"""Measure-kernel bundle registry: the one path from a measure to the
engine's score and grad stages.

A ``MeasureKernelBundle`` declares, for one measure family, the stage
factories the engine may route through: ``score`` (flattened (M, D)
candidate scorer), ``grad`` ((Q, D) frontier value+gradient), and their
index-fused forms ``score_fused`` (``(params, store, idx, qs, mask=None)``)
and ``grad_fused`` (``(params, store, fid, q) -> (vals, grads, x)``), which
take row ids into the resident ``CorpusStore``. Each factory is
``(meta, options) -> stage``. A ``Measure`` joins a family by advertising
``meta = (family, *args)``. ``resolve_stages`` fills every missing slot
(unknown family, absent factory, or ``measure_impl='vmap'`` /
``grad_impl='vmap'``) with the generic stages: the batched ``score_fn``,
``torch.func.vmap(torch.func.grad_and_value(score_fn))``, and the generic
fused scorer (``store.take`` then ``score_fn``). A family without a fused
grad leaves ``grad_fused`` None: the engine then gathers the frontier
itself and runs the plain ``grad`` stage.

Two families are registered, each with all four slots: ``deepfm`` (the
paper's measure, its MLP under ``params['mlp']``) and ``mlp`` (the generic
``sigmoid(MLP([x, q]))`` measure, whose params are the ``{'w', 'b'}``
pytree itself). Every resolved stage carries a ``bundle_family`` tag
("generic" for fallbacks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.deepfm_grad import deepfm_value_and_grad
from repro_torch.kernels.deepfm_grad_fused import deepfm_grad_fused
from repro_torch.kernels.deepfm_score import deepfm_score
from repro_torch.kernels.deepfm_score_fused import deepfm_score_fused
from repro_torch.kernels.mlp_grad import mlp_value_and_grad
from repro_torch.kernels.mlp_grad_fused import mlp_grad_fused
from repro_torch.kernels.mlp_score import mlp_score
from repro_torch.kernels.mlp_score_fused import mlp_score_fused

StageFactory = Callable[[Tuple, Any], Callable]


@dataclasses.dataclass(frozen=True)
class MeasureKernelBundle:
    """Stage factories for one measure family; ``None`` slots fall back to
    the generic stages at resolution time."""
    family: str
    score: Optional[StageFactory] = None
    score_fused: Optional[StageFactory] = None
    grad: Optional[StageFactory] = None
    grad_fused: Optional[StageFactory] = None

    def slots(self) -> Dict[str, bool]:
        return {s: getattr(self, s) is not None
                for s in ("score", "score_fused", "grad", "grad_fused")}


_REGISTRY: Dict[str, MeasureKernelBundle] = {}


def register_bundle(bundle: MeasureKernelBundle,
                    overwrite: bool = False) -> MeasureKernelBundle:
    if not overwrite and bundle.family in _REGISTRY:
        raise ValueError(f"bundle family {bundle.family!r} already "
                         "registered (pass overwrite=True to replace)")
    _REGISTRY[bundle.family] = bundle
    return bundle


def get_bundle(family: str) -> Optional[MeasureKernelBundle]:
    return _REGISTRY.get(family)


def list_families() -> List[str]:
    return sorted(_REGISTRY)


def resolve_bundle(meta: Optional[Tuple]) -> Optional[MeasureKernelBundle]:
    """meta is a Measure's ``(family, *args)`` tuple (or None)."""
    if not meta or not isinstance(meta, tuple):
        return None
    return _REGISTRY.get(meta[0])


# ---------------------------------------------------------------------------
# the generic fallbacks
# ---------------------------------------------------------------------------

def make_vmap_measure_stage(score_fn):
    """Scores (M, D) rows against (M, Dq) queries with the batched
    ``score_fn`` itself."""
    def stage(params, vecs, qs):
        return score_fn(params, vecs, qs).float()
    return stage


def make_vmap_measure_fused_stage(score_fn):
    """Generic index-fused scorer: ``store.take`` then the batched
    ``score_fn``. ``mask`` is the adaptive per-lane prefix mask: masked
    rows score -inf (they are computed all the same)."""
    def stage(params, store, idx, qs, mask=None):
        out = score_fn(params, store.take(idx.clamp_min(0)), qs).float()
        return out if mask is None else out.masked_fill(~mask,
                                                        float("-inf"))
    return stage


def make_grad_stage(score_fn):
    """Per-row value and df/dx through ``torch.func``."""
    def stage(params, x, q):
        def f(xx, qq):
            return score_fn(params, xx, qq)
        grads, vals = torch.func.vmap(torch.func.grad_and_value(f))(x, q)
        return vals.float(), grads
    return stage


def _tag(stage, family: str):
    stage.bundle_family = family
    return stage


class ResolvedStages(NamedTuple):
    """What ``resolve_stages`` hands ``build_engine_from_fn``.
    ``measure_fused`` and ``grad_fused`` are None unless ``options.fused``;
    ``grad_fused`` is also None when the family has no fused grad kernel."""
    measure: Callable
    measure_fused: Optional[Callable]
    grad: Callable
    grad_fused: Optional[Callable]


def resolve_stages(score_fn, meta: Optional[Tuple],
                   options: Any) -> ResolvedStages:
    """The single measure-to-stage dispatch path. ``options`` is the
    engine's EngineOptions: ``measure_impl`` gates the score slots,
    ``grad_impl`` the grad slots ('vmap' forces the generic stage), and
    ``fused`` enables the fused slots."""
    bundle = resolve_bundle(meta)
    fam = bundle.family if bundle is not None else "generic"

    def pick(slot: str, impl: str, fallback):
        factory = getattr(bundle, slot, None) if bundle is not None else None
        if factory is not None and impl != "vmap":
            return _tag(factory(meta, options), fam)
        return _tag(fallback(), "generic") if fallback is not None else None

    measure = pick("score", options.measure_impl,
                   lambda: make_vmap_measure_stage(score_fn))
    grad = pick("grad", options.grad_impl, lambda: make_grad_stage(score_fn))
    measure_fused = grad_fused = None
    if options.fused:
        measure_fused = pick("score_fused", options.measure_impl,
                             lambda: make_vmap_measure_fused_stage(score_fn))
        grad_fused = pick("grad_fused", options.grad_impl, None)
    return ResolvedStages(measure, measure_fused, grad, grad_fused)


# ---------------------------------------------------------------------------
# the DeepFM bundle (the paper's measure)
# ---------------------------------------------------------------------------

def _deepfm_score_stage(meta, options):
    fm_dim = int(meta[1])

    def stage(params, vecs, qs):
        return deepfm_score(vecs, qs, params["mlp"], fm_dim=fm_dim)
    return stage


def _deepfm_grad_stage(meta, options):
    fm_dim = int(meta[1])

    def stage(params, x, q):
        return deepfm_value_and_grad(x, q, params["mlp"], fm_dim=fm_dim)
    return stage


def _deepfm_score_fused_stage(meta, options):
    fm_dim = int(meta[1])

    def stage(params, store, idx, qs, mask=None):
        return deepfm_score_fused(store, idx, qs, params["mlp"],
                                  fm_dim=fm_dim, mask=mask)
    return stage


def _deepfm_grad_fused_stage(meta, options):
    fm_dim = int(meta[1])

    def stage(params, store, fid, q):
        return deepfm_grad_fused(store, fid, q, params["mlp"], fm_dim=fm_dim)
    return stage


register_bundle(MeasureKernelBundle(
    family="deepfm",
    score=_deepfm_score_stage,
    score_fused=_deepfm_score_fused_stage,
    grad=_deepfm_grad_stage,
    grad_fused=_deepfm_grad_fused_stage,
))


# ---------------------------------------------------------------------------
# the MLP bundle (the generic 'heavier f' measure; params are {'w', 'b'})
# ---------------------------------------------------------------------------

def _mlp_score_stage(meta, options):
    def stage(params, vecs, qs):
        return mlp_score(vecs, qs, params)
    return stage


def _mlp_grad_stage(meta, options):
    def stage(params, x, q):
        return mlp_value_and_grad(x, q, params)
    return stage


def _mlp_score_fused_stage(meta, options):
    def stage(params, store, idx, qs, mask=None):
        return mlp_score_fused(store, idx, qs, params, mask=mask)
    return stage


def _mlp_grad_fused_stage(meta, options):
    def stage(params, store, fid, q):
        return mlp_grad_fused(store, fid, q, params)
    return stage


register_bundle(MeasureKernelBundle(
    family="mlp",
    score=_mlp_score_stage,
    score_fused=_mlp_score_fused_stage,
    grad=_mlp_grad_stage,
    grad_fused=_mlp_grad_fused_stage,
))
