"""Measure-kernel bundle registry: the one path from a measure to the
engine's score and grad stages.

A ``MeasureKernelBundle`` declares, for one measure family, the stage
factories the engine may route through: ``score`` (flattened (M, D)
candidate scorer) and ``grad`` ((Q, D) frontier value+gradient). Each
factory is ``(meta, options) -> stage``; a slot left ``None`` falls back to
the generic stages. A ``Measure`` joins a family by advertising
``meta = (family, *args)``. ``resolve_stages`` fills every missing slot
(unknown family, absent factory, or ``measure_impl='vmap'`` /
``grad_impl='vmap'``) with the generic batched ``score_fn`` and
``torch.func.vmap(torch.func.grad_and_value(score_fn))`` stages.

The index-fused slots (``score_fused``, ``grad_fused``) and the ``mlp``
family are not registered yet (ROADMAP.md, queue 2). Every resolved stage
carries a ``bundle_family`` tag ("generic" for fallbacks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.deepfm_grad import deepfm_value_and_grad
from repro_torch.kernels.deepfm_score import deepfm_score

StageFactory = Callable[[Tuple, Any], Callable]


@dataclasses.dataclass(frozen=True)
class MeasureKernelBundle:
    """Stage factories for one measure family; ``None`` slots fall back to
    the generic stages at resolution time."""
    family: str
    score: Optional[StageFactory] = None
    grad: Optional[StageFactory] = None


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
    measure: Callable
    grad: Callable


def resolve_stages(score_fn, meta: Optional[Tuple],
                   options: Any) -> ResolvedStages:
    """The single measure-to-stage dispatch path. ``options`` is the
    engine's EngineOptions: ``measure_impl`` gates the score slot,
    ``grad_impl`` the grad slot ('vmap' forces the generic stage)."""
    bundle = resolve_bundle(meta)
    fam = bundle.family if bundle is not None else "generic"

    def pick(slot: str, impl: str, fallback):
        factory = getattr(bundle, slot, None) if bundle is not None else None
        if factory is not None and impl != "vmap":
            return _tag(factory(meta, options), fam)
        return _tag(fallback(), "generic")

    measure = pick("score", options.measure_impl,
                   lambda: make_vmap_measure_stage(score_fn))
    grad = pick("grad", options.grad_impl, lambda: make_grad_stage(score_fn))
    return ResolvedStages(measure, grad)


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


register_bundle(MeasureKernelBundle(
    family="deepfm",
    score=_deepfm_score_stage,
    grad=_deepfm_grad_stage,
))
