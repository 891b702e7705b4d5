"""SLA tiers for the serving scheduler: the port's own copy of the JAX
package's ``serving/sla.py`` (numpy and the standard library only).

The engine exposes two per-lane quality/cost knobs, the iteration budget
(``iter_caps``) and the adaptive angle cutoff (``taus``): a lane with a
small cap and a tight tau does less measure work and answers sooner.

- An ``SLAClass`` is one named tier: the per-lane knobs it admits requests
  under (``iter_cap``, ``angle_tau``) plus the residency it recommends
  (``corpus_dtype``, advisory: residency is fixed when the runtime is
  built, so a tier cannot switch it per request).
- An ``SLAPolicy`` is an ordered ladder of tiers, richest first. It maps a
  request's deadline to the richest tier whose expected work fits
  (``classify``) and a tier to the next-cheaper one (``degrade``): the
  runtime's degrade-before-shed ladder under pressure.

Tiers are policy, not mechanism: the runtime applies a tier's (iter_cap,
tau) through the same per-lane arrays as an explicit ``budget_iters``, so
results under a tier equal a oneshot search with the same knobs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SLAClass:
    """One serving tier.

    ``min_deadline_s``: smallest request deadline (seconds) this tier's
    work is expected to fit under — ``classify`` picks the richest tier
    whose ``min_deadline_s`` the deadline clears (None deadline clears
    everything). ``iter_cap``: per-lane expansion budget (None = the
    engine config's uniform cap). ``angle_tau``: per-lane adaptive angle
    cutoff in radians (0.0 = no absolute cutoff; only meaningful under
    ``EngineOptions(adaptive='angle')`` — inert otherwise, by the adaptive
    contract). ``corpus_dtype``: recommended residency for a fleet serving
    this tier as its floor (advisory — see module docstring)."""
    name: str
    min_deadline_s: float = 0.0
    iter_cap: Optional[int] = None
    angle_tau: float = 0.0
    corpus_dtype: str = "float32"

    def describe(self) -> str:
        cap = "cfg" if self.iter_cap is None else str(self.iter_cap)
        tau = "off" if self.angle_tau <= 0 else f"{self.angle_tau:.3f}"
        return (f"{self.name}: deadline>={self.min_deadline_s * 1e3:.0f}ms "
                f"iter_cap={cap} angle_tau={tau} "
                f"corpus_dtype={self.corpus_dtype}")


@dataclasses.dataclass(frozen=True)
class SLAPolicy:
    """An ordered ladder of tiers, richest (most work) FIRST. The last
    tier is the floor every request can fall back to, so its
    ``min_deadline_s`` should be 0."""
    classes: Sequence[SLAClass]

    def __post_init__(self):
        if not self.classes:
            raise ValueError("SLAPolicy needs at least one SLAClass")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")

    def get(self, name: str) -> SLAClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(
            f"unknown SLA tier {name!r} (have {[c.name for c in self.classes]})")

    def classify(self, deadline_s: Optional[float]) -> SLAClass:
        """Richest tier whose ``min_deadline_s`` the deadline clears; a
        None deadline (no latency requirement) gets the richest tier."""
        if deadline_s is None:
            return self.classes[0]
        for c in self.classes:
            if deadline_s >= c.min_deadline_s:
                return c
        return self.classes[-1]

    def degrade(self, tier: SLAClass) -> Optional[SLAClass]:
        """Next-cheaper tier, or None when ``tier`` is already the floor."""
        names = [c.name for c in self.classes]
        i = names.index(tier.name)
        return self.classes[i + 1] if i + 1 < len(self.classes) else None

    def floor(self) -> SLAClass:
        return self.classes[-1]

    def table(self) -> List[str]:
        return [c.describe() for c in self.classes]


def default_policy(base_iters: int = 0) -> SLAPolicy:
    """The stock 3-tier ladder. ``base_iters`` anchors the caps to the
    engine config's uniform budget (0 = leave premium at the cfg cap and
    use absolute caps for the cheaper tiers)."""
    full = base_iters if base_iters > 0 else 0
    std = max(2, full // 2) if full else 16
    eco = max(1, full // 4) if full else 8
    # tau anchors: gradient angle keys for gaussian corpora concentrate
    # just below pi/2 — 1.62 trims only the widest-angle candidates
    # (evals drop several-fold, recall nearly intact; the JAX package's
    # benchmarks/adaptive.py sweep), 1.55 cuts visibly into recall and is
    # the economy floor. Data-dependent: override via a policy JSON.
    return SLAPolicy((
        SLAClass("premium", min_deadline_s=0.250,
                 iter_cap=None, angle_tau=0.0, corpus_dtype="float32"),
        SLAClass("standard", min_deadline_s=0.050,
                 iter_cap=std, angle_tau=1.62, corpus_dtype="bfloat16"),
        SLAClass("economy", min_deadline_s=0.0,
                 iter_cap=eco, angle_tau=1.55, corpus_dtype="int8"),
    ))


def policy_from_spec(spec) -> SLAPolicy:
    """Build a policy from a JSON-ish spec: a list of tier dicts (richest
    first), each ``{"name": ..., "min_deadline_s": ..., "iter_cap": ...,
    "angle_tau": ..., "corpus_dtype": ...}`` — missing keys take the
    ``SLAClass`` defaults."""
    if isinstance(spec, dict):
        spec = spec.get("classes", spec.get("tiers"))
    if not isinstance(spec, list):
        raise ValueError("SLA spec must be a list of tier dicts (or a dict "
                         "with a 'classes'/'tiers' list)")
    classes = []
    for d in spec:
        allowed = {f.name for f in dataclasses.fields(SLAClass)}
        extra = set(d) - allowed
        if extra:
            raise ValueError(f"unknown SLA tier keys {sorted(extra)} "
                             f"(allowed: {sorted(allowed)})")
        classes.append(SLAClass(**d))
    return SLAPolicy(tuple(classes))


def load_policy(path_or_name: str) -> SLAPolicy:
    """``'default'`` -> the stock ladder; anything else is a JSON file
    path holding a ``policy_from_spec`` spec."""
    if path_or_name == "default":
        return default_policy()
    with open(path_or_name) as f:
        return policy_from_spec(json.load(f))


def resolve_tier(policy: Optional[SLAPolicy], sla: Optional[str],
                 deadline_s: Optional[float]) -> Optional[SLAClass]:
    """The one tier-resolution path both runtimes use: an explicit tier
    name wins; otherwise the deadline classifies. None policy -> None
    (untiered requests keep the pre-SLA behavior exactly)."""
    if policy is None:
        return None
    return policy.get(sla) if sla is not None else policy.classify(deadline_s)
