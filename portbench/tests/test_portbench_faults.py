"""A run with the timed path broken underneath has to come out not
``correct``: once for each fault a search cell can have. The run skips
the look for a card and runs at a CPU size; the fault is planted in the
engine's step, which both the one-shot search and the runtime's tick
drive. (One chip: there is no exchange between chips to leave out.)"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.core.engine import ExpansionEngine  # noqa: E402

from portbench.tests.tiny_run import tiny_run  # noqa: E402

STEP = ExpansionEngine.step


def unchanged(self, *a, **kw):
    """The step returns its state unchanged (its lanes marked done, so
    that the search ends)."""
    state = a[5]
    return state._replace(done=torch.ones_like(state.done))


def half_left_out(self, *a, **kw):
    """The second half of the batch's lanes is left out: they keep their
    state and end."""
    state, new = a[5], STEP(self, *a, **kw)
    h = state.done.shape[0] // 2
    out = []
    for n, o in zip(new, state):
        n = n.clone()
        n[h:] = o[h:]
        out.append(n)
    out = type(state)(*out)
    done = out.done.clone()
    done[h:] = True
    return out._replace(done=done)


def altered(self, *a, **kw):
    """Every answer's scores are altered where they are produced, by
    1e-3: ten times the widest ``score_err`` limit."""
    new = STEP(self, *a, **kw)
    s = new.pool_scores
    return new._replace(pool_scores=torch.where(torch.isfinite(s),
                                                s + 1e-3, s))


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["twitch-deepfm.bulk",
                                  "twitch-deepfm.poisson",
                                  "twitch-mlp-int8.bulk"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(ExpansionEngine, "step", fault)
    result = tiny_run(cell, trace=False)
    assert result["correct"] is False
    failed = [n for n, c in result["checks"].items()
              if not (c["value"] <= c["limit"] if c["op"] == "<="
                      else c["value"] >= c["limit"])]
    assert failed, result["checks"]


def test_sound_run_is_correct():
    assert tiny_run("twitch-deepfm.bulk", trace=False)["correct"] is True
