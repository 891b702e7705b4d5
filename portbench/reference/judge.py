"""The comparison that decides ``correct``: a sample of the answers the
timed path returned (each query's ids and scores, best first) against
the plain reference.

Numbers compared, each with its limit (from the configuration's
``limits``):

- ``bad_answers`` (limit 0): answers that are malformed: an id outside
  the corpus, an id twice, fewer than k ids, a score that is not finite
  or that rises along the list.
- ``missing`` (limit 0): requests due in the window that never came back
  ``ok`` (the online cells; a minute's wait past the close).
- ``score_err``: the widest gap between a served score and the
  reference's score of that id for that query, the reference reading the
  rows as the configuration stores them (worked out again from the
  corpus). It covers the measure kernels and the dequantising gather.
- ``recall_at_10``: the mean share of the exact top-10 (over the float32
  corpus, by the same measure) that the served answers hold; it has to
  stay at or above its limit. It covers the grad and rank stages through
  the ids they chose: a search that does not move fails it.
"""
from __future__ import annotations

import torch

from portbench.reference import exact, measures, store


def malformed(ids: torch.Tensor, scores: torch.Tensor, n: int,
              k: int) -> torch.Tensor:
    """(S,) bool: the answers that break the form of an answer."""
    bad = (ids < 0).any(1) | (ids >= n).any(1) | (ids.shape[1] < k)
    srt = ids.sort(dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= ~torch.isfinite(scores).all(1)
    bad |= (scores[:, 1:] > scores[:, :-1]).any(1)
    return bad


def judge(config: dict, inputs_weights: dict, corpus: torch.Tensor,
          queries: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor,
          missing: int = 0) -> dict:
    """Judge the served answers (``ids``, ``scores``: (S, k)) of the
    ``queries`` (S, D). Returns {'checks': [(name, value, limit, op)],
    'correct': bool, 'recall': float}."""
    measure, k = config["measure"], config["search"]["k"]
    limits = config["limits"]
    # the reference's float32 products: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        rows = store.stored_rows(corpus, config["engine"]["corpus_dtype"])
        n = corpus.shape[0]
        bad = malformed(ids, scores, n, k)
        ok = ~bad
        err = 0.0
        if ok.any():
            got_ids, got = ids[ok], scores[ok]
            ref = measures.scores(measure, inputs_weights,
                                  rows[got_ids], queries[ok][:, None, :])
            err = float((got - ref).abs().max())
        recall = 0.0
        if ids.shape[0]:
            truth_ids, _ = exact.exact_topk(measure, inputs_weights, corpus,
                                            queries, k)
            hits = (ids[:, :, None] == truth_ids[:, None, :]).any(2)
            recall = float(hits.float().sum(1).div(k).mean())
    checks = [("bad_answers", int(bad.sum()), 0, "<="),
              ("missing", int(missing), 0, "<="),
              ("score_err", err, limits["score_err"], "<="),
              ("recall_at_10", recall, limits["recall_at_10"], ">=")]
    correct = all(v <= lim if op == "<=" else v >= lim
                  for _, v, lim, op in checks)
    return {"checks": checks, "correct": correct, "recall": recall}
