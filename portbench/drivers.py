"""The two ways a traffic mix drives the system, by its ``kind``:

- ``bulk``: ``ExpansionEngine.search`` over one-shot batches, back to
  back, for the window's seconds (a closed loop);
- ``online``: ``ContinuousRuntime`` (``submit`` / ``step_once``) under
  open-loop arrivals, each request timed on the harness's own clock from
  when it was due to the return of the round that harvested it.

Each warms up the shapes it will use before the window, calls
``setup.finish()`` at the first timed query, and returns what the window
produced: the served answers (for the judge), the counts and times (for
the metric readers) and, when traced, the reduced trace of a stretch after
the window."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import data as data_lib
from portbench import trace as trace_lib
from portbench.traffic import generator

DRAIN_S = 60.0   # how long a request due in the window is waited for


def settle() -> None:
    """End of set-up: collect once, then move everything set-up left
    alive (the imports, the inputs, the index, about 230,000 objects) out
    of the collector's sight, as a server does once it has started
    (``gc.freeze``). Without it a full collection over them, about 200 ms
    on the card's host, falls into the window at random and decides the
    online cells' p95."""
    gc.collect()
    gc.freeze()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _judged(users: np.ndarray, size: int, seed: int) -> np.ndarray:
    """The served positions the judge compares: one served answer of
    each of the ``size`` users first in the draw's own order (``users``:
    each served answer's index there), picked among that user's answers
    by the seed. Every seed judges the same users, so the sample does
    not move the recall a run reads (with ``size`` answers drawn from the
    seed, the MLP cells' recall moved 4% from seed to seed)."""
    rng = data_lib.host_rng(seed, data_lib.SAMPLE)
    shuffled = rng.permutation(len(users))
    _, first = np.unique(users[shuffled], return_index=True)
    return np.sort(shuffled[first[:size]])


def run_bulk(system, inputs, mix: dict, seconds: float, trace: bool,
             seed: int, setup) -> dict:
    dev = system.device
    pool = inputs.queries
    P, B = pool.shape[0], mix["batch"]
    entries = system.entries(B)
    lane = torch.arange(B, device=dev)

    def batch_ids(p: int) -> torch.Tensor:
        return (lane + p) % P

    # warm-up: the one batch shape, captured at its first search
    for p in (0, B):
        system.search(pool[batch_ids(p)], entries)
    _sync(dev)
    setup.mark("capture_warmup")
    settle()
    setup_s = setup.finish()

    stats = system.engine.stats
    steps0 = stats["steps"]
    served, counts = [], torch.zeros(3, dtype=torch.int64, device=dev)
    p = 0
    t0 = time.perf_counter()
    while True:
        idx = batch_ids(p)
        p = (p + B) % P
        res = system.search(pool[idx], entries)
        served.append((idx, res.ids, res.scores))
        counts += torch.stack([res.n_eval.sum(), res.n_grad.sum(),
                               res.n_iters.sum()]).long()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    steps = stats["steps"] - steps0
    n_eval, n_grad, n_iters = (float(c) for c in counts.cpu())
    out = {"kind": "bulk", "window_s": window_s, "setup_s": setup_s,
           "attempted": B * len(served), "completed": B * len(served),
           "failed": 0, "steps": steps, "n_eval": n_eval, "n_grad": n_grad,
           "n_iters": n_iters, "missing": 0, "trace": None}

    if trace:
        tcounts = torch.zeros(3, dtype=torch.int64, device=dev)
        tsteps = stats["steps"]
        reduced = {}
        with trace_lib.traced(dev, reduced):
            for _ in range(mix["trace_batches"]):
                idx = batch_ids(p)
                p = (p + B) % P
                res = system.search(pool[idx], entries)
                tcounts += torch.stack([res.n_eval.sum(), res.n_grad.sum(),
                                        res.n_iters.sum()]).long()
            _sync(dev)
        te, tg, ti = (float(c) for c in tcounts.cpu())
        reduced.update(n_eval=te, n_grad=tg, n_iters=ti,
                       steps=stats["steps"] - tsteps)
        out["trace"] = reduced

    # the judged sample: the first users' answers, picked by the seed
    flat_idx = torch.cat([s[0] for s in served])
    flat_ids = torch.cat([s[1] for s in served])
    flat_sc = torch.cat([s[2] for s in served])
    users = inputs.order[flat_idx].cpu().numpy()
    pick = torch.as_tensor(_judged(users, mix["sample"], seed), device=dev)
    out["judged"] = {"queries": pool[flat_idx[pick]],
                     "ids": flat_ids[pick], "scores": flat_sc[pick]}
    return out


def run_online(system, inputs, mix: dict, seconds: float, trace: bool,
               seed: int, setup) -> dict:
    from repro_torch.serving import ContinuousRuntime
    dev = system.device
    rt = ContinuousRuntime(system.engine, system.params, system.store,
                           system.neighbors,
                           query_dim=inputs.queries.shape[1],
                           entry=system.entry, device=system.device,
                           **mix["runtime"])
    queries = inputs.queries.cpu().numpy()
    rt.warmup(queries[0])          # captures the lane reset and the tick
    _sync(dev)
    setup.mark("capture_warmup")

    rng = data_lib.host_rng(seed, data_lib.ARRIVALS)
    due = generator.arrivals(mix, seconds, rng)
    n_window = len(due)
    if trace:
        extra = generator.arrivals(mix, mix["trace_s"], rng) + seconds
        due = np.concatenate([due, extra])
    if len(due) > len(queries):
        raise ValueError(f"{len(due)} requests, {len(queries)} queries")
    settle()
    setup_s = setup.finish()

    # the answers as they come back, kept in arrays (no per-request
    # objects survive the round)
    k = system.config["search"]["k"]
    ids = np.full((n_window, k), -1, np.int64)
    scores = np.zeros((n_window, k), np.float32)
    lat = np.full((n_window,), np.inf)
    queue_ms = np.full((n_window,), np.nan)
    work = np.zeros((n_window, 3), np.int64)

    def keep(completions, t_back: float) -> None:
        """``t_back``: the harness's clock once the round that harvested
        them has returned, the answers on the host; a latency runs from
        the request's due time to it."""
        for c in completions:
            if 0 <= c.rid < n_window and c.status == "ok":
                ids[c.rid], scores[c.rid] = c.ids, c.scores
                lat[c.rid] = (t_back - t0 - due[c.rid]) * 1e3
                queue_ms[c.rid] = c.record.queue_ms
                work[c.rid] = (c.n_eval, c.n_grad, c.n_iters)

    reduced = {}
    tracer = None
    rounds = 0
    occupancy = None
    i, n = 0, len(due)
    t0 = time.perf_counter()
    t_close = t0 + seconds
    t_give_up = t_close + DRAIN_S + (mix["trace_s"] if trace else 0.0)
    while True:
        now = time.perf_counter()
        if occupancy is None and now >= t_close:
            occupancy = rt.metrics.occupancy
            if trace:
                tracer = trace_lib.traced(dev, reduced)
                tracer.__enter__()
        while i < n and t0 + due[i] <= now:
            rt.submit(queries[i], rid=i, t_arrive=t0 + due[i])
            i += 1
        if i >= n and not rt.queue and not rt.in_flight:
            break
        if now > t_give_up:
            break
        if not rt.queue and not rt.in_flight:
            time.sleep(min(t0 + due[i] - now, 0.005))
            continue
        rt.step_once()
        keep(rt.pop_completions(), time.perf_counter())
        if now < t_close:
            rounds += 1
    if occupancy is None:
        occupancy = rt.metrics.occupancy
    if tracer is not None:
        _sync(dev)
        tracer.__exit__(None, None, None)

    ok = np.flatnonzero(np.isfinite(lat))
    missing = n_window - len(ok)
    out = {"kind": "online", "window_s": seconds, "setup_s": setup_s,
           "attempted": n_window, "completed": len(ok), "failed": missing,
           "missing": missing, "latency_ms": lat,
           "queue_ms": queue_ms[ok], "occupancy": occupancy,
           "rounds": rounds, "trace": reduced if trace else None}
    out["n_eval"], out["n_grad"], out["n_iters"] = (
        float(v) for v in work[ok].sum(0))
    users = inputs.order[:n_window].cpu().numpy()[ok]
    pick = torch.as_tensor(ok[_judged(users, mix["sample"], seed)],
                           device=dev)
    out["judged"] = {"queries": inputs.queries[pick],
                     "ids": torch.as_tensor(ids, device=dev)[pick],
                     "scores": torch.as_tensor(scores, device=dev)[pick]}
    return out


DRIVERS = {"bulk": run_bulk, "online": run_online}
