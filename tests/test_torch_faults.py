"""The port's fault-domain serving against the JAX package on the CPU.

Host modules, exactly equal to the JAX ones on the same inputs:
``FaultPlan`` firing sequences (and plans saved by either package load in
the other), ``CircuitBreaker``, ``StragglerMonitor`` and
``ShardHealthTracker`` state sequences under the same scripted failures,
successes and tick times.

Within the port, bit for bit: ``ShardedContinuousRuntime`` equals the
one-shot ``sharded_search_stores`` on the same index (ids, scores;
n_eval / n_grad summed, n_iters the max), the per-rid merge equals the
JAX runtime's, and after ``install_index`` the answers equal a fresh
runtime's on the new index. Against JAX: the
sharded continuous recall@10 within 0.01 of the JAX
``ShardedContinuousRuntime``'s. Behaviour as the JAX fault tests, without
the pager: one shard down gives ``partial`` answers and recovers, all down
gives ``failed``, shedding and drain, the health line; a kernel's or the
card's error in a shard's tick propagates, from a round and from
``warmup``, and is not a strike.
"""
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import (EngineOptions as JOptions,  # noqa: E402
                        SearchConfig as JConfig,
                        brute_force_topk as j_brute_force_topk,
                        build_engine as j_build_engine,
                        make_family_measure as j_make_family_measure)
from repro.core import sharded as jsharded  # noqa: E402
from repro.ft import straggler as jstraggler  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import health as jhealth  # noqa: E402
from repro.serving import runtime as jruntime  # noqa: E402
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              ShardedIndex, build_engine,
                              make_family_measure, merge_topk,
                              params_from_jax, recall,
                              sharded_search_stores)
from repro_torch.ft import (CircuitBreaker, StragglerAction,  # noqa: E402
                            StragglerMonitor)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.obs import Registry  # noqa: E402
from repro_torch.serving import (ContinuousRuntime, FaultEvent,  # noqa: E402
                                 FaultPlan, InjectedFault, InjectedKill,
                                 Request, ShardedContinuousRuntime,
                                 ShardHealthTracker)
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving.runtime import SHARD_FAULTS, _merge_one  # noqa: E402
from repro.obs import Registry as JRegistry  # noqa: E402

N, D, Q = 1203, 40, 24
CFG = dict(k=5, ef=24, budget=6, alpha=1.1)
PATHS = {
    "deepfm-unfused-f32": ("deepfm", {}),
    "deepfm-fused-int8": ("deepfm", dict(fused=True, corpus_dtype="int8")),
    "mlp-fused-int8": ("mlp", dict(fused=True, corpus_dtype="int8")),
}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Many small ops: spinning BLAS threads under xdist workers cost more
    than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_measure(family, jm):
    np_tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = make_family_measure(family, torch.Generator(), D, device="cpu")
    if family == "deepfm":
        return dataclasses.replace(tm, params={
            "mlp": params_from_jax(np_tree["mlp"], device="cpu")})
    return dataclasses.replace(tm, params=params_from_jax(np_tree,
                                                          device="cpu"))


def _port_index(jidx):
    return ShardedIndex(base=jidx.base, neighbors=jidx.neighbors,
                        entries=jidx.entries, global_ids=jidx.global_ids,
                        n_shards=jidx.n_shards)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(23)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    jidx = {S: jsharded.build_sharded_index(base, n_shards=S, m=8,
                                            k_construction=24, seed=3)
            for S in (2, 4)}
    jms = {f: j_make_family_measure(f, jax.random.PRNGKey(1), D)
           for f in ("deepfm", "mlp")}
    return dict(base=base, queries=queries, jidx=jidx, jms=jms,
                tms={f: _port_measure(f, m) for f, m in jms.items()},
                idx={S: _port_index(j) for S, j in jidx.items()})


def _engine(system, path="deepfm-fused-int8"):
    family, opts = PATHS[path]
    m = system["tms"][family]
    return build_engine(m, SearchConfig(**CFG), EngineOptions(**opts)), m


def _sharded(system, S=2, path="deepfm-fused-int8", **kw):
    eng, m = _engine(system, path)
    kw.setdefault("n_lanes", 4)
    kw.setdefault("steps_per_tick", 2)
    return ShardedContinuousRuntime(eng, m.params, system["idx"][S],
                                    query_dim=D, devices=["cpu"], **kw)


def _drive(rt, queries, per_round=2):
    """Paced submits: ``per_round`` per scheduler round, so outages
    and recoveries meet fresh traffic."""
    i, done = 0, {}
    while i < len(queries) or rt.in_flight or rt.queued or rt._partial \
            or any(r.completions for r in rt.runtimes):
        for _ in range(per_round):
            if i < len(queries):
                rt.submit(queries[i], rid=i)
                i += 1
        for c in rt.step_once():
            assert c.rid not in done, f"rid {c.rid} resolved twice"
            done[c.rid] = c
    return done


# ---------------------------------------------------------------------------
# host modules against the JAX ones
# ---------------------------------------------------------------------------

PLANS = {
    "rate": [dict(kind="slow_tick", site="shard:0/tick", start=2, count=40,
                  rate=0.3, seconds=0.5),
             dict(kind="shard_crash", site="shard:1/tick", start=5,
                  count=20, rate=0.5)],
    "wildcard": [dict(kind="shard_stall", site="*", start=3, count=4),
                 dict(kind="shard_crash", site="*", start=9, count=2),
                 dict(kind="page_io_error", site="*", start=1, count=6,
                      rate=0.6)],
    "pager": [dict(kind="page_io_error", site="pager", start=0, count=7,
                   rate=0.7),
              dict(kind="page_io_error", site="pager/whole", start=2,
                   count=3)],
    "kill": [dict(kind="kill", site="mutate/post-journal", start=1,
                  count=2),
             dict(kind="kill", site="*", start=6, count=1)],
}


def _fire(mod, plan, n=60):
    """Every hook kind's outcome per invocation, as plain data."""
    out = []
    for site in ("shard:0/tick", "shard:1/tick", "tick"):
        hook = plan.tick_hook(site)
        for _ in range(n):
            try:
                out.append((site, hook()))
            except mod.InjectedFault as e:
                out.append((site, "crash", e.kind, e.site, e.index))
    pager = plan.pager_hook()
    for i in range(n):
        try:
            pager(i % 5 - 1, i % 3)
            out.append(("pager", None))
        except OSError as e:
            out.append(("pager", str(e)))
    kill = plan.kill_hook()
    for i in range(n):
        stage = jfaults.MUTATION_STAGES[i % 4]
        try:
            kill(stage)
            out.append((stage, None))
        except mod.InjectedKill as e:
            out.append((stage, e.kind, e.site, e.index))
    return out


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_fires_as_jax(name, seed):
    got = _fire(tfaults, FaultPlan([FaultEvent(**e) for e in PLANS[name]],
                                   seed=seed))
    want = _fire(jfaults, jfaults.FaultPlan(
        [jfaults.FaultEvent(**e) for e in PLANS[name]], seed=seed))
    assert got == want
    assert any(len(x) > 2 or x[1] not in (None, 0.0) for x in got)


def test_fault_plan_json_across_packages(tmp_path):
    events = [e for evs in PLANS.values() for e in evs]
    ours = FaultPlan([FaultEvent(**e) for e in events], seed=11)
    theirs = jfaults.FaultPlan([jfaults.FaultEvent(**e) for e in events],
                               seed=11)
    ours.save(str(tmp_path / "a.json"))
    theirs.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    into_jax = jfaults.FaultPlan.load(str(tmp_path / "a.json"))
    into_port = FaultPlan.load(str(tmp_path / "b.json"))
    assert into_port.to_dict() == into_jax.to_dict() == ours.to_dict()
    assert _fire(tfaults, into_port) == _fire(jfaults, into_jax)


def test_fault_event_validation_and_exceptions():
    for bad in (dict(kind="meteor"), dict(kind="kill", start=-1),
                dict(kind="kill", rate=1.5)):
        with pytest.raises(ValueError):
            FaultEvent(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultEvent(**bad)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.TICK_KINDS == jfaults.TICK_KINDS
    assert tfaults.MUTATION_STAGES == jfaults.MUTATION_STAGES
    e = InjectedKill("kill", "mutate/pre-save", 3)
    assert isinstance(e, InjectedFault) and isinstance(e, RuntimeError)
    assert str(e) == str(jfaults.InjectedKill("kill", "mutate/pre-save", 3))


def _breaker_trace(cls, script, k, cooldown):
    b = cls(k_failures=k, cooldown=cooldown)
    out = []
    for op in script:
        r = None
        if op == 0:
            r = b.record_failure()
        elif op == 1:
            b.record_success()
        else:
            b.tick()
        out.append((r, b.state, b.failures, b.n_opened, b._cooldown_left,
                    b.serving))
    return out


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_circuit_breaker_matches_jax(seed):
    r = np.random.default_rng(seed)
    script = r.integers(0, 3, size=80).tolist()
    k, cooldown = int(r.integers(1, 5)), int(r.integers(1, 6))
    assert _breaker_trace(CircuitBreaker, script, k, cooldown) == \
        _breaker_trace(jstraggler.CircuitBreaker, script, k, cooldown)
    with pytest.raises(ValueError):
        CircuitBreaker(k_failures=0)


def _monitor_trace(cls, steps, **kw):
    m = cls(5, **kw)
    out = []
    for times in steps:
        a = m.record_step(times)
        out.append((a.kind, a.hosts, a.reason, sorted(m.flagged),
                    dict(m.slow_streak), m.healthy_hosts()))
    return out


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_straggler_monitor_matches_jax(seed):
    r = np.random.default_rng(seed)
    steps = []
    for _ in range(40):
        hosts = sorted(r.choice(5, size=int(r.integers(1, 6)),
                                replace=False).tolist())
        steps.append({h: float(r.choice([1.0, 1.1, 4.0, 9.0]))
                      for h in hosts})
    kw = dict(threshold=float(r.choice([1.5, 3.0])),
              patience=int(r.integers(1, 4)), reshard_frac=0.05)
    assert _monitor_trace(StragglerMonitor, steps, **kw) == \
        _monitor_trace(jstraggler.StragglerMonitor, steps, **kw)
    assert StragglerAction("none", []) == StragglerAction("none", [])


def _health_trace(cls, script, S):
    h = cls(S, k_failures=2, cooldown_rounds=3, straggler_threshold=3.0,
            straggler_patience=2)
    out = []
    for op, arg in script:
        r = None
        if op == "round":
            h.on_round()
        elif op == "fail":
            r = h.record_failure(arg, "x")
        elif op == "ok":
            h.record_success(*arg)
        else:
            a = h.record_tick_times(arg)
            r = (a.kind, a.hosts)
        out.append((r, h.states(), h.n_opened,
                    [h.serving(s) for s in range(S)], dict(h.last_reason)))
    return out


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_shard_health_tracker_matches_jax(seed):
    r = np.random.default_rng(seed)
    S = 4
    script = []
    for _ in range(60):
        op = str(r.choice(["round", "fail", "ok", "times"]))
        s = int(r.integers(0, S))
        arg = (s if op == "fail" else (s, bool(r.integers(0, 2)))
               if op == "ok" else
               {h: float(r.choice([1.0, 1.2, 5.0])) for h in range(S)
                if r.random() < 0.8} if op == "times" else None)
        script.append((op, arg))
    assert _health_trace(ShardHealthTracker, script, S) == \
        _health_trace(jhealth.ShardHealthTracker, script, S)


def test_shard_health_registry_matches_jax():
    regs = []
    for cls, reg in ((ShardHealthTracker, Registry()),
                     (jhealth.ShardHealthTracker, JRegistry())):
        h = cls(3, k_failures=1, cooldown_rounds=2)
        h.bind_registry(reg)
        h.record_failure(1, "crash")
        h.record_failure(2, "crash")
        h.on_round()
        h.on_round()
        h.record_success(2)
        regs.append((reg.render_text(), reg.render_json_str()))
    assert regs[0] == regs[1]
    assert 'repro_health_shard_state{shard="1"} 2' in regs[0][0]


# ---------------------------------------------------------------------------
# the sharded runtime: bit for bit within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_continuous_matches_oneshot(system, path):
    """Through 4 lanes per shard, every rid equals the one-shot sharded
    search of its query: ids, scores, summed n_eval / n_grad, max
    n_iters."""
    eng, m = _engine(system, path)
    idx = system["idx"][4]
    ref = sharded_search_stores(
        m, idx.stores(eng.corpus_dtype, ["cpu"]), idx,
        torch.from_numpy(system["queries"]), SearchConfig(**CFG),
        EngineOptions(**PATHS[path][1]))
    rt = _sharded(system, 4, path, steps_per_tick=3)
    order = np.random.default_rng(3).permutation(Q)
    comps = rt.run_stream([Request(rid=int(i), query=system["queries"][i])
                           for i in order], realtime=False)
    by = {c.rid: c for c in comps}
    assert sorted(by) == list(range(Q))
    for i in range(Q):
        c = by[i]
        assert c.status == "ok" and not c.partial and c.epoch == 0
        np.testing.assert_array_equal(c.ids, ref.ids[i].numpy())
        np.testing.assert_array_equal(c.scores, ref.scores[i].numpy())
        assert (c.n_eval, c.n_grad, c.n_iters) == (
            int(ref.n_eval[i]), int(ref.n_grad[i]), int(ref.n_iters[i]))
    assert rt.health.n_opened == 0
    assert all(r.program.runs["tick"] > 0 for r in rt.runtimes)
    s = rt.metrics.summary()
    assert s["n_completed"] == Q and 0 < s["occupancy"] <= 1


def test_merge_one_matches_jax():
    """The per-rid merge over a rid's live parts equals the JAX runtime's
    ``_merge_one`` bit for bit (ties, -1 ids, -inf scores, one to four
    live parts)."""
    r = np.random.default_rng(5)
    k = 6
    for _ in range(40):
        parts = []
        for s in range(int(r.integers(1, 5))):
            ids = r.permutation(1000)[:k] + 1000 * s
            scores = (r.integers(0, 4, size=k) / 4).astype(np.float32)
            if r.random() < 0.3:
                ids[r.integers(0, k):] = -1
            if r.random() < 0.2:
                scores[r.integers(0, k):] = -np.inf
            parts.append((ids.astype(np.int64), scores))
        got_ids, got_scores = _merge_one(parts, k)
        want_ids, want_scores = jruntime._merge_one(
            jnp.asarray(np.stack([p[0] for p in parts]).astype(np.int32)
                        )[None],
            jnp.asarray(np.stack([p[1] for p in parts]))[None], k)
        np.testing.assert_array_equal(got_ids, np.asarray(want_ids)[0])
        np.testing.assert_array_equal(got_scores, np.asarray(want_scores)[0])
    ids0, _ = merge_topk(torch.full((1, 4, k), -1), torch.zeros(1, 4, k), k)
    assert (ids0 == -1).all()


def test_sharded_install_index_epochs(system):
    """A second index (the same corpus, another partition seed) staged
    mid-stream: completions carry epochs 0 and 1, the first epoch's ids
    map through its own global ids, and the post-swap answers equal a
    fresh runtime's on the new index; each epoch captures (on the card)
    its own two programs, the old ones dropped."""
    other = _port_index(jsharded.build_sharded_index(
        system["base"], n_shards=2, m=8, k_construction=24, seed=9))
    qs = system["queries"]
    fresh = {c.rid: c for c in _sharded(system).run_stream(
        [Request(rid=i, query=qs[i]) for i in range(Q)], realtime=False)}
    eng, m = _engine(system)
    want_new = {c.rid: c for c in ShardedContinuousRuntime(
        eng, m.params, other, 4, D, steps_per_tick=2,
        devices=["cpu"]).run_stream(
        [Request(rid=i, query=qs[i]) for i in range(Q)], realtime=False)}
    rt = _sharded(system)
    for i in range(8):
        rt.submit(qs[i], rid=i)
    rt.step_once()
    assert rt.install_index(other) == 1
    programs = [r.program for r in rt.runtimes]
    for i in range(8, Q):
        rt.submit(qs[i], rid=i)
    done = {}
    while len(done) < Q:
        for c in rt.step_once():
            done[c.rid] = c
    assert {c.epoch for c in done.values()} == {0, 1}
    for rid, c in done.items():
        assert c.status == "ok"
        want = fresh[rid] if c.epoch == 0 else want_new[rid]
        np.testing.assert_array_equal(c.ids, want.ids)
        np.testing.assert_array_equal(c.scores, want.scores)
    # the 4 admitted before the install finish on epoch 0; the queued
    # ones wait for the swap
    assert [done[r].epoch for r in range(Q)] == [0] * 4 + [1] * (Q - 4)
    for r, old in zip(rt.runtimes, programs):
        assert r.epoch == 1 and r.program is not old
        assert r.epoch_captures == [()]   # the CPU runs eagerly
    with pytest.raises(ValueError, match="shards"):
        rt.install_index(system["idx"][4])


def test_single_install_index_and_fail_all_in_place(system):
    """The single runtime: fail_all parks every lane by writing the idle
    state into the program's own tensors; install_index swaps in a new
    store and graph once the lanes drain."""
    eng, m = _engine(system)
    idx = system["idx"][2]
    stores = idx.stores(eng.corpus_dtype, ["cpu"])
    nbrs = [idx.placed(s, "cpu")[0] for s in range(2)]
    rt = ContinuousRuntime(eng, m.params, stores[0], nbrs[0], n_lanes=3,
                           query_dim=D, entry=int(idx.entries[0]),
                           steps_per_tick=2, device="cpu")
    qs = system["queries"]
    for i in range(5):
        rt.submit(qs[i], rid=i)
    rt.step_once()
    ptrs = [t.data_ptr() for t in rt.program.state]
    failed = rt.fail_all()
    assert sorted(c.rid for c in failed) == list(range(5))
    assert all(c.status == "failed" and (c.ids == -1).all() for c in failed)
    assert [t.data_ptr() for t in rt.program.state] == ptrs
    assert bool(rt.program.state.done.all()) and rt.in_flight == 0
    assert rt.metrics.summary()["n_failed"] == 5
    want = ContinuousRuntime(eng, m.params, stores[1], nbrs[1], n_lanes=3,
                             query_dim=D, entry=int(idx.entries[1]),
                             steps_per_tick=2, device="cpu").run_stream(
        [Request(rid=i, query=qs[i]) for i in range(6)], realtime=False)
    rt.pop_completions()
    assert rt.install_index(stores[1], nbrs[1], int(idx.entries[1])) == 1
    got = rt.run_stream([Request(rid=i, query=qs[i]) for i in range(6)],
                        realtime=False)
    for a, b in zip(sorted(got, key=lambda c: c.rid),
                    sorted(want, key=lambda c: c.rid)):
        assert a.epoch == 1 and b.epoch == 0
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_sharded_recall_matches_jax(system):
    """The sharded continuous recall@10 against brute force, within 0.01
    of the JAX ShardedContinuousRuntime's on the same index, queries and
    weights (DeepFM, f32)."""
    S, k = 4, 10
    jidx, jm = system["jidx"][S], system["jms"]["deepfm"]
    qs = system["queries"]
    truth = np.asarray(j_brute_force_topk(jm, jnp.asarray(system["base"]),
                                          jnp.asarray(qs), k)[0])
    jeng = j_build_engine(jm, JConfig(k=k, ef=32, budget=8, alpha=1.05),
                          JOptions())
    jrt = jruntime.ShardedContinuousRuntime(jeng, jm.params, jidx,
                                            n_lanes=8, query_dim=D,
                                            steps_per_tick=4)
    jby = {c.rid: c for c in jrt.run_stream(
        [jruntime.Request(rid=i, query=qs[i]) for i in range(Q)],
        realtime=False)}
    tm = system["tms"]["deepfm"]
    eng = build_engine(tm, SearchConfig(k=k, ef=32, budget=8, alpha=1.05),
                       EngineOptions())
    rt = ShardedContinuousRuntime(eng, tm.params, system["idx"][S], 8, D,
                                  steps_per_tick=4, devices=["cpu"])
    by = {c.rid: c for c in rt.run_stream(
        [Request(rid=i, query=qs[i]) for i in range(Q)], realtime=False)}
    want = recall(np.stack([np.asarray(jby[i].ids) for i in range(Q)]),
                  truth)
    got = recall(np.stack([by[i].ids for i in range(Q)]), truth)
    assert got > 0.5 and abs(got - want) <= 0.01, (got, want)


# ---------------------------------------------------------------------------
# behaviour under faults (the JAX fault tests, without the pager)
# ---------------------------------------------------------------------------

def test_one_shard_down_partial_and_recovers(system):
    qs = np.random.default_rng(3).normal(size=(40, D)).astype(np.float32)
    ref = _drive(_sharded(system), qs)
    plan = FaultPlan([FaultEvent("shard_crash", site="shard:1/tick",
                                 start=4, count=3)], seed=0)
    rt = _sharded(system, k_failures=3, cooldown_rounds=4, fault_plan=plan)
    got = _drive(rt, qs)
    assert set(got) == set(range(40))
    statuses = Counter(c.status for c in got.values())
    assert statuses["partial"] > 0 and statuses["ok"] > 0
    assert rt.health.n_opened >= 1
    assert rt.health.states() == ["healthy", "healthy"]   # re-admitted
    shard0 = set(system["idx"][2].global_ids[0].tolist())
    for rid, c in got.items():
        if c.status == "ok":
            np.testing.assert_array_equal(c.ids, ref[rid].ids)
            np.testing.assert_array_equal(c.scores, ref[rid].scores)
        else:
            assert c.status == "partial" and c.partial and c.record.partial
            live = c.ids[c.ids >= 0]
            assert live.size and set(live.tolist()) <= shard0
    assert rt.metrics.summary()["n_partial"] == statuses["partial"]


def test_all_shards_down_resolve_failed(system):
    plan = FaultPlan([FaultEvent("shard_crash", site=f"shard:{s}/tick",
                                 start=0, count=50) for s in range(2)])
    rt = _sharded(system, k_failures=1, cooldown_rounds=100,
                  fault_plan=plan)
    got = _drive(rt, system["queries"][:4])
    assert len(got) == 4
    for c in got.values():
        assert c.status == "failed" and c.record.failed
        assert (c.ids == -1).all() and (c.scores == -np.inf).all()
    assert rt.metrics.summary()["n_failed"] == 4
    assert rt.health.states() == ["open", "open"]


def test_stall_and_slow_tick_under_deadline(system):
    """A stall reports an infinite tick: a strike under tick_deadline_s
    (the shard's work stays and is retried); a slow tick under the
    deadline is a straggler, not a strike."""
    plan = FaultPlan([FaultEvent("shard_stall", site="shard:1/tick",
                                 start=2, count=1),
                      FaultEvent("slow_tick", site="shard:0/tick", start=1,
                                 count=2, seconds=0.5)])
    rt = _sharded(system, tick_deadline_s=5.0, k_failures=2,
                  fault_plan=plan)
    got = _drive(rt, system["queries"][:12])
    assert Counter(c.status for c in got.values()) == Counter({"ok": 12})
    assert rt.health.n_opened == 0
    assert rt.health.last_reason == {1: "tick infs > deadline 5.0s"}
    assert rt.health.states() == ["healthy", "healthy"]


def test_sharded_shed_and_close(system):
    rt = _sharded(system, n_lanes=2, max_queue=2)
    for i in range(6):
        rt.submit(system["queries"][i], rid=i)
    done = {c.rid: c for c in rt.pop_completions()}
    assert sum(c.status == "shed" for c in done.values()) == 4
    while len(done) < 6:
        for c in rt.step_once():
            done[c.rid] = c
    assert Counter(c.status for c in done.values()) \
        == Counter({"shed": 4, "ok": 2})
    rt.pop_completions()
    rt.close()
    assert rt.submit(system["queries"][0], rid=99) == 99
    assert rt.pop_completions()[-1].status == "shed"
    assert rt.metrics.summary()["n_shed"] == 5


def test_health_line_mentions_shard_states(system):
    rt = _sharded(system)
    line = rt.format_health()
    assert "shards=[healthy,healthy]" in line and "shed=0" in line
    assert rt.health_snapshot()["breaker_opens"] == 0


def _build_error(monkeypatch):
    """The kernel library's build without nvcc: ``_lib.build`` raises."""
    monkeypatch.setattr(_lib.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    _lib.build(force=True)


def _argument_error(monkeypatch):
    """A kernel wrapper's argument check refusing a tensor."""
    _lib.require(torch.zeros(3), "deepfm_score_fused", torch.device("meta"),
                 (3,))


def _raises(make):
    def fn(monkeypatch):
        raise make()
    return fn


# errors a shard's round may raise that are not the shard's own fault
KERNEL_ERRORS = {
    "launch": _raises(lambda: _lib.CudaKernelError(
        "deepfm_score_fused: CUDA error 700 (an illegal memory access)")),
    "build": _build_error,
    "argument": _argument_error,
    "accelerator": _raises(lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered")),
    "capture": _raises(lambda: RuntimeError("CUDA graph capture failed")),
}


def _raised(fn, monkeypatch):
    with pytest.raises(Exception) as info:
        fn(monkeypatch)
    return type(info.value)


@pytest.mark.parametrize("kind", list(KERNEL_ERRORS))
def test_device_error_propagates_and_is_not_a_strike(system, kind,
                                                     monkeypatch):
    """A kernel's build, launch or argument error, or the card's, from a
    shard's tick leaves ``step_once`` and ``warmup`` and strikes nothing;
    an injected fault or an OSError in the same place is a strike."""
    err = _raised(KERNEL_ERRORS[kind], monkeypatch)
    assert not issubclass(err, SHARD_FAULTS)
    rt = _sharded(system)
    tick = rt.runtimes[1]._tick
    rt.runtimes[1]._tick = lambda: KERNEL_ERRORS[kind](monkeypatch)
    with pytest.raises(err):
        rt.warmup(system["queries"][0])
    for i in range(4):
        rt.submit(system["queries"][i], rid=i)
    with pytest.raises(err):
        rt.step_once()
    assert rt.health.breakers[1].failures == 0 and rt.health.n_opened == 0
    assert not rt.health.last_reason
    for fault in (OSError("disk"), InjectedFault("shard_crash", "x", 0)):
        def other(fault=fault):
            raise fault
        rt.runtimes[1]._tick = other
        rt.step_once()
    assert rt.health.breakers[1].failures == 2
    rt.runtimes[1]._tick = tick


def test_warmup_requires_an_ok_sentinel(system):
    """A runtime that cannot answer its warmup sentinel raises instead of
    serving: the single runtime when closed (the sentinel is shed), the
    sharded one when a shard's tick keeps failing."""
    rt = _sharded(system)
    rt.runtimes[0].close()
    with pytest.raises(RuntimeError, match="sentinel request resolved as"):
        rt.warmup(system["queries"][0])

    def crash():
        raise InjectedFault("shard_crash", "shard:0/tick", 0)
    rt = _sharded(system)
    rt.runtimes[0]._tick = crash
    with pytest.raises(InjectedFault):
        rt.warmup(system["queries"][0])
    assert rt.health.n_opened == 0 and not rt.health.last_reason


def test_shared_fns_refused_by_name(system):
    eng, m = _engine(system)
    idx = system["idx"][2]
    with pytest.raises(ValueError, match="bound to their own runtime"):
        ContinuousRuntime(eng, m.params, idx.stores("int8", ["cpu"])[0],
                          idx.placed(0, "cpu")[0], n_lanes=2, query_dim=D,
                          shared_fns=(None, None), device="cpu")


def test_plan_json_drives_the_sharded_runtime(system, tmp_path):
    """The same JSON plan, loaded by each package, fires the same tick
    faults in the port's sharded runtime as in a direct replay."""
    path = str(tmp_path / "plan.json")
    jfaults.FaultPlan([jfaults.FaultEvent(
        "shard_crash", site="shard:0/tick", start=1, count=2)]).save(path)
    assert json.loads(open(path).read())["events"][0]["site"] == \
        "shard:0/tick"
    rt = _sharded(system, k_failures=5, fault_plan=FaultPlan.load(path))
    got = _drive(rt, system["queries"][:10])
    assert all(c.status == "ok" for c in got.values())
    assert rt.health.last_reason[0].startswith("InjectedFault(")
