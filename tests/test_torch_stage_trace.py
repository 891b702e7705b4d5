"""The port's spans inside its programs (``obs/phases.py``): the engine's
timed chunks (``core/engine.py`` ``STAGES``, ``stats``) and the serving
round's phases and counters (``serving/runtime.py``), on the CPU, where
the marks are host stamps in the eager runs; the ``cuda`` test holds the
captured timed graph on a card.

A tracer changes what is measured, never what is computed: the timed
program returns the untimed one's ids, scores and counters bit for bit,
and with no tracer (or one switched off) nothing is marked.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              build_engine, make_corpus_store,
                              make_family_measure)
from repro_torch.core.engine import STAGES  # noqa: E402
from repro_torch.graph import build_l2_graph  # noqa: E402
from repro_torch.obs import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.serving import ContinuousRuntime  # noqa: E402
from repro_torch.serving.runtime import ROUND_PHASES  # noqa: E402

N, D, Q = 1000, 40, 16
CFG = SearchConfig(k=10, ef=32, budget=8, alpha=1.01)
PATHS = {"unfused": EngineOptions(), "fused": EngineOptions(fused=True)}
FAMILIES = ("deepfm", "mlp")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops (as the program tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(35)
    base = rng.normal(size=(N, D)).astype(np.float32)
    graph = build_l2_graph(base, m=12, k_construction=48, device="cpu")
    measures = {f: make_family_measure(f, torch.Generator().manual_seed(3),
                                       D, device="cpu") for f in FAMILIES}
    return {"base": torch.from_numpy(base), "graph": graph,
            "nbrs": torch.as_tensor(graph.neighbors),
            "queries": rng.normal(size=(Q, D)).astype(np.float32),
            "measures": measures}


def _engine(system, family, path, tracer=NULL_TRACER, **replace):
    """A private copy of the cached engine (its own programs and stats),
    holding ``tracer``."""
    m = system["measures"][family]
    eng = dataclasses.replace(build_engine(m, CFG, PATHS[path]), **replace)
    eng.set_tracer(tracer)
    store = make_corpus_store(system["base"], eng.corpus_dtype, device="cpu")
    return eng, m, store


def _search(system, eng, m, store):
    return eng.search(m.params, store, system["nbrs"],
                      torch.from_numpy(system["queries"]),
                      torch.full((Q,), system["graph"].entry))


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("family", FAMILIES)
def test_timed_search_equals_untimed(system, family, path):
    """Tracer on = tracer off = no tracer, bit for bit (ids, scores,
    n_eval, n_grad, n_iters); the timed chunks mark the seven stages, a
    call per step (per chunk for copy_back), one gap per chunk; off, or
    without a tracer, nothing is marked and no span is emitted."""
    plain, m, store = _engine(system, family, path)
    ref = _search(system, plain, m, store)
    assert plain.stats["programs"] == 1
    assert all(plain.stats["stage_calls." + s] == 0 for s in STAGES)
    tr = Tracer(sample=None)
    eng, _, _ = _engine(system, family, path, tr)
    tr.enabled = False
    _same(_search(system, eng, m, store), ref)
    assert eng.stats["programs"] == 2          # the timed one beside it
    assert eng.stats["stage_calls.pop"] == 0 and not tr.spans()
    tr.enabled = True
    st0 = dict(eng.stats)
    _same(_search(system, eng, m, store), ref)
    st = {k: eng.stats[k] - st0[k] for k in st0}
    assert eng.stats["programs"] == 2
    chunks = st["runs"] - 1
    assert chunks >= 1 and st["steps"] == 8 * chunks
    for name in STAGES:
        assert st["stage_calls." + name] == (
            chunks if name == "copy_back" else st["steps"]), name
        assert st["stage_s." + name] >= 0.0
    assert st["chunk_gaps"] == chunks and st["chunk_gap_s"] >= 0.0
    assert st["issue_s"] == pytest.approx(st["load_s"] + st["launch_s"])
    names = [sp.name for sp in tr.spans(site="engine")]
    assert names[:2] == ["load", "launch"]
    assert names.count("sync") == chunks
    tr.enabled = False
    _same(_search(system, eng, m, store), ref)
    assert eng.stats["stage_calls.pop"] == st["stage_calls.pop"]


def test_stages_tile_each_eager_chunk(system):
    """The seven stages of each eager chunk add up to 90-100% of the
    chunk's run, timed around it."""
    eng, m, store = _engine(system, "deepfm", "fused", Tracer(sample=None))
    _search(system, eng, m, store)
    prog = eng.search_program(m.params, store, system["nbrs"],
                              torch.from_numpy(system["queries"]),
                              timed=True)
    assert sorted(prog.marks) == ["chunk", "chunk.alt"]
    run = prog.run
    shares = []

    def timed_run(name):
        t0 = time.perf_counter()
        run(name)
        wall = time.perf_counter() - t0
        if name in prog.marks:
            got = prog.marks[name].read()
            assert [n for n, _ in got] == list(STAGES[:-1]) * 8 + \
                ["copy_back"]
            shares.append(sum(s for _, s in got) / wall)
    prog.run = timed_run
    _search(system, eng, m, store)
    assert shares and all(0.9 <= s <= 1.0 for s in shares), shares


def test_planted_grad_sleep_moves_only_grad(system):
    """5 ms slept inside the grad stage shows in ``stage_s.grad`` (at least
    5 ms a step more) and moves no other stage by 1 ms a step."""
    tr = Tracer(sample=None)
    fast, m, store = _engine(system, "deepfm", "unfused", tr)
    grad = fast.grad

    def slow_grad(*args):
        time.sleep(0.005)
        return grad(*args)
    slow, _, _ = _engine(system, "deepfm", "unfused", tr, grad=slow_grad)
    per_step = []
    for eng in (fast, slow):
        _search(system, eng, m, store)
        st = eng.stats
        per_step.append({s: st["stage_s." + s] / st["stage_calls.pop"]
                         for s in STAGES})
    assert per_step[1]["grad"] - per_step[0]["grad"] >= 0.005
    for s in STAGES:
        if s != "grad":
            assert abs(per_step[1][s] - per_step[0][s]) < 0.001, s


def _runtime(system, eng, m, store, **kw):
    return ContinuousRuntime(eng, m.params, store, system["nbrs"],
                             n_lanes=4, query_dim=D,
                             entry=system["graph"].entry, steps_per_tick=3,
                             device="cpu", **kw)


def _drive(rt, queries):
    for i, q in enumerate(queries):
        rt.submit(q, rid=i)
    out, calls = [], 0
    while rt.queue or rt.in_flight:
        out += rt.step_once()
        calls += 1
    return {c.rid: c for c in out}, calls


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("family", FAMILIES)
def test_runtime_traced_equals_untraced(system, family, path):
    """The continuous runtime under a tracer that is on returns what it
    returns without one, bit for bit; its counters are kept either way."""
    eng, m, store = _engine(system, family, path)
    got = []
    for tracer in (NULL_TRACER, Tracer(sample=2)):
        rt = _runtime(system, eng, m, store, tracer=tracer)
        by, calls = _drive(rt, system["queries"])
        assert rt.counters["rounds"] == calls
        got.append(by)
    for rid, c in got[0].items():
        d = got[1][rid]
        assert c.status == d.status == "ok"
        assert np.array_equal(c.ids, d.ids)
        assert np.array_equal(c.scores, d.scores)
        assert (c.n_eval, c.n_grad, c.n_iters) == (d.n_eval, d.n_grad,
                                                   d.n_iters)


def test_runtime_counters(system):
    """rounds = step_once calls, admitted = lanes filled, harvested =
    requests harvested, a reset replay per round that filled a lane and a
    tick per busy round; untraced, no phase seconds."""
    eng, m, store = _engine(system, "mlp", "fused")
    rt = _runtime(system, eng, m, store)
    n_reset = n_tick = 0
    run = rt.program.run

    def counted(name):
        nonlocal n_reset, n_tick
        n_reset += name == "reset"
        n_tick += name == "tick"
        run(name)
    rt.program.run = counted
    by, calls = _drive(rt, system["queries"])
    c = rt.counters
    assert c["rounds"] == calls and c["admitted"] == Q == len(by)
    assert c["harvested"] == Q
    assert (c["resets"], c["ticks"]) == (n_reset, n_tick)
    assert 0 < c["resets"] < c["ticks"] <= calls
    assert rt.traced_rounds == 0
    assert all(v == 0.0 for v in rt.round_s.values())


def test_phases_tile_each_round(system):
    """Traced, each round's four phases are site-scoped spans (site
    ``runtime``) in order, each starting where the one before ended, and
    their seconds are the runtime's ``round_s``; no request is sampled
    by ``Tracer(sample=None)``."""
    eng, m, store = _engine(system, "deepfm", "fused")
    tr = Tracer(sample=None, capacity=1 << 14)
    rt = _runtime(system, eng, m, store, tracer=tr)
    by, calls = _drive(rt, system["queries"])
    assert len(by) == Q and rt.traced_rounds == calls
    spans = tr.spans(site="runtime")
    assert len(spans) == 4 * calls
    assert not [sp for sp in tr.spans() if sp.rid is not None]
    for r in range(calls):
        rnd = spans[4 * r:4 * r + 4]
        assert [sp.name for sp in rnd] == list(ROUND_PHASES)
        assert {sp.attrs["i"] for sp in rnd} == {r + 1}
        for a, b in zip(rnd, rnd[1:]):
            assert a.t1 == b.t0
    for p in ROUND_PHASES:
        assert rt.round_s[p] == pytest.approx(
            sum(sp.t1 - sp.t0 for sp in spans if sp.name == p))
    assert rt.round_s["device"] == 0.0          # no card


def test_done_is_stamped_after_the_harvest_copy(system):
    """A request's ``t_done`` (and so its latency) ends after the harvest
    copy has returned, traced or not."""
    eng, m, store = _engine(system, "deepfm", "unfused")
    for tracer in (NULL_TRACER, Tracer(sample=1)):
        clock = {"t": 0.0}
        rt = _runtime(system, eng, m, store, tracer=tracer,
                      now_fn=lambda: clock["t"])
        fetch = rt._fetch
        copied = []

        def slow_fetch(*args):
            out = fetch(*args)
            clock["t"] += 1.0          # the copy returns a second later
            copied.append(clock["t"])
            return out
        rt._fetch = slow_fetch
        rt.submit(system["queries"][0], rid=0, t_arrive=0.0)
        done = []
        while not done:
            done = rt.step_once()
        assert done[0].record.t_done == copied[-1]
        assert done[0].record.latency_ms == 1e3 * copied[-1]


def test_untraced_paths_enter_no_profiler_range(system, monkeypatch):
    """With no tracer, neither ``search`` nor ``step_once`` enters a
    ``record_function`` range, and the search program holds no marks."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    eng, m, store = _engine(system, "deepfm", "fused")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _search(system, eng, m, store)
    prog = eng.search_program(m.params, store, system["nbrs"],
                              torch.from_numpy(system["queries"]))
    assert prog.marks == {}
    rt = _runtime(system, eng, m, store)
    by, _ = _drive(rt, system["queries"][:6])
    assert len(by) == 6


def test_tracer_sample_none_samples_no_request():
    tr = Tracer(sample=None)
    assert tr.enabled and not any(tr.sampled(r) for r in range(64))
    with pytest.raises(ValueError, match="sample must be"):
        Tracer(sample=0)


@pytest.mark.cuda
def test_timed_graph_equals_untimed_on_card():
    """On the card: the timed program's captured chunk = the untimed one
    bit for bit with the same launches per replay, no event made while the
    tracer is off, and the chunk's stage events within 5% of events
    recorded around its replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the timed graphs run only there")
    dev = torch.device("cuda")
    rng = np.random.default_rng(35)
    n, q = 5000, 64
    base = rng.normal(size=(n, D)).astype(np.float32)
    graph = build_l2_graph(base, m=12, k_construction=48, device=dev)
    nbrs = torch.as_tensor(graph.neighbors, device=dev)
    queries = torch.as_tensor(rng.normal(size=(q, D)).astype(np.float32),
                              device=dev)
    entries = torch.full((q,), graph.entry, device=dev)
    for family in FAMILIES:
        m = make_family_measure(family, torch.Generator().manual_seed(3), D,
                                device=dev)
        eng = dataclasses.replace(build_engine(m, CFG, PATHS["fused"]))
        store = make_corpus_store(torch.as_tensor(base, device=dev),
                                  "float32", device=dev)
        made = []
        event = torch.cuda.Event

        class Counted(event):
            def __new__(cls, *a, **k):
                made.append(1)
                return event.__new__(cls, *a, **k)
        torch.cuda.Event = Counted
        try:
            ref = eng.search(m.params, store, nbrs, queries, entries)
        finally:
            torch.cuda.Event = event
        assert not made
        tr = Tracer(sample=None)
        eng.set_tracer(tr)
        _same(eng.search(m.params, store, nbrs, queries, entries), ref)
        plain = eng.search_program(m.params, store, nbrs, queries)
        timed = eng.search_program(m.params, store, nbrs, queries,
                                   timed=True)
        assert plain.captured == ("init", "chunk")
        assert timed.captured == ("init", "chunk", "chunk.alt")
        for name in ("chunk", "chunk.alt"):
            assert plain.captured_launches("chunk") == \
                timed.captured_launches(name)
        tr.enabled = False
        _same(eng.search(m.params, store, nbrs, queries, entries), ref)
        # the stage events against events around the replay
        timed.load(queries=queries, entries=entries)
        timed.fill(caps=CFG.iters(), taus=0.0)
        timed.run("init")
        a, b = event(enable_timing=True), event(enable_timing=True)
        a.record()
        timed.run("chunk")
        b.record()
        torch.cuda.synchronize()
        stages = sum(s for _, s in timed.marks["chunk"].read())
        around = a.elapsed_time(b) * 1e-3
        assert 0.95 * around <= stages <= around * 1.001, (stages, around)


def test_serve_profile_dir_names_the_search_phases(tmp_path, monkeypatch):
    """``serve --profile-dir`` (oneshot) turns the engine's phases on: the
    profile holds ``repro/load``, ``repro/launch`` and ``repro/sync``; the
    shared engine's tracer is taken away after the run."""
    import json

    from repro_torch.core.engine import ExpansionEngine
    from repro_torch.launch import serve
    given = []
    set_tracer = ExpansionEngine.set_tracer

    def recorded(self, tracer):
        given.append(tracer)
        set_tracer(self, tracer)
    monkeypatch.setattr(ExpansionEngine, "set_tracer", recorded)
    prof = tmp_path / "prof"
    serve.main(["--items", "500", "--dim", "40", "--queries", "8",
                "--batch", "8", "--device", "cpu", "--fused",
                "--profile-dir", str(prof)])
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"repro/load", "repro/launch", "repro/sync"} <= names
    assert len(given) == 2 and given[0].enabled and given[0].sample is None
    assert given[1] is NULL_TRACER
