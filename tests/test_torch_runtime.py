"""The port's continuous-batching runtime, SLA tiers, serving metrics and
continuous launcher on the CPU.

Continuous serving must return, per request, the port's own oneshot
``search`` of the same query bit for bit (ids, scores, counters): the
stages are lane-row independent. That invariant is the port's own; it is
not held against the JAX runtime's outputs (they fail on this jax, see
ROADMAP.md). ``sla.py`` and ``ServingMetrics`` are held against the JAX
modules on the same inputs. The fault-domain and telemetry hooks have
their own files (test_torch_faults.py, test_torch_obs.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import make_family_measure as j_make_family_measure  # noqa: E402
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro.serving import runtime as jruntime  # noqa: E402
from repro.serving import sla as jsla  # noqa: E402
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              build_engine, make_corpus_store,
                              make_family_measure, params_from_jax)
from repro_torch.serving import metrics as tmetrics  # noqa: E402
from repro_torch.serving import (ContinuousRuntime, Request,  # noqa: E402
                                 RequestRecord, ServingMetrics, SLAClass,
                                 SLAPolicy, default_policy, load_policy,
                                 poisson_arrivals, policy_from_spec,
                                 resolve_tier)

N, D, Q = 800, 40, 12
CFG = dict(k=5, ef=24, budget=6, alpha=1.1)
ENGINES = {
    "deepfm": ("deepfm", CFG, {}),
    "mlp": ("mlp", CFG, {}),
    "sl2g": ("mlp", dict(k=5, ef=24, mode="sl2g"), {}),
    "deepfm-fused-int8-adaptive": (
        "deepfm", {**CFG, "alpha": 1.2},
        dict(fused=True, corpus_dtype="int8", adaptive="angle", c_max=10,
             angle_tau=1.8)),
}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its searches are many
    small ops, and BLAS threads spinning beside the other test workers'
    cost far more than they give."""
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


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(5)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    graph = j_build_l2_graph(base, m=8, k_construction=24)
    tms = {f: _port_measure(f, j_make_family_measure(
        f, jax.random.PRNGKey(1), D)) for f in ("deepfm", "mlp")}
    return dict(base=base, queries=queries, graph=graph, tms=tms,
                nbrs=torch.from_numpy(graph.neighbors))


def _setup(system, name):
    family, cfg_kw, opt_kw = ENGINES[name]
    m = system["tms"][family]
    eng = build_engine(m, SearchConfig(**cfg_kw), EngineOptions(**opt_kw))
    store = make_corpus_store(system["base"], eng.corpus_dtype, device="cpu")
    return eng, m, store


def _oneshot(system, eng, m, store, **kw):
    g = system["graph"]
    return eng.search(m.params, store, system["nbrs"],
                      torch.from_numpy(system["queries"]),
                      torch.full((Q,), g.entry), **kw)


def _runtime(system, eng, m, store, **kw):
    g = system["graph"]
    return ContinuousRuntime(eng, m.params, store, system["nbrs"],
                             query_dim=D, entry=g.entry, **kw)


def _assert_same(comp, ref, i):
    assert np.array_equal(comp.ids, ref.ids[i].numpy()), i
    assert np.array_equal(comp.scores, ref.scores[i].numpy()), i
    assert comp.n_eval == int(ref.n_eval[i])
    assert comp.n_grad == int(ref.n_grad[i])
    assert comp.n_iters == int(ref.n_iters[i])


@pytest.mark.parametrize("name", list(ENGINES))
def test_continuous_matches_oneshot_bit_identical(system, name):
    """A shuffled stream through 4 lanes (fewer than the 12 requests)
    returns, per query, the oneshot search's ids, scores and counters;
    every lane is recycled."""
    eng, m, store = _setup(system, name)
    ref = _oneshot(system, eng, m, store)
    rt = _runtime(system, eng, m, store, n_lanes=4, steps_per_tick=3)
    order = np.random.default_rng(7).permutation(Q)
    comps = rt.run_stream([Request(rid=int(i), query=system["queries"][i])
                           for i in order], realtime=False)
    assert len(comps) == Q
    by = {c.rid: c for c in comps}
    for i in range(Q):
        assert by[i].status == "ok"
        _assert_same(by[i], ref, i)
    assert {c.lane for c in comps} == set(range(4))
    assert rt.program.runs["tick"] > 0 and rt.program.runs["reset"] > 0


def test_tiered_iteration_budgets_match_oneshot_caps(system):
    """Per-request budget_iters equal the oneshot search with the same
    iter_caps; capped lanes do less work."""
    eng, m, store = _setup(system, "mlp")
    caps = np.where(np.arange(Q) % 2 == 0, 6,
                    eng.cfg.iters()).astype(np.int32)
    ref = _oneshot(system, eng, m, store, iter_caps=caps)
    assert (ref.n_iters[::2] <= 6).all() and ref.n_iters.max() > 6
    rt = _runtime(system, eng, m, store, n_lanes=3)
    comps = rt.run_stream([Request(rid=i, query=system["queries"][i],
                                   budget_iters=int(caps[i])
                                   if i % 2 == 0 else None)
                           for i in range(Q)], realtime=False)
    by = {c.rid: c for c in comps}
    for i in range(Q):
        _assert_same(by[i], ref, i)


def test_deadline_drops_stale_requests(system):
    """A request queued past its deadline resolves as timed out (ids -1,
    scores -inf) through both surfaces; a fresh one completes."""
    eng, m, store = _setup(system, "deepfm")
    clock = {"t": 0.0}
    rt = _runtime(system, eng, m, store, n_lanes=2,
                  now_fn=lambda: clock["t"])
    rt.submit(system["queries"][0], rid=0, deadline=1.0, t_arrive=0.0)
    rt.submit(system["queries"][1], rid=1, deadline=100.0, t_arrive=0.0)
    clock["t"] = 5.0
    streamed = []
    while rt.queue or rt.in_flight:
        streamed += rt.step_once()
        clock["t"] += 0.01
    assert sorted(c.rid for c in streamed) == [0, 1]
    by = {c.rid: c for c in rt.pop_completions()}
    assert by[0].status == "timeout" and by[0].record.timed_out
    assert (by[0].ids == -1).all() and np.isneginf(by[0].scores).all()
    assert by[1].status == "ok" and (by[1].ids >= 0).all()
    summ = rt.metrics.summary()
    assert summ["n_timed_out"] == 1 and summ["n_completed"] == 1


def test_fifo_admission_order(system):
    """One lane: completions come back in submission order, time in queue
    monotone."""
    eng, m, store = _setup(system, "mlp")
    rt = _runtime(system, eng, m, store, n_lanes=1, steps_per_tick=8)
    for i in range(4):
        rt.submit(system["queries"][i], rid=i)
    while rt.queue or rt.in_flight:
        rt.step_once()
    comps = rt.pop_completions()
    assert [c.rid for c in comps] == [0, 1, 2, 3]
    qms = [c.record.queue_ms for c in comps]
    assert all(qms[i] <= qms[i + 1] + 1e-6 for i in range(3))


def test_max_queue_sheds_without_policy(system):
    """Untiered: beyond max_queue a submit is shed at once (ids -1), the
    queued ones complete; close() drains and sheds late submits."""
    eng, m, store = _setup(system, "mlp")
    rt = _runtime(system, eng, m, store, n_lanes=2, max_queue=2)
    for i in range(5):
        rt.submit(system["queries"][i], rid=i)
    comps = rt.step_once()          # admits 0 and 1
    comps += rt.close()
    rt.submit(system["queries"][5], rid=5)
    by = {c.rid: c for c in comps + rt.pop_completions()}
    assert sorted(by) == [0, 1, 2, 3, 4, 5]
    assert [i for i in by if by[i].status == "shed"] == [2, 3, 4, 5]
    assert all(by[i].status == "ok" for i in (0, 1))
    snap = rt.health_snapshot()
    assert snap == {"queue": 0, "in_flight": 0, "completed": 2,
                    "timed_out": 0, "shed": 4, "failed": 0}
    assert rt.format_health() == ("[health] queue=0 in_flight=0 "
                                  "completed=2 timed_out=0 shed=4 failed=0")


def test_degrade_before_shed(system):
    """With an SLA policy, pressure between max_queue and 2x max_queue
    admits at the floor tier (degraded), past 2x it sheds; records keep
    the original tier. A degraded request runs the floor tier's cap."""
    eng, m, store = _setup(system, "deepfm-fused-int8-adaptive")
    pol = default_policy()
    rt = _runtime(system, eng, m, store, n_lanes=2, steps_per_tick=2,
                  max_queue=2, sla_policy=pol)
    rt.warmup(system["queries"][0])
    for i in range(6):
        rt.submit(system["queries"][i], rid=i)
    comps = []
    while rt.queue or rt.in_flight:
        comps += rt.step_once()
    comps += rt.pop_completions()
    by = {c.rid: c for c in comps}
    assert len(by) == 6
    assert [i for i in range(6) if by[i].record.shed] == [4, 5]
    assert [i for i in range(6) if by[i].record.degraded] == [2, 3]
    assert all(by[i].record.sla == "premium" for i in range(6))
    assert all(by[i].n_iters <= pol.floor().iter_cap for i in (2, 3))
    tiers = rt.metrics.sla_summary()
    assert tiers["premium"]["n"] == 6
    assert tiers["premium"]["n_degraded"] == 2
    assert tiers["premium"]["n_shed"] == 2


def test_realtime_stream_and_warmup(system):
    """Open-loop Poisson arrivals run to the end; warmup's sentinel leaves
    no completion or record behind."""
    eng, m, store = _setup(system, "deepfm")
    rt = _runtime(system, eng, m, store, n_lanes=4)
    rt.warmup(system["queries"][0])
    assert rt.metrics.records == [] and rt.completions == []
    arr = poisson_arrivals(Q, qps=400.0, seed=1)
    comps = rt.run_stream([Request(rid=i, query=system["queries"][i],
                                   t_arrive=float(arr[i]))
                           for i in range(Q)], health_every_s=0.0)
    assert sorted(c.rid for c in comps) == list(range(Q))
    s = rt.metrics.summary()
    assert s["n_completed"] == Q and 0 < s["occupancy"] <= 1
    assert s["qps"] > 0 and s["p99_ms"] >= s["p50_ms"]


def test_runtime_refuses_unported_by_name(system):
    """What stays refused: shared_fns (captured programs are bound to their
    own runtime's tensors), and bad lane and tick sizes. The fault, trace,
    index-epoch and registry hooks are ported (test_torch_faults.py,
    test_torch_obs.py)."""
    eng, m, store = _setup(system, "mlp")
    with pytest.raises(ValueError, match="shared_fns: a captured reset"):
        _runtime(system, eng, m, store, n_lanes=2, shared_fns=(None, None))
    with pytest.raises(ValueError, match="n_lanes"):
        _runtime(system, eng, m, store, n_lanes=0)
    with pytest.raises(ValueError, match="steps_per_tick"):
        _runtime(system, eng, m, store, n_lanes=1, steps_per_tick=0)


# ---------------------------------------------------------------------------
# sla.py, metrics and arrivals against the JAX modules
# ---------------------------------------------------------------------------

def test_sla_matches_jax():
    for base_iters in (0, 64, 256):
        assert default_policy(base_iters).table() == \
            jsla.default_policy(base_iters).table()
    p, jp = default_policy(), jsla.default_policy()
    assert load_policy("default").table() == jp.table()
    for d in (None, 0.3, 0.25, 0.1, 0.05, 0.01, 0.0):
        assert p.classify(d).name == jp.classify(d).name
        for sla in (None, "economy", "premium"):
            assert resolve_tier(p, sla, d).name == \
                jsla.resolve_tier(jp, sla, d).name
    assert resolve_tier(None, "economy", 0.1) is None
    for c in p.classes:
        down, jdown = p.degrade(c), jp.degrade(jp.get(c.name))
        assert (down is None) == (jdown is None)
        if down is not None:
            assert down.describe() == jdown.describe()
    assert p.floor().describe() == jp.floor().describe()
    spec = {"tiers": [{"name": "gold", "min_deadline_s": 0.1,
                       "iter_cap": 32},
                      {"name": "bronze", "angle_tau": 1.5}]}
    assert policy_from_spec(spec).table() == \
        jsla.policy_from_spec(spec).table()
    with pytest.raises(ValueError, match="unknown SLA tier keys"):
        policy_from_spec([{"name": "x", "iters": 3}])
    with pytest.raises(ValueError, match="duplicate"):
        SLAPolicy((SLAClass("a"), SLAClass("a")))
    with pytest.raises(ValueError):
        SLAPolicy(())
    with pytest.raises(KeyError, match="unknown SLA tier"):
        p.get("gold")


def test_load_policy_from_json(tmp_path):
    spec = [{"name": "fast", "iter_cap": 8, "corpus_dtype": "int8"}]
    path = tmp_path / "policy.json"
    path.write_text(__import__("json").dumps(spec))
    assert load_policy(str(path)).table() == \
        jsla.load_policy(str(path)).table()


def _records(mod):
    recs = []
    for i in range(12):
        recs.append(mod.RequestRecord(
            rid=i, t_arrive=0.001 * i, t_admit=0.002 * i + 0.003,
            t_done=0.01 * (i + 2), n_eval=10 + 3 * i, n_grad=i,
            n_iters=5 + i, timed_out=(i == 3), shed=(i == 5),
            sla=("premium" if i % 3 else "economy") if i > 1 else "",
            degraded=(i == 7)))
    return recs


def test_serving_metrics_match_jax():
    ms, jms = ServingMetrics(4), jmetrics.ServingMetrics(4)
    for r, jr in zip(_records(tmetrics), _records(jmetrics)):
        ms.observe(r)
        jms.observe(jr)
    for m in (ms, jms):
        m.observe_occupancy(2, 4, steps=8)
        m.observe_occupancy(4, 4, steps=8)
        m.observe_queue_depth(5)
        m.observe_queue_depth(2)
    a, b = ms.summary(), jms.summary()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], nan_ok=True), k
    assert ms.sla_summary().keys() == jms.sla_summary().keys()
    for tier, t in ms.sla_summary().items():
        for k, v in t.items():
            assert v == pytest.approx(jms.sla_summary()[tier][k],
                                      nan_ok=True), (tier, k)
    assert ms.report() == jms.report()
    assert ServingMetrics().report() == jmetrics.ServingMetrics().report()
    rec = RequestRecord(0, 1.0, 1.5, 2.0)
    assert rec.latency_ms == 1000.0 and rec.queue_ms == 500.0


def test_poisson_arrivals_match_jax():
    np.testing.assert_array_equal(poisson_arrivals(500, 123.0, seed=3),
                                  jruntime.poisson_arrivals(500, 123.0,
                                                            seed=3))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_continuous_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--runtime", "continuous", "--items", "600", "--dim",
                      "40", "--queries", "24", "--lanes", "8",
                      "--offered-qps", "5000", "--device", "cpu"])
    assert out["runtime"] == "continuous" and out["n_completed"] == 24
    assert out["recall"] > 0.5 and out["qps"] > 0
    text = capsys.readouterr().out
    assert "runtime=continuous" in text and "lane-occupancy" in text
    tiered = serve.main(["--runtime", "continuous", "--items", "600",
                         "--dim", "40", "--queries", "16", "--lanes", "4",
                         "--offered-qps", "5000", "--sla", "default",
                         "--sla-mix", "economy:0.5,premium:0.5",
                         "--max-queue", "64", "--deadline", "30",
                         "--steps-per-tick", "4", "--device", "cpu"])
    assert tiered["n_completed"] == 16
    assert "sla=economy" in capsys.readouterr().out


def test_serve_flags_and_refusals():
    from repro_torch.launch import serve
    args = serve.parse_args([])
    assert (args.runtime, args.lanes, args.offered_qps, args.steps_per_tick,
            args.deadline, args.max_queue, args.sla, args.sla_mix) == \
        ("oneshot", 32, 200.0, 8, None, None, "off", None)
    assert not args.host_loop
    assert (args.chaos, args.health_every, args.trace_sample, args.trace_out,
            args.metrics_out, args.metrics_json, args.profile_dir) == \
        (None, None, 0, None, None, None, None)
    for flag in ("--chaos", "--health-every", "--trace-sample", "--trace-out",
                 "--metrics-out", "--metrics-json", "--profile-dir"):
        assert flag not in serve.JAX_ONLY_FLAGS
    for flag in serve.JAX_ONLY_FLAGS:
        with pytest.raises(SystemExit, match=f"{flag} is not ported yet"):
            serve.parse_args([flag, "x"])
    with pytest.raises(SystemExit, match="--sla needs --runtime continuous"):
        serve.parse_args(["--sla", "default"])
    with pytest.raises(SystemExit, match="--host-loop is a oneshot option"):
        serve.parse_args(["--runtime", "continuous", "--host-loop"])
    with pytest.raises(SystemExit, match="not in policy"):
        serve._parse_sla_mix("gold:1.0", default_policy())
    mix = serve._parse_sla_mix("premium:0.3,standard:0.4,economy:0.3",
                               default_policy())
    assert len(mix) == 100 and mix.count("standard") == 40


def test_serve_oneshot_reports_host_loop(capsys):
    """The oneshot report carries steps and program runs per batch and
    host issue per step; --host-loop serves the same results."""
    from repro_torch.launch import serve
    common = ["--items", "600", "--dim", "40", "--queries", "40",
              "--device", "cpu"]
    a = serve.main(common)
    b = serve.main(common + ["--host-loop"])
    assert a["loop"] == b["loop"] == "host"     # the CPU has no graphs
    assert a["recall"] == b["recall"] and a["iters_mean"] == b["iters_mean"]
    assert a["steps_per_batch"] % 8 == 0
    assert a["runs_per_batch"] == a["steps_per_batch"] / 8 + 1
    assert a["host_us_per_step"] > 0
    assert "program runs per batch" in capsys.readouterr().out
