"""The port's telemetry (``obs/``: tracer, registry, profiler hooks) and
its wiring into the serving runtimes and the launcher, on the CPU.

Host modules equal the JAX package's exactly: ``Tracer``,
``attribution`` and ``format_trace`` over the same emitted spans;
``Registry`` text and JSON exposition after the same operations;
``ServingMetrics.bind_registry`` over the same records. Within the port,
tracing is read-only: a traced run equals the untraced one bit for bit
(single and sharded runtime), sampled-out rids emit no span, and a traced
request's spans cover >= 95% of its wall clock, healthy and under a shard
crash, and a host stall between rounds lies under none of them.
``serve --runtime continuous`` with the seven telemetry and chaos flags
writes a trace JSONL, a Prometheus file, a metrics JSON and a profiler
trace, each of which parses.
"""
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import make_family_measure as j_make_family_measure  # noqa: E402
from repro.core import sharded as jsharded  # noqa: E402
from repro.obs import registry as jregistry  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              ShardedIndex, build_engine,
                              make_family_measure, params_from_jax)
from repro_torch.obs import (DEFAULT_BUCKETS, NULL_TRACER,  # noqa: E402
                             NullTracer, Registry, Tracer, annotate,
                             attribution, format_trace, profile_trace)
from repro_torch.obs import registry as tregistry  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.serving import (ContinuousRuntime, FaultEvent,  # noqa: E402
                                 FaultPlan, ShardedContinuousRuntime)
from repro_torch.serving import metrics as tmetrics  # noqa: E402
from repro_torch.serving.runtime import TRACE_SITES  # noqa: E402

N, D = 900, 40
CFG = SearchConfig(k=5, ef=24, budget=6, alpha=1.1)
OPTS = EngineOptions(fused=True, corpus_dtype="int8")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(31)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(32, D)).astype(np.float32)
    jidx = jsharded.build_sharded_index(base, n_shards=2, m=8,
                                        k_construction=24, seed=1)
    idx = ShardedIndex(base=jidx.base, neighbors=jidx.neighbors,
                       entries=jidx.entries, global_ids=jidx.global_ids,
                       n_shards=2)
    jm = j_make_family_measure("deepfm", jax.random.PRNGKey(2), D)
    tm = make_family_measure("deepfm", torch.Generator(), D, device="cpu")
    tm = dataclasses.replace(tm, params={"mlp": params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params["mlp"]),
        device="cpu")})
    eng = build_engine(tm, CFG, OPTS)
    return dict(queries=queries, idx=idx, tm=tm, eng=eng,
                stores=idx.stores("int8", ["cpu"]))


def _single(s, tracer=NULL_TRACER, n=12):
    idx = s["idx"]
    rt = ContinuousRuntime(s["eng"], s["tm"].params, s["stores"][0],
                           idx.placed(0, "cpu")[0], n_lanes=4, query_dim=D,
                           entry=int(idx.entries[0]), steps_per_tick=2,
                           tracer=tracer, device="cpu")
    for i in range(n):
        rt.submit(s["queries"][i], rid=i)
    while rt.queue or rt.in_flight:
        rt.step_once()
    return {c.rid: c for c in rt.pop_completions()}, rt


def _drive_sharded(rt, queries, per_round=2):
    i, out = 0, {}
    while i < len(queries) or rt.in_flight or rt.queued or rt._partial \
            or any(r.completions for r in rt.runtimes):
        for _ in range(per_round):
            if i < len(queries):
                rt.submit(queries[i], rid=i)
                i += 1
        for c in rt.step_once():
            out[c.rid] = c
    return out


def _sharded(s, **kw):
    return ShardedContinuousRuntime(s["eng"], s["tm"].params, s["idx"],
                                    n_lanes=4, query_dim=D,
                                    steps_per_tick=2, devices=["cpu"], **kw)


def _same(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid].ids, b[rid].ids)
        np.testing.assert_array_equal(a[rid].scores, b[rid].scores)
        assert a[rid].status == b[rid].status
        assert (a[rid].n_eval, a[rid].n_iters) == (b[rid].n_eval,
                                                   b[rid].n_iters)


# ---------------------------------------------------------------------------
# host modules against the JAX ones
# ---------------------------------------------------------------------------

def _tracer_script(mod):
    ticks = iter(np.arange(0.0, 1000.0, 0.125).tolist())
    tr = mod.Tracer(capacity=64, sample=2, clock=lambda: next(ticks))
    for rid in range(6):
        if not tr.sampled(rid):
            continue
        root = tr.root_for(rid, t0=float(rid))
        assert tr.root_for(rid) == root
        q = tr.begin("queue", rid=rid, site="shard:0", parent=root)
        tr.end(q, lane=rid % 3)
        for name in ("admit", "tick", "harvest"):
            tr.emit(name, rid + 0.5, rid + 0.75, rid=rid, site="shard:1",
                    parent=root, i=rid)
        if rid != 4:
            tr.finish_request(rid, status="ok")
    tr.emit("page_fault", 0.1, 0.2, site="pager", rows=3)
    tr.begin("tick", rid=2)                   # never ended: drained open
    tr.drain()
    return tr


def test_tracer_matches_jax(tmp_path):
    got, want = _tracer_script(ttrace), _tracer_script(jtrace)
    assert [s.to_dict() for s in got.spans()] == \
        [s.to_dict() for s in want.spans()]
    assert got.n_emitted == want.n_emitted
    for rid in (0, 2, 4, 5):
        for sites in ((), ("pager",)):
            assert attribution(got.spans(), rid, sites) == \
                jtrace.attribution(want.spans(), rid, sites)
            assert format_trace(got, rid, sites) == \
                jtrace.format_trace(want, rid, sites)
    assert [s.to_dict() for s in got.spans(rid=None, site="pager")] == \
        [s.to_dict() for s in want.spans(rid=None, site="pager")]
    got.export_jsonl(str(tmp_path / "a.jsonl"))
    want.export_jsonl(str(tmp_path / "b.jsonl"))
    assert (tmp_path / "a.jsonl").read_text() == \
        (tmp_path / "b.jsonl").read_text()
    ring = Tracer(capacity=4)
    for i in range(10):
        ring.emit(f"s{i}", 0.0, 1.0)
    assert [s.name for s in ring.spans()] == ["s6", "s7", "s8", "s9"]
    assert ring.n_emitted == 10
    for bad in (dict(sample=0), dict(capacity=0)):
        with pytest.raises(ValueError):
            Tracer(**bad)


def test_null_tracer_is_inert():
    assert isinstance(NULL_TRACER, NullTracer) and not NULL_TRACER.enabled
    assert NULL_TRACER.root_for(3) == -1 and NULL_TRACER.begin("x") == -1
    assert NULL_TRACER.emit("x", 0, 1) == -1 and NULL_TRACER.spans() == []
    assert not NULL_TRACER.sampled(0) and NULL_TRACER.drain() == []


def _registry_script(mod):
    reg = mod.Registry(max_series_per_metric=4)
    c = reg.counter("repro_serving_requests_total", "by status",
                    labelnames=("status",))
    c.labels(status="ok").inc()
    c.labels(status="ok").inc(2)
    c.labels(status="shed").inc()
    g = reg.gauge("repro_serving_queue_depth", 'a "quoted"\nhelp')
    g.set(3.5)
    h = reg.histogram("repro_serving_latency_ms", "ms")
    for v in (0.3, 1.0, 7.0, 99.0, 1e4):
        h.observe(v)
    hl = reg.histogram("repro_x_ms", "", labelnames=("sla",),
                       buckets=(5.0, 1.0))
    hl.labels(sla="gold").observe(2.0)
    t = reg.counter("repro_total_set")
    reg.register_collect(lambda: t.set_to(41))
    errors = []
    for fn in (lambda: [c.labels(status=str(i)) for i in range(9)],
               lambda: c.labels(code="x"), lambda: g.inc(-1) or c.inc(-1),
               lambda: reg.gauge("repro_serving_requests_total"),
               lambda: reg.counter("bad name"), lambda: h.set(1),
               lambda: c.observe(1)):
        try:
            fn()
        except ValueError as e:
            errors.append(str(e))
    return reg.render_text(), reg.render_json_str(), errors


def test_registry_matches_jax():
    got, want = _registry_script(tregistry), _registry_script(jregistry)
    assert got == want
    assert DEFAULT_BUCKETS == jregistry.DEFAULT_BUCKETS
    assert 'repro_serving_requests_total{status="ok"} 3' in got[0]
    assert "repro_total_set 41" in got[0]
    assert len(got[2]) == 7


def test_serving_metrics_bind_registry_matches_jax():
    out = []
    for mod, reg in ((tmetrics, Registry()),
                     (jmetrics, jregistry.Registry())):
        m = mod.ServingMetrics(4)
        m.bind_registry(reg)
        for i in range(10):
            m.observe(mod.RequestRecord(
                i, 0.001 * i, 0.002 * i + 0.003, 0.01 * (i + 2),
                10 + i, i, 3 + i, timed_out=(i == 2), shed=(i == 3),
                failed=(i == 4), partial=(i == 5),
                sla="gold" if i % 2 else "", degraded=(i == 7)))
        m.observe_queue_depth(5)
        m.observe_occupancy(3, 4, steps=8)
        m.sync_occupancy(30, 64)
        out.append((reg.render_text(), reg.render_json_str(),
                    m.summary()["occupancy"]))
    assert out[0] == out[1]
    assert 'repro_serving_requests_total{status="partial"} 1' in out[0][0]
    assert "repro_serving_occupancy 0.46875" in out[0][0]


# ---------------------------------------------------------------------------
# the runtimes: read-only tracing, sampling, coverage, registry
# ---------------------------------------------------------------------------

def test_single_traced_equals_untraced(system):
    ref, _ = _single(system)
    tr = Tracer(sample=1)
    got, rt = _single(system, tracer=tr)
    _same(got, ref)
    for rid in ref:
        assert {"request", "queue", "tick", "harvest"} <= \
            {sp.name for sp in tr.spans(rid=rid)}
    rt.close()
    assert all(not sp.open for sp in tr.spans())


def test_sharded_traced_equals_untraced(system):
    qs = system["queries"]
    ref = _drive_sharded(_sharded(system), qs)
    tr = Tracer(sample=1, capacity=1 << 15)
    got = _drive_sharded(_sharded(system, tracer=tr), qs)
    _same(got, ref)
    assert {"shard:0", "shard:1"} <= {sp.site for sp in tr.spans(rid=0)}
    assert any(sp.name == "merge" for sp in tr.spans(rid=0))


def test_sampled_out_requests_emit_no_spans(system):
    tr = Tracer(sample=3)
    _single(system, tracer=tr)
    for rid in range(12):
        assert bool(tr.spans(rid=rid)) == (rid % 3 == 0), rid


@pytest.mark.parametrize("case", ["single", "sharded", "sharded-crash"])
def test_attribution_covers_wall_clock(system, case):
    """>= 95% of each traced answered request's wall clock lies under its
    phase spans (queue / admit / tick / harvest, and merge when sharded,
    with the sharded runtime's own site spans), also while one shard
    crashes until its breaker opens."""
    tr = Tracer(sample=2, capacity=1 << 15)
    if case == "single":
        got, _ = _single(system, tracer=tr)
    else:
        plan = (FaultPlan([FaultEvent("shard_crash", site="shard:1/tick",
                                      start=3, count=3)])
                if case == "sharded-crash" else None)
        rt = _sharded(system, tracer=tr, fault_plan=plan, k_failures=2,
                      cooldown_rounds=3)
        got = _drive_sharded(rt, system["queries"])
        if plan is not None:
            assert Counter(c.status for c in got.values())["partial"] > 0
    checked = 0
    for rid, c in got.items():
        if rid % 2 or c.status not in ("ok", "partial"):
            continue
        att = attribution(tr.spans(), rid,
                          () if case == "single" else TRACE_SITES)
        assert att["wall_ms"] > 0 and att["coverage"] >= 0.95, (rid, att)
        assert att["attributed_ms"] >= attribution(
            tr.spans(), rid)["attributed_ms"]
        checked += 1
    assert checked >= 6
    rid = max(r for r in got if r % 2 == 0)
    assert format_trace(tr, rid).startswith(f"request rid={rid}")


def test_host_gap_between_rounds_is_unattributed(system):
    """A host stall between two sharded rounds (outside the runtime, as
    the stream loop's) lies under no phase span and under neither of the
    runtime's own site spans: attribution reads it as a gap. Only a merge
    span (a rid waiting on its other shard's part) may cover it."""
    clock = {"t": 0.0}

    def now():
        clock["t"] += 1e-6
        return clock["t"]
    tr = Tracer(sample=1, capacity=1 << 15, clock=now)
    rt = _sharded(system, tracer=tr, now_fn=now)
    for i in range(4):
        rt.submit(system["queries"][i], rid=i)
    rt.step_once()
    rt.step_once()
    gap0 = now()
    clock["t"] += 1.0
    gap1 = now()
    while rt.in_flight or rt._partial:
        rt.step_once()
    assert {c.status for c in rt.pop_completions()} == {"ok"}
    spans = tr.spans()
    assert {"spans", "round"} <= {sp.name for sp in spans if sp.rid is None}
    across = [sp for sp in spans if sp.t0 < gap1 and sp.t1 > gap0]
    assert {sp.name for sp in across} <= {"request", "merge"}, across
    gapped = 0
    for rid in range(4):
        if any(sp.name == "merge" and sp.rid == rid for sp in across):
            continue
        att = attribution(spans, rid, TRACE_SITES)
        assert att["wall_ms"] - att["attributed_ms"] >= 1000.0, (rid, att)
        gapped += 1
    assert gapped


def test_runtime_bind_registry(system):
    reg = Registry()
    idx = system["idx"]
    rt = ContinuousRuntime(system["eng"], system["tm"].params,
                           system["stores"][0], idx.placed(0, "cpu")[0],
                           n_lanes=4, query_dim=D, entry=int(idx.entries[0]),
                           steps_per_tick=2, device="cpu")
    assert rt.bind_registry(reg) is reg
    for i in range(8):
        rt.submit(system["queries"][i], rid=i)
    while rt.queue or rt.in_flight:
        rt.step_once()
    text = reg.render_text()
    assert 'repro_serving_requests_total{status="ok"} 8' in text
    assert "repro_serving_latency_ms_count 8" in text
    sreg = Registry()
    srt = _sharded(system)
    srt.bind_registry(sreg)
    _drive_sharded(srt, system["queries"][:6])
    text = sreg.render_text()
    assert 'repro_serving_requests_total{status="ok"} 6' in text
    assert text.count("repro_health_shard_state{") == 2


def test_profile_trace_and_annotate(tmp_path):
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        with annotate("repro/tick"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "repro/tick" in names


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_chaos_trace_metrics_profile_flags(tmp_path, capsys):
    from repro_torch.launch import serve
    plan = tmp_path / "plan.json"
    FaultPlan([FaultEvent("slow_tick", site="tick", start=1, count=2,
                          seconds=0.01)]).save(str(plan))
    paths = {k: str(tmp_path / v) for k, v in (
        ("trace", "spans.jsonl"), ("prom", "metrics.prom"),
        ("json", "metrics.json"), ("prof", "prof"))}
    out = serve.main(["--runtime", "continuous", "--items", "500", "--dim",
                      "40", "--queries", "12", "--lanes", "4",
                      "--offered-qps", "5000", "--device", "cpu",
                      "--chaos", str(plan), "--health-every", "0",
                      "--trace-sample", "2", "--trace-out", paths["trace"],
                      "--metrics-out", paths["prom"],
                      "--metrics-json", paths["json"],
                      "--profile-dir", paths["prof"]])
    assert out["n_completed"] == 12 and out["statuses"] == {"ok": 12}
    text = capsys.readouterr().out
    assert "chaos: replaying" in text and "[health]" in text
    assert "slowest traced ok request" in text
    spans = [json.loads(line) for line in open(paths["trace"])]
    assert {sp["rid"] for sp in spans if sp["name"] == "request"} == \
        set(range(0, 12, 2))
    prom = open(paths["prom"]).read()
    assert 'repro_serving_requests_total{status="ok"} 12' in prom
    assert json.load(open(paths["json"]))["n_completed"] == 12
    trace = json.load(open(f"{paths['prof']}/trace.json"))
    assert any(e.get("name") == "repro/tick" for e in trace["traceEvents"])
    with pytest.raises(SystemExit, match="--chaos needs --runtime"):
        serve.parse_args(["--chaos", str(plan)])
    with pytest.raises(SystemExit, match="--trace-out needs --trace-sample"):
        serve.parse_args(["--runtime", "continuous", "--trace-out", "x"])
