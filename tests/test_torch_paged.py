"""The port's paged corpus residency against the JAX package on the CPU.

The host pager (``core.corpus._PageCache``) must equal the JAX one on the
same trace of gathers: the rows, every ``PageCacheStats`` field after each
gather, the read hook's ``(pid, attempt)`` calls and where a fault
degrades (retries, the whole host copy, ``CorpusUnavailableError``). A
paged search must equal the whole-resident one bit for bit (ids, scores,
counters) through ``search``, ``search_debug``, the sharded search and the
continuous runtime, for DeepFM and MLP, fused and unfused; the gathers a
port search makes, replayed through the JAX pager, give the same stats;
recall stays within 0.01 of the JAX paged search's. Files either package
writes (v1-v3) load paged; the registry families and health fields read
as the JAX ones; the launchers serve and verify paged on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as jcorpus  # noqa: E402
from repro.core import (EngineOptions as JOptions,  # noqa: E402
                        SearchConfig as JConfig,
                        brute_force_topk as j_brute_force_topk,
                        build_engine as j_build_engine,
                        make_family_measure as j_make_family_measure)
from repro.graph import build as jbuild  # noqa: E402
from repro.graph import io as jio  # noqa: E402
from repro.obs import Registry as JRegistry  # noqa: E402
from repro.serving import ContinuousRuntime as JRuntime  # noqa: E402
from repro.serving import FaultEvent as JEvent  # noqa: E402
from repro.serving import FaultPlan as JPlan  # noqa: E402
from repro_torch.core import (CorpusUnavailableError,  # noqa: E402
                              EngineOptions, PagedCorpusStore,
                              ResidencyPolicy, SearchConfig, ShardedIndex,
                              build_engine, make_corpus_store,
                              make_family_measure, make_paged_store,
                              params_from_jax, recall, shard_stores,
                              sharded_search_stores)
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.graph import load_corpus_store, save_index  # noqa: E402
from repro_torch.obs import Registry  # noqa: E402
from repro_torch.serving import (ContinuousRuntime, FaultEvent,  # noqa: E402
                                 FaultPlan, Request)

DTYPES = ("float32", "bfloat16", "int8")
N, D, Q = 600, 40, 12
PAGED = ResidencyPolicy("paged", page_rows=64, cache_bytes=4 * 64 * 160)


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


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(3)
    base = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
    queries = (rng.normal(size=(Q, D)) * 0.5).astype(np.float32)
    graph = jbuild.build_l2_graph(base, m=8, k_construction=24)
    jms = {f: j_make_family_measure(f, jax.random.PRNGKey(1), D)
           for f in ("deepfm", "mlp")}
    return dict(base=base, queries=queries, graph=graph, jms=jms,
                tms={f: _port_measure(f, jm) for f, jm in jms.items()},
                nbrs=torch.from_numpy(graph.neighbors))


def _payload(base, dtype):
    """The JAX paged store's host payload for ``base`` in ``dtype``."""
    js = jcorpus.make_corpus_store(base, dtype,
                                   residency=jcorpus.ResidencyPolicy("paged"))
    return js.cache.data, js.cache.scales


def _caches(base, dtype, **policy):
    data, scales = _payload(base, dtype)
    return (tcorpus._PageCache(data, scales, dtype,
                               ResidencyPolicy(**policy)),
            jcorpus._PageCache(data, scales, dtype,
                               jcorpus.ResidencyPolicy(**policy)))


def _traces(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return [rng.integers(-3, n + 3, size=rng.integers(1, 150))
                for _ in range(40)]
    return [np.arange(s, s + 90) for s in range(0, n, 45)] * 2


# ---------------------------------------------------------------------------
# the pager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trace", ["random", "sequential"])
@pytest.mark.parametrize("budget_pages", [0, 3, 100])
@pytest.mark.parametrize("page_rows", [4, 64])
def test_pager_matches_jax_pager(system, dtype, trace, budget_pages,
                                 page_rows):
    """Rows and every stats field equal the JAX pager's after each
    gather (clamped out-of-range ids included); 4-row pages make a gather
    need more pages than the slab holds."""
    per_page = page_rows * {"float32": 160, "bfloat16": 80,
                            "int8": 44}[dtype]
    tp, jp = _caches(system["base"], dtype, kind="paged",
                     page_rows=page_rows,
                     cache_bytes=budget_pages * per_page)
    for ids in _traces(trace, N):
        np.testing.assert_array_equal(tp.gather(ids), jp.gather(ids))
        assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)
    # ``out=`` writes the same rows in place
    out = np.empty((7, 5, D), np.float32)
    ids = np.random.default_rng(1).integers(0, N, size=(7, 5))
    assert tp.gather(ids, out=out) is out
    np.testing.assert_array_equal(out, jp.gather(ids))
    np.testing.assert_array_equal(tp.materialize(), jp.materialize())


def test_lru_evicts_cold_pages_under_budget(system):
    """Disjoint sequential gathers over more pages than the budget holds:
    cold pages go, the footprint stays at budget + the pinned working set,
    every gather is exact, and the newest page is a hit."""
    base = system["base"]
    page_bytes = 64 * D * 4
    policy = ResidencyPolicy("paged", page_rows=64,
                             cache_bytes=3 * page_bytes)
    store = make_paged_store(base, "float32", policy, device="cpu")
    for start in range(0, 512, 64):
        ids = np.arange(start, start + 64)
        np.testing.assert_array_equal(store.cache.gather(ids), base[ids])
    st = store.stats_snapshot()
    assert st.evictions > 0
    assert st.resident_bytes <= policy.cache_bytes
    assert st.peak_resident_bytes <= policy.cache_bytes + page_bytes
    hits0 = st.hits
    store.cache.gather(np.arange(512 - 64, 512))
    assert store.stats_snapshot().hits > hits0
    assert store.nbytes() == store.stats_snapshot().resident_bytes


def test_pager_slab_grows_past_its_free_slots(system):
    """A gather that needs more new pages than the slab's free slots and
    its doubling together (one-row pages): rows and stats stay the JAX
    pager's."""
    tp, jp = _caches(system["base"], "float32", kind="paged", page_rows=1,
                     cache_bytes=5 * 160)
    for ids in (np.arange(10), np.arange(10, 41), np.arange(100, 300),
                np.arange(5, 60)):
        np.testing.assert_array_equal(tp.gather(ids), jp.gather(ids))
        assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)


def _ladder(cache, plan_cls, event_cls, events, calls):
    plan = plan_cls(events, seed=0)
    hook = plan.pager_hook("pager")

    def recorded(pid, attempt):
        calls.append((int(pid), int(attempt)))
        hook(pid, attempt)
    cache.read_hook = recorded
    out = []
    for ids in _traces("random", N, seed=4)[:12]:
        try:
            out.append(cache.gather(ids))
        except Exception as err:   # noqa: BLE001 - compared by type
            out.append(type(err).__name__)
        out.append(dataclasses.asdict(cache.stats))
    return out


@pytest.mark.parametrize("rung", ["retries", "whole", "unavailable",
                                  "whole_read_fails"])
def test_degradation_ladder_matches_jax(system, rung):
    """Retries absorb transient errors; persistent ones degrade to the
    whole host copy; past ``fallback_bytes`` (or when the whole read fails
    too) ``CorpusUnavailableError``: the same rows, stats, exceptions and
    read-hook calls as the JAX pager, fault by fault."""
    policy = dict(kind="paged", page_rows=64, cache_bytes=2 * 64 * 44,
                  retry_backoff_s=0.0,
                  fallback_bytes=1 if rung == "unavailable" else None)
    events = {"retries": [("pager", 2, 2), ("pager", 9, 3)],
              "whole": [("pager", 6, 10**6)],
              "unavailable": [("pager", 6, 10**6)],
              "whole_read_fails": [("pager", 6, 10**6),
                                   ("pager/whole", 0, 10**6)]}[rung]
    tp, jp = _caches(system["base"], "int8", **policy)
    tcalls, jcalls = [], []
    got = _ladder(tp, FaultPlan, FaultEvent,
                  [FaultEvent("page_io_error", site=s, start=a, count=c)
                   for s, a, c in events], tcalls)
    want = _ladder(jp, JPlan, JEvent,
                   [JEvent("page_io_error", site=s, start=a, count=c)
                    for s, a, c in events], jcalls)
    assert tcalls == jcalls and len(tcalls) > 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    final = got[-1]
    if rung == "retries":
        assert final["retries"] > 0 and final["fallback"] == ""
    elif rung == "whole":
        assert final["fallback"] == "whole"
    else:
        assert any(isinstance(a, str) and a == "CorpusUnavailableError"
                   for a in got)


def test_pager_spans_match_jax(system):
    """Traced, the pager emits the JAX pager's page_fault spans (names,
    site, attributes, the retry-absorbed errors included) in order."""
    from repro.obs import Tracer as JTracer
    from repro_torch.obs import Tracer
    tp, jp = _caches(system["base"], "float32", kind="paged", page_rows=64,
                     cache_bytes=64 * 160, retry_backoff_s=0.0)
    tp.tracer, jp.tracer = Tracer(), JTracer()
    tp.read_hook = FaultPlan([FaultEvent(
        "page_io_error", site="pager", start=1, count=2)]).pager_hook()
    jp.read_hook = JPlan([JEvent(
        "page_io_error", site="pager", start=1, count=2)]).pager_hook()
    for ids in _traces("sequential", N)[:6]:
        tp.gather(ids)
        jp.gather(ids)
    got = [(s.name, s.site, s.attrs) for s in tp.tracer.spans()]
    want = [(s.name, s.site, s.attrs) for s in jp.tracer.spans()]
    assert got == want and any("io_errors" in a for _, _, a in got)


def test_store_guards(system):
    base = system["base"]
    store = make_corpus_store(base, "int8", device="cpu", residency=PAGED)
    assert isinstance(store, PagedCorpusStore) and store.device.type == "cpu"
    with pytest.raises(ValueError, match="paged store holds"):
        tcorpus.as_corpus_store(store, "float32", device="cpu")
    assert tcorpus.as_corpus_store(store, "int8", device="cpu") is store
    with pytest.raises(ValueError, match="scales"):
        make_paged_store(np.zeros((4, 3), np.int8), "int8", PAGED,
                         device="cpu")
    with pytest.raises(ValueError, match="residency kind"):
        ResidencyPolicy("mmap")
    with pytest.raises(ValueError, match="page_rows"):
        ResidencyPolicy("paged", page_rows=0)
    flags = np.zeros(N, bool)
    flags[::5] = True
    dead = store.with_tombstones(flags)
    assert dead.cache is store.cache and store.tombstones is None
    np.testing.assert_array_equal(
        dead.tombstones.numpy().astype(np.uint32), tcorpus.pack_bitmap(flags))
    # the device (here the CPU) gathers the whole store's rows
    whole = make_corpus_store(base, "int8", device="cpu")
    ids = torch.arange(N).reshape(20, 30)
    assert torch.equal(store.take(ids), whole.take(ids))
    assert torch.equal(store.dequantize(), whole.dequantize())


# ---------------------------------------------------------------------------
# paged == whole through every search path
# ---------------------------------------------------------------------------

def _eng(system, family, fused, dtype="float32", **cfg):
    m = system["tms"][family]
    eng = build_engine(m, SearchConfig(k=10, ef=32, budget=6, alpha=1.1,
                                       **cfg),
                       EngineOptions(fused=fused, corpus_dtype=dtype))
    return eng, m


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


@pytest.mark.parametrize("family", ["deepfm", "mlp"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_search_equals_whole(system, family, fused, dtype):
    """``search`` (the two halves of each step) and ``search_debug`` on a
    paged store equal the whole store's search bit for bit: unfused at
    every dtype (the path a paged store runs) and fused at every dtype on
    the CPU (the plain versions there dequantize as ``take`` does)."""
    eng, m = _eng(system, family, fused, dtype)
    g = system["graph"]
    q = torch.from_numpy(system["queries"])
    e = torch.full((Q,), g.entry)
    whole = make_corpus_store(system["base"], dtype, device="cpu")
    paged = make_corpus_store(system["base"], dtype, device="cpu",
                              residency=PAGED)
    want = eng.search(m.params, whole, system["nbrs"], q, e)
    got = eng.search(m.params, paged, system["nbrs"], q, e)
    dbg = eng.search_debug(m.params, paged, system["nbrs"], q, e)
    assert _same(got, want) and _same(dbg, want)
    st = paged.stats_snapshot()
    assert st.hits + st.faults > 0
    # the host issue seconds of a paged search split by part
    assert eng.stats["paged_gather_s"] > 0


def test_paged_search_gathers_replay_through_jax_pager(system):
    """Every gather a port search makes (the entries, then one (Q, 1+B)
    block per step), replayed through the JAX pager, leaves the same
    stats; a gather per step, none after the lanes are done."""
    eng, m = _eng(system, "deepfm", True, "int8")
    g = system["graph"]
    paged = make_corpus_store(system["base"], "int8", device="cpu",
                              residency=PAGED)
    trace = []
    gather = paged.cache.gather

    def recording(ids, out=None):
        trace.append(np.array(ids))
        return gather(ids, out=out)
    paged.cache.gather = recording
    steps0 = eng.stats["steps"]
    eng.search(m.params, paged, system["nbrs"],
               torch.from_numpy(system["queries"]), torch.full((Q,),
                                                               g.entry))
    assert len(trace) == 1 + eng.stats["steps"] - steps0
    assert trace[0].shape == (Q,) and trace[1].shape == (Q, 1 + 8 * 2)
    data, scales = _payload(system["base"], "int8")
    jp = jcorpus._PageCache(data, scales, "int8", jcorpus.ResidencyPolicy(
        "paged", PAGED.page_rows, PAGED.cache_bytes))
    for ids in trace:
        jp.gather(ids)
    assert dataclasses.asdict(paged.stats_snapshot()) \
        == dataclasses.asdict(jp.stats)


@pytest.mark.parametrize("family", ["deepfm", "mlp"])
def test_paged_recall_matches_jax_paged_search(system, family):
    """Recall@10 of the port's paged search within 0.01 of the JAX paged
    search's on the same index, queries, weights and policy."""
    g = system["graph"]
    jm = system["jms"][family]
    jstore = jcorpus.make_corpus_store(
        system["base"], "float32", residency=jcorpus.ResidencyPolicy(
            "paged", PAGED.page_rows, PAGED.cache_bytes))
    jeng = j_build_engine(jm, JConfig(k=10, ef=32, budget=6, alpha=1.1),
                          JOptions(fused=True, rank_impl="ref",
                                   measure_impl="ref", grad_impl="ref"))
    qj = jnp.asarray(system["queries"])
    jres = jeng.search(jm.params, jstore, jnp.asarray(g.neighbors), qj,
                       jnp.full((Q,), g.entry, jnp.int32))
    truth, _ = j_brute_force_topk(jm, jnp.asarray(system["base"]), qj, 10)
    eng, m = _eng(system, family, True)
    paged = make_corpus_store(system["base"], device="cpu", residency=PAGED)
    res = eng.search(m.params, paged, system["nbrs"],
                     torch.from_numpy(system["queries"]),
                     torch.full((Q,), g.entry))
    r_port = recall(res.ids, np.asarray(truth))
    r_jax = recall(np.asarray(jres.ids), np.asarray(truth))
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)


@pytest.mark.parametrize("family", ["deepfm", "mlp"])
def test_paged_sharded_equals_whole(system, family):
    """``shard_stores(residency=paged)``: S pagers on their own budgets;
    ``sharded_search_stores`` over them equals over whole stores."""
    from repro.core import sharded as jsharded
    jidx = jsharded.build_sharded_index(system["base"], n_shards=3, m=8,
                                        k_construction=20)
    idx = ShardedIndex(base=jidx.base, neighbors=jidx.neighbors,
                       entries=jidx.entries, global_ids=jidx.global_ids,
                       n_shards=3)
    m = system["tms"][family]
    cfg = SearchConfig(k=10, ef=32, budget=6, alpha=1.1)
    q = system["queries"]
    for fused in (False, True):
        opts = EngineOptions(fused=fused, corpus_dtype="int8")
        paged = shard_stores(idx, "int8", residency=PAGED, devices=["cpu"])
        whole = shard_stores(idx, "int8", devices=["cpu"])
        assert all(p.is_paged for p in paged)
        got = sharded_search_stores(m, paged, idx, q, cfg, opts)
        want = sharded_search_stores(m, whole, idx, q, cfg, opts)
        assert _same(got, want)


@pytest.mark.parametrize("family", ["deepfm", "mlp"])
def test_paged_continuous_equals_whole(system, family):
    """The continuous runtime on a paged store (entries gathered on the
    host before each reset, a tick of paged steps, then the pack) returns
    the whole-resident runtime's completions bit for bit; its health line
    and registry carry the pager."""
    eng, m = _eng(system, family, True, "int8")
    g = system["graph"]
    reqs = [Request(rid=i, query=system["queries"][i]) for i in range(Q)]
    out = {}
    for name, res in (("whole", None), ("paged", PAGED)):
        store = make_corpus_store(system["base"], "int8", device="cpu",
                                  residency=res)
        rt = ContinuousRuntime(eng, m.params, store, system["nbrs"],
                               n_lanes=4, query_dim=D, entry=g.entry,
                               steps_per_tick=3, device="cpu")
        out[name] = {c.rid: c for c in rt.run_stream(reqs, realtime=False)}
        if name == "paged":
            assert set(rt.program.runs) == {"reset", "pre", "post", "pack"}
            assert rt.program.runs["pre"] == 3 * rt.program.runs["pack"]
            assert "pager(mode=paged hit_rate=" in rt.format_health()
            text = rt.bind_registry(Registry()).render_text()
            assert "repro_pager_hits_total" in text
    for rid, c in out["whole"].items():
        p = out["paged"][rid]
        assert np.array_equal(p.ids, c.ids)
        assert np.array_equal(p.scores, c.scores)
        assert (p.n_eval, p.n_grad, p.n_iters) == (c.n_eval, c.n_grad,
                                                   c.n_iters)


def test_paged_sharded_runtime_strikes_unavailable_shard(system):
    """In the sharded runtime a paged shard whose pager gives up
    (``CorpusUnavailableError``) is struck until its breaker opens; the
    other shards answer, flagged partial, free of its ids."""
    from repro.core import sharded as jsharded
    from repro_torch.serving import ShardedContinuousRuntime
    jidx = jsharded.build_sharded_index(system["base"], n_shards=2, m=8,
                                        k_construction=20)
    idx = ShardedIndex(base=jidx.base, neighbors=jidx.neighbors,
                       entries=jidx.entries, global_ids=jidx.global_ids,
                       n_shards=2)
    eng, m = _eng(system, "deepfm", False)
    pol = ResidencyPolicy("paged", page_rows=16, cache_bytes=16 * 160,
                          retry_backoff_s=0.0, fallback_bytes=1)
    rt = ShardedContinuousRuntime(eng, m.params, idx, 4, D,
                                  steps_per_tick=2, k_failures=2,
                                  cooldown_rounds=50, devices=["cpu"],
                                  residency=pol)
    rt.warmup(system["queries"][0])
    rt.runtimes[1].store.set_read_hook(FaultPlan([FaultEvent(
        "page_io_error", site="pager", count=10**6)]).pager_hook())
    got = rt.run_stream([Request(rid=i, query=system["queries"][i])
                         for i in range(8)], realtime=False)
    assert rt.health.n_opened == 1 and rt.health.states()[1] == "open"
    dead = idx.global_ids[1]
    assert {c.status for c in got} <= {"partial", "ok"}
    assert any(c.status == "partial" for c in got)
    for c in got:
        if c.status == "partial":
            assert not np.isin(c.ids[c.ids >= 0], dead).any()
    assert "repro_pager_degraded" in rt.bind_registry(
        Registry()).render_text()


# ---------------------------------------------------------------------------
# files, registry, health, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version,dtype", [(1, "float32"), (2, "bfloat16"),
                                           (2, "int8"), (3, "float32"),
                                           (3, "bfloat16"), (3, "int8")])
def test_load_corpus_store_paged_over_jax_files(tmp_path, system, version,
                                                dtype):
    """A paged store over files the JAX package wrote (v3 memory-mapped,
    v1/v2 from their npz arrays) gathers what the JAX paged store does,
    with its tombstones and the meta's page size when the policy keeps
    the default."""
    g = system["graph"]
    flags = np.zeros(N, bool)
    flags[::9] = True
    jg = jbuild.GraphIndex(neighbors=g.neighbors, entry=g.entry,
                           base=g.base, tombstones=flags)
    if version == 3:
        jio.save_index(str(tmp_path), jg, corpus_dtype=dtype, page_rows=50)
    else:
        arrays = {"neighbors": g.neighbors,
                  "tombstones": jcorpus.pack_bitmap(flags),
                  **jio._encode_base(g.base, dtype)}
        np.savez_compressed(tmp_path / "arrays.npz", **arrays)
        meta = {"format_version": version, "kind": "graph",
                "entry": int(g.entry), "n": N, "dim": D,
                "max_degree": int(g.max_degree), "avg_degree": 1.0,
                "corpus_dtype": dtype}
        (tmp_path / "meta.json").write_text(json.dumps(meta))
    policy = ResidencyPolicy("paged", cache_bytes=2 * 50 * 160)
    store = load_corpus_store(str(tmp_path), residency=policy, device="cpu")
    jstore = jio.load_corpus_store(str(tmp_path),
                                   residency=jcorpus.ResidencyPolicy(
                                       "paged", cache_bytes=2 * 50 * 160))
    assert store.cache.page_rows == jstore.cache.page_rows \
        == (50 if version == 3 else 4096)
    if version == 3:
        assert isinstance(store.cache.data, np.memmap)
    np.testing.assert_array_equal(
        store.tombstones.numpy().astype(np.uint32),
        np.asarray(jstore.tombstones))
    for ids in _traces("random", N, seed=8)[:10]:
        np.testing.assert_array_equal(store.cache.gather(ids),
                                      jstore.cache.gather(ids))
        assert dataclasses.asdict(store.stats_snapshot()) \
            == dataclasses.asdict(jstore.stats_snapshot())
    save_index(str(tmp_path / "port"), _tgraph(jg), corpus_dtype=dtype)
    back = load_corpus_store(str(tmp_path / "port"), residency="paged",
                             device="cpu")
    whole = load_corpus_store(str(tmp_path / "port"), device="cpu")
    ids = torch.arange(N)
    assert torch.equal(back.take(ids), whole.take(ids))


def _tgraph(jg):
    from repro_torch.graph import GraphIndex
    return GraphIndex(neighbors=jg.neighbors, entry=jg.entry, base=jg.base,
                      tombstones=jg.tombstones)


def test_registry_and_health_match_jax(system):
    """The eight ``repro_pager_*`` families render as the JAX store's over
    the same gathers, and the runtime's health fields and line read as
    the JAX runtime's for the same pager stats."""
    data, scales = _payload(system["base"], "bfloat16")
    tstore = make_paged_store(data, "bfloat16", PAGED, scales, device="cpu")
    jstore = jcorpus.make_paged_store(data, "bfloat16",
                                      jcorpus.ResidencyPolicy(
                                          "paged", PAGED.page_rows,
                                          PAGED.cache_bytes))
    for ids in _traces("random", N)[:10]:
        tstore.cache.gather(ids)
        jstore.cache.gather(ids)
    treg = tstore.bind_registry(Registry(), shard="2")
    jreg = jstore.bind_registry(JRegistry(), shard="2")
    assert treg.render_text() == jreg.render_text()
    assert treg.render_text().count("# TYPE repro_pager_") == 8

    g = system["graph"]
    eng, m = _eng(system, "deepfm", True, "bfloat16")
    rt = ContinuousRuntime(eng, m.params, tstore, system["nbrs"], n_lanes=4,
                           query_dim=D, entry=g.entry, device="cpu")
    jm = system["jms"]["deepfm"]
    jeng = j_build_engine(jm, JConfig(k=10, ef=32, budget=6, alpha=1.1),
                          JOptions(fused=True, corpus_dtype="bfloat16",
                                   rank_impl="ref", measure_impl="ref",
                                   grad_impl="ref"))
    jrt = JRuntime(jeng, jm.params, jstore, jnp.asarray(g.neighbors),
                   n_lanes=4, query_dim=D, entry=g.entry)
    jstore.cache.stats = dataclasses.replace(tstore.cache.stats)
    assert rt.health_snapshot() == jrt.health_snapshot()
    assert rt.format_health() == jrt.format_health()


def test_serve_and_build_index_paged_on_cpu(tmp_path, capsys):
    """``serve --residency paged`` (one-shot, and continuous with page-read
    chaos, tracing and the registry) and ``build_index --residency
    paged`` on the CPU; a paged serve of an index in another dtype is
    refused (paging cannot re-quantize)."""
    from repro_torch.launch import build_index, serve
    out = str(tmp_path / "idx")
    build_index.main(["--items", "500", "--dim", "40", "--m", "8",
                      "--k-construction", "20", "--corpus-dtype", "int8",
                      "--page-rows", "32", "--residency", "paged", "--out",
                      out, "--device", "cpu"])
    assert "paged verification ok" in capsys.readouterr().out
    common = ["--index", out, "--queries", "40", "--batch", "32",
              "--corpus-dtype", "int8", "--device", "cpu"]
    whole = serve.main(common)
    paged = serve.main(common + ["--residency", "paged", "--cache-mb",
                                 "1"])
    assert paged["recall"] == whole["recall"]
    assert paged["evals_per_query"] == whole["evals_per_query"]
    assert paged["pager"]["faults"] > 0 and paged["pager"]["fallback"] == ""
    assert set(paged["paged_us_per_step"]) == {"replay", "sync", "gather",
                                               "h2d"}
    text = capsys.readouterr().out
    assert "corpus paged: dtype=int8 page_rows=32" in text
    assert "paged step: replays" in text
    plan = tmp_path / "plan.json"
    FaultPlan([FaultEvent("page_io_error", site="pager", start=1,
                          count=2)]).save(str(plan))
    spans, prom = str(tmp_path / "s.jsonl"), str(tmp_path / "m.prom")
    cont = serve.main(common + ["--residency", "paged", "--page-rows", "16",
                                "--cache-mb", "0", "--runtime", "continuous",
                                "--lanes", "8", "--offered-qps", "400",
                                "--chaos", str(plan), "--trace-sample", "1",
                                "--trace-out", spans, "--metrics-out", prom])
    assert cont["health"]["pager"]["retries"] == 2
    assert cont["statuses"] == {"ok": 40}
    text = capsys.readouterr().out
    assert "pager(mode=paged" in text
    assert open(prom).read().count("# TYPE repro_pager_") == 8
    with open(spans) as f:
        assert any(json.loads(ln).get("site") == "pager" for ln in f)
    with pytest.raises(SystemExit, match="cannot re-quantize"):
        serve.main(["--index", out, "--queries", "8", "--device", "cpu",
                    "--residency", "paged"])
