"""The port's engine, measures, corpus, registry, search API and serving
pieces against the JAX package on the CPU.

Integer and comparison stages (pop, visited bitmap, top-C selection, pool
insert) must match the JAX functions exactly on the same state. Whole
searches are held on recall@10 (within 0.01 of the JAX engine on the same
graph, base, queries and weights): trajectories may part once the two
backends round one ulp apart. The JAX engine runs on the CPU, where its
stages route to the jnp references.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import (EngineOptions as JOptions,  # noqa: E402
                        SearchConfig as JConfig,
                        brute_force_topk as j_brute_force_topk,
                        make_family_measure as j_make_family_measure,
                        search_measure as j_search_measure)
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro_torch.core import (EngineOptions,  # noqa: E402
                              MeasureKernelBundle, SearchConfig,
                              brute_force_topk, build_engine, get_bundle,
                              register_bundle,
                              deepfm_measure, inner_product_measure,
                              l2_measure, make_corpus_store,
                              make_family_measure, params_from_jax, recall,
                              resolve_stages, search_measure)
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.corpus import as_corpus_store  # noqa: E402
from repro_torch.core.measures import deepfm_config_for  # noqa: E402
from repro_torch.serving import (bucket_pad, bucket_size,  # noqa: E402
                                 latency_summary)

N, D, Q = 1000, 40, 64


@pytest.fixture(scope="module")
def system():
    """N=1000 items, D=40, the JAX DeepFM measure and its l2 graph; the
    port gets the same weights through ``params_from_jax``."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    graph = j_build_l2_graph(base, m=12, k_construction=48)
    jm = j_make_family_measure("deepfm", jax.random.PRNGKey(0), D)
    np_mlp = jax.tree_util.tree_map(np.asarray, jm.params["mlp"])
    tm = deepfm_measure({"mlp": params_from_jax(np_mlp, device="cpu")},
                        deepfm_config_for(D))
    truth, _ = j_brute_force_topk(jm, jnp.asarray(base), jnp.asarray(queries),
                                  10)
    return dict(base=base, queries=queries, graph=graph, jm=jm, tm=tm,
                np_mlp=np_mlp, truth=np.asarray(truth))


# ---------------------------------------------------------------------------
# stages: exact against the JAX functions
# ---------------------------------------------------------------------------

def _random_state(seed, Qs=16, ef=12, nwords=8):
    """A JAX EngineState and its port twin: desc-sorted pools with tied
    scores and -inf tails, random expansion flags and done lanes."""
    rng = np.random.default_rng(seed)
    scores = -np.sort(-rng.integers(0, 5, size=(Qs, ef)).astype(np.float32),
                      axis=1)
    scores[:, ef - 3:] = -np.inf
    scores[0] = -np.inf                           # an empty pool
    ids = rng.integers(0, 32 * nwords, size=(Qs, ef)).astype(np.int32)
    ids[:, ef - 3:] = -1
    expanded = rng.random((Qs, ef)) < 0.5
    expanded[:, ef - 3:] = True
    visited = rng.integers(0, 2 ** 32, size=(Qs, nwords), dtype=np.uint64)
    cnt = rng.integers(0, 9, size=(Qs,)).astype(np.int32)
    done = rng.random(Qs) < 0.25
    caps = np.full((Qs,), 8, np.int32)
    taus = np.zeros((Qs,), np.float32)
    js = jeng.EngineState(
        jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(expanded),
        jnp.asarray(visited.astype(np.uint32)), jnp.asarray(cnt),
        jnp.asarray(cnt), jnp.asarray(cnt), jnp.asarray(done),
        jnp.asarray(caps), jnp.asarray(taus))
    ts = teng.EngineState(
        torch.from_numpy(scores), torch.from_numpy(ids.astype(np.int64)),
        torch.from_numpy(expanded), torch.from_numpy(visited.astype(np.int64)),
        torch.from_numpy(cnt), torch.from_numpy(cnt), torch.from_numpy(cnt),
        torch.from_numpy(done), torch.from_numpy(caps),
        torch.from_numpy(taus))
    return js, ts


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(
        t.numpy().dtype))


@pytest.mark.parametrize("seed", [0, 1])
def test_pop_stage_exact(seed):
    js, ts = _random_state(seed)
    js2, jpop = jeng.default_pop_stage(js)
    ts2, tpop = teng.default_pop_stage(ts)
    for t, j in zip(tpop, jpop):
        _eq(t, j)
    _eq(ts2.pool_expanded, js2.pool_expanded)


def test_visited_bitmap_exact():
    js, ts = _random_state(3)
    rng = np.random.default_rng(3)
    Qs, W = ts.visited.shape
    ids = np.stack([rng.permutation(32 * W)[:10] for _ in range(Qs)])
    ids[:, -2:] = -1
    mask = rng.random(ids.shape) < 0.6
    _eq(teng.bit_test_rows(ts.visited, torch.from_numpy(ids)),
        jeng.bit_test_rows(js.visited, jnp.asarray(ids)))
    # setting needs fresh ids: clear their bits first on both sides
    fresh = np.asarray(js.visited).astype(np.uint64)
    for q in range(Qs):
        for i in ids[q][ids[q] >= 0]:
            fresh[q, i >> 5] &= ~np.uint64(1 << (i & 31))
    got = teng.bit_set_rows(torch.from_numpy(fresh.astype(np.int64)),
                            torch.from_numpy(ids), torch.from_numpy(mask))
    want = jeng.bit_set_rows(jnp.asarray(fresh.astype(np.uint32)),
                             jnp.asarray(ids), jnp.asarray(mask))
    _eq(got, np.asarray(want).astype(np.int64))
    assert int(got.max()) < 2 ** 32


@pytest.mark.parametrize("variant", ["band", "valid", "adaptive_tau"])
def test_select_top_c_exact(variant):
    rng = np.random.default_rng(5)
    Qs, B = 16, 24
    key = rng.integers(0, 6, size=(Qs, B)).astype(np.float32) / 4.0  # ties
    valid = rng.random((Qs, B)) < 0.7
    key[~valid] = np.inf
    in_range = valid & (rng.random((Qs, B)) < 0.6)
    tau = rng.choice([-1.0, 0.5, 1.0], size=Qs).astype(np.float32)
    cfg_kw = dict(budget=8, adaptive=variant != "valid")
    c_max, tau_arg = (12, tau) if variant == "adaptive_tau" else (None, None)
    j_idx, j_mask = jeng._select_top_c(
        jnp.asarray(key), jnp.asarray(in_range), jnp.asarray(valid),
        JConfig(**cfg_kw), c_max,
        None if tau_arg is None else jnp.asarray(tau_arg))
    t_idx, t_mask = teng._select_top_c(
        torch.from_numpy(key), torch.from_numpy(in_range),
        torch.from_numpy(valid), SearchConfig(**cfg_kw), c_max,
        None if tau_arg is None else torch.from_numpy(tau_arg))
    _eq(t_idx, j_idx)
    _eq(t_mask, j_mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_stage_exact(seed):
    js, ts = _random_state(seed)
    rng = np.random.default_rng(100 + seed)
    Qs = ts.pool_scores.shape[0]
    C = 6
    # candidate scores tie with pool entries and with each other
    scores = rng.integers(0, 5, size=(Qs, C)).astype(np.float32)
    ids = rng.integers(0, 256, size=(Qs, C)).astype(np.int32)
    mask = rng.random((Qs, C)) < 0.7
    jout = jeng.default_insert_stage(js, jnp.asarray(ids),
                                     jnp.asarray(scores), jnp.asarray(mask))
    tout = teng.default_insert_stage(ts, torch.from_numpy(ids.astype(
        np.int64)), torch.from_numpy(scores), torch.from_numpy(mask))
    for f in ("pool_scores", "pool_ids", "pool_expanded"):
        _eq(getattr(tout, f), getattr(jout, f))


def test_freeze_done_keeps_done_lanes_and_exempts_visited():
    _, old = _random_state(7)
    _, new = _random_state(8)
    out = teng._freeze_done(old.done, new, old)
    d = old.done
    for f in teng.EngineState._fields:
        got, n, o = getattr(out, f), getattr(new, f), getattr(old, f)
        if f == "visited":
            assert got is n
        else:
            assert torch.equal(got[d], o[d]) and torch.equal(got[~d], n[~d])


# ---------------------------------------------------------------------------
# whole searches: recall parity with the JAX engine
# ---------------------------------------------------------------------------

SEARCHES = {
    "guitar-angle": (dict(mode="guitar", rank_by="angle"), {}),
    "guitar-projection": (dict(mode="guitar", rank_by="projection"), {}),
    "sl2g": (dict(mode="sl2g"), {}),
    "adaptive-angle": (dict(mode="guitar", rank_by="angle", alpha=1.2),
                       dict(adaptive="angle", c_max=12, angle_tau=1.8)),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_recall_matches_jax(system, name):
    cfg_kw, opt_kw = SEARCHES[name]
    cfg_kw = {**dict(k=10, ef=32, budget=8, alpha=1.01), **cfg_kw}
    g = system["graph"]
    jr = j_search_measure(
        system["jm"], jnp.asarray(system["base"]), jnp.asarray(g.neighbors),
        jnp.asarray(system["queries"]), jnp.full((Q,), g.entry, jnp.int32),
        JConfig(**cfg_kw), JOptions(**opt_kw))
    tr = search_measure(
        system["tm"], make_corpus_store(system["base"], device="cpu"),
        torch.from_numpy(g.neighbors), torch.from_numpy(system["queries"]),
        torch.full((Q,), g.entry), SearchConfig(**cfg_kw),
        EngineOptions(**opt_kw))
    r_j = recall(np.asarray(jr.ids), system["truth"])
    r_t = recall(tr.ids, system["truth"])
    assert abs(r_j - r_t) <= 0.01, (r_j, r_t)
    assert r_t > 0.5
    n_iters = tr.n_iters.numpy()
    if cfg_kw["mode"] == "guitar":
        assert (tr.n_grad.numpy() == n_iters).all()
        C = opt_kw.get("c_max", cfg_kw["budget"])
        assert (tr.n_eval.numpy() <= 1 + C * n_iters).all()
    else:
        assert (tr.n_grad.numpy() == 0).all()
    # returned scores are the measure's scores of the returned ids
    ids = tr.ids
    want = system["tm"].score(torch.from_numpy(system["base"])[ids],
                              torch.from_numpy(system["queries"])[:, None])
    np.testing.assert_allclose(tr.scores.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_generic_stages_match_kernel_stages(system):
    """measure_impl/grad_impl='vmap' (batched score_fn, torch.func grad)
    against the DeepFM bundle's stages; routing tags say which is which."""
    tm = system["tm"]
    kern = resolve_stages(tm.score_fn, tm.meta, EngineOptions())
    gen = resolve_stages(tm.score_fn, tm.meta,
                         EngineOptions(measure_impl="vmap", grad_impl="vmap"))
    assert kern.measure.bundle_family == "deepfm"
    assert kern.grad.bundle_family == "deepfm"
    assert gen.measure.bundle_family == gen.grad.bundle_family == "generic"
    x = torch.from_numpy(system["base"][:24])
    q = torch.from_numpy(system["queries"][:24])
    np.testing.assert_allclose(kern.measure(tm.params, x, q).numpy(),
                               gen.measure(tm.params, x, q).numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(kern.grad(tm.params, x, q), gen.grad(tm.params, x, q)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    ip = inner_product_measure()
    assert resolve_stages(ip.score_fn, ip.meta,
                          EngineOptions()).measure.bundle_family == "generic"


def test_registry_routes_registered_families(system):
    """A family joins through ``register_bundle``; its slots route, absent
    slots fall back to the generic stages, and names are unique."""
    tm = system["tm"]
    assert get_bundle("deepfm").family == "deepfm"
    with pytest.raises(ValueError, match="already registered"):
        register_bundle(MeasureKernelBundle("deepfm"))
    calls = []

    def score_factory(meta, options):
        def stage(params, vecs, qs):
            calls.append(vecs.shape[0])
            return tm.score_fn(params, vecs, qs)
        return stage

    register_bundle(MeasureKernelBundle("test-family", score=score_factory),
                    overwrite=True)
    st = resolve_stages(tm.score_fn, ("test-family",), EngineOptions())
    assert st.measure.bundle_family == "test-family"
    assert st.grad.bundle_family == "generic"
    x = torch.from_numpy(system["base"][:5])
    st.measure(tm.params, x, x)
    assert calls == [5]


def test_rank_impl_ref_matches_auto(system):
    """rank_impl='ref' forces the plain ranking everywhere; on the CPU it is
    the path 'auto' takes, so the searches agree exactly."""
    g = system["graph"]
    args = (system["tm"], torch.from_numpy(system["base"]),
            torch.from_numpy(g.neighbors),
            torch.from_numpy(system["queries"][:16]),
            torch.full((16,), g.entry), SearchConfig(k=10, ef=24))
    a = search_measure(*args, EngineOptions())
    b = search_measure(*args, EngineOptions(rank_impl="ref"))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    with pytest.raises(ValueError, match="rank_impl"):
        build_engine(system["tm"], SearchConfig(),
                     EngineOptions(rank_impl="pallas"))


def test_generic_measure_search_runs(system):
    g = system["graph"]
    for m in (inner_product_measure(), l2_measure()):
        res = search_measure(m, torch.from_numpy(system["base"]),
                             torch.from_numpy(g.neighbors),
                             torch.from_numpy(system["queries"][:8]),
                             torch.full((8,), g.entry),
                             SearchConfig(k=5, ef=16))
        assert res.ids.shape == (8, 5) and torch.isfinite(res.scores).all()


def test_brute_force_topk_matches_jax(system):
    ids, scores = brute_force_topk(system["tm"],
                                   torch.from_numpy(system["base"]),
                                   torch.from_numpy(system["queries"]), 10,
                                   batch=300, q_block=40)
    np.testing.assert_array_equal(ids.numpy(), system["truth"])
    assert (scores[:, :-1] >= scores[:, 1:]).all()


def test_measure_matches_jax_score(system):
    x, q = system["base"][:50], system["queries"][:50]
    want = jax.vmap(lambda a, b: system["jm"].score(a, b))(jnp.asarray(x),
                                                          jnp.asarray(q))
    got = system["tm"].score(torch.from_numpy(x), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    gx = system["tm"].grad_x(torch.from_numpy(x[0]), torch.from_numpy(q[0]))
    wgx = system["jm"].grad_x(jnp.asarray(x[0]), jnp.asarray(q[0]))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wgx), rtol=1e-5,
                               atol=1e-6)


def test_make_family_measure_init():
    a = make_family_measure("deepfm", torch.Generator().manual_seed(3), 40,
                            device="cpu")
    b = make_family_measure("deepfm", torch.Generator().manual_seed(3), 40,
                            device="cpu")
    assert a.meta == ("deepfm", 8)
    w, bias = a.params["mlp"]["w"], a.params["mlp"]["b"]
    assert [tuple(t.shape) for t in w] == [(64, 64), (64, 64), (64, 1)]
    assert all(torch.equal(s, t) for s, t in zip(w, b.params["mlp"]["w"]))
    assert all((t == 0).all() for t in bias)
    # N(0, 1) / sqrt(d_in), as the JAX dense_init
    assert abs(float(w[0].std()) * 8 - 1) < 0.05
    # the mlp family builds too (since its kernels were ported): the JAX
    # launcher's widths, 80 -> 64 -> 64 -> 1
    m = make_family_measure("mlp", torch.Generator(), 40, device="cpu")
    assert m.meta == ("mlp",)
    assert [tuple(t.shape) for t in m.params["w"]] == [(80, 64), (64, 64),
                                                       (64, 1)]
    with pytest.raises(RuntimeError, match="cuda"):
        if torch.cuda.is_available():
            raise RuntimeError("cuda present: nothing to refuse here")
        make_family_measure("deepfm", torch.Generator(), 40)


def test_corpus_store_fp32_only():
    """Residency in all three dtypes (the test kept its first slice's
    name): fp32 gathers exactly, bf16 within bf16 rounding, int8 within
    half a step of its row scale, and a store in another dtype is
    re-quantized from its float32 view."""
    base = np.random.default_rng(0).normal(size=(50, 40)).astype(np.float32)
    ids = torch.tensor([[3, 0], [49, 7]])
    step = np.abs(base).max(1, keepdims=True) / 127
    for dt, itemsize, tol in (("float32", 4, 0.0), ("bfloat16", 2, 2 ** -8),
                              ("int8", 1, None)):
        store = make_corpus_store(base, dt, device="cpu")
        extra = 50 * 4 if dt == "int8" else 0
        assert store.n == 50 and store.dim == 40 and store.dtype == dt
        assert store.nbytes() == 50 * 40 * itemsize + extra
        got = store.take(ids).numpy()
        assert got.dtype == np.float32
        err = np.abs(got - base[[[3, 0], [49, 7]]])
        if tol is None:
            assert (err <= step[[[3, 0], [49, 7]]] / 2 + 1e-7).all()
        else:
            assert (err <= tol * np.abs(base[[[3, 0], [49, 7]]])).all()
        np.testing.assert_array_equal(store.dequantize()[ids].numpy(), got)
        assert as_corpus_store(store, dt) is store
        again = as_corpus_store(store, "float32")
        np.testing.assert_array_equal(again.data.numpy(),
                                      store.dequantize().numpy())
    with pytest.raises(ValueError, match="corpus_dtype"):
        make_corpus_store(base, "float16", device="cpu")


def test_engine_options_checked(system):
    tm = system["tm"]
    with pytest.raises(ValueError, match="corpus_dtype"):
        build_engine(tm, SearchConfig(), EngineOptions(corpus_dtype="fp8"))
    with pytest.raises(ValueError, match="rank_by='angle'"):
        build_engine(tm, SearchConfig(rank_by="projection"),
                     EngineOptions(adaptive="angle"))
    eng = build_engine(tm, SearchConfig(mode="sl2g"))
    assert eng.grad is None and eng.n_candidates(48) == 48
    assert eng.rank_fused is None and eng.measure_fused is None
    fused = build_engine(tm, SearchConfig(mode="sl2g"),
                         EngineOptions(fused=True, corpus_dtype="int8"))
    assert fused.grad_fused is None and fused.rank_fused is not None


def test_batching_and_latency_match_jax():
    for n in (1, 8, 9, 33, 512, 513, 1500):
        assert bucket_size(n) == jbatching.bucket_size(n)
    q = np.random.default_rng(0).normal(size=(5, 40)).astype(np.float32)
    qt, entries, n = bucket_pad(q, 17, device="cpu")
    qj, ej, nj = jbatching.bucket_pad(q, 17)
    assert n == nj == 5
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(entries.numpy(), np.asarray(ej))
    lat = [3.0, 1.0, 7.5, 2.25, 9.0]
    assert latency_summary(lat) == jmetrics.latency_summary(lat)
    assert np.isnan(latency_summary([])["p50_ms"])


def test_serve_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--items", "600", "--dim", "40", "--queries", "40",
                      "--batch", "32", "--device", "cpu"])
    assert out["n_batches"] == 2 and out["qps"] > 0
    assert out["recall"] > 0.5
    assert "steady-state" in capsys.readouterr().out
    # paged residency serves the same answers (the recall window's ids)
    paged = serve.main(["--items", "600", "--dim", "40", "--queries", "40",
                        "--batch", "32", "--device", "cpu", "--residency",
                        "paged", "--page-rows", "64", "--cache-mb", "1"])
    assert paged["residency"] == "paged" and out["residency"] == "whole"
    assert paged["recall"] == out["recall"]
    assert paged["evals_per_query"] == out["evals_per_query"]
    assert "corpus paged:" in capsys.readouterr().out
    with pytest.raises(SystemExit,
                       match="--trace-sample needs --runtime continuous"):
        serve.main(["--trace-sample", "8", "--device", "cpu"])
    mlp = serve.main(["--items", "600", "--dim", "40", "--queries", "40",
                      "--batch", "32", "--measure", "mlp", "--device",
                      "cpu"])
    assert mlp["n_batches"] == 2 and mlp["qps"] > 0 and mlp["recall"] > 0.5
    # the fused step's plan override serves (the fused f32 answers)
    fused = serve.main(["--items", "600", "--dim", "40", "--queries", "40",
                        "--batch", "32", "--device", "cpu", "--fused"])
    rowwise = serve.main(["--items", "600", "--dim", "40", "--queries",
                          "40", "--batch", "32", "--device", "cpu",
                          "--fused", "--tile", "rowwise"])
    assert rowwise["fused"] and rowwise["n_batches"] == 2
    assert rowwise["recall"] == fused["recall"] == out["recall"]
    assert rowwise["evals_per_query"] == fused["evals_per_query"]
