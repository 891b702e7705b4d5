"""The port's ``core/search.py`` against the JAX package's on the CPU:
``rank_and_prune`` exactly (slots and mask), ``search_legacy`` against the
JAX legacy searcher and against the port's engine, ``search`` against
``search_measure``, and ``serve --searcher legacy`` with its refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.core import brute_force_topk as j_brute_force_topk  # noqa: E402
from repro.core import l2_measure as j_l2_measure  # noqa: E402
from repro.core import make_family_measure as j_make_family_measure  # noqa: E402
from repro.core import search_legacy as j_search_legacy  # noqa: E402
from repro.core.search import rank_and_prune as j_rank_and_prune  # noqa: E402
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro_torch.core import (SearchConfig, deepfm_measure,  # noqa: E402
                              l2_measure, make_corpus_store,
                              params_from_jax, rank_and_prune, recall,
                              search, search_legacy, search_measure)
from repro_torch.core.measures import deepfm_config_for  # noqa: E402

N, D, Q = 1000, 40, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these searches are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# rank_and_prune: exact against JAX
# ---------------------------------------------------------------------------

def _rank_inputs(case, seed):
    rng = np.random.default_rng(seed)
    B, Dd = 20, 8
    diffs = rng.normal(size=(B, Dd)).astype(np.float32)
    grad = rng.normal(size=(Dd,)).astype(np.float32)
    valid = rng.random(B) < 0.7
    if case == "ties":
        diffs[5] = diffs[2]                  # equal keys: lower slot first
        diffs[11] = diffs[2]
        diffs[7] = diffs[3]
        valid[[2, 3, 5, 7, 11]] = True
    elif case == "all_invalid":
        valid[:] = False
    elif case == "negative_theta":
        # every neighbor against the gradient: theta < 0 in projection
        diffs = -np.abs(diffs) * np.sign(grad)[None, :]
    elif case == "zero_rows":
        diffs[[1, 4]] = 0.0
        valid[[1, 4]] = True
    return diffs, grad, valid


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid",
                                  "negative_theta", "zero_rows"])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("rank_by", ["angle", "projection"])
def test_rank_and_prune_matches_jax(rank_by, adaptive, case):
    for seed, (budget, alpha) in enumerate(((6, 1.1), (25, 1.01),
                                            (3, 1.5))):
        diffs, grad, valid = _rank_inputs(case, seed)
        j_idx, j_mask = j_rank_and_prune(jnp.asarray(diffs),
                                         jnp.asarray(grad),
                                         jnp.asarray(valid), budget, alpha,
                                         rank_by, adaptive)
        t_idx, t_mask = rank_and_prune(torch.from_numpy(diffs),
                                       torch.from_numpy(grad),
                                       torch.from_numpy(valid), budget,
                                       alpha, rank_by, adaptive)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))


# ---------------------------------------------------------------------------
# whole searches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system():
    """N=1000 items of D=40, the JAX DeepFM measure and its port twin (the
    same weights), the l2 measure, their exact top-10 and an l2 graph."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    graph = j_build_l2_graph(base, m=12, k_construction=48)
    jm = j_make_family_measure("deepfm", jax.random.PRNGKey(0), D)
    np_mlp = jax.tree_util.tree_map(np.asarray, jm.params["mlp"])
    tm = deepfm_measure({"mlp": params_from_jax(np_mlp, device="cpu")},
                        deepfm_config_for(D))
    measures = {"deepfm": (jm, tm), "l2": (j_l2_measure(), l2_measure())}
    truth = {name: np.asarray(j_brute_force_topk(
        j, jnp.asarray(base), jnp.asarray(queries), 10)[0])
        for name, (j, _) in measures.items()}
    return dict(base=base, queries=queries, graph=graph, measures=measures,
                truth=truth)


def _port_args(system):
    g = system["graph"]
    return (torch.as_tensor(system["base"]), torch.as_tensor(g.neighbors),
            torch.as_tensor(system["queries"]), torch.full((Q,), g.entry))


CONFIGS = {
    "guitar-angle": dict(mode="guitar", rank_by="angle"),
    "guitar-projection": dict(mode="guitar", rank_by="projection"),
    "guitar-no-band": dict(mode="guitar", rank_by="angle", adaptive=False),
    "sl2g": dict(mode="sl2g"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("measure", ["deepfm", "l2"])
def test_search_legacy_matches_jax_legacy(system, measure, name):
    """The port's legacy searcher against the JAX one on the same graph,
    base, queries and weights: recall@10 within 0.01, the counters within
    2 a query."""
    jm, tm = system["measures"][measure]
    kw = dict(k=10, ef=32, budget=6, alpha=1.1, **CONFIGS[name])
    g = system["graph"]
    jr = j_search_legacy(jm.score_fn, jm.params, jnp.asarray(system["base"]),
                         jnp.asarray(g.neighbors),
                         jnp.asarray(system["queries"]),
                         jnp.full((Q,), g.entry, jnp.int32), JConfig(**kw))
    tr = search_legacy(tm.score_fn, tm.params, *_port_args(system),
                       SearchConfig(**kw))
    truth = system["truth"][measure]
    rj, rt = recall(np.asarray(jr.ids), truth), recall(tr.ids, truth)
    assert abs(rj - rt) <= 0.01, (rj, rt)
    for f in ("n_eval", "n_grad", "n_iters"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=2,
                                   err_msg=f)
    assert tr.ids.dtype == torch.int64 and tr.scores.dtype == torch.float32


@pytest.mark.parametrize("name", list(CONFIGS))
def test_legacy_matches_engine(system, name):
    """The port's legacy searcher against the port's engine (as
    tests/test_engine.py holds JAX's): overlap >= 0.9, counters within 2;
    SL2G computes no gradient."""
    _, tm = system["measures"]["deepfm"]
    cfg = SearchConfig(k=10, ef=32, budget=6, alpha=1.1, **CONFIGS[name])
    args = _port_args(system)
    eng = search_measure(tm, *args, cfg)
    leg = search_legacy(tm.score_fn, tm.params, *args, cfg)
    overlap = np.mean([len(set(eng.ids[i].tolist())
                           & set(leg.ids[i].tolist())) / 10
                       for i in range(Q)])
    assert overlap >= 0.9, overlap
    for f in ("n_eval", "n_grad"):
        np.testing.assert_allclose(getattr(eng, f).numpy(),
                                   getattr(leg, f).numpy(), atol=2)
    if cfg.mode == "sl2g":
        assert int(leg.n_grad.abs().sum()) == 0


def test_search_equals_search_measure(system):
    """``search`` runs the engine for a bare score_fn: for a measure
    without a kernel bundle it is ``search_measure`` bit for bit; for
    DeepFM (the generic stages against the bundle's) recall agrees."""
    args = _port_args(system)
    cfg = SearchConfig(k=10, ef=32, budget=6, alpha=1.1)
    for name, (_, tm) in system["measures"].items():
        a = search(tm.score_fn, tm.params, *args, cfg)
        b = search_measure(tm, *args, cfg)
        if tm.meta is None:
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        else:
            truth = system["truth"][name]
            assert abs(recall(a.ids, truth) - recall(b.ids, truth)) <= 0.01


def test_search_legacy_refuses_a_store(system):
    _, tm = system["measures"]["deepfm"]
    _, nbrs, qt, entries = _port_args(system)
    store = make_corpus_store(system["base"], "float32", device="cpu")
    with pytest.raises(TypeError, match="float32"):
        search_legacy(tm.score_fn, tm.params, store, nbrs, qt, entries,
                      SearchConfig())


def test_legacy_programs_cached_and_eager_equal(system):
    """One program per batch shape and params/base/graph identity; the
    eager chunks (``capture=False``) give the same result."""
    from repro_torch.core.search import legacy_searcher
    _, tm = system["measures"]["deepfm"]
    cfg = SearchConfig(k=10, ef=24, budget=6, alpha=1.1)
    args = _port_args(system)
    a = search_legacy(tm.score_fn, tm.params, *args, cfg)
    b = search_legacy(tm.score_fn, tm.params, *args, cfg, capture=False)
    searcher = legacy_searcher(tm.score_fn, cfg)
    n = searcher.stats["programs"]
    c = search_legacy(tm.score_fn, tm.params, *args, cfg)
    assert searcher.stats["programs"] == n
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.equal(getattr(a, f), getattr(c, f))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SERVE = ["--items", "600", "--dim", "40", "--queries", "40", "--batch",
         "16", "--device", "cpu"]


def test_serve_searcher_legacy_on_cpu(capsys):
    """``--searcher legacy`` serves the same answers as the engine here
    (the recall window), over the float32 base; --adaptive and --tile are
    inert for it and paged residency searches the whole base, as in the
    JAX launcher."""
    from repro_torch.launch import serve
    eng = serve.main(SERVE)
    leg = serve.main(SERVE + ["--searcher", "legacy"])
    text = capsys.readouterr().out
    assert leg["searcher"] == "legacy" and eng["searcher"] == "engine"
    assert "searcher=legacy" in text
    assert leg["recall"] == eng["recall"] and leg["qps"] > 0
    assert leg["evals_per_query"] == eng["evals_per_query"]
    inert = serve.main(SERVE + ["--searcher", "legacy", "--adaptive",
                                "angle", "--tile", "tile"])
    paged = serve.main(SERVE + ["--searcher", "legacy", "--residency",
                                "paged", "--page-rows", "64",
                                "--cache-mb", "1"])
    for other in (inert, paged):
        assert other["recall"] == leg["recall"]
        assert other["evals_per_query"] == leg["evals_per_query"]
    assert paged["residency"] == "whole"
    assert "the paged store is not searched" in capsys.readouterr().out
    sl2g = serve.main(SERVE + ["--searcher", "legacy", "--mode", "sl2g"])
    assert sl2g["recall"] >= leg["recall"] - 0.05


def test_serve_searcher_legacy_from_an_index(tmp_path):
    """From ``--index`` legacy searches the index's base (as load_index
    gives it): the same answers as the engine serving that index."""
    from repro_torch.launch import serve
    idx = str(tmp_path / "idx")
    serve.main(SERVE + ["--searcher", "legacy", "--save-index", idx])
    loaded = serve.main(SERVE + ["--searcher", "legacy", "--index", idx])
    engine = serve.main(SERVE + ["--index", idx])
    assert loaded["recall"] == engine["recall"]
    assert loaded["evals_per_query"] == engine["evals_per_query"]


@pytest.mark.parametrize("flags,msg", [
    (["--fused"], "has no index-fused/quantized path"),
    (["--corpus-dtype", "int8"], "has no index-fused/quantized path"),
    (["--corpus-dtype", "bfloat16"], "has no index-fused/quantized path"),
    (["--runtime", "continuous"], "--runtime continuous is engine-only"),
])
def test_serve_searcher_legacy_refusals(flags, msg):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=msg):
        serve.main(SERVE + ["--searcher", "legacy"] + flags)


@pytest.mark.cuda
def test_legacy_captured_equals_eager_on_card():
    """On the card: the captured legacy search = the eager one bit for
    bit, and it launches none of the port's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured graphs run only there")
    from repro_torch.core import make_family_measure
    from repro_torch.graph import build_l2_graph
    from repro_torch.kernels import launch_counts, reset_launch_counts
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    base = rng.normal(size=(2000, D)).astype(np.float32)
    graph = build_l2_graph(base, m=12, k_construction=48, device=dev)
    m = make_family_measure("deepfm", torch.Generator().manual_seed(0), D,
                            device=dev)
    args = (torch.as_tensor(base, device=dev),
            torch.as_tensor(graph.neighbors, device=dev),
            torch.as_tensor(rng.normal(size=(32, D)).astype(np.float32),
                            device=dev),
            torch.full((32,), graph.entry, device=dev))
    for mode in ("guitar", "sl2g"):
        cfg = SearchConfig(k=10, ef=32, budget=6, alpha=1.1, mode=mode)
        reset_launch_counts()
        a = search_legacy(m.score_fn, m.params, *args, cfg)
        b = search_legacy(m.score_fn, m.params, *args, cfg, capture=False)
        torch.cuda.synchronize()
        assert not any(launch_counts().values())
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
