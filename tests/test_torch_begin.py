"""The port's BEGIN graph and paper-faithful searcher against the JAX
package on the CPU.

The co-rank adjacency is host integer logic: on the same top-L ids it must
equal the JAX ``build_begin_graph`` exactly. The top-L ids themselves come
from each package's exhaustive labeler (scores one ulp apart may reorder
near-ties), so the port's whole build is held on >= 99% of rows. The
faithful searcher and ``deepfm_numpy_fns`` are numpy copies: ids, scores
and counters must equal the JAX ones exactly. The engine on the BEGIN
graph stays within 0.05 recall of the faithful oracle, as in the JAX
package's own test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import begin as jbegin  # noqa: E402
from repro.core import (brute_force_topk as j_brute_force_topk,  # noqa: E402
                        deepfm_measure as j_deepfm_measure,
                        deepfm_numpy_fns as j_deepfm_numpy_fns,
                        faithful_search_batch as j_faithful_search_batch)
from repro.models import deepfm as jdeepfm  # noqa: E402
from repro_torch.core import (SearchConfig, begin_adjacency,  # noqa: E402
                              brute_force_topk, build_begin_graph,
                              deepfm_measure, deepfm_numpy_fns,
                              faithful_search, faithful_search_batch,
                              params_from_jax, recall, search_measure)
from repro_torch.models import deepfm as tdeepfm  # noqa: E402


@pytest.fixture(scope="module")
def system():
    """The JAX package's BEGIN unit-test system: DeepFM fm 4, deep 8,
    16x16, 300 items, 96 training queries, 8 queries."""
    cfg_j = jdeepfm.DeepFMConfig(fm_dim=4, deep_dim=8, mlp_hidden=(16, 16))
    params, _ = jdeepfm.init_measure(jax.random.PRNGKey(0), cfg_j)
    jm = j_deepfm_measure(params, cfg_j)
    np_mlp = jax.tree_util.tree_map(np.asarray, params["mlp"])
    cfg_t = tdeepfm.DeepFMConfig(fm_dim=4, deep_dim=8, mlp_hidden=(16, 16))
    tm = deepfm_measure({"mlp": params_from_jax(np_mlp, device="cpu")},
                        cfg_t)
    rng = np.random.default_rng(2)
    base = rng.normal(size=(300, 12)).astype(np.float32) * 0.5
    train_q = rng.normal(size=(96, 12)).astype(np.float32) * 0.5
    queries = rng.normal(size=(8, 12)).astype(np.float32) * 0.5
    jgraph = jbegin.build_begin_graph(jm, base, train_q, m=12, top_l=8)
    true_ids, _ = j_brute_force_topk(jm, jnp.asarray(base),
                                     jnp.asarray(queries), 10)
    return dict(params=params, cfg_j=cfg_j, cfg_t=cfg_t, jm=jm, tm=tm,
                base=base, train_q=train_q, queries=queries, jgraph=jgraph,
                true_ids=np.asarray(true_ids))


def test_begin_adjacency_equals_jax_on_same_top_ids(system):
    s = system
    top, _ = j_brute_force_topk(s["jm"], jnp.asarray(s["base"]),
                                jnp.asarray(s["train_q"]), 8)
    got = begin_adjacency(np.asarray(top), 300, m=12, seed=0)
    np.testing.assert_array_equal(got, s["jgraph"].neighbors)
    assert got.dtype == np.int32


@pytest.mark.parametrize("m,seed", [(4, 3), (48, 1)])
def test_begin_adjacency_backfill_and_caps(monkeypatch, m, seed):
    """Items no query ranked get min(m, 4) random links; rows cap at m."""
    top = np.random.default_rng(9).integers(0, 40, size=(25, 6))
    n = 60                           # items 40..59 are never ranked
    # the JAX builder on these top-L ids
    monkeypatch.setattr(jbegin, "brute_force_topk",
                        lambda *a, **k: (jnp.asarray(top), None))
    want = jbegin.build_begin_graph(None, np.zeros((n, 2), np.float32),
                                    np.zeros((25, 2), np.float32),
                                    m=m, top_l=6, seed=seed).neighbors
    got = begin_adjacency(top, n, m=m, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert ((got[40:] >= 0).sum(1) == min(m, 4)).all()


def test_build_begin_graph_matches_jax(system):
    s = system
    g = build_begin_graph(s["tm"], s["base"], s["train_q"], m=12, top_l=8,
                          device="cpu")
    jg = s["jgraph"]
    assert g.entry == jg.entry and g.neighbors.shape == (300, 12)
    assert (g.neighbors == jg.neighbors).all(axis=1).mean() >= 0.99
    assert np.array_equal(g.base, s["base"])
    nbrs = g.neighbors
    assert nbrs.min() >= -1 and nbrs.max() < 300
    assert not (nbrs == np.arange(300)[:, None]).any()
    assert ((nbrs >= 0).sum(1) >= 4).all()
    top_t, _ = brute_force_topk(s["tm"], torch.as_tensor(s["base"]),
                                torch.as_tensor(s["train_q"]), 8)
    top_j, _ = j_brute_force_topk(s["jm"], jnp.asarray(s["base"]),
                                  jnp.asarray(s["train_q"]), 8)
    assert (top_t.numpy() == np.asarray(top_j)).all(1).mean() >= 0.99


def test_deepfm_numpy_fns_exact(system):
    s = system
    fs, fg = deepfm_numpy_fns({"mlp": s["tm"].params["mlp"]}, s["cfg_t"])
    js, jg = j_deepfm_numpy_fns(s["params"], s["cfg_j"])
    r = np.random.default_rng(3)
    for _ in range(20):
        x = r.normal(size=12).astype(np.float32)
        q = r.normal(size=12).astype(np.float32)
        assert fs(x, q) == js(x, q)
        (f1, g1), (f2, g2) = fg(x, q), jg(x, q)
        assert f1 == f2
        np.testing.assert_array_equal(g1, g2)
        # and the port's torch measure agrees with its numpy twin
        want = float(s["tm"].score(torch.as_tensor(x), torch.as_tensor(q)))
        assert abs(fs(x, q) - want) < 1e-6
        np.testing.assert_allclose(
            g1, s["tm"].grad_x(torch.as_tensor(x),
                               torch.as_tensor(q)).numpy(),
            rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode,rank_by", [("guitar", "angle"),
                                          ("guitar", "projection"),
                                          ("sl2g", "angle")])
def test_faithful_search_batch_equals_jax(system, mode, rank_by):
    s = system
    fs, fg = deepfm_numpy_fns(s["tm"].params, s["cfg_t"])
    js, jg = j_deepfm_numpy_fns(s["params"], s["cfg_j"])
    g = s["jgraph"]
    kw = dict(k=10, ef=32, mode=mode, rank_by=rank_by, alpha=1.1)
    ids, scores, st = faithful_search_batch(fs, fg, s["base"], g.neighbors,
                                            s["queries"], g.entry, **kw)
    jids, jscores, jst = j_faithful_search_batch(
        js, jg, s["base"], g.neighbors, s["queries"], g.entry, **kw)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(scores, jscores)
    assert (st.n_eval, st.n_grad, st.n_iters, st.total) == \
        (jst.n_eval, jst.n_grad, jst.n_iters, jst.total)
    one_ids, _, one = faithful_search(fs, fg, s["base"], g.neighbors,
                                      s["queries"][0], g.entry, **kw)
    np.testing.assert_array_equal(one_ids, ids[0, :len(one_ids)])
    assert one.n_eval <= st.n_eval


def test_engine_on_begin_graph_tracks_faithful(system):
    """GUITAR on the port's BEGIN graph stays within 0.05 recall of the
    faithful dynamic-set oracle on the same adjacency."""
    s = system
    g = build_begin_graph(s["tm"], s["base"], s["train_q"], m=12, top_l=8,
                          device="cpu")
    Q = s["queries"].shape[0]
    cfg = SearchConfig(k=10, ef=48, mode="guitar", budget=8, alpha=1.1)
    res = search_measure(s["tm"], torch.as_tensor(s["base"]),
                         torch.as_tensor(g.neighbors),
                         torch.as_tensor(s["queries"]),
                         torch.full((Q,), g.entry), cfg)
    r_engine = recall(res.ids, s["true_ids"])
    fs, fg = deepfm_numpy_fns(s["tm"].params, s["cfg_t"])
    ids_f, _, st = faithful_search_batch(fs, fg, s["base"], g.neighbors,
                                         s["queries"], g.entry, k=10, ef=48,
                                         mode="guitar", alpha=1.1)
    r_faithful = recall(ids_f, s["true_ids"])
    assert r_engine >= 0.5
    assert abs(r_engine - r_faithful) <= 0.05, (r_engine, r_faithful)
    assert st.n_grad > 0 and bool((res.n_grad > 0).all())
