"""The port's corpus-sharded search against the JAX package on the CPU.

``merge_topk`` must equal the JAX merge bit for bit (padding, -1 ids and
ties included). ``build_sharded_index`` must give the same partitions,
padding and entries; each shard's graph is held as ``build_l2_graph`` is
(>= 97% of rows identical; in a padded shard reading each padded copy of
row 0 as row 0, a distance tie the backends break apart). Whole sharded searches hold the JAX host-merge
search's recall@10 within 0.01 on the same index, queries and weights
(carried across by ``params_from_jax``), and return no id twice;
``sharded_search_host`` over one device or a list of them equals
``sharded_search_stores`` on the same stores bit for bit, and its counters
are the per-shard searches' sums (n_eval, n_grad) and maxima (n_iters).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_map  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sharded as jsharded  # noqa: E402
from repro.core import (EngineOptions as JOptions,  # noqa: E402
                        SearchConfig as JConfig,
                        brute_force_topk as j_brute_force_topk,
                        make_family_measure as j_make_family_measure)
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              ShardedIndex, build_engine,
                              build_sharded_index, deepfm_measure,
                              empty_topk, merge_topk, params_from_jax,
                              recall, shard_stores, sharded_search_host,
                              sharded_search_stores)
from repro_torch.core.measures import deepfm_config_for  # noqa: E402

N, D, Q, S = 1203, 40, 32, 4


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Many small ops: spinning BLAS threads under xdist workers cost more
    than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(41)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    jidx = jsharded.build_sharded_index(base, n_shards=S, m=12,
                                        k_construction=40, seed=2)
    jm = j_make_family_measure("deepfm", jax.random.PRNGKey(0), D)
    np_mlp = jax.tree_util.tree_map(np.asarray, jm.params["mlp"])
    tm = deepfm_measure({"mlp": params_from_jax(np_mlp, device="cpu")},
                        deepfm_config_for(D))
    truth, _ = j_brute_force_topk(jm, jnp.asarray(base), jnp.asarray(queries),
                                  10)
    tidx = ShardedIndex(base=jidx.base, neighbors=jidx.neighbors,
                        entries=jidx.entries, global_ids=jidx.global_ids,
                        n_shards=S)
    return dict(base=base, queries=queries, jidx=jidx, tidx=tidx, jm=jm,
                tm=tm, truth=np.asarray(truth))


def test_merge_topk_bit_for_bit():
    r = np.random.default_rng(7)
    Qm, Sm, k = 9, 4, 6
    ids = r.integers(0, 500, size=(Qm, Sm, k)).astype(np.int32)
    scores = r.integers(0, 4, size=(Qm, Sm, k)).astype(np.float32) / 4
    ids[:, 1, 4:] = -1                      # pool padding / padded rows
    scores[:, 1, 4:] = 0.9                  # ... that would otherwise win
    scores[:, 2, 3:] = -np.inf
    ids[0] = -1                             # a query with nothing valid
    ids[1, :, :] = np.arange(Sm * k).reshape(Sm, k)
    scores[1] = 0.5                         # all tied
    ids[2, :3] = -1
    for kk in (k, 3, Sm * k):
        want_i, want_s = jsharded.merge_topk(jnp.asarray(ids),
                                             jnp.asarray(scores), kk)
        got_i, got_s = merge_topk(torch.as_tensor(ids),
                                  torch.as_tensor(scores), kk)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    i0, s0 = empty_topk(5)
    ji0, js0 = jsharded.empty_topk(5)
    np.testing.assert_array_equal(i0, ji0)
    np.testing.assert_array_equal(s0, js0)
    assert i0.dtype == ji0.dtype and s0.dtype == js0.dtype


@pytest.mark.parametrize("n", [1203, 1200])
def test_build_sharded_index_matches_jax(n):
    base = np.random.default_rng(42).normal(size=(n, 16)).astype(np.float32)
    want = jsharded.build_sharded_index(base, n_shards=S, m=8,
                                        k_construction=24, seed=5)
    got = build_sharded_index(base, n_shards=S, m=8, k_construction=24,
                              seed=5, device="cpu")
    assert got.n_shards == S
    np.testing.assert_array_equal(got.global_ids, want.global_ids)
    np.testing.assert_array_equal(got.entries, want.entries)
    np.testing.assert_array_equal(got.base, want.base)
    assert got.global_ids.dtype == want.global_ids.dtype == np.int32
    assert (got.global_ids < 0).sum() == (-n) % S
    assert got.neighbors.shape == want.neighbors.shape
    for s in range(S):
        # a padded row is a copy of the shard's row 0, a distance tie the
        # two backends break apart: read either copy as row 0
        pad = np.flatnonzero(got.global_ids[s] < 0)
        a, b = got.neighbors[s].copy(), want.neighbors[s].copy()
        a[np.isin(a, pad)] = 0
        b[np.isin(b, pad)] = 0
        real = np.setdiff1d(np.arange(a.shape[0]), np.append(pad, 0))
        same = (np.sort(a[real], 1) == np.sort(b[real], 1)).all(1).mean()
        assert same >= 0.97, (s, same)
        if pad.size == 0:
            assert (got.neighbors[s] == want.neighbors[s]).all(1).mean() \
                >= 0.97
    real = got.global_ids[got.global_ids >= 0]
    assert np.array_equal(np.sort(real), np.arange(n))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_search_stores_recall_matches_jax(system, dtype):
    s = system
    fused = dtype != "float32"
    jres = jsharded.sharded_search_stores(
        s["jm"], jsharded.shard_stores(s["jidx"], dtype), s["jidx"],
        s["queries"], JConfig(k=10, ef=48, budget=8, alpha=1.05),
        JOptions(fused=fused, corpus_dtype=dtype))
    cfg = SearchConfig(k=10, ef=48, budget=8, alpha=1.05)
    options = EngineOptions(fused=fused, corpus_dtype=dtype)
    stores = shard_stores(s["tidx"], dtype, devices=["cpu"])
    res = sharded_search_stores(s["tm"], stores, s["tidx"], s["queries"],
                                cfg, options)
    want = recall(np.asarray(jres.ids), s["truth"])
    got = recall(res.ids, s["truth"])
    assert got > 0.5 and abs(got - want) <= 0.01, (got, want)
    ids = res.ids.numpy()
    assert (ids >= 0).all()
    srt = np.sort(ids, axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all()          # duplicate-free
    # scores are the measure's on each returned corpus row
    rows = torch.as_tensor(s["base"])[res.ids.reshape(-1)]
    qs = torch.as_tensor(s["queries"]).repeat_interleave(10, dim=0)
    want_s = s["tm"].score(rows, qs).reshape(Q, 10)
    if dtype == "float32":
        torch.testing.assert_close(res.scores, want_s, rtol=1e-5, atol=1e-6)
    # counters are the shards' sums and maxima
    eng = build_engine(s["tm"], cfg, options)
    parts = [eng.search(s["tm"].params, st, s["tidx"].placed(i, "cpu")[0],
                        torch.as_tensor(s["queries"]),
                        torch.full((Q,), int(s["tidx"].entries[i])))
             for i, st in enumerate(stores)]
    assert torch.equal(res.n_eval, sum(p.n_eval for p in parts))
    assert torch.equal(res.n_grad, sum(p.n_grad for p in parts))
    assert torch.equal(res.n_iters,
                       torch.stack([p.n_iters for p in parts]).amax(0))


def test_sharded_search_host_devices_and_caps(system):
    """One device or a list of them (shard s on devices[s % len]): the
    same results as sharded_search_stores; the placed tensors and stores
    are made once, so a second call reuses the engine's programs;
    per-lane caps broadcast to every shard."""
    s = system
    cfg = SearchConfig(k=10, ef=32, budget=8, alpha=1.05)
    opts = EngineOptions(fused=True, corpus_dtype="int8", adaptive="angle",
                         c_max=12)
    base = sharded_search_stores(
        s["tm"], shard_stores(s["tidx"], "int8", devices=["cpu"]),
        s["tidx"], s["queries"], cfg, opts)
    for devices in (["cpu"], ["cpu", "cpu"]):
        got = sharded_search_host(s["tm"], s["tidx"], s["queries"], cfg,
                                  devices=devices, options=opts)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(base, f)), f
    eng = build_engine(s["tm"], cfg, opts)
    n_prog = len(eng._programs)
    sharded_search_host(s["tm"], s["tidx"], s["queries"], cfg,
                        devices=["cpu"], options=opts)
    assert len(eng._programs) == n_prog            # no new program
    assert s["tidx"].stores("int8", ["cpu"]) is s["tidx"].stores(
        "int8", ["cpu"])
    caps = np.full((Q,), 3, np.int32)
    capped = sharded_search_stores(
        s["tm"], s["tidx"].stores("int8", ["cpu"]), s["tidx"], s["queries"],
        cfg, opts, iter_caps=caps, taus=np.full((Q,), 0.8, np.float32))
    assert int(capped.n_iters.max()) <= 3
    assert (capped.n_eval <= base.n_eval).all()


def test_sharded_search_params_by_device(system):
    """Params are never copied across devices: a measure whose params live
    elsewhere than the stores is refused by name, and the same measure
    with ``params_by_device`` naming the stores' device searches as the
    measure whose params live there."""
    s = system
    cfg = SearchConfig(k=10, ef=32, budget=8, alpha=1.05)
    opts = EngineOptions(fused=True, corpus_dtype="int8")
    want = sharded_search_host(s["tm"], s["tidx"], s["queries"], cfg,
                               devices=["cpu"], options=opts)
    away = dataclasses.replace(s["tm"], params=tree_map(
        lambda t: t.to("meta"), s["tm"].params))
    with pytest.raises(ValueError, match="params_by_device"):
        sharded_search_host(away, s["tidx"], s["queries"], cfg,
                            devices=["cpu"], options=opts)
    got = sharded_search_host(away, s["tidx"], s["queries"], cfg,
                              devices=["cpu"], options=opts,
                              params_by_device={"cpu": s["tm"].params})
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="no params for 'cpu'"):
        sharded_search_host(away, s["tidx"], s["queries"], cfg,
                            devices=["cpu"], options=opts,
                            params_by_device={"meta": away.params})


def test_sharded_refusals(system):
    # a paged policy pages each partition on its own pager, over the
    # whole stores' payload; an unknown residency kind raises
    paged = shard_stores(system["tidx"], "int8", residency="paged",
                         devices=["cpu"])
    whole = shard_stores(system["tidx"], "int8", devices=["cpu"])
    assert len({id(p.cache) for p in paged}) == S
    for p, w in zip(paged, whole):
        ids = torch.arange(w.n)
        assert p.is_paged and torch.equal(p.take(ids), w.take(ids))
    with pytest.raises(ValueError, match="residency kind"):
        shard_stores(system["tidx"], "int8", residency="bogus",
                     devices=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        sharded_search_host(system["tm"], system["tidx"],
                            system["queries"], SearchConfig(), devices=[])
