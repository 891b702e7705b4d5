"""The port's engine as programs (``core/program.py``, ``search``,
``search_debug``, the engine cache, ``engine_search``, the lane lifecycle)
on the CPU, against itself and the JAX package.

``search`` runs the same chunks on the CPU that it captures on the card,
through the same static buffers, copy-in and copy-back; it must return
``search_debug``'s ids, scores and counters bit for bit. Whole searches
are held on recall@10 within 0.01 of the JAX ``engine_search`` on the same
graph, base, queries and weights. On the card the captured graphs are
held by ``chip_smoke.check_graph`` (the ``cuda`` test below).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (EngineOptions as JOptions,  # noqa: E402
                        SearchConfig as JConfig,
                        brute_force_topk as j_brute_force_topk,
                        make_family_measure as j_make_family_measure)
from repro.core.engine import engine_search as j_engine_search  # noqa: E402
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              StateProgram, build_engine,
                              build_engine_from_fn, engine_search,
                              make_corpus_store, make_family_measure,
                              params_from_jax, recall, search_measure)
from repro_torch.core import engine as teng  # noqa: E402

N, D, Q = 1000, 40, 16
CFG = dict(k=10, ef=32, budget=8, alpha=1.01, mode="guitar",
           rank_by="angle")
ADAPTIVE = dict(adaptive="angle", c_max=12, angle_tau=1.8)
MODES = {
    "unfused": ({}, {}),
    "fused-f32": ({}, dict(fused=True)),
    "fused-bf16": ({}, dict(fused=True, corpus_dtype="bfloat16")),
    "fused-int8": ({}, dict(fused=True, corpus_dtype="int8")),
    "adaptive": (dict(alpha=1.2), dict(fused=True, corpus_dtype="int8",
                                       **ADAPTIVE)),
}
FAMILIES = ("deepfm", "mlp")



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
    """The port's measure of ``family`` with the JAX measure's weights."""
    np_tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = make_family_measure(family, torch.Generator(), D, device="cpu")
    if family == "deepfm":
        return dataclasses.replace(tm, params={
            "mlp": params_from_jax(np_tree["mlp"], device="cpu")})
    return dataclasses.replace(tm, params=params_from_jax(np_tree,
                                                          device="cpu"))


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(21)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = rng.normal(size=(Q, D)).astype(np.float32)
    graph = j_build_l2_graph(base, m=12, k_construction=48)
    caps = rng.integers(3, 90, size=Q).astype(np.int32)
    taus = rng.uniform(1.3, 2.0, size=Q).astype(np.float32)
    jms = {f: j_make_family_measure(f, jax.random.PRNGKey(0), D)
           for f in FAMILIES}
    return dict(base=base, queries=queries, graph=graph, caps=caps,
                taus=taus, jms=jms,
                tms={f: _port_measure(f, jms[f]) for f in FAMILIES},
                nbrs=torch.from_numpy(graph.neighbors),
                qt=torch.from_numpy(queries))


def _engine(system, family, mode):
    cfg_kw, opt_kw = MODES[mode]
    return build_engine(system["tms"][family],
                        SearchConfig(**{**CFG, **cfg_kw}),
                        EngineOptions(**opt_kw))


def _same(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("caps", ["default", "iter_caps"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", FAMILIES)
def test_search_equals_search_debug(system, family, mode, caps):
    """The chunked program and the one-step host loop: same ids, scores
    and counters, with and without per-query iter_caps (and taus where
    adaptive)."""
    eng = _engine(system, family, mode)
    m = system["tms"][family]
    store = make_corpus_store(system["base"], eng.corpus_dtype, device="cpu")
    g = system["graph"]
    kw = {}
    if caps == "iter_caps":
        kw["iter_caps"] = system["caps"]
        if eng.adaptive == "angle":
            kw["taus"] = system["taus"]
    entries = torch.full((Q,), g.entry)
    got = eng.search(m.params, store, system["nbrs"], system["qt"], entries,
                     **kw)
    want = eng.search_debug(m.params, store, system["nbrs"], system["qt"],
                            entries, **kw)
    _same(got, want)
    if caps == "iter_caps":
        assert (got.n_iters <= torch.from_numpy(system["caps"])).all()


def test_program_across_bucket_shapes(system):
    """Two batch shapes on one engine: each shape gets its own program,
    the second call of a shape reuses it (its buffers stay where they
    are; only their contents change) and every result equals
    search_debug."""
    eng = _engine(system, "deepfm", "fused-int8")
    m = system["tms"]["deepfm"]
    store = make_corpus_store(system["base"], "int8", device="cpu")
    g, nbrs = system["graph"], system["nbrs"]
    progs, ptrs = {}, {}
    for q in (8, 16, 8, 16):
        qt = system["qt"][:q] if q < Q else system["qt"]
        entries = torch.full((q,), g.entry)
        got = eng.search(m.params, store, nbrs, qt, entries)
        _same(got, eng.search_debug(m.params, store, nbrs, qt, entries))
        prog = eng.search_program(m.params, store, nbrs, qt)
        assert progs.setdefault(q, prog) is prog
        p = tuple(t.data_ptr() for t in prog.state)
        assert ptrs.setdefault(q, p) == p
        assert prog.state.pool_ids.shape == (q, eng.cfg.ef)
        # the result is a copy, not a view of the program's buffers
        assert got.ids.data_ptr() != prog.state.pool_ids.data_ptr()
    assert progs[8] is not progs[16]
    assert progs[8].runs["init"] == 2
    # another query batch of the same shape overwrites the buffers
    other = torch.flip(system["qt"][:8], dims=[0])
    entries = torch.full((8,), g.entry)
    _same(eng.search(m.params, store, nbrs, other, entries),
          eng.search_debug(m.params, store, nbrs, other, entries))


def test_program_cache_is_bounded(system):
    """At most PROGRAM_CACHE programs per engine, least recent out; a
    corpus that is a new object gets a new program."""
    eng = dataclasses.replace(_engine(system, "mlp", "unfused"))
    m = system["tms"]["mlp"]
    g, nbrs = system["graph"], system["nbrs"]
    stores = [make_corpus_store(system["base"][:N], "float32", device="cpu")
              for _ in range(teng.PROGRAM_CACHE + 1)]
    qt = system["qt"][:8]
    entries = torch.full((8,), g.entry)
    first = None
    for st in stores:
        eng.search(m.params, st, nbrs, qt, entries, iter_caps=[2] * 8)
        first = first or eng.search_program(m.params, stores[0], nbrs, qt)
    assert len(eng._programs) == teng.PROGRAM_CACHE
    assert eng.search_program(m.params, stores[0], nbrs, qt) is not first
    assert eng.stats["searches"] == len(stores)


def test_state_program_copy_in_and_back():
    """The plumbing alone: a routine's new state and outputs land in the
    program's own tensors, inputs come from the buffers, and on the CPU
    ``capture=True`` runs eagerly."""
    class S(tuple):
        _fields = ("a", "b")

        def __new__(cls, a, b):
            return super().__new__(cls, (a, b))

    st = S(torch.zeros(3), torch.zeros(3, dtype=torch.int32))
    prog = StateProgram(st, {"x": torch.zeros(3), "out": torch.zeros(3)},
                        capture=True)
    assert not prog.capture

    def bump(b, s):
        a = s[0] + b["x"]
        return S(a, s[1] + 1), {"out": a * 2}
    prog.add("bump", bump)
    ptrs = [t.data_ptr() for t in prog.state]
    prog.load(x=np.array([1.0, 2.0, 3.0]))
    prog.run("bump")
    prog.fill(x=0.5)
    prog.run("bump")
    assert [t.data_ptr() for t in prog.state] == ptrs
    assert torch.equal(prog.state[0], torch.tensor([1.5, 2.5, 3.5]))
    assert torch.equal(prog.state[1], torch.full((3,), 2, dtype=torch.int32))
    assert torch.equal(prog.buffers["out"], torch.tensor([3.0, 5.0, 7.0]))
    assert prog.runs["bump"] == 2 and prog.captured_launches("bump") == {}
    with pytest.raises(ValueError, match="share storage"):
        z = torch.zeros(3)
        StateProgram(S(z, z), {})


def test_launch_accounting_helpers():
    """Replays add captured launches; warm-ups move apart; a reset clears
    both."""
    kernels.reset_launch_counts()
    before = kernels.launch_counts()
    kernels.neighbor_rank.launches += 3
    kernels.mlp_score.launches += 1
    delta = kernels.launches_since(before)
    assert delta == {"neighbor_rank": 3, "mlp_score": 1}
    kernels.move_to_warmup(delta)
    assert kernels.launch_counts()["neighbor_rank"] == 0
    assert kernels.warmup_launch_counts()["neighbor_rank"] == 3
    kernels.add_launches(delta, 4)
    assert kernels.launch_counts()["neighbor_rank"] == 12
    assert kernels.launch_counts()["mlp_score"] == 4
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.warmup_launch_counts().values())


def test_engine_cache(system):
    """Equal arguments return the same engine (and so its programs);
    other options or configs another."""
    m = system["tms"]["deepfm"]
    cfg = SearchConfig(**CFG)
    a = build_engine(m, cfg, EngineOptions(fused=True))
    assert build_engine(m, SearchConfig(**CFG),
                        EngineOptions(fused=True)) is a
    assert build_engine_from_fn(m.score_fn, cfg, EngineOptions(fused=True),
                                list(m.meta)) is a
    assert build_engine(m, cfg, EngineOptions()) is not a
    assert build_engine(m, SearchConfig(**{**CFG, "ef": 40}),
                        EngineOptions(fused=True)) is not a
    with pytest.raises(ValueError, match="corpus_dtype"):
        build_engine(m, cfg, EngineOptions(corpus_dtype="fp8"))


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_search_matches_search_measure_and_jax(system, family):
    """``engine_search`` = ``search_measure``; its recall@10 within 0.01
    of the JAX ``engine_search`` on the same graph, base and weights."""
    m, jm, g = system["tms"][family], system["jms"][family], system["graph"]
    cfg = SearchConfig(**CFG)
    entries = torch.full((Q,), g.entry)
    got = engine_search(m, system["base"], system["nbrs"], system["qt"],
                        entries, cfg)
    _same(got, search_measure(m, system["base"], system["nbrs"],
                              system["qt"], entries, cfg))
    jres = j_engine_search(jm, jnp.asarray(system["base"]),
                           jnp.asarray(g.neighbors),
                           jnp.asarray(system["queries"]),
                           jnp.full((Q,), g.entry, jnp.int32),
                           JConfig(**CFG), JOptions())
    truth, _ = j_brute_force_topk(jm, jnp.asarray(system["base"]),
                                  jnp.asarray(system["queries"]), 10)
    rt = recall(got.ids, np.asarray(truth))
    rj = recall(np.asarray(jres.ids), np.asarray(truth))
    assert abs(rt - rj) <= 0.01, (rt, rj)


@pytest.mark.parametrize("mode", ["unfused", "adaptive"])
def test_reset_lanes_equals_init_state(system, mode):
    """Masked lanes get exactly init_state's rows (caps and taus too);
    unmasked lanes keep their stepped state bit for bit."""
    eng = _engine(system, "mlp", mode)
    m = system["tms"]["mlp"]
    store = make_corpus_store(system["base"], eng.corpus_dtype, device="cpu")
    nbrs, g = system["nbrs"], system["graph"]
    q = system["qt"][:4]
    e = torch.full((4,), g.entry)
    state = eng.init_state(m.params, store, nbrs, q, e)
    qs_flat = teng._repeat_rows(q, eng.n_candidates(nbrs.shape[1]))
    for _ in range(3):
        state = eng.step(m.params, store, nbrs, q, qs_flat, state)
    mask = torch.tensor([True, False, True, False])
    merged = torch.where(mask[:, None], system["qt"][4:8], q)
    e2 = torch.where(mask, torch.tensor([5, 0, 7, 0]), e)
    caps = torch.tensor([3, 99, 5, 99], dtype=torch.int32)
    taus = torch.tensor([1.5, 0.0, 1.7, 0.0])
    out = eng.reset_lanes(m.params, store, merged, e2, state, mask, caps,
                          taus)
    fresh = eng.init_state(m.params, store, nbrs, merged, e2, caps, taus)
    for o, f, s in zip(out, fresh, state):
        assert torch.equal(o[0], f[0]) and torch.equal(o[2], f[2])
        assert torch.equal(o[1], s[1]) and torch.equal(o[3], s[3])


def test_idle_state_steps_are_noops(system):
    """idle_state has init_state's shapes and dtypes, every lane done, no
    two fields sharing storage; a step on it changes nothing."""
    eng = _engine(system, "deepfm", "unfused")
    m = system["tms"]["deepfm"]
    store = make_corpus_store(system["base"], "float32", device="cpu")
    nbrs = system["nbrs"]
    idle = eng.idle_state(3, store.n, device="cpu")
    init = eng.init_state(m.params, store, nbrs, system["qt"][:3],
                          torch.zeros(3, dtype=torch.int64))
    for a, b in zip(idle, init):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert bool(idle.done.all())
    assert len({t.data_ptr() for t in idle}) == len(idle)
    q = torch.zeros((3, D))
    qs_flat = teng._repeat_rows(q, eng.n_candidates(nbrs.shape[1]))
    s2 = teng._freeze_done(idle.done, eng.step(m.params, store, nbrs, q,
                                               qs_flat, idle), idle)
    for a, b in zip(idle, s2):
        assert torch.equal(a, b)


def test_repeat_rows_and_bitmap_scatter():
    """The step's view-based query repeat and scatter-add bitmap equal
    ``repeat_interleave`` and a per-bit OR."""
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(teng._repeat_rows(x, 5),
                       x.repeat_interleave(5, dim=0))
    rng = np.random.default_rng(4)
    bm = torch.from_numpy(rng.integers(0, 2 ** 31, size=(4, 6)))
    ids = torch.from_numpy(np.stack([rng.permutation(192)[:9]
                                     for _ in range(4)]))
    ids[:, -1] = -1
    mask = torch.from_numpy(rng.random((4, 9)) < 0.7)
    mask[:, -1] = False
    for r in range(4):          # the engine sets only unset bits
        for i in ids[r].tolist():
            bm[r, max(i, 0) >> 5] &= ~(1 << (max(i, 0) & 31))
    out = teng.bit_set_rows(bm, ids, mask)
    want = bm.clone()
    for r in range(4):
        for i, ok in zip(ids[r].tolist(), mask[r].tolist()):
            if ok:
                want[r, max(i, 0) >> 5] |= 1 << (max(i, 0) & 31)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_captured_search_matches_debug_on_card():
    """On the card: the captured search = search_debug bit for bit on
    every path, launches = the eager loop's, one eager step sync-free."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured graphs run only there")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    dev = torch.device("cuda")
    for family in FAMILIES:
        chip_smoke.check_graph(torch, np, dev, family, N=2000)
