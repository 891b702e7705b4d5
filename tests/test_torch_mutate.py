"""The port's streaming index mutation (``graph/mutate.py``) against the
JAX package on the CPU: ``insert_rows``, ``delete_rows`` and ``compact``
give the JAX neighbors, entry, tombstones and base exactly, and so does
``occlusion_prune_nodes``; journals either package writes load and replay
in the other; the recovery discipline (torn tails, the whole-file format,
the ``journal_applied`` watermark, a kill at every durability stage,
checkpoint and reopen) reproduces the uninterrupted index exactly; recall
after an insert stays within 0.01 of a rebuild's; deleted rows never
surface (whole or paged); and ``install_index`` swaps a mutated index in
by epochs.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.graph import build as jbuild  # noqa: E402
from repro.graph import mutate as jmutate  # noqa: E402
from repro.graph import prune as jprune  # noqa: E402
from repro.serving import FaultEvent as JEvent  # noqa: E402
from repro.serving import FaultPlan as JPlan  # noqa: E402
from repro_torch.core import (EngineOptions, ResidencyPolicy,  # noqa: E402
                              SearchConfig, brute_force_topk, build_engine,
                              make_corpus_store, make_family_measure,
                              recall)
from repro_torch.graph import (DurableIndex, GraphIndex,  # noqa: E402
                               MutationJournal, append_journal, apply_op,
                               build_l2_graph, compact, delete_rows,
                               insert_rows, load_index, load_journal,
                               occlusion_prune_nodes, recover_index,
                               save_index, save_journal)
from repro_torch.serving import (ContinuousRuntime, FaultEvent,  # noqa: E402
                                 FaultPlan, InjectedKill)

D = 16
RNG = np.random.default_rng(11)
BASE = RNG.normal(size=(80, 8)).astype(np.float32)
NEW_ROWS = RNG.normal(size=(6, 8)).astype(np.float32)
DEL_IDS = [3, 17, 40, 81]          # 81: one of the freshly inserted rows
OPS = [("insert", lambda d: d.insert(NEW_ROWS, k_candidates=16)),
       ("delete", lambda d: d.delete(DEL_IDS)),
       ("compact", lambda d: d.compact())]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(g):
    """A JAX GraphIndex as the port's."""
    return GraphIndex(neighbors=np.asarray(g.neighbors), entry=int(g.entry),
                      base=np.asarray(g.base), tombstones=None
                      if g.tombstones is None else np.asarray(g.tombstones))


def _same_index(a, b):
    np.testing.assert_array_equal(np.asarray(a.base), np.asarray(b.base))
    np.testing.assert_array_equal(np.asarray(a.neighbors),
                                  np.asarray(b.neighbors))
    assert int(a.entry) == int(b.entry)
    ta = None if a.tombstones is None else np.asarray(a.tombstones, bool)
    tb = None if b.tombstones is None else np.asarray(b.tombstones, bool)
    if ta is None or tb is None:
        assert (ta is None or not ta.any()) and (tb is None or not tb.any())
    else:
        np.testing.assert_array_equal(ta, tb)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(5)
    base = (rng.normal(size=(600, D)) * 0.5).astype(np.float32)
    jg = jbuild.build_l2_graph(base[:500], m=8, k_construction=24)
    return dict(base=base, jg=jg, tg=_t(jg))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The uninterrupted lineage (the JAX recovery tests' OPS)."""
    graph = build_l2_graph(BASE, m=4, k_construction=12, device="cpu")
    d = DurableIndex.create(str(tmp_path_factory.mktemp("ref")), graph,
                            device="cpu")
    for _, fn in OPS:
        fn(d)
    return {"graph": graph, "final": d.index}


# ---------------------------------------------------------------------------
# the primitives against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_candidates", [16, 64])
def test_insert_rows_matches_jax(graphs, k_candidates):
    new = graphs["base"][500:]
    got = insert_rows(graphs["tg"], new, k_candidates=k_candidates,
                      device="cpu")
    want = jmutate.insert_rows(graphs["jg"], new, k_candidates=k_candidates)
    _same_index(got, want)
    assert got.n == 600 and got.entry == graphs["tg"].entry


def test_delete_insert_compact_chain_matches_jax(graphs):
    """A delete that kills the entry, an insert over tombstones (fresh
    edges avoid dead rows), then compact: every step equals JAX's."""
    tg, jg = graphs["tg"], graphs["jg"]
    ids = [1, 2, 3, int(tg.entry)]
    t1, j1 = delete_rows(tg, ids), jmutate.delete_rows(jg, ids)
    _same_index(t1, j1)
    assert t1.entry != tg.entry and not t1.tombstones[t1.entry]
    new = graphs["base"][500:540]
    t2, j2 = insert_rows(t1, new, device="cpu"), jmutate.insert_rows(j1, new)
    _same_index(t2, j2)
    dead = np.flatnonzero(t2.tombstones)
    assert not np.isin(t2.neighbors[500:], dead).any()
    t3, j3 = compact(t2), jmutate.compact(j2)
    _same_index(t3, j3)
    assert t3.tombstones is None and t3.n == 540 - len(ids)
    assert compact(t3) is t3
    with pytest.raises(ValueError, match="delete ids"):
        delete_rows(tg, [tg.n])
    with pytest.raises(ValueError, match="every row"):
        delete_rows(tg, range(tg.n))
    with pytest.raises(ValueError, match="new_rows"):
        insert_rows(tg, np.zeros((2, D + 1), np.float32), device="cpu")


@pytest.mark.parametrize("assume_unique", [False, True])
def test_occlusion_prune_nodes_matches_jax(graphs, assume_unique):
    base = graphs["base"]
    rng = np.random.default_rng(3)
    nodes = rng.choice(600, 70, replace=False).astype(np.int32)
    cand = np.stack([rng.choice(600, 30, replace=False) for _ in nodes])
    cand[:, -4:] = -1
    if not assume_unique:
        cand[:, 5] = cand[:, 2]             # a repeated candidate
        cand[:, 7] = nodes                  # a self candidate
    got = occlusion_prune_nodes(base, nodes, cand.astype(np.int32), 8,
                                assume_unique=assume_unique, device="cpu")
    want = jprune.occlusion_prune_nodes(base, nodes, cand.astype(np.int32),
                                        8, assume_unique=assume_unique)
    np.testing.assert_array_equal(got, want)
    assert occlusion_prune_nodes(base, nodes[:0], cand[:0], 8,
                                 device="cpu").shape == (0, 8)


# ---------------------------------------------------------------------------
# journals across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_written_by_one_package_replays_in_the_other(tmp_path,
                                                             graphs, writer):
    tg, jg = graphs["tg"], graphs["jg"]
    new = graphs["base"][500:520]
    j = MutationJournal(n_base=tg.n) if writer == "port" \
        else jmutate.MutationJournal(n_base=tg.n)
    mod = jmutate if writer == "jax" else None
    if writer == "jax":
        g = mod.insert_rows(jg, new, k_candidates=16, journal=j)
        g = mod.delete_rows(g, [4, 505], journal=j)
        mod.compact(g, journal=j)
        jmutate.save_journal(str(tmp_path), jmutate.MutationJournal(
            j.n_base, j.ops[:1]))
        for op in j.ops[1:]:
            jmutate.append_journal(str(tmp_path), op)
    else:
        g = insert_rows(tg, new, k_candidates=16, journal=j, device="cpu")
        g = delete_rows(g, [4, 505], journal=j)
        compact(g, journal=j)
        save_journal(str(tmp_path), MutationJournal(j.n_base, j.ops[:1]))
        for op in j.ops[1:]:
            append_journal(str(tmp_path), op)
    tj = load_journal(str(tmp_path))
    jj = jmutate.load_journal(str(tmp_path))
    assert tj.ops == jj.ops == j.ops and tj.n_base == jj.n_base
    assert (tj.n_inserted, tj.n_deleted) == (20, 2)
    tcur, jcur = tg, jg
    for op in tj.ops:
        tcur = apply_op(tcur, op, device="cpu")
        jcur = jmutate.apply_op(jcur, op)
        _same_index(tcur, jcur)


def test_journal_damage_matches_jax(tmp_path):
    """Torn tails and garbage truncate with a warning, the whole-file
    format loads, an empty or headerless journal reads as unmutated: as
    the JAX reader does, case for case."""
    head = json.dumps({"n_base": 5})
    cases = {
        "torn": head + "\n" + json.dumps({"op": "delete", "ids": [1]})
        + "\n{\"op\": \"del",
        "garbage": head + "\n\x00\x01junk\n" + json.dumps(
            {"op": "delete", "ids": [2]}) + "\n",
        "legacy": json.dumps({"n_base": 7, "ops": [{"op": "compact",
                                                    "n_dropped": 0}]}),
        "empty": "",
        "headerless": json.dumps({"op": "delete", "ids": [1]}) + "\n",
        "list": "[1, 2]\n",
    }
    for name, text in cases.items():
        path = tmp_path / name
        path.mkdir()
        (path / "journal.json").write_text(text)
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = load_journal(str(path))
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jmutate.load_journal(str(path))
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        if want is None:
            assert got is None, name
        else:
            assert (got.n_base, got.ops) == (want.n_base, want.ops), name
    assert load_journal(str(tmp_path / "nothing")) is None
    with pytest.raises(FileNotFoundError, match="save_journal"):
        append_journal(str(tmp_path / "nothing"), {"op": "compact"})


def test_apply_op_rejects_unreplayable_records(ref):
    with pytest.raises(ValueError, match="no row payload"):
        apply_op(ref["graph"], {"op": "insert", "n": 3}, device="cpu")
    with pytest.raises(ValueError, match="unknown journal op"):
        apply_op(ref["graph"], {"op": "rename"}, device="cpu")


# ---------------------------------------------------------------------------
# recovery: the counterparts of tests/test_recovery.py
# ---------------------------------------------------------------------------

def test_recover_legacy_dir_does_not_double_replay(tmp_path, ref):
    """A directory saved after its mutations without a watermark counts
    every journal op as absorbed."""
    j = MutationJournal(n_base=ref["graph"].n)
    g2 = insert_rows(ref["graph"], NEW_ROWS, k_candidates=16, journal=j,
                     device="cpu")
    save_index(str(tmp_path), g2)
    save_journal(str(tmp_path), j)
    rec, j2 = recover_index(str(tmp_path), device="cpu")
    assert rec.n == g2.n
    _same_index(rec, g2)
    assert j2.ops == j.ops
    # and a directory never mutated recovers as saved, with an empty log
    save_index(str(tmp_path / "plain"), ref["graph"])
    rec, j3 = recover_index(str(tmp_path / "plain"), device="cpu")
    _same_index(rec, ref["graph"])
    assert j3.ops == [] and j3.n_base == ref["graph"].n


def test_port_lineage_matches_jax_lineage(tmp_path, ref):
    """The port's uninterrupted lineage equals the JAX package's, and the
    JAX package recovers the port's directory (and the other way round)."""
    jgraph = jbuild.GraphIndex(neighbors=ref["graph"].neighbors,
                               entry=ref["graph"].entry,
                               base=ref["graph"].base)
    jd = jmutate.DurableIndex.create(str(tmp_path / "jax"), jgraph)
    jd.insert(NEW_ROWS, k_candidates=16)
    jd.delete(DEL_IDS)
    jd.compact()
    _same_index(ref["final"], jd.index)
    rec, _ = recover_index(str(tmp_path / "jax"), device="cpu")
    _same_index(rec, ref["final"])
    td = DurableIndex.create(str(tmp_path / "port"), ref["graph"],
                             device="cpu")
    for _, fn in OPS:
        fn(td)
    jrec, _ = jmutate.recover_index(str(tmp_path / "port"))
    _same_index(jrec, ref["final"])


@pytest.mark.parametrize("stage", ["pre-journal", "post-journal"])
@pytest.mark.parametrize("op_i", [0, 1, 2])
def test_kill_mid_mutation_recovers_exactly(tmp_path, ref, stage, op_i):
    plan = FaultPlan([FaultEvent("kill", site=f"mutate/{stage}",
                                 start=op_i)])
    d = DurableIndex.create(str(tmp_path), ref["graph"],
                            kill_hook=plan.kill_hook(), device="cpu")
    with pytest.raises(InjectedKill):
        for _, fn in OPS:
            fn(d)
    d2 = DurableIndex.open(str(tmp_path), device="cpu")
    committed = len(d2.journal.ops)
    assert committed == op_i + (1 if stage == "post-journal" else 0)
    for _, fn in OPS[committed:]:      # redo what the crash lost
        fn(d2)
    _same_index(d2.index, ref["final"])


@pytest.mark.parametrize("stage", ["pre-save", "post-save"])
def test_kill_during_checkpoint_keeps_a_durable_baseline(tmp_path, ref,
                                                         stage):
    plan = FaultPlan([FaultEvent("kill", site=f"mutate/{stage}", start=1)])
    d = DurableIndex.create(str(tmp_path), ref["graph"],
                            kill_hook=plan.kill_hook(), device="cpu")
    for _, fn in OPS:
        fn(d)
    with pytest.raises(InjectedKill):
        d.checkpoint()
    d2 = DurableIndex.open(str(tmp_path), device="cpu")
    _same_index(d2.index, ref["final"])
    if stage == "pre-save":
        assert len(d2.journal.ops) == len(OPS)
        assert load_index(str(tmp_path)).n == ref["graph"].n
    else:
        _same_index(load_index(str(tmp_path)), ref["final"])


def test_checkpoint_then_reopen_round_trips(tmp_path, ref):
    from repro_torch.obs import Tracer
    d = DurableIndex.create(str(tmp_path), ref["graph"], device="cpu")
    d.tracer = Tracer()
    for _, fn in OPS:
        fn(d)
    d.checkpoint()
    names = [(s.name, s.site) for s in d.tracer.spans()]
    assert names.count(("commit", "mutate")) == 3
    assert names.count(("journal", "mutate")) == 3
    assert names.count(("checkpoint", "mutate")) == 1
    d2 = DurableIndex.open(str(tmp_path), device="cpu")
    assert len(d2.journal.ops) == len(OPS)
    assert d2.corpus_dtype == "float32" and d2.page_rows == 4096
    _same_index(d2.index, ref["final"])
    _same_index(load_index(str(tmp_path)), ref["final"])
    # the JAX kill plan JSON drives the port's hook the same way
    plan = JPlan([JEvent("kill", site="mutate/pre-save")])
    tplan = FaultPlan.from_dict(plan.to_dict())
    d3 = DurableIndex.open(str(tmp_path), kill_hook=tplan.kill_hook(),
                           device="cpu")
    with pytest.raises(InjectedKill):
        d3.checkpoint()


# ---------------------------------------------------------------------------
# searches over mutated indexes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def measure():
    return make_family_measure("mlp", torch.Generator().manual_seed(1), D,
                               device="cpu", hidden=(32,))


def _search(eng, m, g, q, store=None):
    store = store if store is not None else make_corpus_store(
        g.base, device="cpu", tombstones=g.tombstones)
    return eng.search(m.params, store, torch.as_tensor(g.neighbors),
                      torch.as_tensor(q), torch.full((len(q),), g.entry))


def test_insert_recall_within_1pct_of_rebuild(graphs, measure):
    """Streaming insert of 100 rows into a 500-row index: recall on the
    grown index within 0.01 of a rebuild over the same 600 rows."""
    base = graphs["base"]
    g_inc = insert_rows(graphs["tg"], base[500:], device="cpu")
    g_reb = build_l2_graph(base, m=8, k_construction=24, device="cpu")
    eng = build_engine(measure, SearchConfig(k=10, ef=32, budget=6,
                                             alpha=1.1))
    q = (np.random.default_rng(5).normal(size=(64, D)) * 0.5).astype(
        np.float32)
    truth, _ = brute_force_topk(measure, torch.as_tensor(base),
                                torch.as_tensor(q), 10)
    r_inc = recall(_search(eng, measure, g_inc, q).ids, truth)
    r_reb = recall(_search(eng, measure, g_reb, q).ids, truth)
    assert r_inc >= r_reb - 0.01, (r_inc, r_reb)


@pytest.mark.parametrize("residency", ["whole", "paged"])
def test_deleted_rows_never_surface(graphs, measure, residency):
    """The whole search's top answers deleted: no search of the mutated
    index returns them (whole or paged, tombstones carried through a
    saved index), and searches still answer."""
    g = graphs["tg"]
    eng = build_engine(measure, SearchConfig(k=10, ef=32, budget=6,
                                             alpha=1.1))
    q = (np.random.default_rng(6).normal(size=(12, D)) * 0.5).astype(
        np.float32)
    victims = np.unique(_search(eng, measure, g, q).ids[:, :3].numpy())
    g2 = delete_rows(g, victims)
    policy = ResidencyPolicy("paged", page_rows=32, cache_bytes=4096) \
        if residency == "paged" else None
    store = make_corpus_store(g2.base, device="cpu", tombstones=g2.tombstones,
                              residency=policy)
    ids = _search(eng, measure, g2, q, store).ids.numpy()
    assert not np.isin(ids[ids >= 0], victims).any()
    assert (ids >= 0).any()


@pytest.mark.parametrize("residency", ["whole", "paged"])
def test_install_index_epochs_with_a_mutated_index(graphs, measure,
                                                   residency):
    """Lanes in flight finish on epoch 0; the staged (grown) index swaps
    in once they drain; epoch 1 answers equal the one-shot search of the
    grown index bit for bit."""
    g = graphs["tg"]
    eng = build_engine(measure, SearchConfig(k=5, ef=24, budget=6,
                                             alpha=1.1))
    policy = ResidencyPolicy("paged", page_rows=32, cache_bytes=8192) \
        if residency == "paged" else None
    rt = ContinuousRuntime(eng, measure.params,
                           make_corpus_store(g.base, device="cpu",
                                             residency=policy),
                           g.neighbors, n_lanes=2, query_dim=D,
                           entry=g.entry, steps_per_tick=1, device="cpu")
    q = (np.random.default_rng(9).normal(size=(2, D)) * 0.5).astype(
        np.float32)
    rt.submit(q[0], rid=0)
    rt.step_once()
    assert rt.in_flight == 1
    g2 = insert_rows(g, graphs["base"][500:530], device="cpu")
    staged = rt.install_index(make_corpus_store(
        g2.base, device="cpu", residency=policy), g2.neighbors, g2.entry)
    assert staged == 1 and rt.epoch == 0
    rt.submit(q[1], rid=1)
    comps = []
    for _ in range(600):
        comps += rt.step_once()
        if len(comps) == 2:
            break
    by = {c.rid: c for c in comps}
    assert by[0].epoch == 0 and by[1].epoch == 1
    assert rt.epoch == 1 and rt.store.n == g2.n
    assert rt.store.is_paged == (residency == "paged")
    want = _search(eng, measure, g2, q[1:2])
    np.testing.assert_array_equal(by[1].ids, want.ids[0].numpy())
    np.testing.assert_array_equal(by[1].scores, want.scores[0].numpy())


def test_graph_and_core_export_mutation():
    import repro_torch.core as core
    import repro_torch.graph as graph
    for name in ("DurableIndex", "MutationJournal", "append_journal",
                 "apply_op", "compact", "delete_rows", "insert_rows",
                 "load_journal", "recover_index", "save_journal",
                 "occlusion_prune_nodes"):
        assert getattr(core, name) is getattr(graph, name)
    assert dataclasses.is_dataclass(MutationJournal)
    assert jax is not None
