"""The port's tuning cache (``kernels/autotune.py``) and the engine's tile
plan on the CPU: spec parsing and keys against the JAX module, the lookup
precedence, the cache round trip and its hardening (every test points the
cache at a temporary file), the shipped card defaults, the tile plan
against rowwise and unfused searches (bit for bit), the plan resolved once
per program, and the launcher's ``--tile`` / ``--autotune``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as jautotune  # noqa: E402
from repro_torch.core import (EngineOptions, ResidencyPolicy,  # noqa: E402
                              SearchConfig, build_engine, make_corpus_store,
                              make_family_measure, search_measure)
from repro_torch.graph import build_l2_graph  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.autotune import TileConfig  # noqa: E402

N, D, Q = 600, 40, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these searches are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    """The port's local cache in a throwaway file (never the repo's)."""
    path = tmp_path / "tuning.json"
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(path))
    return path


# ---------------------------------------------------------------------------
# specs and keys: the JAX module's values and strings
# ---------------------------------------------------------------------------

SPECS = (None, "", "tile", "rowwise", ":16", "tile:4", "rowwise:1")


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tile_matches_jax(spec):
    got, want = autotune.parse_tile(spec), jautotune.parse_tile(spec)
    if want is None:
        assert got is None
    else:
        assert (got.plan, got.bt) == (want.plan, want.bt)
        base = TileConfig(plan="rowwise", bt=8)
        merged = got.merged_over(base)
        jm = want.merged_over(jautotune.TileConfig(plan="rowwise", bt=8))
        assert (merged.plan, merged.bt) == (jm.plan, jm.bt)


@pytest.mark.parametrize("bad", ["diag", "tile:0", "tile:-3", "tile:x"])
def test_parse_tile_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        jautotune.parse_tile(bad)
    with pytest.raises(ValueError):
        autotune.parse_tile(bad)


def test_make_key_matches_jax_and_needs_a_backend():
    for args in (("engine_step", 32, 48, 40, "int8"),
                 ("neighbor_rank_fused", 5, 37, 33, "bfloat16"),
                 ("engine_step", 0, 0, 0, "float32")):
        for backend in ("cuda", "cpu"):
            assert autotune.make_key(*args, backend=backend) == \
                jautotune.make_key(*args, backend=backend)
    assert autotune._wildcard("engine_step", "cuda") == \
        jautotune._wildcard("engine_step", "cuda")
    assert autotune.TUNABLE_KERNELS == jautotune.TUNABLE_KERNELS
    with pytest.raises(ValueError, match="backend"):
        autotune.make_key("engine_step", 1, 1, 1, "float32")


def test_cache_file_is_the_ports_own(tmp_path, monkeypatch):
    """The port reads $REPRO_TORCH_TUNING_CACHE (else
    ./.tuning_cache.torch.json), never the JAX package's cache."""
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.chdir(tmp_path)
    assert autotune.cache_path() == str(tmp_path
                                        / ".tuning_cache.torch.json")
    (tmp_path / "jax.json").write_text(json.dumps({"entries": {
        "cuda|engine_step|*": {"plan": "tile", "bt": 8}}}))
    assert autotune.load_cache() == {}


# ---------------------------------------------------------------------------
# precedence, shipped defaults, the sweep round trip
# ---------------------------------------------------------------------------

def test_resolve_precedence(tmp_cache, monkeypatch):
    """override > local exact > shipped exact > local wildcard > shipped
    wildcard > builtin."""
    shape = dict(q=7, m=13, d=24, dtype="float32", backend="cuda")
    wild = autotune._wildcard("engine_step", "cuda")
    monkeypatch.setattr(autotune, "shipped_defaults", lambda: {
        autotune.make_key("engine_step", 7, 13, 24, "float32", "cuda"):
            {"plan": "rowwise", "bt": 2},
        wild: {"plan": "tile", "bt": 3},
    })
    assert autotune.resolve("engine_step", **shape) == \
        TileConfig(plan="rowwise", bt=2)
    autotune.save_cache({wild: {"plan": "tile", "bt": 5}})
    assert autotune.resolve("engine_step", **shape) == \
        TileConfig(plan="rowwise", bt=2)
    assert autotune.resolve("engine_step", q=1, m=1, d=1,
                            backend="cuda") == TileConfig(plan="tile", bt=5)
    # the backend is part of the key: a cpu lookup sees no cuda entry
    assert autotune.resolve("engine_step", q=1, m=1, d=1,
                            backend="cpu") == TileConfig()
    autotune.record("engine_step", TileConfig(plan="tile", bt=16), **shape)
    assert autotune.resolve("engine_step", **shape) == \
        TileConfig(plan="tile", bt=16)
    assert autotune.resolve("engine_step", **shape,
                            override=autotune.parse_tile("rowwise")) == \
        TileConfig(plan="rowwise", bt=16)
    assert autotune.resolve("engine_step", **shape,
                            override=autotune.parse_tile(":4")) == \
        TileConfig(plan="tile", bt=4)
    monkeypatch.setattr(autotune, "shipped_defaults", lambda: {})
    autotune.save_cache({})
    assert autotune.resolve("engine_step", **shape) == TileConfig()


def test_shipped_defaults_are_card_entries(tmp_cache):
    """The shipped file holds only engine-step entries from a card sweep,
    each a valid config, and names the card and its power limit; no JAX
    cpu|/tpu| entry came along."""
    doc = json.loads(autotune._DEFAULTS_PATH.read_text())
    assert "H100" in doc["comment"] and " W" in doc["comment"]
    shipped = autotune.shipped_defaults()
    assert shipped
    for key, entry in shipped.items():
        assert key.startswith("cuda|engine_step|"), key
        assert autotune._from_entry(entry) is not None, key
    # no local cache: a cuda lookup at a shipped key resolves through it
    key = next(iter(shipped))
    _, _, q, m, d, dtype = key.split("|")
    cfg = autotune.lookup("engine_step", int(q[1:]), int(m[1:]),
                          int(d[1:]), dtype, backend="cuda")
    assert cfg == autotune._from_entry(shipped[key])
    assert autotune.lookup("engine_step", 3, 3, 3, backend="cpu") is None


def test_autotune_round_trip_skips_second_sweep(tmp_cache):
    calls = []

    def bench(cand):
        calls.append(cand)
        return 0.001 if cand.plan == "tile" else 0.002

    cands = [TileConfig(plan="rowwise", bt=8), TileConfig(plan="tile", bt=8)]
    shape = dict(q=16, m=8, d=32, dtype="float32", backend="cuda")
    before = dict(autotune.CACHE_STATS)
    won = autotune.autotune("engine_step", cands, bench, **shape)
    assert won.plan == "tile" and len(calls) == 2
    again = autotune.autotune("engine_step", cands, bench, **shape)
    assert again == won and len(calls) == 2
    assert autotune.CACHE_STATS["sweeps"] == before["sweeps"] + 1
    assert autotune.CACHE_STATS["sweep_cache_hits"] == \
        before["sweep_cache_hits"] + 1
    autotune.autotune("engine_step", cands, bench, q=99, m=8, d=32,
                      backend="cuda")
    assert len(calls) == 4
    autotune.autotune("engine_step", cands, bench, force=True, **shape)
    assert len(calls) == 6
    doc = json.loads(tmp_cache.read_text())
    entry = doc["entries"][autotune.make_key("engine_step", 16, 8, 32,
                                             "float32", "cuda")]
    assert entry["plan"] == "tile" and "swept_us" in entry
    assert set(entry["swept_us"]) == {"rowwise:8", "tile:8"}


def test_shipped_defaults_do_not_suppress_sweep(tmp_cache, monkeypatch):
    key = autotune.make_key("engine_step", 4, 4, 4, "float32", "cuda")
    monkeypatch.setattr(autotune, "shipped_defaults",
                        lambda: {key: {"plan": "rowwise", "bt": 8}})
    calls = []
    autotune.autotune("engine_step", [TileConfig(plan="tile", bt=8)],
                      lambda c: calls.append(c) or 0.001, q=4, m=4, d=4,
                      backend="cuda")
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# cache hardening
# ---------------------------------------------------------------------------

def test_corrupt_cache_warns_and_falls_back(tmp_cache, monkeypatch):
    monkeypatch.setattr(autotune, "shipped_defaults", lambda: {
        "cuda|engine_step|*": {"plan": "tile", "bt": 8}})
    tmp_cache.write_text("{ this is not json")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        cfg = autotune.lookup("engine_step", backend="cuda")
    assert cfg == TileConfig(plan="tile", bt=8)
    with pytest.warns(RuntimeWarning):
        assert autotune.resolve("engine_step", backend="cuda").plan == "tile"


def test_unexpected_cache_layout_warns(tmp_cache, monkeypatch):
    monkeypatch.setattr(autotune, "shipped_defaults", lambda: {})
    tmp_cache.write_text('{"entries": [1, 2, 3]}')
    with pytest.warns(RuntimeWarning, match="unexpected layout"):
        assert autotune.load_cache() == {}


def test_garbage_entry_values_fall_through(tmp_cache, monkeypatch):
    monkeypatch.setattr(autotune, "shipped_defaults", lambda: {
        "cuda|engine_step|*": {"plan": "rowwise", "bt": 4}})
    key = autotune.make_key("engine_step", 8, 24, 32, "float32", "cuda")
    autotune.save_cache({key: {"plan": "tile", "bt": "fast"},
                         "cuda|engine_step|*": {"plan": "diagonal",
                                                "bt": 2}})
    cfg = autotune.lookup("engine_step", 8, 24, 32, "float32",
                          backend="cuda")
    assert cfg == TileConfig(plan="rowwise", bt=4)


def test_corrupt_cache_is_repairable_by_save(tmp_cache):
    tmp_cache.write_text("garbage")
    with pytest.warns(RuntimeWarning):
        assert autotune.load_cache() == {}
    with pytest.warns(RuntimeWarning):      # record reads it first
        autotune.record("engine_step", TileConfig("tile", 16),
                        backend="cuda")
    key = autotune.make_key("engine_step", 0, 0, 0, "float32", "cuda")
    assert autotune._from_entry(autotune.load_cache()[key]) \
        == TileConfig("tile", 16)


# ---------------------------------------------------------------------------
# the engine's tile plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(5)
    base = rng.normal(size=(N, D)).astype(np.float32)
    queries = torch.as_tensor(rng.normal(size=(Q, D)).astype(np.float32))
    graph = build_l2_graph(base, m=10, k_construction=32, device="cpu")
    return dict(base=base, queries=queries,
                nbrs=torch.as_tensor(graph.neighbors),
                entries=torch.full((Q,), graph.entry), graph=graph)


def _measure(family):
    return make_family_measure(family, torch.Generator().manual_seed(0), D,
                               device="cpu")


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("ids", "scores", "n_eval", "n_grad", "n_iters"))


SEARCHES = {
    "guitar": (dict(mode="guitar"), {}),
    "sl2g": (dict(mode="sl2g"), {}),
    "adaptive": (dict(mode="guitar", alpha=1.2),
                 dict(adaptive="angle", c_max=10, angle_tau=1.8)),
}


@pytest.mark.parametrize("name", list(SEARCHES))
@pytest.mark.parametrize("family", ["deepfm", "mlp"])
def test_tile_plan_equals_rowwise_and_unfused_at_f32(system, family, name,
                                                     tmp_cache):
    """EngineOptions(tile=...) picks a dataflow, never a result: the tile
    plan, the rowwise plan and the unfused search return the same ids,
    scores and counters at float32."""
    cfg_kw, opt_kw = SEARCHES[name]
    cfg = SearchConfig(k=10, ef=24, budget=6, **{"alpha": 1.1, **cfg_kw})
    m = _measure(family)
    store = make_corpus_store(system["base"], "float32", device="cpu")
    args = (store, system["nbrs"], system["queries"], system["entries"], cfg)
    ref = search_measure(m, *args, EngineOptions(**opt_kw))
    for plan in ("rowwise", "tile"):
        r = search_measure(m, *args, EngineOptions(fused=True, tile=plan,
                                                   **opt_kw))
        assert _same(ref, r), plan
    eng = build_engine(m, cfg, EngineOptions(fused=True, tile="tile",
                                             **opt_kw))
    assert eng._use_tile_plan(store, system["nbrs"].shape[1], Q)
    assert _same(ref, eng.search_debug(m.params, *args[:4]))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("family", ["deepfm", "mlp"])
def test_tile_plan_equals_rowwise_quantized(system, family, dtype,
                                            tmp_cache):
    """At bf16/int8 the tile plan's rows come from ``store.take``, which
    dequantizes as the fused stages do: tile = rowwise = unfused."""
    cfg = SearchConfig(k=10, ef=24, budget=6, alpha=1.1)
    m = _measure(family)
    store = make_corpus_store(system["base"], dtype, device="cpu")
    args = (store, system["nbrs"], system["queries"], system["entries"], cfg)
    rows = search_measure(m, *args, EngineOptions(
        fused=True, corpus_dtype=dtype, tile="rowwise"))
    tile = search_measure(m, *args, EngineOptions(
        fused=True, corpus_dtype=dtype, tile="tile"))
    unfused = search_measure(m, *args, EngineOptions(corpus_dtype=dtype))
    assert _same(rows, tile) and _same(unfused, tile)


def test_bt_changes_no_result(system, tmp_cache):
    cfg = SearchConfig(k=10, ef=24, budget=6, alpha=1.1)
    m = _measure("deepfm")
    store = make_corpus_store(system["base"], "int8", device="cpu")
    args = (store, system["nbrs"], system["queries"], system["entries"], cfg)
    outs = [search_measure(m, *args, EngineOptions(
        fused=True, corpus_dtype="int8", tile=spec))
        for spec in ("tile:1", "tile:16", "rowwise:3", ":5")]
    assert all(_same(outs[0], o) for o in outs[1:])


def test_plan_resolved_once_per_program(system, tmp_cache):
    """The plan is looked up once per engine and shape (it reads the cache
    files), never per step, and is part of the program's key; the cache
    decides it when no override is given; a paged store always tiles."""
    m = _measure("deepfm")
    cfg = SearchConfig(k=10, ef=24, budget=6, alpha=1.1)
    store = make_corpus_store(system["base"], "float32", device="cpu")
    B = system["nbrs"].shape[1]
    autotune.record("engine_step", TileConfig("tile", 8), q=Q, m=B, d=D,
                    dtype="float32", backend="cpu")
    eng = build_engine(m, cfg, EngineOptions(fused=True))
    args = (m.params, store, system["nbrs"], system["queries"],
            system["entries"])
    looks = lambda: (autotune.CACHE_STATS["lookup_hits"]  # noqa: E731
                     + autotune.CACHE_STATS["lookup_misses"])
    n0 = looks()
    first = eng.search(*args)
    assert looks() == n0 + 1
    assert eng.search(*args) is not None and looks() == n0 + 1
    eng.search_debug(*args)
    assert looks() == n0 + 1
    assert [key[-1] for key in eng._programs] == [True]
    assert eng.stats["steps"] > 8          # many steps, one lookup
    # a new batch shape resolves (and misses: no entry at Q=5)
    eng.search(m.params, store, system["nbrs"], system["queries"][:5],
               system["entries"][:5])
    assert looks() == n0 + 2
    assert sorted(key[-1] for key in eng._programs) == [False, True]
    unfused = search_measure(m, *args[1:], cfg)
    assert _same(first, unfused)
    paged = make_corpus_store(system["base"], "float32", device="cpu",
                              residency=ResidencyPolicy("paged", 64, 1 << 20))
    eng_r = build_engine(m, cfg, EngineOptions(fused=True, tile="rowwise"))
    assert eng_r._use_tile_plan(paged, B, Q)
    assert not eng_r._use_tile_plan(store, B, Q)
    assert not build_engine(m, cfg, EngineOptions(tile="tile")) \
        ._use_tile_plan(store, B, Q)         # no fused stage: no plan


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SERVE = ["--items", "600", "--dim", "40", "--queries", "40", "--batch",
         "16", "--device", "cpu"]


def test_serve_autotune_sweeps_then_hits(tmp_cache, tmp_path, capsys):
    from repro_torch.launch import serve
    plain = serve.main(SERVE + ["--corpus-dtype", "int8"])
    before = dict(autotune.CACHE_STATS)
    first = serve.main(SERVE + ["--corpus-dtype", "int8", "--autotune"])
    text = capsys.readouterr().out
    assert autotune.CACHE_STATS["sweeps"] == before["sweeps"] + 1
    assert "autotune: engine_step plan=" in text and "swept rowwise:8=" in text
    assert str(tmp_cache) in text and "(Q=16, B=" in text
    assert first["recall"] == plain["recall"]
    assert first["evals_per_query"] == plain["evals_per_query"]
    # the second run at this shape (continuous, 16 lanes) hits the cache
    metrics = tmp_path / "m.prom"
    second = serve.main(SERVE + ["--corpus-dtype", "int8", "--autotune",
                                 "--runtime", "continuous", "--lanes", "16",
                                 "--offered-qps", "5000",
                                 "--metrics-out", str(metrics)])
    text = capsys.readouterr().out
    assert autotune.CACHE_STATS["sweeps"] == before["sweeps"] + 1
    assert autotune.CACHE_STATS["sweep_cache_hits"] == \
        before["sweep_cache_hits"] + 1
    assert "cache hit, no sweep" in text and second["recall"] > 0.5
    prom = metrics.read_text()
    for name in ("repro_autotune_lookup_hits_total",
                 "repro_autotune_lookup_misses_total",
                 "repro_autotune_sweeps_total",
                 "repro_autotune_sweep_cache_hits_total"):
        assert name in prom, name
    entry = json.loads(tmp_cache.read_text())["entries"][
        autotune.make_key("engine_step", 16, second_b(text), 40, "int8",
                          "cpu")]
    assert set(entry["swept_us"]) == {"rowwise:8", "tile:8"}


def second_b(text):
    """The neighbor degree B the launcher's autotune line reports."""
    return int(text.split("(Q=16, B=")[1].split(",")[0])


def test_serve_autotune_skips_and_tile_flag(tmp_cache, capsys):
    from repro_torch.launch import serve
    serve.main(SERVE + ["--autotune"])
    assert "nothing to tune" in capsys.readouterr().out
    serve.main(SERVE + ["--autotune", "--residency", "paged",
                        "--page-rows", "64", "--cache-mb", "1"])
    assert "autotune: skipped (paged residency" in capsys.readouterr().out
    assert not tmp_cache.exists()
    rows, tiles = [], []
    a = serve.main(SERVE + ["--fused", "--tile", "rowwise"], results=rows)
    b = serve.main(SERVE + ["--fused", "--tile", "tile:4"], results=tiles)
    assert a["recall"] == b["recall"]
    assert all(_same(x, y) for x, y in zip(rows, tiles))
    with pytest.raises(ValueError, match="bad tile spec"):
        serve.main(SERVE + ["--fused", "--tile", "diagonal"])
