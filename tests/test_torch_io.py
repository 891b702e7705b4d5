"""The port's index files against the JAX package's, both directions, on
the CPU: a file either package writes (v1, v2 and v3; float32, bfloat16
and int8; ``graph`` with and without tombstones, and ``sharded``) loads in
the other with equal arrays, and the payload files the port writes are
byte for byte the JAX package's. Then the version, kind and residency
guards, and the port's two launchers: ``build_index`` (single, sharded,
BEGIN) and ``serve --index`` / ``--save-index``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sharded as jsharded  # noqa: E402
from repro.graph import build as jbuild  # noqa: E402
from repro.graph import io as jio  # noqa: E402
from repro_torch.core import make_corpus_store  # noqa: E402
from repro_torch.core.sharded import ShardedIndex  # noqa: E402
from repro_torch.graph import (FORMAT_VERSION, GraphIndex,  # noqa: E402
                               load_corpus_store, load_index,
                               load_index_meta, save_index)
from repro_torch.graph import io as tio  # noqa: E402

DTYPES = ("float32", "bfloat16", "int8")
N, D = 300, 12


@pytest.fixture(scope="module")
def jgraph():
    base = np.random.default_rng(31).normal(size=(N, D)).astype(np.float32)
    return jbuild.build_l2_graph(base, m=8, k_construction=20)


@pytest.fixture(scope="module")
def jsharded_index():
    base = np.random.default_rng(32).normal(size=(207, D)).astype(np.float32)
    return jsharded.build_sharded_index(base, n_shards=4, m=6,
                                        k_construction=16)


def _flags():
    flags = np.zeros(N, bool)
    flags[::7] = True
    return flags


def _port_graph(jg, tombstones=None):
    return GraphIndex(neighbors=jg.neighbors, entry=jg.entry, base=jg.base,
                      tombstones=tombstones)


def _port_sharded(js):
    return ShardedIndex(base=js.base, neighbors=js.neighbors,
                        entries=js.entries, global_ids=js.global_ids,
                        n_shards=js.n_shards)


def _store_arrays(store):
    """A port store's payload as the JAX store's numpy leaves."""
    data = store.data.cpu()
    if store.dtype == "bfloat16":
        data = data.view(torch.int16).numpy().view(np.uint16)
    else:
        data = data.numpy()
    scales = None if store.scales is None else store.scales.cpu().numpy()
    words = None if store.tombstones is None else \
        store.tombstones.cpu().numpy().astype(np.uint32)
    return data, scales, words


def _assert_store_equal(store, jstore):
    data, scales, words = _store_arrays(store)
    assert store.dtype == jstore.dtype
    np.testing.assert_array_equal(data, np.asarray(jstore.data))
    assert data.dtype == np.asarray(jstore.data).dtype
    if jstore.scales is None:
        assert scales is None
    else:
        np.testing.assert_array_equal(scales, np.asarray(jstore.scales))
    if jstore.tombstones is None:
        assert words is None
    else:
        np.testing.assert_array_equal(words, np.asarray(jstore.tombstones))


# ---------------------------------------------------------------------------
# JAX-written files load in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tomb", [False, True])
def test_jax_v3_graph_loads_in_port(tmp_path, jgraph, dtype, tomb):
    flags = _flags() if tomb else None
    jg = jbuild.GraphIndex(neighbors=jgraph.neighbors, entry=jgraph.entry,
                           base=jgraph.base, tombstones=flags)
    jio.save_index(str(tmp_path), jg, corpus_dtype=dtype, page_rows=64,
                   extra_meta={"graph_kind": "l2"})
    g = load_index(str(tmp_path))
    want = jio.load_index(str(tmp_path))
    assert isinstance(g, GraphIndex) and g.entry == want.entry
    np.testing.assert_array_equal(g.neighbors, want.neighbors)
    np.testing.assert_array_equal(g.base, want.base)
    assert g.base.dtype == np.float32
    if tomb:
        np.testing.assert_array_equal(g.tombstones, flags)
        assert g.n_alive == want.n_alive
    else:
        assert g.tombstones is None
    store = load_corpus_store(str(tmp_path), device="cpu")
    _assert_store_equal(store, jio.load_corpus_store(str(tmp_path)))
    assert load_index_meta(str(tmp_path)) == jio.load_index_meta(
        str(tmp_path))


@pytest.mark.parametrize("version,dtype", [(1, "float32"), (2, "float32"),
                                           (2, "bfloat16"), (2, "int8")])
def test_jax_legacy_versions_load_in_port(tmp_path, jgraph, version, dtype):
    """v1 (always float32) and v2 (quantized) layouts: the corpus payload
    as npz members, no page metadata."""
    arrays = {"neighbors": jgraph.neighbors,
              **jio._encode_base(jgraph.base, dtype)}
    np.savez_compressed(tmp_path / "arrays.npz", **arrays)
    meta = {"format_version": version, "kind": "graph",
            "entry": int(jgraph.entry), "n": N, "dim": D,
            "max_degree": int(jgraph.max_degree),
            "avg_degree": float(jgraph.avg_degree)}
    if version >= 2:
        meta["corpus_dtype"] = dtype
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    g = load_index(str(tmp_path))
    want = jio.load_index(str(tmp_path))
    np.testing.assert_array_equal(g.neighbors, want.neighbors)
    np.testing.assert_array_equal(g.base, want.base)
    _assert_store_equal(load_corpus_store(str(tmp_path), device="cpu"),
                        jio.load_corpus_store(str(tmp_path)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_sharded_loads_in_port(tmp_path, jsharded_index, dtype):
    jio.save_index(str(tmp_path), jsharded_index, corpus_dtype=dtype)
    idx = load_index(str(tmp_path))
    want = jio.load_index(str(tmp_path))
    assert isinstance(idx, ShardedIndex) and idx.n_shards == 4
    for f in ("base", "neighbors", "entries", "global_ids"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(want, f))
    assert (idx.global_ids < 0).sum() > 0            # 207 % 4 != 0


# ---------------------------------------------------------------------------
# port-written files load in JAX, byte for byte in the payload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tomb", [False, True])
def test_port_v3_graph_loads_in_jax(tmp_path, jgraph, dtype, tomb):
    flags = _flags() if tomb else None
    extra = {"graph_kind": "begin", "measure_family": "deepfm"}
    save_index(str(tmp_path / "port"), _port_graph(jgraph, flags),
               corpus_dtype=dtype, page_rows=64, extra_meta=extra)
    jio.save_index(str(tmp_path / "jax"),
                   jbuild.GraphIndex(neighbors=jgraph.neighbors,
                                     entry=jgraph.entry, base=jgraph.base,
                                     tombstones=flags),
                   corpus_dtype=dtype, page_rows=64, extra_meta=extra)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "meta.json").read_text())
    for name in meta["payload_files"].values():
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    g = jio.load_index(str(tmp_path / "port"))
    want = jio.load_index(str(tmp_path / "jax"))
    np.testing.assert_array_equal(g.neighbors, want.neighbors)
    np.testing.assert_array_equal(g.base, want.base)
    assert g.entry == want.entry
    if tomb:
        np.testing.assert_array_equal(g.tombstones, flags)
    else:
        assert g.tombstones is None
    js = jio.load_corpus_store(str(tmp_path / "port"))
    jw = jio.load_corpus_store(str(tmp_path / "jax"))
    np.testing.assert_array_equal(np.asarray(js.data), np.asarray(jw.data))
    if jw.scales is not None:
        np.testing.assert_array_equal(np.asarray(js.scales),
                                      np.asarray(jw.scales))
    assert list(tmp_path.glob("port/*.tmp")) == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_sharded_loads_in_jax(tmp_path, jsharded_index, dtype):
    save_index(str(tmp_path / "port"), _port_sharded(jsharded_index),
               corpus_dtype=dtype)
    jio.save_index(str(tmp_path / "jax"), jsharded_index, corpus_dtype=dtype)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "meta.json").read_text())
    got = jio.load_index(str(tmp_path / "port"))
    want = jio.load_index(str(tmp_path / "jax"))
    assert isinstance(got, jsharded.ShardedIndex)
    for f in ("base", "neighbors", "entries", "global_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with np.load(tmp_path / "port" / "arrays.npz") as zp, \
            np.load(tmp_path / "jax" / "arrays.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype
            np.testing.assert_array_equal(zp[k], zj[k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_corpus_store_round_trip_equals_make_corpus_store(tmp_path, jgraph,
                                                          dtype):
    """A saved and reloaded store holds the bytes ``make_corpus_store``
    makes from the same base (bf16 and int8 never widened on the way)."""
    save_index(str(tmp_path), _port_graph(jgraph, _flags()),
               corpus_dtype=dtype)
    store = load_corpus_store(str(tmp_path), device="cpu")
    want = make_corpus_store(jgraph.base, dtype, device="cpu",
                             tombstones=_flags())
    assert store.data.dtype == want.data.dtype
    assert torch.equal(store.data, want.data)
    if dtype == "int8":
        assert torch.equal(store.scales, want.scales)
    assert torch.equal(store.tombstones, want.tombstones)
    assert store.nbytes() == want.nbytes()


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_guards(tmp_path, jgraph, jsharded_index):
    path = tmp_path / "idx"
    save_index(str(path), _port_graph(jgraph))
    meta = json.loads((path / "meta.json").read_text())
    assert meta["format_version"] == FORMAT_VERSION == jio.FORMAT_VERSION
    for bad in (FORMAT_VERSION + 1, 0, "3"):
        (path / "meta.json").write_text(
            json.dumps({**meta, "format_version": bad}))
        with pytest.raises(ValueError, match="format_version"):
            load_index(str(path))
        with pytest.raises(ValueError, match="format_version"):
            load_index_meta(str(path))
    (path / "meta.json").write_text(json.dumps({**meta, "kind": "mystery"}))
    with pytest.raises(ValueError, match="unknown kind"):
        load_index(str(path))
    (path / "meta.json").write_text(
        json.dumps({**meta, "corpus_dtype": "fp8"}))
    with pytest.raises(ValueError, match="unknown corpus_dtype"):
        load_index(str(path))
    with pytest.raises(ValueError, match="unknown corpus_dtype"):
        load_corpus_store(str(path), device="cpu")
    (path / "meta.json").write_text(json.dumps(meta))
    # a paged policy by name, or any object with the policy's fields,
    # loads a paged store over the same payload; an unknown kind raises
    whole = load_corpus_store(str(path), residency="whole", device="cpu")
    assert whole.n == N and not whole.is_paged
    ids = torch.arange(N)
    paged = load_corpus_store(str(path), residency="paged", device="cpu")
    assert paged.is_paged and torch.equal(paged.take(ids), whole.take(ids))

    class Policy:
        kind = "paged"
        page_rows = 64
    paged = load_corpus_store(str(path), residency=Policy(), device="cpu")
    assert paged.cache.page_rows == 64
    assert torch.equal(paged.take(ids), whole.take(ids))
    with pytest.raises(ValueError, match="residency kind"):
        load_corpus_store(str(path), residency="bogus", device="cpu")
    with pytest.raises(TypeError):
        save_index(str(tmp_path / "bad"), {"not": "an index"})
    with pytest.raises(ValueError, match="corpus_dtype"):
        save_index(str(tmp_path / "bad"), _port_graph(jgraph),
                   corpus_dtype="fp8")
    with pytest.raises(ValueError, match="page_rows"):
        save_index(str(tmp_path / "bad"), _port_graph(jgraph), page_rows=0)
    save_index(str(tmp_path / "sh"), _port_sharded(jsharded_index))
    with pytest.raises(ValueError, match="single-partition"):
        load_corpus_store(str(tmp_path / "sh"), device="cpu")


def test_bf16_encoding_matches_ml_dtypes():
    """Round to nearest even at every tie and edge the N(0,1) data never
    hits: halfway cases, subnormals, infinities, the largest finite."""
    x = np.array([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -1.0 - 2 ** -8, 1e-40,
                  -1e-39, np.inf, -np.inf, 3.3895314e38, 0.0, -0.0,
                  65504.0, 1.0 / 3.0], np.float32)
    got = tio._encode_base(x[None, :], "bfloat16")["base_bf16"]
    np.testing.assert_array_equal(
        got, jio._encode_base(x[None, :], "bfloat16")["base_bf16"])
    np.testing.assert_array_equal(
        tio._decode_base({"base_bf16": got}, "bfloat16"),
        jio._decode_base({"base_bf16": got}, "bfloat16"))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_build_index_cli_single_sharded_and_begin(tmp_path, capsys):
    from repro_torch.launch import build_index
    out = str(tmp_path / "single")
    build_index.main(["--items", "400", "--dim", "8", "--m", "8",
                      "--k-construction", "20", "--out", out,
                      "--device", "cpu"])
    g = jio.load_index(out)               # the JAX reader takes it
    assert g.n == 400 and g.avg_degree > 4
    assert jio.load_index_meta(out)["graph_kind"] == "l2"

    out2 = str(tmp_path / "sharded")
    build_index.main(["--items", "410", "--dim", "8", "--m", "8",
                      "--k-construction", "20", "--shards", "4",
                      "--corpus-dtype", "int8", "--out", out2,
                      "--device", "cpu"])
    idx = load_index(out2)
    assert isinstance(idx, ShardedIndex)
    gids = idx.global_ids
    assert (gids < 0).sum() > 0          # 410 % 4 != 0 -> padded rows
    real = gids[gids >= 0]
    assert len(np.unique(real)) == real.size == 410
    assert isinstance(jio.load_index(out2), jsharded.ShardedIndex)

    npy = tmp_path / "corpus.npy"
    corpus = np.random.default_rng(2).normal(size=(200, 8)).astype(
        np.float32)
    np.save(npy, corpus)
    out3 = str(tmp_path / "begin")
    build_index.main(["--base", str(npy), "--graph", "begin", "--m", "12",
                      "--train-queries", "32", "--out", out3,
                      "--corpus-dtype", "bfloat16", "--page-rows", "64",
                      "--device", "cpu"])
    meta = load_index_meta(out3)
    assert (meta["graph_kind"], meta["measure_family"], meta["page_rows"]) \
        == ("begin", "deepfm", 64)
    assert load_index(out3).neighbors.shape == (200, 12)
    assert "built in" in capsys.readouterr().out
    out4 = str(tmp_path / "paged")
    build_index.main(["--items", "300", "--dim", "8", "--m", "8",
                      "--k-construction", "20", "--corpus-dtype", "int8",
                      "--page-rows", "32", "--residency", "paged",
                      "--out", out4, "--device", "cpu"])
    assert "paged verification ok: page_rows=32" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="single-partition only"):
        build_index.main(["--out", out, "--shards", "2", "--graph",
                          "begin", "--device", "cpu"])


def test_serve_index_and_save_index_round_trip(tmp_path, capsys):
    """serve --save-index writes the served graph with its provenance;
    serve --index of it returns the synthetic run's results bit for bit
    (same graph, same payload, same query stream after the base draw);
    a dtype or measure-family mismatch warns and still serves."""
    from repro_torch.launch import build_index, serve
    saved = str(tmp_path / "saved")
    common = ["--dim", "40", "--queries", "64", "--batch", "32",
              "--device", "cpu", "--corpus-dtype", "int8"]
    first = []
    serve.main(["--items", "500", "--save-index", saved] + common,
               results=first)
    meta = load_index_meta(saved)
    assert (meta["graph_kind"], meta["corpus_dtype"], meta["n"]) == \
        ("l2", "int8", 500)
    again = []
    out = serve.main(["--index", saved, "--save-index",
                      str(tmp_path / "copy")] + common, results=again)
    assert out["n_batches"] == 2 and out["recall"] > 0.3
    # the index run draws no base, so its queries differ from the first
    # run's; hold it against the in-memory graph on its own query stream
    g = load_index(saved)
    args = serve.parse_args(["--index", saved] + common)
    from repro_torch.core import SearchConfig, make_family_measure
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device="cpu")
    store = make_corpus_store(
        jio.load_index(saved).base, "int8", device="cpu")
    mem = []
    serve.serve_oneshot(args, g, measure,
                        SearchConfig(k=10, ef=64, budget=8, alpha=1.01),
                        serve.engine_options(args), store,
                        torch.as_tensor(g.neighbors), torch.as_tensor(g.base),
                        np.random.default_rng(0), torch.device("cpu"),
                        results=mem)
    assert len(mem) == len(again) == 2
    for a, b in zip(again, mem):
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert load_index_meta(str(tmp_path / "copy"))["graph_kind"] == "l2"
    capsys.readouterr()
    serve.main(["--index", saved, "--dim", "40", "--queries", "32",
                "--device", "cpu"])
    assert "re-quantizing" in capsys.readouterr().out
    bg = str(tmp_path / "bg")
    build_index.main(["--items", "300", "--dim", "40", "--graph", "begin",
                      "--measure", "mlp", "--train-queries", "16",
                      "--m", "16", "--out", bg, "--device", "cpu"])
    serve.main(["--index", bg, "--queries", "32", "--device", "cpu"])
    assert "built measure-aware under the 'mlp' family" in \
        capsys.readouterr().out
    build_index.main(["--items", "200", "--dim", "40", "--shards", "2",
                      "--m", "6", "--k-construction", "16",
                      "--out", str(tmp_path / "sh"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="not a single-partition"):
        serve.main(["--index", str(tmp_path / "sh"), "--device", "cpu"])


def test_serve_index_keeps_tombstones(tmp_path, jgraph):
    """A saved index with tombstones serves with them: no deleted row is
    returned (the store comes from the file, as stored). Deleted rows are
    scored -inf and not expanded, so some results come back short."""
    from repro_torch.launch import serve
    base = np.random.default_rng(5).normal(size=(600, 40)).astype(
        np.float32)
    g = jbuild.build_l2_graph(base, m=8, k_construction=24)
    flags = np.zeros(600, bool)
    flags[::11] = True
    flags[g.entry] = False
    jio.save_index(str(tmp_path), jbuild.GraphIndex(
        neighbors=g.neighbors, entry=g.entry, base=g.base,
        tombstones=flags), corpus_dtype="float32")
    res = []
    serve.main(["--index", str(tmp_path), "--queries", "64",
                "--device", "cpu"], results=res)
    ids = torch.cat([r.ids for r in res]).numpy()
    found = ids[ids >= 0]
    assert found.size > 0.5 * ids.size and not flags[found].any()
