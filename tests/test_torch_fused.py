"""The port's index-fused search and bf16/int8 corpus residency against the
JAX package on the CPU.

- Residency helpers must equal the JAX functions bit for bit (int8
  quantization rounds half to even on both sides, bf16 rounds to nearest
  even), and a store built from a JAX store's leaves must gather the same
  float32 rows.
- Each fused wrapper is held against the JAX fused jnp reference
  (``use_pallas=False``) on the same payload: scores, values and gradients
  at rtol 1e-5 / atol 1e-6, angle keys at atol 5e-4 with masks equal away
  from the band edge (the tolerances of ``test_torch_kernels.py``, for the
  same reasons), the dequantized frontier rows ``x`` exactly.
- Inside the port, the fused search at float32 residency equals the
  unfused one exactly (ids, scores, counters); bf16/int8 and tombstoned
  searches hold the JAX engine's recall@10 within 0.01.

On the CPU every wrapper runs its plain version; the CUDA kernels are held
against those on the card (``test_fused_kernels_match_plain_on_card``, and
``chip_smoke.py``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as jcorpus  # noqa: E402
from repro.core import (EngineOptions as JOptions,  # noqa: E402
                        SearchConfig as JConfig,
                        brute_force_topk as j_brute_force_topk,
                        make_family_measure as j_make_family_measure,
                        search_measure as j_search_measure)
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro.kernels.deepfm_grad_fused import (  # noqa: E402
    deepfm_grad_fused as j_grad_fused)
from repro.kernels.deepfm_score_fused import (  # noqa: E402
    deepfm_score_fused as j_score_fused)
from repro.kernels.neighbor_rank_fused import (  # noqa: E402
    neighbor_rank_fused as j_rank_fused)
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              build_engine, deepfm_measure,
                              make_corpus_store, params_from_jax, recall,
                              search_measure, store_from_arrays)
from repro_torch.core import corpus as tcorpus  # noqa: E402
from repro_torch.core.measures import deepfm_config_for  # noqa: E402
from repro_torch.kernels import (deepfm_grad_fused,  # noqa: E402
                                 deepfm_score_fused, launch_counts,
                                 neighbor_rank_fused)

DTYPES = ("float32", "bfloat16", "int8")
FM, DD = 8, 32
D = FM + DD
RTOL, ATOL = 1e-5, 1e-6
ANGLE_ATOL = 5e-4


def _jax_store(base, dtype, tombstones=None):
    return jcorpus.make_corpus_store(jnp.asarray(base), dtype,
                                     tombstones=tombstones)


def _port_store(js):
    """The port's store over exactly the JAX store's payload."""
    words = None if js.tombstones is None else np.asarray(js.tombstones)
    return store_from_arrays(
        np.asarray(js.data), None if js.scales is None
        else np.asarray(js.scales), js.dtype, words, device="cpu")


# ---------------------------------------------------------------------------
# residency: exact against the JAX functions
# ---------------------------------------------------------------------------

def test_quantize_rows_int8_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, D)).astype(np.float32)
    # a row with max|x| = 127 has scale exactly 1: x / scale sits on .5 ties
    x[0, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5]
    x[1] = 0.0                                   # the eps floor
    x[2] *= 1e-3
    q8, sc = tcorpus.quantize_rows_int8(torch.from_numpy(x))
    jq8, jsc = jcorpus.quantize_rows_int8(jnp.asarray(x))
    assert q8.dtype == torch.int8 and sc.shape == (64, 1)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  np.asarray(jsc).view(np.uint32))
    assert list(q8[0, 1:7]) == [2, -4, 0, 0, 2, -2]   # half to even
    np.testing.assert_array_equal(
        tcorpus.dequantize_rows_int8(q8, sc).numpy(),
        np.asarray(jcorpus.dequantize_rows_int8(jq8, jsc)))


def test_bf16_bits_match_jax():
    rng = np.random.default_rng(1)
    # low halves of exactly 0x8000 are round-half-to-even ties
    hi = rng.integers(0x0080, 0x7F00, size=256).astype(np.uint32)
    ties = ((hi << 16) | 0x8000).view(np.float32)
    x = np.concatenate([ties, -ties, rng.normal(size=512).astype(np.float32),
                        np.float32([0.0, -0.0, 1e-40, 3.0e38])])
    got = tcorpus.f32_to_bf16_bits(torch.from_numpy(x)).numpy()
    want = np.asarray(jcorpus.f32_to_bf16_bits(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint16), want)
    every = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    wide = tcorpus.bf16_bits_to_f32(torch.from_numpy(every.view(np.int16)))
    np.testing.assert_array_equal(
        wide.numpy().view(np.uint32),
        np.asarray(jcorpus.bf16_bits_to_f32(jnp.asarray(every))).view(
            np.uint32))


def test_bitmaps_match_jax():
    rng = np.random.default_rng(2)
    flags = rng.random(77) < 0.3
    words = tcorpus.pack_bitmap(flags)
    np.testing.assert_array_equal(words, jcorpus.pack_bitmap(flags))
    np.testing.assert_array_equal(tcorpus.unpack_bitmap(words, 77), flags)
    np.testing.assert_array_equal(jcorpus.unpack_bitmap(words, 77), flags)
    ids = np.concatenate([rng.integers(0, 77, size=(40,)),
                          [-1, 0, 76, 95, 200]]).reshape(5, 9)
    got = tcorpus.bit_test_global(
        torch.from_numpy(words.astype(np.int64)), torch.from_numpy(ids))
    want = jcorpus.bit_test_global(jnp.asarray(words),
                                   jnp.asarray(ids.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_store_matches_jax_store(dtype):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(300, D)).astype(np.float32)
    js = _jax_store(base, dtype)
    ts = _port_store(js)
    ids = rng.integers(0, 300, size=(7, 11))
    np.testing.assert_array_equal(ts.take(torch.from_numpy(ids)).numpy(),
                                  np.asarray(js.take(jnp.asarray(ids))))
    np.testing.assert_array_equal(ts.dequantize().numpy(),
                                  np.asarray(js.dequantize()))
    assert ts.nbytes() == js.nbytes()
    # the port quantizes to the same payload by itself
    own = make_corpus_store(base, dtype, device="cpu")
    raw = own.data.view(torch.int16) if dtype == "bfloat16" else own.data
    np.testing.assert_array_equal(
        raw.numpy().view(np.asarray(js.data).dtype), np.asarray(js.data))
    if dtype == "int8":
        np.testing.assert_array_equal(own.scales.numpy(),
                                      np.asarray(js.scales))
    raw = own.take_raw(torch.tensor([5, 9]))
    jraw = np.asarray(js.take_raw(jnp.asarray([5, 9])))
    if dtype == "bfloat16":
        raw = raw.view(torch.int16)
    np.testing.assert_array_equal(raw.numpy().view(jraw.dtype), jraw)


def test_requantize_keeps_tombstones():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(100, D)).astype(np.float32)
    dead = rng.random(100) < 0.2
    ts = make_corpus_store(base, "bfloat16", device="cpu").with_tombstones(
        dead)
    js = _jax_store(base, "bfloat16").with_tombstones(dead)
    t8 = tcorpus.as_corpus_store(ts, "int8")
    j8 = jcorpus.as_corpus_store(js, "int8")
    assert t8.dtype == "int8"
    np.testing.assert_array_equal(t8.data.numpy(), np.asarray(j8.data))
    np.testing.assert_array_equal(t8.tombstones.numpy(),
                                  np.asarray(j8.tombstones).astype(np.int64))
    assert tcorpus.as_corpus_store(t8, "int8") is t8
    np.testing.assert_array_equal(
        tcorpus.unpack_bitmap(t8.tombstones.numpy(), 100), dead)


# ---------------------------------------------------------------------------
# the fused wrappers against the JAX fused references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(5)
    dims = [2 * DD, 64, 64, 1]
    w = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
         for a, b in zip(dims[:-1], dims[1:])]
    b = [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in dims[1:]]
    np_params = {"w": w, "b": b}
    return np_params, params_from_jax(np_params, device="cpu")


@pytest.fixture(scope="module")
def stores():
    base = np.random.default_rng(6).normal(size=(500, D)).astype(np.float32)
    out = {}
    for dt in DTYPES:
        js = _jax_store(base, dt)
        out[dt] = (js, _port_store(js))
    return out


def _jmlp(np_params):
    return {"w": [jnp.asarray(a) for a in np_params["w"]],
            "b": [jnp.asarray(a) for a in np_params["b"]]}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_deepfm_score_fused_matches_jax(mlp, stores, dtype, shared, masked):
    np_params, params = mlp
    js, ts = stores[dtype]
    M = 77
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 500, size=M)
    idx[[3, 40]] = -1                        # padding, clamped to row 0
    query = rng.normal(size=(D,) if shared else (M, D)).astype(np.float32)
    mask = rng.random(M) < 0.6 if masked else None
    got = deepfm_score_fused(
        ts, torch.from_numpy(idx), torch.from_numpy(query), params, FM,
        mask=None if mask is None else torch.from_numpy(mask))
    want = np.asarray(j_score_fused(
        js, jnp.asarray(idx.astype(np.int32)), jnp.asarray(query),
        _jmlp(np_params), FM, use_pallas=False,
        mask=None if mask is None else jnp.asarray(mask)))
    assert got.shape == (M,) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    if masked:
        assert np.isneginf(got[~mask]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(32, 48), (5, 37)])
@pytest.mark.parametrize("rank_by", ["angle", "projection"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_neighbor_rank_fused_matches_jax(stores, dtype, rank_by, shape):
    js, ts = stores[dtype]
    Q, B = shape
    alpha = 1.01
    rng = np.random.default_rng(Q * B)
    fid = rng.integers(0, 500, size=Q)
    x = np.array(js.take(jnp.asarray(fid)))
    g = rng.normal(size=(Q, D)).astype(np.float32)
    idx = rng.integers(0, 500, size=(Q, B))
    idx[1, 2] = fid[1]                       # a zero diff
    idx[2, :4] = -1
    valid = (rng.random((Q, B)) < 0.7) & (idx >= 0)
    valid[0] = False                         # an all-invalid lane
    key, mask = neighbor_rank_fused(
        torch.from_numpy(x), torch.from_numpy(g), ts, torch.from_numpy(idx),
        torch.from_numpy(valid), alpha, rank_by)
    wk, wm = j_rank_fused(jnp.asarray(x), jnp.asarray(g), js,
                          jnp.asarray(idx.astype(np.int32)),
                          jnp.asarray(valid), alpha, rank_by,
                          use_pallas=False)
    wk, wm = np.asarray(wk), np.asarray(wm)
    key, mask = key.numpy(), mask.numpy()
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(key), fin)
    np.testing.assert_array_equal(key[~fin], wk[~fin])
    if rank_by == "angle":
        np.testing.assert_allclose(key[fin], wk[fin], rtol=0,
                                   atol=ANGLE_ATOL)
        theta = np.where(fin, wk, np.inf).min(1, keepdims=True)
        with np.errstate(invalid="ignore"):   # inf - inf on invalid lanes
            near = np.abs(wk - alpha * theta) <= ANGLE_ATOL
    else:
        np.testing.assert_allclose(key[fin], wk[fin], rtol=RTOL, atol=ATOL)
        proj = np.where(fin, -wk, -np.inf)
        theta = proj.max(1, keepdims=True)
        bound = np.where(theta >= 0, theta / alpha, theta * alpha)
        with np.errstate(invalid="ignore"):
            near = np.abs(proj - bound) <= 1e-5 * (1 + np.abs(bound))
    assert not ((mask != wm) & ~near).any()
    assert not mask[~valid].any()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_deepfm_grad_fused_matches_jax(mlp, stores, dtype, shared):
    np_params, params = mlp
    js, ts = stores[dtype]
    Q = 33
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 500, size=Q)
    idx[5] = -1
    query = rng.normal(size=(D,) if shared else (Q, D)).astype(np.float32)
    vals, grads, x = deepfm_grad_fused(ts, torch.from_numpy(idx),
                                       torch.from_numpy(query), params, FM)
    q_b = np.broadcast_to(query, (Q, D)) if shared else query
    wv, wg, wx = j_grad_fused(js, jnp.asarray(idx.astype(np.int32)),
                              jnp.asarray(q_b), _jmlp(np_params), FM,
                              use_pallas=False)
    assert vals.shape == (Q,) and grads.shape == x.shape == (Q, D)
    np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(
        x.numpy(), ts.take(torch.from_numpy(idx).clamp_min(0)).numpy())
    np.testing.assert_allclose(vals.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(wg), rtol=RTOL,
                               atol=ATOL)


def test_fused_wrappers_reject_bad_arguments(mlp, stores):
    _, params = mlp
    _, ts = stores["int8"]
    ids = torch.arange(4)
    q = torch.zeros((4, D))
    with pytest.raises(TypeError, match="dtype"):
        deepfm_score_fused(ts, ids.int(), q, params, FM)
    with pytest.raises(ValueError, match="shape"):
        deepfm_score_fused(ts, ids, q, params, FM,
                           mask=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="shape"):
        deepfm_grad_fused(ts, ids, torch.zeros((3, D)), params, FM)
    with pytest.raises(ValueError, match="rank_by"):
        neighbor_rank_fused(q, q, ts, ids[:, None].repeat(1, 2),
                            torch.ones((4, 2), dtype=torch.bool), 1.01,
                            "cosine")
    with pytest.raises(ValueError, match="shape"):
        neighbor_rank_fused(q, q, ts, ids[:, None].repeat(1, 2),
                            torch.ones((4, 3), dtype=torch.bool))


def test_fused_cpu_calls_launch_no_kernel(mlp, stores):
    _, params = mlp
    _, ts = stores["bfloat16"]
    before = launch_counts()
    assert {"deepfm_score_fused", "neighbor_rank_fused",
            "deepfm_grad_fused"} <= set(before)
    ids = torch.arange(6)
    deepfm_score_fused(ts, ids, torch.zeros(D), params, FM)
    _, g, x = deepfm_grad_fused(ts, ids, torch.zeros((6, D)), params, FM)
    neighbor_rank_fused(x, g, ts, ids[:, None].repeat(1, 3),
                        torch.ones((6, 3), dtype=torch.bool))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# whole searches
# ---------------------------------------------------------------------------

N, Q = 1000, 64


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
                truth=np.asarray(truth))


SEARCHES = {
    "guitar-angle": (dict(mode="guitar", rank_by="angle"), {}),
    "guitar-projection": (dict(mode="guitar", rank_by="projection"), {}),
    "sl2g": (dict(mode="sl2g"), {}),
    "adaptive-angle": (dict(mode="guitar", rank_by="angle", alpha=1.2),
                       dict(adaptive="angle", c_max=12, angle_tau=1.8)),
}


def _cfg(name):
    cfg_kw, opt_kw = SEARCHES[name]
    return {**dict(k=10, ef=32, budget=8, alpha=1.01), **cfg_kw}, opt_kw


def _port_search(system, store, cfg_kw, opt_kw, queries=None):
    g = system["graph"]
    qs = system["queries"] if queries is None else queries
    return search_measure(
        system["tm"], store, torch.from_numpy(g.neighbors),
        torch.from_numpy(qs), torch.full((qs.shape[0],), g.entry),
        SearchConfig(**cfg_kw), EngineOptions(**opt_kw))


def _jax_search(system, store, cfg_kw, opt_kw):
    g = system["graph"]
    return j_search_measure(
        system["jm"], store, jnp.asarray(g.neighbors),
        jnp.asarray(system["queries"]), jnp.full((Q,), g.entry, jnp.int32),
        JConfig(**cfg_kw), JOptions(**opt_kw))


@pytest.mark.parametrize("name", list(SEARCHES))
def test_fused_search_equals_unfused_at_f32(system, name):
    cfg_kw, opt_kw = _cfg(name)
    store = make_corpus_store(system["base"], device="cpu")
    un = _port_search(system, store, cfg_kw, opt_kw)
    fu = _port_search(system, store, cfg_kw, {**opt_kw, "fused": True})
    eng = build_engine(system["tm"], SearchConfig(**cfg_kw),
                       EngineOptions(fused=True, **opt_kw))
    assert eng.measure_fused.bundle_family == "deepfm"
    assert (eng.grad_fused is None) == (cfg_kw["mode"] == "sl2g")
    for f in ("ids", "scores", "n_eval", "n_grad", "n_iters"):
        assert torch.equal(getattr(un, f), getattr(fu, f)), f


@pytest.mark.parametrize("name", ["guitar-angle", "adaptive-angle"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_search_recall_matches_jax(system, dtype, name):
    """The same graph, payload (the JAX store's bits) and weights."""
    cfg_kw, opt_kw = _cfg(name)
    opt_kw = {**opt_kw, "fused": True, "corpus_dtype": dtype}
    js = _jax_store(system["base"], dtype)
    jr = _jax_search(system, js, cfg_kw, opt_kw)
    tr = _port_search(system, _port_store(js), cfg_kw, opt_kw)
    r_j = recall(np.asarray(jr.ids), system["truth"])
    r_t = recall(tr.ids, system["truth"])
    assert abs(r_j - r_t) <= 0.01, (r_j, r_t)
    assert r_t > 0.5
    # returned scores are the measure's scores of the dequantized rows
    want = system["tm"].score(_port_store(js).take(tr.ids),
                              torch.from_numpy(system["queries"])[:, None])
    np.testing.assert_allclose(tr.scores.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype,fused", [("float32", False), ("int8", True)])
def test_tombstoned_rows_never_returned(system, dtype, fused):
    cfg_kw, opt_kw = _cfg("guitar-angle")
    opt_kw = {**opt_kw, "fused": fused, "corpus_dtype": dtype}
    rng = np.random.default_rng(12)
    dead = rng.random(N) < 0.03
    dead[system["truth"][:, 0]] = True       # every query's best item
    dead[system["graph"].entry] = False      # deletes keep a live entry
    js = _jax_store(system["base"], dtype, tombstones=dead)
    jr = _jax_search(system, js, cfg_kw, opt_kw)
    tr = _port_search(system, _port_store(js), cfg_kw, opt_kw)
    ids = tr.ids.numpy()
    assert not dead[ids[ids >= 0]].any()
    # the exact top-10 among the live rows
    n_dead = int(dead.sum())
    wide, _ = j_brute_force_topk(system["jm"], jnp.asarray(system["base"]),
                                 jnp.asarray(system["queries"]), 10 + n_dead)
    truth = np.stack([row[~dead[row]][:10] for row in np.asarray(wide)])
    r_j = recall(np.asarray(jr.ids), truth)
    r_t = recall(ids, truth)
    assert abs(r_j - r_t) <= 0.01, (r_j, r_t)
    # deleted rows score -inf and are never popped, so deleting each
    # query's best item cuts paths through it: recall falls on both sides
    assert r_t > 0.2


def test_serve_fused_int8_on_cpu(monkeypatch, capsys):
    """``--fused --corpus-dtype int8 --adaptive angle`` serves on the CPU,
    and recall is labelled on the float32 base, not the int8 payload."""
    from repro_torch.launch import serve
    labelled = []
    real = serve.brute_force_topk

    def spy(measure, base, queries, k, *a, **kw):
        labelled.append(base)
        return real(measure, base, queries, k, *a, **kw)

    monkeypatch.setattr(serve, "brute_force_topk", spy)
    out = serve.main(["--items", "600", "--dim", "40", "--queries", "40",
                      "--batch", "32", "--fused", "--corpus-dtype", "int8",
                      "--adaptive", "angle", "--c-max", "16",
                      "--device", "cpu"])
    assert out["fused"] and out["corpus_dtype"] == "int8"
    assert out["adaptive"] == "angle"
    assert out["n_batches"] == 2 and out["qps"] > 0 and out["recall"] > 0.5
    assert "corpus_dtype=int8 fused=True" in capsys.readouterr().out
    base = np.random.default_rng(0).normal(size=(600, 40)).astype(np.float32)
    assert len(labelled) == 1
    assert labelled[0].dtype == torch.float32
    np.testing.assert_array_equal(labelled[0].numpy(), base)
    # a quantized residency implies the fused path, as in the JAX launcher
    args = serve.parse_args(["--corpus-dtype", "bfloat16"])
    assert serve.engine_options(args).fused
    with pytest.raises(SystemExit, match="rank_by='angle'"):
        serve.main(["--items", "300", "--mode", "sl2g", "--adaptive",
                    "angle", "--device", "cpu"])


@pytest.mark.cuda
def test_fused_kernels_match_plain_on_card(mlp):
    """On a card: the three fused kernels against their plain versions at
    each residency, and bit for bit against the unfused kernels at float32
    (the same checks as chip_smoke.py's kernel phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core import make_family_measure
    dev = torch.device("cuda")
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  D, device=dev)
    report = chip_smoke.check_fused_kernels(torch, dev, measure, FM)
    assert set(report) == {"deepfm_score_fused", "neighbor_rank_fused",
                           "deepfm_grad_fused"}
    assert set(report["deepfm_score_fused"]["err_by_net"]) == \
        set(report["deepfm_grad_fused"]["err_by_net"])
