"""The port's graph construction against the JAX package on the CPU.

``symmetrize``, ``medoid``, NN-descent's reverse sampling and the seed
loops are numpy or integer logic and must match exactly. The occlusion
prune works in Gram form, where near-ties may flip between two backends'
rounding, so on the same kNN input at least 99% of its rows must be
identical; the kNN itself (blocked matmul + top-k) is held on overlap.
NN-descent's join sums distances in another order than XLA: on the same
inputs at least 99.9% of its rows are identical and its distances agree at
rtol 1e-5; whole NN-descent runs hold the JAX recall within 0.01.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import build as jbuild  # noqa: E402
from repro.graph import prune as jprune  # noqa: E402
from repro_torch.graph import (GraphIndex, brute_force_knn,  # noqa: E402
                               build_l2_graph, knn_recall, medoid, nn_descent,
                               occlusion_prune, occlusion_prune_ref,
                               symmetrize, symmetrize_ref)
from repro_torch.graph import build as tbuild  # noqa: E402

N, D, KC = 800, 40, 48


@pytest.fixture(scope="module")
def data():
    base = np.random.default_rng(21).normal(size=(N, D)).astype(np.float32)
    return base, jbuild.brute_force_knn(base, KC)


def test_brute_force_knn_matches_jax(data):
    base, jknn = data
    knn = brute_force_knn(base, KC, block=300, device="cpu")
    assert knn.shape == (N, KC) and knn.dtype == np.int32
    assert not (knn == np.arange(N)[:, None]).any()       # self excluded
    overlap = np.mean([len(set(a) & set(b)) / KC for a, b in zip(knn, jknn)])
    assert overlap >= 0.99, overlap
    # nearest first
    d = ((base[knn] - base[:, None, :]) ** 2).sum(-1)
    assert (np.diff(d, axis=1) >= -1e-4).all()


@pytest.mark.parametrize("m,assume_unique", [(12, True), (16, False)])
def test_occlusion_prune_matches_jax(data, m, assume_unique):
    base, knn = data
    if not assume_unique:
        knn = knn.copy()
        knn[::7, 5] = knn[::7, 2]                 # duplicate candidates
        knn[::11, 9] = -1                         # padding
        knn[::13, 3] = np.arange(N)[::13]         # self candidates
    got = occlusion_prune(base, knn, m, block=256,
                          assume_unique=assume_unique, device="cpu")
    want = jprune.occlusion_prune(base, knn, m, block=256,
                                  assume_unique=assume_unique)
    assert got.shape == (N, m) and got.dtype == np.int32
    same = (got == want).all(axis=1).mean()
    assert same >= 0.99, same


def test_occlusion_prune_matches_python_reference(data):
    base, knn = data
    sub = knn[:60]
    got = occlusion_prune(base, np.concatenate(
        [sub, np.full((N - 60, KC), -1, np.int32)]), 10, device="cpu")[:60]
    want = jbuild.occlusion_prune_ref(base, np.concatenate(
        [sub, np.full((N - 60, KC), -1, np.int32)]), 10)[:60]
    assert (got == want).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("m_max", [24, 8])
def test_symmetrize_exact(data, m_max):
    base, knn = data
    pruned = jprune.occlusion_prune(base, knn, 12, block=256,
                                    assume_unique=True)
    pruned[::5, -3:] = -1
    np.testing.assert_array_equal(symmetrize(pruned, m_max),
                                  jprune.symmetrize(pruned, m_max))
    np.testing.assert_array_equal(symmetrize(pruned, m_max),
                                  jbuild.symmetrize_ref(pruned, m_max))


def test_medoid_exact(data):
    base, _ = data
    assert medoid(base) == jbuild.medoid(base)


def test_build_l2_graph_matches_jax(data):
    base, _ = data
    g = build_l2_graph(base, m=12, k_construction=KC, device="cpu")
    jg = jbuild.build_l2_graph(base, m=12, k_construction=KC)
    assert g.entry == jg.entry
    assert g.neighbors.shape == jg.neighbors.shape == (N, 24)
    assert (g.neighbors == jg.neighbors).all(axis=1).mean() >= 0.97
    assert abs(g.avg_degree - jg.avg_degree) < 0.1
    assert g.n == N and g.max_degree == 24


# ---------------------------------------------------------------------------
# NN-descent and the build above exact_threshold
# ---------------------------------------------------------------------------

def _recall(approx, exact):
    return sum(len(set(a) & set(e)) for a, e in zip(approx, exact)) \
        / exact.size


def test_reverse_sample_exact():
    fwd = np.random.default_rng(1).integers(0, 500, size=(500, 10)) \
        .astype(np.int32)
    want = jbuild._reverse_sample(fwd, 500, 7, np.random.default_rng(5))
    got = tbuild._reverse_sample(torch.as_tensor(fwd), 500, 7,
                                 np.random.default_rng(5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_dists_match_jax(data):
    base, jknn = data
    got = tbuild._row_dists(torch.as_tensor(base),
                            torch.as_tensor(jknn).long(), block=300)
    np.testing.assert_allclose(got.numpy(), jbuild._row_dists(base, jknn),
                               rtol=1e-5, atol=1e-6)


def test_join_block_matches_jax(data):
    """Current lists with repeats, candidates with -1 padding, repeats,
    self ids and ids already listed: >= 99.9% of rows identical,
    distances at rtol 1e-5."""
    import jax.numpy as jnp
    base, _ = data
    r = np.random.default_rng(3)
    k = 12
    nbrs = r.integers(0, N, size=(N, k)).astype(np.int32)
    nbrs[::9, 4] = nbrs[::9, 2]
    nbrs[nbrs == np.arange(N)[:, None]] = 0
    dists = jbuild._row_dists(base, nbrs)
    cand = r.integers(-1, N, size=(N, 80)).astype(np.int32)
    cand[:, 5] = cand[:, 3]
    cand[::3, 7] = nbrs[::3, 1]
    cand[::5, 11] = np.arange(N)[::5]
    rows = np.arange(N, dtype=np.int32)
    ji, jd = jbuild._join_block(jnp.asarray(base), jnp.asarray(rows),
                                jnp.asarray(nbrs), jnp.asarray(dists),
                                jnp.asarray(cand), k)
    ti, td = tbuild._join_block(torch.as_tensor(base),
                                torch.as_tensor(rows).long(),
                                torch.as_tensor(nbrs).long(),
                                torch.as_tensor(dists),
                                torch.as_tensor(cand).long(), k)
    same = (ti.numpy() == np.asarray(ji)).all(axis=1).mean()
    assert same >= 0.999, same
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    srt = np.sort(ti.numpy(), axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all()            # duplicate-free


def test_nn_descent_recall_matches_jax():
    base = np.random.default_rng(0).normal(size=(800, 16)).astype(np.float32)
    exact = jbuild.brute_force_knn(base, 10)
    want = _recall(jbuild.nn_descent(base, 10, n_iters=6), exact)
    stats = {}
    approx = nn_descent(base, 10, n_iters=6, device="cpu", stats=stats)
    assert approx.shape == (800, 10) and approx.dtype == np.int32
    got = _recall(approx, exact)
    assert got > 0.6 and abs(got - want) <= 0.01, (got, want)
    assert 1 <= len(stats["iters"]) <= 6 and stats["init_host_s"] >= 0
    assert all(it["changed"] >= 0 for it in stats["iters"])


def test_knn_recall_against_the_exact_lists():
    """knn_recall over sampled rows is the recall of the JAX exact kNN
    lists: 1 for the exact table itself, and on NN-descent's table the
    whole-table recall restricted to those rows."""
    base = np.random.default_rng(6).normal(size=(600, 12)).astype(np.float32)
    exact = jbuild.brute_force_knn(base, 20)
    rows = np.sort(np.random.default_rng(1).choice(600, 100, replace=False))
    assert knn_recall(base, exact, rows, device="cpu") == (1.0, 1.0)
    approx = nn_descent(base, 20, n_iters=2, device="cpu")
    rk, r10 = knn_recall(base, approx, rows, device="cpu")
    assert rk == _recall(approx[rows], exact[rows]) < 1.0
    assert r10 == _recall(approx[rows, :10], exact[rows, :10])


def test_nn_descent_k_smaller_than_sample():
    """k < sample: the forward sample has k columns, not ``sample``."""
    base = np.random.default_rng(4).normal(size=(300, 8)).astype(np.float32)
    approx = nn_descent(base, 6, n_iters=4, sample=10, device="cpu")
    assert approx.shape == (300, 6)
    exact = jbuild.brute_force_knn(base, 6)
    got = _recall(approx, exact)
    want = _recall(jbuild.nn_descent(base, 6, n_iters=4, sample=10), exact)
    assert got > 0.6 and abs(got - want) <= 0.01, (got, want)


@pytest.mark.parametrize("impl", ["blocked", "ref"])
def test_build_l2_graph_nn_descent_matches_jax(impl):
    """Above exact_threshold both builders take NN-descent from the same
    seed: >= 99% of rows identical, the same entry."""
    base = np.random.default_rng(8).normal(size=(400, 16)).astype(np.float32)
    stats = {}
    g = build_l2_graph(base, m=8, k_construction=20, exact_threshold=399,
                       seed=3, impl=impl, device="cpu", stats=stats)
    jg = jbuild.build_l2_graph(base, m=8, k_construction=20,
                               exact_threshold=399, seed=3, impl=impl)
    assert g.neighbors.shape == jg.neighbors.shape == (400, 16)
    assert (g.neighbors == jg.neighbors).all(axis=1).mean() >= 0.99
    assert g.entry == jg.entry
    assert stats["knn"].shape == (400, 20) and "nn_descent" in stats
    np.testing.assert_array_equal(
        stats["knn"], jbuild.nn_descent(base, 20, seed=3))


def test_seed_loops_exact(data):
    base, knn = data
    sub = np.concatenate([knn[:40], np.full((N - 40, KC), -1, np.int32)])
    np.testing.assert_array_equal(occlusion_prune_ref(base, sub, 10),
                                  jbuild.occlusion_prune_ref(base, sub, 10))
    pruned = jprune.occlusion_prune(base, knn, 12, block=256,
                                    assume_unique=True)
    np.testing.assert_array_equal(symmetrize_ref(pruned, 20),
                                  jbuild.symmetrize_ref(pruned, 20))


def test_graph_index_tombstones(data):
    base, knn = data
    g = GraphIndex(neighbors=knn[:, :8], entry=0, base=base)
    assert g.tombstones is None and g.n_alive == N
    flags = np.zeros(N, bool)
    flags[::10] = True
    g2 = GraphIndex(neighbors=knn[:, :8], entry=0, base=base,
                    tombstones=flags)
    jg = jbuild.GraphIndex(neighbors=knn[:, :8], entry=0, base=base,
                           tombstones=flags)
    assert g2.n_alive == jg.n_alive == N - 80


def test_build_l2_graph_rejects_unknown_impl(data):
    base, _ = data
    with pytest.raises(ValueError, match="unknown impl"):
        build_l2_graph(base, impl="fast", device="cpu")
