"""The port's graph construction against the JAX package on the CPU.

``symmetrize`` and ``medoid`` are numpy and must match exactly. The
occlusion prune works in Gram form, where near-ties may flip between two
backends' rounding, so on the same kNN input at least 99% of its rows must
be identical; the kNN itself (blocked matmul + top-k) is held on overlap.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import build as jbuild  # noqa: E402
from repro.graph import prune as jprune  # noqa: E402
from repro_torch.graph import (brute_force_knn, build_l2_graph,  # noqa: E402
                               medoid, occlusion_prune, symmetrize)

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


def test_build_l2_graph_needs_exact_threshold(data):
    base, _ = data
    with pytest.raises(NotImplementedError, match="nn_descent"):
        build_l2_graph(base, exact_threshold=N - 1, device="cpu")
