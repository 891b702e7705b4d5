"""The port's kernel wrappers against the JAX package's jnp references.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
run only on the card: ``test_kernels_match_plain_on_card`` there, and
``chip_smoke.py``). Inputs come from numpy seeds and go through both sides.

Tolerances: scores, values and gradients rtol 1e-5 / atol 1e-6 (fp32 sums
in another order); angle keys atol 5e-4, because acos turns a one-ulp
cosine difference near +-1 into ~3.5e-4 rad; masks must agree except where
a key lies within that tolerance of the alpha*theta band edge.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.deepfm_grad.ref import (  # noqa: E402
    deepfm_value_and_grad_ref as jax_grad_ref)
from repro.kernels.deepfm_score.ref import (  # noqa: E402
    deepfm_score_ref as jax_score_ref)
from repro.kernels.neighbor_rank.ref import (  # noqa: E402
    neighbor_rank_ref as jax_rank_ref)
from repro_torch.core.measures import params_from_jax  # noqa: E402
from repro_torch.kernels import (deepfm_score,  # noqa: E402
                                 deepfm_value_and_grad, launch_counts,
                                 neighbor_rank)

FM, DD = 8, 32
D = FM + DD
RTOL, ATOL = 1e-5, 1e-6
ANGLE_ATOL = 5e-4


def _mlp_numpy(seed, hidden=(64, 64)):
    rng = np.random.default_rng(seed)
    dims = [2 * DD, *hidden, 1]
    w = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
         for a, b in zip(dims[:-1], dims[1:])]
    b = [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in dims[1:]]
    return {"w": w, "b": b}


@pytest.fixture(scope="module")
def mlp():
    np_params = _mlp_numpy(0)
    return np_params, params_from_jax(np_params, device="cpu")


def _jax_weights(np_params):
    out = []
    for w, b in zip(np_params["w"], np_params["b"]):
        out += [jnp.asarray(w), jnp.asarray(b)]
    return out


def _rows(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("M", [256, 77, 1])
def test_deepfm_score_matches_jax_ref(mlp, M, shared):
    np_params, params = mlp
    cand = _rows(M, M, D)
    query = _rows(M + 1, D) if shared else _rows(M + 1, M, D)
    got = deepfm_score(torch.from_numpy(cand), torch.from_numpy(query),
                       params, FM)
    q_b = np.broadcast_to(query, cand.shape) if shared else query
    want = jax_score_ref(jnp.asarray(cand), jnp.asarray(q_b),
                         *_jax_weights(np_params), FM)
    assert got.shape == (M,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("M", [32, 7])
def test_deepfm_grad_matches_jax_ref(mlp, M, shared):
    np_params, params = mlp
    cand = _rows(10 + M, M, D)
    query = _rows(20 + M, D) if shared else _rows(20 + M, M, D)
    vals, grads = deepfm_value_and_grad(torch.from_numpy(cand),
                                        torch.from_numpy(query), params, FM)
    q_b = np.broadcast_to(query, cand.shape) if shared else query
    wv, wg = jax_grad_ref(jnp.asarray(cand), jnp.asarray(q_b),
                          *_jax_weights(np_params), FM)
    assert vals.shape == (M,) and grads.shape == (M, D)
    np.testing.assert_allclose(vals.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(wg), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(32, 48), (5, 37)])
@pytest.mark.parametrize("rank_by", ["angle", "projection"])
def test_neighbor_rank_matches_jax_ref(mlp, rank_by, shape):
    Q, B = shape
    alpha = 1.01
    rng = np.random.default_rng(Q * B)
    x = rng.normal(size=(Q, D)).astype(np.float32)
    g = rng.normal(size=(Q, D)).astype(np.float32)
    nv = (x[:, None, :] + 0.5 * rng.normal(size=(Q, B, D))).astype(
        np.float32)
    nv[1, 2] = x[1]                      # a zero diff
    valid = rng.random((Q, B)) < 0.7
    valid[0] = False                     # an all-invalid lane
    key, mask = neighbor_rank(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(nv), torch.from_numpy(valid),
                              alpha, rank_by)
    wk, wm = jax_rank_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(nv),
                          jnp.asarray(valid), alpha, rank_by)
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


def test_wrappers_reject_bad_arguments(mlp):
    _, params = mlp
    cand = torch.zeros((4, D))
    with pytest.raises(ValueError, match="exactly 3"):
        deepfm_score(cand, cand, {"w": params["w"][:2],
                                  "b": params["b"][:2]}, FM)
    with pytest.raises(TypeError, match="dtype"):
        deepfm_score(cand.double(), cand, params, FM)
    with pytest.raises(ValueError, match="shape"):
        deepfm_value_and_grad(cand, torch.zeros((3, D)), params, FM)
    with pytest.raises(ValueError, match="contiguous"):
        deepfm_score(torch.zeros((D, 4)).T, cand, params, FM)
    with pytest.raises(ValueError, match="rank_by"):
        neighbor_rank(cand, cand, torch.zeros((4, 2, D)),
                      torch.ones((4, 2), dtype=torch.bool), 1.01, "cosine")
    with pytest.raises(TypeError, match="dtype"):
        neighbor_rank(cand, cand, torch.zeros((4, 2, D)),
                      torch.ones((4, 2)), 1.01)


def test_cpu_calls_launch_no_kernel(mlp):
    """The launch counters move only where a CUDA kernel is launched; the
    CPU path runs the plain version."""
    _, params = mlp
    before = launch_counts()
    x = torch.from_numpy(_rows(5, 8, D))
    deepfm_score(x, x, params, FM)
    deepfm_value_and_grad(x, x[0].contiguous(), params, FM)
    neighbor_rank(x, x, x[:, None, :].repeat(1, 3, 1),
                  torch.ones((8, 3), dtype=torch.bool))
    assert launch_counts() == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card(mlp):
    """On a card: each kernel against its plain version at the main-path
    shapes (the same checks as chip_smoke.py's kernel phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core import make_family_measure
    dev = torch.device("cuda")
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  D, device=dev)
    report = chip_smoke.check_kernels(torch, dev, measure, FM)
    assert set(report) == {"deepfm_score", "deepfm_grad", "neighbor_rank"}
    assert set(report["deepfm_score"]["err_by_net"]) == \
        set(report["deepfm_grad"]["err_by_net"])
