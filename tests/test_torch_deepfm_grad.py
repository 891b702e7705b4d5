"""The DeepFM grad pair's body on the card (``csrc/mlp_grad.cuh`` over its
DeepFM input: the MLP grad pair's cluster body) against the JAX package on
the CPU.

The CUDA kernels run only on the card (``chip_smoke.py``,
``test_deepfm_grad_nets_match_plain_on_card``). Here:

- ``deepfm_grad_plan`` mirrors the body's launch plan for the DeepFM net:
  the serving widths' cluster of 8 with 4 deep gradient columns per CTA,
  and no DeepFM net refused that the score kernels' one-warp-per-row
  layout takes;
- a plain emulation of the body's order of summation (hidden units and
  gradient columns split over the plan's CTAs, the K split, the value's
  lane order and the FM term added after the top layer's dot and bias)
  keeps rtol 1e-5 / atol 1e-6 against the JAX ``deepfm_value_and_grad``
  through its Pallas kernel in interpret mode and through its jnp
  reference, at every ``DEEPFM_NETS`` net, and against the JAX fused jnp
  reference over the JAX store's bfloat16 and int8 payloads (the fused
  Pallas kernel cannot run on this jax: ``pltpu`` has no
  ``TPUMemorySpace``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as jcorpus  # noqa: E402
from repro.kernels.deepfm_grad import (  # noqa: E402
    deepfm_value_and_grad as j_value_and_grad)
from repro.kernels.deepfm_grad_fused import (  # noqa: E402
    deepfm_grad_fused as j_grad_fused)
from repro_torch.core import params_from_jax, store_from_arrays  # noqa: E402
from repro_torch.kernels.deepfm_grad.ops import (  # noqa: E402
    deepfm_grad_plan)
from repro_torch.kernels.mlp_grad.ops import (GRAD_SMEM_CAP,  # noqa: E402
                                              GRAD_TILE)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from chip_smoke import DEEPFM_NETS  # noqa: E402
from test_torch_mlp import _align4, _dense_slices  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
NET_IDS = [f"D{d}-fm{f}-{a}x{b}" for d, f, a, b in DEEPFM_NETS]


def _np_deepfm_mlp(seed, dd, h0, h1):
    """The measure MLP's three layers, non-zero biases."""
    rng = np.random.default_rng(seed)
    dims = [2 * dd, h0, h1, 1]
    w = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
         for a, b in zip(dims[:-1], dims[1:])]
    b = [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in dims[1:]]
    return {"w": w, "b": b}


def _jax(np_params):
    return {"w": [jnp.asarray(a) for a in np_params["w"]],
            "b": [jnp.asarray(a) for a in np_params["b"]]}


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, **kw)


def _score_layout_bytes(D, fm, h0, h1):
    """Shared memory of the block of the one-warp-per-row DeepFM score
    kernels that the cluster body replaced (their ``deepfm_smem_bytes``):
    the network staged in rows padded to cols + 1 and eight warps' scratch
    (deep input, z0, z1, the row). The rule the cluster plans are held
    to."""
    k0 = 2 * (D - fm)
    weights = k0 * (h0 + 1) + h0 + h0 * (h1 + 1) + h1 + h1 + 1
    return 4 * (weights + 8 * (k0 + h0 + h1 + D))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_deepfm_grad_plan():
    """The serving net (D 40, fm 8, 64x64) runs on a cluster of 8 CTAs of
    8 units per hidden layer and 4 of the 32 deep gradient columns, the
    tile holding x[:fm] and q[:fm] beside the MLP plan's buffers; every
    DEEPFM_NETS net fits; and no net is refused that the score kernels'
    layout takes (nor, so, the larger layout of the one-warp-per-row grad
    kernel this body replaced, which had two more vectors per warp)."""
    plan = deepfm_grad_plan(40, 8, 64, 64)
    assert plan == {
        "n": 8, "slices": [8, 8], "ks": 4,
        "smem_bytes": 4 * (32 + 64 * 8 + 8 + 4 * 64 + 64 * 8 + 8 + 8 * 64
                           + 64 + 4 + GRAD_TILE * (64 + 2 * 64 + 2 * 64)
                           + GRAD_TILE + 2 * GRAD_TILE * 8)}
    for D, fm, h0, h1 in DEEPFM_NETS:
        p = deepfm_grad_plan(D, fm, h0, h1)
        assert p is not None and p["smem_bytes"] <= GRAD_SMEM_CAP
        assert 2 <= p["n"] <= 8
        assert p["ks"] == -(-(D - fm) // p["n"])
    rng = np.random.default_rng(18)
    taken = 0
    for _ in range(20_000):
        D = int(rng.integers(2, 2500))
        fm = int(rng.integers(1, D))
        h0, h1 = (int(h) for h in rng.integers(1, 700, size=2))
        if _score_layout_bytes(D, fm, h0, h1) <= GRAD_SMEM_CAP:
            taken += 1
            assert deepfm_grad_plan(D, fm, h0, h1) is not None, \
                (D, fm, h0, h1)
    assert taken > 1000


# ---------------------------------------------------------------------------
# the body's order of summation over the DeepFM input
# ---------------------------------------------------------------------------

def _lanes8(a, b, width):
    """sum_k a[:, k] b[..., k] as 8 lanes sum it: lane l the columns of
    the ``width``-wide chunks l, l + 8, ... in order (16-byte chunks for
    the top layer's dot, single columns for the FM term), the lanes' sums
    added as the xor shuffles 4, 2, 1 add them."""
    lanes = [torch.zeros(a.shape[0]) for _ in range(8)]
    for k in range(a.shape[1]):
        lane = (k // width) % 8
        lanes[lane] = lanes[lane] + a[:, k] * b[..., k]
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + half] for i in range(half)]
    return lanes[0]


def _emulate_deepfm_cluster_grad(x, q, Ws, bs, fm):
    """Value and df/dx as csrc/mlp_grad.cuh sums them over DeepFMInput, in
    float32: the deep input [q[fm:] | x[fm:]]; each hidden layer's units
    and the deep gradient columns split over the cluster as
    ``deepfm_grad_plan`` splits them, every slice a ``_dense_slices``;
    the top layer's dot by 8 lanes over 16-byte columns, plus the bias,
    then the FM term (8 lanes over single columns); the gradient's FM
    columns g_logit * q[:fm], the rest from W0's x rows [dd, 2 dd)."""
    D = x.shape[1]
    dd = D - fm
    h0, h1 = Ws[0].shape[1], Ws[1].shape[1]
    plan = deepfm_grad_plan(D, fm, h0, h1)
    n, s, ks = plan["n"], plan["slices"], plan["ks"]
    dims = [2 * dd, h0, h1, 1]
    acts = [torch.cat([q[:, fm:], x[:, fm:]], dim=1)]
    for i in range(2):
        acts.append(torch.relu(_dense_slices(acts[-1], Ws[i], bs[i], s[i],
                                             dims[i + 1], n)))
    top, wl = acts[-1], Ws[-1][:, 0]
    H4 = _align4(h1)
    top_p = torch.nn.functional.pad(top, (0, H4 - h1))
    wl_p = torch.nn.functional.pad(wl, (0, H4 - h1))
    logit = (_lanes8(top_p, wl_p, 4) + bs[-1][0]) + \
        _lanes8(x[:, :fm], q[:, :fm], 1)
    val = 1.0 / (1.0 + torch.exp(-logit))
    fp = (val * (1.0 - val))[:, None]
    g = torch.where(top > 0, fp * wl[None, :], torch.zeros(()))
    g = _dense_slices(g, Ws[1].T, None, s[0], h0, n)
    g = torch.where(acts[1] > 0, g, torch.zeros(()))
    gx = _dense_slices(g, Ws[0][dd:].T, None, ks, dd, n)
    return val, torch.cat([fp * q[:, :fm], gx], dim=1)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("net_spec", DEEPFM_NETS, ids=NET_IDS)
def test_deepfm_grad_cluster_order_matches_jax(net_spec, shared):
    """The body's order of summation over the DeepFM input keeps the
    card's 1e-5 / 1e-6 against the JAX Pallas kernel in interpret mode and
    the jnp reference, at every DEEPFM_NETS net, both query forms."""
    D, fm, h0, h1 = net_spec
    np_params = _np_deepfm_mlp(D + h0 + h1, D - fm, h0, h1)
    tp = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(D + fm)
    M = 13
    cand = rng.normal(size=(M, D)).astype(np.float32)
    query = rng.normal(size=(D,) if shared else (M, D)).astype(np.float32)
    q_rows = np.broadcast_to(query, (M, D)).copy()
    vals, grads = _emulate_deepfm_cluster_grad(
        torch.from_numpy(cand), torch.from_numpy(q_rows), tp["w"], tp["b"],
        fm)
    assert vals.dtype == grads.dtype == torch.float32
    assert vals.shape == (M,) and grads.shape == (M, D)
    for use_pallas in (True, False):
        wv, wg = j_value_and_grad(jnp.asarray(cand), jnp.asarray(query),
                                  _jax(np_params), fm, use_pallas=use_pallas,
                                  interpret=True)
        _close(vals.numpy(), wv, err_msg=f"use_pallas={use_pallas}")
        _close(grads.numpy(), wg, err_msg=f"use_pallas={use_pallas}")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("net_spec", [DEEPFM_NETS[0], DEEPFM_NETS[3]],
                         ids=[NET_IDS[0], NET_IDS[3]])
def test_deepfm_grad_fused_cluster_order_matches_jax(net_spec, dtype,
                                                     shared):
    """The fused form: the same body over the rows the kernel gathers and
    dequantizes (the port's ``CorpusStore.take`` of the JAX store's own
    payload, -1 ids clamped to row 0) keeps 1e-5 / 1e-6 against the JAX
    fused jnp reference, and the rows equal its ``x`` exactly."""
    D, fm, h0, h1 = net_spec
    np_params = _np_deepfm_mlp(D * 3 + h1, D - fm, h0, h1)
    tp = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(D + h0)
    N, Q = 300, 33
    base = rng.normal(size=(N, D)).astype(np.float32)
    js = jcorpus.make_corpus_store(jnp.asarray(base), dtype)
    ts = store_from_arrays(
        np.asarray(js.data), None if js.scales is None
        else np.asarray(js.scales), js.dtype, None, device="cpu")
    idx = rng.integers(0, N, size=Q)
    idx[[2, 20]] = -1
    query = rng.normal(size=(D,) if shared else (Q, D)).astype(np.float32)
    q_rows = np.broadcast_to(query, (Q, D)).copy()
    x = ts.take(torch.from_numpy(idx).clamp_min(0))
    vals, grads = _emulate_deepfm_cluster_grad(
        x, torch.from_numpy(q_rows), tp["w"], tp["b"], fm)
    wv, wg, wx = j_grad_fused(js, jnp.asarray(idx.astype(np.int32)),
                              jnp.asarray(q_rows), _jax(np_params), fm,
                              use_pallas=False)
    np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
    _close(vals.numpy(), wv)
    _close(grads.numpy(), wg)


@pytest.mark.cuda
def test_deepfm_grad_nets_match_plain_on_card():
    """On a card: both DeepFM grad kernels against their plain versions at
    every DEEPFM_NETS net, the Q of GRAD_QS, both query forms and every
    residency, x equal to CorpusStore.take and the fused kernel bit for
    bit against the pre-gathered one at float32 (chip_smoke.py's checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke
    from repro_torch.core import make_family_measure
    dev = torch.device("cuda")
    m = make_family_measure("deepfm", torch.Generator().manual_seed(0), 40,
                            device=dev)
    for fused in (False, True):
        worst, by_net = chip_smoke.check_deepfm_grad_nets(
            torch, dev, m.params["mlp"], m.meta[1], fused)
        assert len(by_net) == len(DEEPFM_NETS)
