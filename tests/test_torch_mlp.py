"""The port's MLP measure family (``mlp_measure``, the ``mlp`` bundle, the
``mlp_*`` kernels' wrappers, ``--measure mlp``) against the JAX package on
the CPU.

- The pre-gathered wrappers (kernels 7 and 9) are held against the JAX
  functions both through the Pallas kernels in interpret mode
  (``use_pallas=True, interpret=True``) and through the jnp references
  (``use_pallas=False``); the fused wrappers (8 and 10) against the JAX
  fused jnp references (the fused Pallas interpret path does not run on
  this jax: ``pltpu`` has no ``TPUMemorySpace``), over the JAX store's own
  payload at float32, bfloat16 and int8. Scores, values and gradients at
  rtol 1e-5 / atol 1e-6 (fp32 sums in another order), the dequantized
  frontier rows ``x`` exactly.
- Inside the port the fused float32 kernels and search equal the unfused
  ones exactly (ids, scores, counters).
- Whole searches with a JAX ``mlp_measure`` carried across by
  ``params_from_jax`` hold the JAX engine's recall@10 within 0.01.
- The kernels' cluster body (``csrc/mlp_grad.cuh``): its launch plans
  (grad and score) mirrored, and its orders of summation emulated in
  float32 and held against the JAX kernels at every ``MLP_NETS`` net.

On the CPU every wrapper runs its plain version; the CUDA kernels are held
against those on the card (``test_mlp_kernels_match_plain_on_card`` and
``chip_smoke.py``).
"""
import dataclasses
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
                        mlp_measure as j_mlp_measure,
                        search_measure as j_search_measure)
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro.kernels.mlp_grad import (  # noqa: E402
    mlp_grad_fused as j_grad_fused, mlp_value_and_grad as j_value_and_grad)
from repro.kernels.mlp_score import (  # noqa: E402
    mlp_score as j_score, mlp_score_fused as j_score_fused)
from repro_torch.core import (EngineOptions, SearchConfig,  # noqa: E402
                              build_engine, make_corpus_store,
                              make_family_measure,
                              mlp_measure, params_from_jax, recall,
                              search_measure, store_from_arrays)
from repro_torch.kernels import (launch_counts, mlp_grad_fused,  # noqa: E402
                                 mlp_score, mlp_score_fused,
                                 mlp_value_and_grad)
from repro_torch.kernels.mlp_grad.ops import (GRAD_THREADS,  # noqa: E402
                                              GRAD_TILE, SCORE_CLUSTER,
                                              SCORE_TILE, mlp_grad_plan,
                                              mlp_score_plan)
from repro_torch.kernels.mlp_score.ops import (MAX_LAYERS,  # noqa: E402
                                               mlp_smem_bytes)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import MLP_NETS  # noqa: E402

DX = 40
DTYPES = ("float32", "bfloat16", "int8")
HIDDEN = ((16,), (32, 32), (64, 64))
RTOL, ATOL = 1e-5, 1e-6


def _np_mlp(seed, d_in, hidden):
    """Random layers with non-zero biases (``init_mlp`` zeroes them)."""
    rng = np.random.default_rng(seed)
    dims = [d_in, *hidden, 1]
    w = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
         for a, b in zip(dims[:-1], dims[1:])]
    b = [(0.1 * rng.normal(size=(n,))).astype(np.float32) for n in dims[1:]]
    return {"w": w, "b": b}


def _both(np_params):
    """(the JAX pytree, the port's params) over the same numpy arrays."""
    jp = {"w": [jnp.asarray(a) for a in np_params["w"]],
          "b": [jnp.asarray(a) for a in np_params["b"]]}
    return jp, params_from_jax(np_params, device="cpu")


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, **kw)


# ---------------------------------------------------------------------------
# kernels 7 and 9: pre-gathered, against the Pallas kernels (interpret) and
# the jnp references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 7, 77, 256])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("hidden", HIDDEN, ids=str)
def test_mlp_score_matches_jax(hidden, shared, M):
    jp, tp = _both(_np_mlp(len(hidden) * 10 + hidden[0], 2 * DX, hidden))
    rng = np.random.default_rng(M)
    cand = rng.normal(size=(M, DX)).astype(np.float32)
    query = rng.normal(size=(DX,) if shared else (M, DX)).astype(np.float32)
    got = mlp_score(torch.from_numpy(cand), torch.from_numpy(query), tp)
    assert got.shape == (M,) and got.dtype == torch.float32
    for use_pallas in (True, False):
        want = j_score(jnp.asarray(cand), jnp.asarray(query), jp,
                       use_pallas=use_pallas, interpret=True)
        _close(got.numpy(), want, err_msg=f"use_pallas={use_pallas}")


@pytest.mark.parametrize("M", [1, 7, 77, 256])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("hidden", HIDDEN, ids=str)
def test_mlp_grad_matches_jax(hidden, shared, M):
    jp, tp = _both(_np_mlp(len(hidden) * 10 + hidden[0], 2 * DX, hidden))
    rng = np.random.default_rng(M + 1)
    cand = rng.normal(size=(M, DX)).astype(np.float32)
    query = rng.normal(size=(DX,) if shared else (M, DX)).astype(np.float32)
    vals, grads = mlp_value_and_grad(torch.from_numpy(cand),
                                     torch.from_numpy(query), tp)
    assert vals.shape == (M,) and grads.shape == (M, DX)
    assert grads.is_contiguous()
    for use_pallas in (True, False):
        wv, wg = j_value_and_grad(jnp.asarray(cand), jnp.asarray(query), jp,
                                  use_pallas=use_pallas, interpret=True)
        _close(vals.numpy(), wv, err_msg=f"use_pallas={use_pallas}")
        _close(grads.numpy(), wg, err_msg=f"use_pallas={use_pallas}")


@pytest.mark.parametrize("hidden", [(), (48, 32, 24)], ids=str)
def test_mlp_kernels_take_dq_other_than_dx(hidden):
    """Dq != Dx, a depth-1 network (no hidden layer) and a 4-layer one."""
    dq = 24
    jp, tp = _both(_np_mlp(5, DX + dq, hidden))
    rng = np.random.default_rng(6)
    cand = rng.normal(size=(33, DX)).astype(np.float32)
    for qshape in ((33, dq), (dq,)):
        query = rng.normal(size=qshape).astype(np.float32)
        c, q = torch.from_numpy(cand), torch.from_numpy(query)
        _close(mlp_score(c, q, tp).numpy(),
               j_score(jnp.asarray(cand), jnp.asarray(query), jp,
                       use_pallas=False))
        vals, grads = mlp_value_and_grad(c, q, tp)
        wv, wg = j_value_and_grad(jnp.asarray(cand), jnp.asarray(query), jp,
                                  use_pallas=False)
        assert grads.shape == (33, DX)
        _close(vals.numpy(), wv)
        _close(grads.numpy(), wg)


# ---------------------------------------------------------------------------
# kernels 8 and 10: index-fused, against the JAX fused jnp references
# ---------------------------------------------------------------------------

def _port_store(js):
    """The port's store over exactly the JAX store's payload."""
    return store_from_arrays(
        np.asarray(js.data), None if js.scales is None
        else np.asarray(js.scales), js.dtype, device="cpu")


@pytest.fixture(scope="module")
def stores():
    base = np.random.default_rng(7).normal(size=(500, DX)).astype(np.float32)
    out = {}
    for dt in DTYPES:
        js = jcorpus.make_corpus_store(jnp.asarray(base), dt)
        out[dt] = (js, _port_store(js))
    return out


@pytest.fixture(scope="module")
def net():
    return _both(_np_mlp(8, 2 * DX, (64, 64)))


def _prefix_mask(rng, lanes, C):
    """The adaptive engine's mask: a per-lane prefix of its C candidates;
    lane 0 masked entirely, lane 1 not at all."""
    n = rng.integers(0, C + 1, size=lanes)
    n[0], n[1] = 0, C
    return (np.arange(C)[None, :] < n[:, None]).reshape(-1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_score_fused_matches_jax(net, stores, dtype, shared, masked):
    jp, tp = net
    js, ts = stores[dtype]
    M = 96                                      # 12 lanes of C = 8
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 500, size=M)
    idx[[3, 40, 41]] = -1                       # padding, clamped to row 0
    query = rng.normal(size=(DX,) if shared else (M, DX)).astype(np.float32)
    mask = _prefix_mask(rng, 12, 8) if masked else None
    got = mlp_score_fused(
        ts, torch.from_numpy(idx), torch.from_numpy(query), tp,
        mask=None if mask is None else torch.from_numpy(mask))
    want = np.asarray(j_score_fused(
        js, jnp.asarray(idx.astype(np.int32)), jnp.asarray(query), jp,
        use_pallas=False, mask=None if mask is None else jnp.asarray(mask)))
    assert got.shape == (M,) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    if masked:
        assert np.isneginf(got[~mask]).all() and np.isfinite(got[mask]).all()
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_grad_fused_matches_jax(net, stores, dtype, shared):
    jp, tp = net
    js, ts = stores[dtype]
    Q = 33
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 500, size=Q)
    idx[[5, 6]] = -1
    query = rng.normal(size=(DX,) if shared else (Q, DX)).astype(np.float32)
    vals, grads, x = mlp_grad_fused(ts, torch.from_numpy(idx),
                                    torch.from_numpy(query), tp)
    q_b = np.broadcast_to(query, (Q, DX)) if shared else query
    wv, wg, wx = j_grad_fused(js, jnp.asarray(idx.astype(np.int32)),
                              jnp.asarray(q_b), jp, use_pallas=False)
    assert vals.shape == (Q,) and grads.shape == x.shape == (Q, DX)
    np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(
        x.numpy(), ts.take(torch.from_numpy(idx).clamp_min(0)).numpy())
    _close(vals.numpy(), wv)
    _close(grads.numpy(), wg)


def test_mlp_fused_kernels_equal_unfused_at_f32(net, stores):
    """At float32 residency the fused wrappers return the unfused ones'
    values on the gathered rows, bit for bit (the kernels share one body
    per pair; the plain versions gather, then run the unfused one)."""
    _, tp = net
    _, ts = stores["float32"]
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(-1, 500, size=64))
    q = torch.from_numpy(rng.normal(size=(64, DX)).astype(np.float32))
    mask = torch.from_numpy(_prefix_mask(rng, 8, 8))
    rows = ts.take(idx.clamp_min(0))
    want = mlp_score(rows, q, tp).masked_fill(~mask, float("-inf"))
    assert torch.equal(mlp_score_fused(ts, idx, q, tp, mask=mask), want)
    v, g, x = mlp_grad_fused(ts, idx, q, tp)
    uv, ug = mlp_value_and_grad(rows, q, tp)
    assert torch.equal(x, rows) and torch.equal(v, uv) and torch.equal(g, ug)


# ---------------------------------------------------------------------------
# argument checks, shared-memory sizing, launch counts
# ---------------------------------------------------------------------------

def test_mlp_wrappers_reject_bad_arguments(stores):
    _, ts = stores["int8"]
    c, q = torch.zeros((4, DX)), torch.zeros((4, DX))
    deep = params_from_jax(_np_mlp(0, 2 * DX, (8,) * MAX_LAYERS),
                           device="cpu")
    with pytest.raises(ValueError, match="measure_impl='vmap'"):
        mlp_score(c, q, deep)
    with pytest.raises(ValueError, match="measure_impl='vmap'"):
        mlp_grad_fused(ts, torch.arange(4), q, deep)
    wide = params_from_jax(_np_mlp(0, 2 * DX, (8,)), device="cpu")
    wide["w"][-1] = torch.zeros((8, 2))
    wide["b"][-1] = torch.zeros((2,))
    with pytest.raises(ValueError, match="width 1"):
        mlp_value_and_grad(c, q, wide)
    tp = params_from_jax(_np_mlp(0, 2 * DX, (8,)), device="cpu")
    with pytest.raises(ValueError, match="w0: shape"):     # Dx + Dq != 80
        mlp_score(c, torch.zeros((4, DX + 1)), tp)
    with pytest.raises(ValueError, match="query: shape"):
        mlp_score(c, torch.zeros((3, DX)), tp)
    with pytest.raises(TypeError, match="dtype"):
        mlp_score(c.double(), q, tp)
    with pytest.raises(TypeError, match="dtype"):
        mlp_score_fused(ts, torch.arange(4).int(), q, tp)
    with pytest.raises(ValueError, match="shape"):
        mlp_score_fused(ts, torch.arange(4), q, tp,
                        mask=torch.ones(3, dtype=torch.bool))
    tp["b"][0] = tp["b"][0].double()
    with pytest.raises(TypeError, match="b0: dtype"):
        mlp_score(c, q, tp)


def test_mlp_smem_bytes():
    """The staged network plus eight warps' scratch, as ``mlp_net`` in
    csrc/mlp.cuh lays it out: the serving width (80 -> 64 -> 64 -> 1)
    needs opt-in shared memory above 48 KB, ``hidden=(128, 128)`` about
    129 KB, both under the H100's 227 KB."""
    w64 = 80 * 65 + 64 + 64 * 65 + 64 + 64 + 1
    assert mlp_smem_bytes([80, 64, 64, 1], DX) == \
        4 * (w64 + 8 * (80 + 64 + 64 + 2 * 64 + DX))
    assert 48 * 1024 < mlp_smem_bytes([80, 64, 64, 1], DX) < 52_000
    assert 128_000 < mlp_smem_bytes([80, 128, 128, 1], DX) < 232_448
    assert mlp_smem_bytes([80, 1], DX) == 4 * (80 + 1 + 8 * (80 + DX))


# ---------------------------------------------------------------------------
# the grad pair's cluster body (csrc/mlp_grad.cuh): its launch plan, and its
# order of summation emulated and held against the JAX kernel
# ---------------------------------------------------------------------------

def test_mlp_grad_plan():
    """``mlp_grad_plan`` mirrors the plan of csrc/mlp_grad.cuh: a cluster
    of 8 CTAs of 8 units each at the serving width (the widths the kernel
    is compiled for), every MLP_NETS net within a CTA's 227 KB, and no
    network refused that the score kernels' layout (``net_args``) takes."""
    assert mlp_grad_plan([80, 64, 64, 1], DX) == {
        "n": 8, "slices": [8, 8], "ks": 5,
        "smem_bytes": 4 * (32 + 80 * 8 + 8 + 8 * 64 + 64 * 8 + 8 + 8 * 64
                           + 64 + 4 + GRAD_TILE * (80 + 2 * 64 + 2 * 64)
                           + GRAD_TILE)}
    assert mlp_grad_plan([80, 1], DX)["n"] == 1
    for label, dx, dq, hidden in MLP_NETS:
        plan = mlp_grad_plan([dx + dq, *hidden, 1], dx)
        assert plan is not None and plan["smem_bytes"] <= 232_448, label
        assert 2 <= plan["n"] <= 8 if hidden else plan["n"] == 1, label
    rng = np.random.default_rng(17)
    taken = 0
    for _ in range(20_000):
        L = int(rng.integers(1, MAX_LAYERS + 1))
        d_in = int(rng.integers(1, 3000))
        dx = int(rng.integers(1, d_in + 1))
        dims = [d_in, *rng.integers(1, 600, size=L - 1).tolist(), 1]
        if mlp_smem_bytes(dims, dx) <= 232_448:
            taken += 1
            assert mlp_grad_plan(dims, dx) is not None, (dims, dx)
    assert taken > 1000


def _align4(v):
    return (v + 3) & ~3


def _dense_slices(inp, W, bias, s, units, n, tile=GRAD_TILE):
    """out = inp @ W (+ bias), unit slice by unit slice (CTA c owns units
    [c * s, (c + 1) * s)), each in the cluster kernel's order at ``tile``
    rows per cluster: K in chunks of 4 (zero pads), chunk g, g + KS, ...
    summed by lane g (KS from the tile's rows by the slice's groups of 4
    units), the KS lanes' sums added as the xor shuffles add them, then the
    bias."""
    K = inp.shape[1]
    K4 = _align4(K)
    inp = torch.nn.functional.pad(inp, (0, K4 - K))
    W = torch.nn.functional.pad(W, (0, 0, 0, K4 - K))
    outs = []
    for c in range(n):
        lo, w = c * s, max(0, min(s, units - c * s))
        if w == 0:
            continue
        tiles = (w + 3) // 4 * tile
        lks = 0
        while lks < 5 and tiles << (lks + 1) <= GRAD_THREADS:
            lks += 1
        KS = 1 << lks
        parts = []
        for g in range(KS):
            acc = torch.zeros(inp.shape[0], w)
            for cc in range(g, K4 // 4, KS):
                for k in range(4 * cc, 4 * cc + 4):
                    acc = acc + inp[:, k:k + 1] * W[k, lo:lo + w]
            parts.append(acc)
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[i] + parts[i + half] for i in range(half)]
        outs.append(parts[0] if bias is None else parts[0] + bias[lo:lo + w])
    return torch.cat(outs, dim=1)


def _emulate_forward(x, q, Ws, bs, plan, tile):
    """The forward and value as csrc/mlp_grad.cuh sums them, in float32:
    each hidden layer's units split over the cluster as ``plan`` splits
    them, every slice a ``_dense_slices`` at ``tile`` rows, the value's dot
    over 16-byte columns l, l + 8, ... by 8 lanes added by xor shuffles.
    Returns (every layer's activations, the value)."""
    dims = [Ws[0].shape[0]] + [w.shape[1] for w in Ws]
    L = len(Ws)
    n, s = plan["n"], plan["slices"]
    acts = [torch.cat([x, q], dim=1)]
    for i in range(L - 1):
        acts.append(torch.relu(_dense_slices(acts[-1], Ws[i], bs[i], s[i],
                                             dims[i + 1], n, tile)))
    top, wl = acts[-1], Ws[-1][:, 0]
    H4 = _align4(top.shape[1])
    top_p = torch.nn.functional.pad(top, (0, H4 - top.shape[1]))
    wl_p = torch.nn.functional.pad(wl, (0, H4 - wl.shape[0]))
    lanes = []
    for lane in range(8):
        p = torch.zeros(x.shape[0])
        for cc in range(lane, H4 // 4, 8):
            for k in range(4 * cc, 4 * cc + 4):
                p = p + top_p[:, k] * wl_p[k]
        lanes.append(p)
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + half] for i in range(half)]
    return acts, 1.0 / (1.0 + torch.exp(-(lanes[0] + bs[-1][0])))


def _emulate_cluster_grad(x, q, Ws, bs):
    """Value and df/dx as csrc/mlp_grad.cuh sums them, in float32: the
    forward of ``_emulate_forward`` at the grad's tile, the gradient
    columns split over the cluster as ``mlp_grad_plan`` splits them, the
    backward's products against W^T each a ``_dense_slices``."""
    dims = [Ws[0].shape[0]] + [w.shape[1] for w in Ws]
    L, dx = len(Ws), x.shape[1]
    plan = mlp_grad_plan(dims, dx)
    n, s, ks = plan["n"], plan["slices"], plan["ks"]
    acts, val = _emulate_forward(x, q, Ws, bs, plan, GRAD_TILE)
    top, wl = acts[-1], Ws[-1][:, 0]
    fp = (val * (1.0 - val))[:, None]
    if L == 1:
        return val, fp * wl[None, :dx]
    g = torch.where(top > 0, fp * wl[None, :], torch.zeros(()))
    for i in range(L - 2, 0, -1):
        g = _dense_slices(g, Ws[i].T, None, s[i - 1], dims[i], n)
        g = torch.where(acts[i] > 0, g, torch.zeros(()))
    return val, _dense_slices(g, Ws[0][:dx].T, None, ks, dx, n)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("net_spec", MLP_NETS, ids=[m[0] for m in MLP_NETS])
def test_mlp_grad_cluster_order_matches_jax(net_spec, shared):
    """The cluster kernel's order of summation (column slices over the
    plan's n CTAs, partial sums in lane order, the K split) keeps the
    card's 1e-5 / 1e-6 against the JAX Pallas kernel in interpret mode and
    the jnp reference, at every MLP_NETS net."""
    label, dx, dq, hidden = net_spec
    jp, tp = _both(_np_mlp(len(hidden) + dq, dx + dq, hidden))
    rng = np.random.default_rng(dq + len(hidden))
    M = 13
    cand = rng.normal(size=(M, dx)).astype(np.float32)
    query = rng.normal(size=(dq,) if shared else (M, dq)).astype(np.float32)
    q_rows = np.broadcast_to(query, (M, dq)).copy()
    vals, grads = _emulate_cluster_grad(torch.from_numpy(cand),
                                        torch.from_numpy(q_rows),
                                        tp["w"], tp["b"])
    assert vals.dtype == grads.dtype == torch.float32
    assert grads.shape == (M, dx)
    for use_pallas in (True, False):
        wv, wg = j_value_and_grad(jnp.asarray(cand), jnp.asarray(query), jp,
                                  use_pallas=use_pallas, interpret=True)
        _close(vals.numpy(), wv, err_msg=f"{label} use_pallas={use_pallas}")
        _close(grads.numpy(), wg, err_msg=f"{label} use_pallas={use_pallas}")


def test_mlp_score_plan():
    """``mlp_score_plan`` mirrors the score's plan in csrc/mlp_grad.cuh
    (``with_score_copy``; chip_smoke.py holds it against the C plan on the
    card): SCORE_TILE rows on up to SCORE_CLUSTER CTAs, 16 units each at
    the serving net, without the backward's row slices, cotangents and f'
    but with rows at odd multiples of 4 floats, dense4's partial sums and
    CTA 0's partial dots (21,008 bytes per CTA); every MLP_NETS net within
    a CTA's 227 KB, and no network refused that the admission rule
    (``net_args``) takes."""
    assert mlp_score_plan([80, 64, 64, 1], DX) == {
        "n": SCORE_CLUSTER, "slices": [16, 16], "ks": 10, "rows": SCORE_TILE,
        "smem_bytes": 4 * (32 + 80 * 16 + 16 + 64 * 16 + 16 + 64 + 4
                           + SCORE_TILE * (84 + 68 + 68) + 4 * GRAD_THREADS
                           + SCORE_CLUSTER * SCORE_TILE)}
    assert mlp_score_plan([80, 1], DX) == {
        "n": 1, "slices": [], "ks": DX, "rows": SCORE_TILE,
        "smem_bytes": 4 * (32 + 80 + 4 + SCORE_TILE * 84 + SCORE_TILE)}
    for label, dx, dq, hidden in MLP_NETS:
        dims = [dx + dq, *hidden, 1]
        plan = mlp_score_plan(dims, dx)
        assert plan is not None and plan["smem_bytes"] <= 232_448, label
        assert plan["rows"] == SCORE_TILE and plan["n"] <= SCORE_CLUSTER, \
            label
    rng = np.random.default_rng(17)
    taken = 0
    for _ in range(20_000):
        L = int(rng.integers(1, MAX_LAYERS + 1))
        d_in = int(rng.integers(1, 3000))
        dx = int(rng.integers(1, d_in + 1))
        dims = [d_in, *rng.integers(1, 600, size=L - 1).tolist(), 1]
        if mlp_smem_bytes(dims, dx) <= 232_448:
            taken += 1
            assert mlp_score_plan(dims, dx) is not None, (dims, dx)
    assert taken > 1000


def _emulate_cluster_score(x, q, Ws, bs):
    """The score as csrc/mlp_grad.cuh's score kernel sums it, in float32:
    the hidden layers of ``_emulate_forward`` over ``mlp_score_plan``'s
    slices at its tile, then each CTA's partial dot of its units of the
    top layer (the whole input without a hidden layer) with the last
    layer's weights, unit by unit, the n partials added in rank order, the
    bias last."""
    dims = [Ws[0].shape[0]] + [w.shape[1] for w in Ws]
    plan = mlp_score_plan(dims, x.shape[1])
    top = _emulate_forward(x, q, Ws, bs, plan, plan["rows"])[0][-1]
    wl, n, H = Ws[-1][:, 0], plan["n"], dims[-2]
    s = plan["slices"][-1] if len(Ws) > 1 else H
    logit = torch.zeros(x.shape[0])
    for c in range(n):
        p = torch.zeros(x.shape[0])
        for j in range(c * s, min(H, (c + 1) * s)):
            p = p + top[:, j] * wl[j]
        logit = logit + p
    return 1.0 / (1.0 + torch.exp(-(logit + bs[-1][0])))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("net_spec", MLP_NETS, ids=[m[0] for m in MLP_NETS])
def test_mlp_score_cluster_order_matches_jax(net_spec, shared):
    """The score kernel's order of summation (column slices over the
    plan's n CTAs, the K split over lanes from its tile of rows, the
    value's lanes) keeps the card's 1e-5 / 1e-6 against the JAX Pallas
    kernel in interpret mode and the jnp reference, at every MLP_NETS net
    and an M that is not a multiple of the tile."""
    label, dx, dq, hidden = net_spec
    jp, tp = _both(_np_mlp(len(hidden) + dq + 1, dx + dq, hidden))
    M = 2 * mlp_score_plan([dx + dq, *hidden, 1], dx)["rows"] + 3
    rng = np.random.default_rng(dq + len(hidden) + 1)
    cand = rng.normal(size=(M, dx)).astype(np.float32)
    query = rng.normal(size=(dq,) if shared else (M, dq)).astype(np.float32)
    q_rows = np.broadcast_to(query, (M, dq)).copy()
    got = _emulate_cluster_score(torch.from_numpy(cand),
                                 torch.from_numpy(q_rows), tp["w"], tp["b"])
    assert got.shape == (M,) and got.dtype == torch.float32
    for use_pallas in (True, False):
        want = j_score(jnp.asarray(cand), jnp.asarray(query), jp,
                       use_pallas=use_pallas, interpret=True)
        _close(got.numpy(), want, err_msg=f"{label} use_pallas={use_pallas}")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_score_fused_cluster_order_matches_jax(net, stores, dtype,
                                                   shared):
    """The fused score's order of summation over the port's ``take`` of
    the JAX store's payload (-1 ids clamped to row 0), masked rows -inf,
    held against the JAX fused reference: -inf rows exactly, the rest at
    1e-5 / 1e-6; M = 5 lanes of c_max = 16, not a multiple of the tile."""
    jp, tp = net
    js, ts = stores[dtype]
    M = 80
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 500, size=M)
    idx[[2, 33, 34]] = -1
    query = rng.normal(size=(DX,) if shared else (M, DX)).astype(np.float32)
    mask = _prefix_mask(rng, 5, 16)
    rows = ts.take(torch.from_numpy(idx).clamp_min(0))
    q_rows = torch.from_numpy(np.broadcast_to(query, (M, DX)).copy())
    got = _emulate_cluster_score(rows, q_rows, tp["w"], tp["b"])
    got = got.masked_fill(~torch.from_numpy(mask), float("-inf")).numpy()
    want = np.asarray(j_score_fused(
        js, jnp.asarray(idx.astype(np.int32)), jnp.asarray(query), jp,
        use_pallas=False, mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(np.isneginf(got), ~mask)
    np.testing.assert_array_equal(got[~mask], want[~mask])
    _close(got[mask], want[mask])


def test_mlp_cpu_calls_launch_no_kernel(net, stores):
    _, tp = net
    _, ts = stores["bfloat16"]
    before = launch_counts()
    assert {"mlp_score", "mlp_score_fused", "mlp_value_and_grad",
            "mlp_grad_fused"} <= set(before)
    c = torch.zeros((6, DX))
    ids = torch.arange(6)
    mlp_score(c, torch.zeros(DX), tp)
    mlp_value_and_grad(c, c, tp)
    mlp_score_fused(ts, ids, torch.zeros(DX), tp)
    mlp_grad_fused(ts, ids, c, tp)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the measure and the bundle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dq", [DX, 24])
def test_mlp_measure_matches_jax(dq):
    """A JAX ``mlp_measure`` carried across by ``params_from_jax`` scores
    and differentiates as the JAX one: item first in the concatenation,
    and a shared query meets a block of items as ``brute_force_topk``
    calls it."""
    jm = j_mlp_measure(jax.random.PRNGKey(3), DX, dq, hidden=(64, 64))
    np_params = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = dataclasses.replace(
        mlp_measure(torch.Generator(), DX, dq, hidden=(64, 64),
                    device="cpu"),
        params=params_from_jax(np_params, device="cpu"))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(50, DX)).astype(np.float32)
    q = rng.normal(size=(50, dq)).astype(np.float32)
    want = jax.vmap(jm.score)(jnp.asarray(x), jnp.asarray(q))
    _close(tm.score(torch.from_numpy(x), torch.from_numpy(q)).numpy(), want)
    # a (Qb, 1, Dq) query block against a (1, N, Dx) item block
    block = tm.score(torch.from_numpy(x)[None], torch.from_numpy(q[:3, None]))
    assert block.shape == (3, 50)
    for i in range(3):
        _close(block[i].numpy(), jm.score_batch(jnp.asarray(x),
                                                jnp.asarray(q[i])))
    # a shared (Dq,) query row against (N, Dx) items
    _close(tm.score(torch.from_numpy(x), torch.from_numpy(q[0])).numpy(),
           jm.score_batch(jnp.asarray(x), jnp.asarray(q[0])))
    gx = tm.grad_x(torch.from_numpy(x[0]), torch.from_numpy(q[0]))
    _close(gx.numpy(), jm.grad_x(jnp.asarray(x[0]), jnp.asarray(q[0])))
    # the bundle's kernels agree with the measure's own score_fn
    _close(mlp_score(torch.from_numpy(x), torch.from_numpy(q),
                     tm.params).numpy(), want)


def test_make_family_measure_mlp():
    a = make_family_measure("mlp", torch.Generator().manual_seed(3), DX,
                            device="cpu")
    b = make_family_measure("mlp", torch.Generator().manual_seed(3), DX,
                            device="cpu")
    assert a.meta == ("mlp",) and a.name == "mlp"
    assert [tuple(t.shape) for t in a.params["w"]] == [(80, 64), (64, 64),
                                                       (64, 1)]
    assert all(torch.equal(s, t) for s, t in zip(a.params["w"],
                                                 b.params["w"]))
    assert all((t == 0).all() for t in a.params["b"])
    assert abs(float(a.params["w"][0].std()) * np.sqrt(80) - 1) < 0.05
    deep = mlp_measure(torch.Generator().manual_seed(0), DX, DX,
                       device="cpu")
    assert [tuple(t.shape) for t in deep.params["w"]] == [(80, 128),
                                                          (128, 128),
                                                          (128, 1)]


def test_mlp_bundle_tags():
    m = make_family_measure("mlp", torch.Generator().manual_seed(0), DX,
                            device="cpu")
    eng = build_engine(m, SearchConfig(), EngineOptions(fused=True))
    for stage in (eng.measure, eng.grad, eng.measure_fused, eng.grad_fused):
        assert stage.bundle_family == "mlp"
    gen = build_engine(m, SearchConfig(), EngineOptions(
        fused=True, measure_impl="vmap", grad_impl="vmap"))
    assert gen.measure.bundle_family == gen.grad.bundle_family == "generic"
    assert gen.measure_fused.bundle_family == "generic"
    assert gen.grad_fused is None


# ---------------------------------------------------------------------------
# whole searches
# ---------------------------------------------------------------------------

N, Q = 1000, 64


@pytest.fixture(scope="module")
def system():
    """N=1000 items, D=40, the JAX launcher's mlp measure (80 -> 64 -> 64
    -> 1) and its l2 graph; the port gets the same weights through
    ``params_from_jax``."""
    rng = np.random.default_rng(13)
    base = rng.normal(size=(N, DX)).astype(np.float32)
    queries = rng.normal(size=(Q, DX)).astype(np.float32)
    graph = j_build_l2_graph(base, m=12, k_construction=48)
    jm = j_make_family_measure("mlp", jax.random.PRNGKey(0), DX)
    tm = dataclasses.replace(
        make_family_measure("mlp", torch.Generator(), DX, device="cpu"),
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                               device="cpu"))
    truth, _ = j_brute_force_topk(jm, jnp.asarray(base), jnp.asarray(queries),
                                  10)
    return dict(base=base, queries=queries, graph=graph, jm=jm, tm=tm,
                truth=np.asarray(truth))


CFG = dict(k=10, ef=32, budget=8, alpha=1.01, mode="guitar",
           rank_by="angle")
ADAPTIVE = dict(adaptive="angle", c_max=12, angle_tau=1.8)
MODES = {
    "unfused": ({}, {}),
    "fused-f32": ({}, dict(fused=True)),
    "fused-int8": ({}, dict(fused=True, corpus_dtype="int8")),
    "fused-int8-adaptive": (dict(alpha=1.2),
                            dict(fused=True, corpus_dtype="int8",
                                 **ADAPTIVE)),
}


def _search(system, store, cfg_kw, opt_kw):
    g = system["graph"]
    return search_measure(
        system["tm"], store, torch.from_numpy(g.neighbors),
        torch.from_numpy(system["queries"]), torch.full((Q,), g.entry),
        SearchConfig(**cfg_kw), EngineOptions(**opt_kw))


@pytest.mark.parametrize("mode", list(MODES))
def test_mlp_search_recall_matches_jax(system, mode):
    """The same graph, payload (the JAX store's bits), queries and
    weights through both engines."""
    cfg_kw, opt_kw = MODES[mode]
    cfg_kw = {**CFG, **cfg_kw}
    js = jcorpus.make_corpus_store(jnp.asarray(system["base"]),
                                   opt_kw.get("corpus_dtype", "float32"))
    g = system["graph"]
    jr = j_search_measure(
        system["jm"], js, jnp.asarray(g.neighbors),
        jnp.asarray(system["queries"]), jnp.full((Q,), g.entry, jnp.int32),
        JConfig(**cfg_kw), JOptions(**opt_kw))
    tr = _search(system, _port_store(js), cfg_kw, opt_kw)
    r_j = recall(np.asarray(jr.ids), system["truth"])
    r_t = recall(tr.ids, system["truth"])
    assert abs(r_j - r_t) <= 0.01, (r_j, r_t)
    assert r_t > 0.5
    # returned scores are the measure's scores of the resident rows
    want = system["tm"].score(_port_store(js).take(tr.ids),
                              torch.from_numpy(system["queries"])[:, None])
    np.testing.assert_allclose(tr.scores.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("adaptive", [False, True])
def test_mlp_fused_search_equals_unfused_at_f32(system, adaptive):
    cfg_kw = {**CFG, "alpha": 1.2} if adaptive else CFG
    opt_kw = ADAPTIVE if adaptive else {}
    store = make_corpus_store(system["base"], device="cpu")
    un = _search(system, store, cfg_kw, opt_kw)
    fu = _search(system, store, cfg_kw, {**opt_kw, "fused": True})
    for f in ("ids", "scores", "n_eval", "n_grad", "n_iters"):
        assert torch.equal(getattr(un, f), getattr(fu, f)), f


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_mlp_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--items", "600", "--dim", "40", "--queries", "40",
                      "--batch", "32", "--measure", "mlp", "--fused",
                      "--corpus-dtype", "int8", "--adaptive", "angle",
                      "--c-max", "16", "--device", "cpu"])
    assert out["n_batches"] == 2 and out["qps"] > 0 and out["recall"] > 0.5
    assert "measure=mlp corpus_dtype=int8 fused=True" in \
        capsys.readouterr().out


def test_list_measures_prints_both_families(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--list-measures"])
    slots = ["score", "score_fused", "grad", "grad_fused"]
    assert out == {"deepfm": slots, "mlp": slots}
    text = capsys.readouterr().out
    assert "deepfm: score, score_fused, grad, grad_fused (serve " \
        "constructor)" in text
    assert "mlp: score, score_fused, grad, grad_fused (serve " \
        "constructor)" in text


@pytest.mark.cuda
def test_mlp_kernels_match_plain_on_card():
    """On a card: the four MLP kernels against their plain versions at
    several depths, Dq != Dx and every residency, and the fused pair bit
    for bit against the pre-gathered one at float32 (the same checks as
    chip_smoke.py's MLP kernel phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    report = chip_smoke.check_mlp_kernels(torch, torch.device("cuda"))
    assert set(report) == {"mlp_score", "mlp_score_fused", "mlp_grad",
                           "mlp_grad_fused"}
