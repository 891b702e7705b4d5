"""The DeepFM score pair's body on the card (``csrc/mlp_grad.cuh``'s
cluster body in its score form, over its DeepFM input) against the JAX
package on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py``,
``test_deepfm_score_nets_match_plain_on_card``). Here:

- ``deepfm_score_plan`` mirrors the body's launch plan for the DeepFM
  net: at the serving widths 8 rows on a cluster of 4 CTAs of 16 units per
  hidden layer, every ``DEEPFM_NETS`` net within a CTA's 227 KB, and no
  net of up to 512 FM columns refused that the one-warp-per-row score
  layout this body replaced took (above that, the tile's staged x[:fm] and
  q[:fm] can refuse a net with few first-layer units);
- a plain emulation of the body's order of summation (hidden units split
  over the plan's CTAs, the K split, each CTA's partial dot of the top
  layer, the partials added in rank order, then the bias, then the FM term
  as one chain over k) keeps rtol 1e-5 / atol 1e-6 against the JAX
  ``deepfm_score`` through its Pallas kernel in interpret mode and through
  its jnp reference, at every ``DEEPFM_NETS`` net, and against the JAX
  fused jnp reference over the JAX store's float32, bfloat16 and int8
  payloads with a prefix mask (the fused Pallas kernel cannot run on this
  jax: ``pltpu`` has no ``TPUMemorySpace``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as jcorpus  # noqa: E402
from repro.kernels.deepfm_score import deepfm_score as j_score  # noqa: E402
from repro.kernels.deepfm_score_fused import (  # noqa: E402
    deepfm_score_fused as j_score_fused)
from repro_torch.core import params_from_jax, store_from_arrays  # noqa: E402
from repro_torch.kernels.deepfm_score.ops import (  # noqa: E402
    deepfm_score_plan)
from repro_torch.kernels.mlp_grad.ops import (GRAD_SMEM_CAP,  # noqa: E402
                                              GRAD_THREADS, SCORE_CLUSTER,
                                              SCORE_TILE)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from chip_smoke import DEEPFM_NETS  # noqa: E402
from test_torch_deepfm_grad import (NET_IDS, _close,  # noqa: E402
                                    _jax, _np_deepfm_mlp,
                                    _score_layout_bytes)
from test_torch_mlp import _emulate_forward, _prefix_mask  # noqa: E402

# the most FM columns up to which the plan refuses no net that the
# one-warp-per-row score layout took
FM_ADMIT_ALL = 512


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_deepfm_score_plan():
    """The serving net (D 40, fm 8, 64x64) runs 8 rows on a cluster of 4
    CTAs of 16 units per hidden layer: the MLP score plan of the deep part
    (64 -> 64 -> 64 -> 1) with the tile's x[:fm] and q[:fm] beside it,
    19,984 bytes per CTA; every DEEPFM_NETS net fits (6,672 to 51,088
    bytes); and no net of up to FM_ADMIT_ALL FM columns is refused that
    the one-warp-per-row score layout took."""
    plan = deepfm_score_plan(40, 8, 64, 64)
    assert plan == {
        "n": SCORE_CLUSTER, "slices": [16, 16], "ks": 8, "rows": SCORE_TILE,
        "smem_bytes": 4 * (32 + 64 * 16 + 16 + 64 * 16 + 16 + 64 + 4
                           + SCORE_TILE * (68 + 68 + 68) + 4 * GRAD_THREADS
                           + SCORE_CLUSTER * SCORE_TILE + 2 * SCORE_TILE * 8)}
    assert plan["smem_bytes"] == 19_984
    sizes = []
    for D, fm, h0, h1 in DEEPFM_NETS:
        p = deepfm_score_plan(D, fm, h0, h1)
        assert p is not None and p["smem_bytes"] <= GRAD_SMEM_CAP
        assert 2 <= p["n"] <= SCORE_CLUSTER and p["rows"] == SCORE_TILE
        sizes.append(p["smem_bytes"])
    assert (min(sizes), max(sizes)) == (6_672, 51_088)
    rng = np.random.default_rng(20)
    taken = narrowed = 0
    for _ in range(20_000):
        D = int(rng.integers(2, 2500))
        fm = int(rng.integers(1, D))
        h0, h1 = (int(h) for h in rng.integers(1, 700, size=2))
        if _score_layout_bytes(D, fm, h0, h1) <= GRAD_SMEM_CAP:
            taken += 1
            if deepfm_score_plan(D, fm, h0, h1) is None:
                assert fm > FM_ADMIT_ALL, (D, fm, h0, h1)
                narrowed += 1
    assert taken > 1000 and narrowed < taken // 100
    for fm in range(1, FM_ADMIT_ALL + 1, 7):     # the narrow first layers
        for h0 in range(1, 9):
            for h1 in (1, 64, 699):
                D = fm + 1
                while _score_layout_bytes(D + 1, fm, h0, h1) <= GRAD_SMEM_CAP:
                    D += 64
                while _score_layout_bytes(D, fm, h0, h1) > GRAD_SMEM_CAP:
                    D -= 1
                if D > fm:      # the widest deep part the layout took
                    assert deepfm_score_plan(D, fm, h0, h1) is not None, \
                        (D, fm, h0, h1)


# ---------------------------------------------------------------------------
# the body's order of summation over the DeepFM input
# ---------------------------------------------------------------------------

def _emulate_deepfm_cluster_score(x, q, Ws, bs, fm):
    """The score as csrc/mlp_grad.cuh's score kernel sums it over
    DeepFMInput, in float32: the deep input [q[fm:] | x[fm:]] through the
    hidden layers of ``_emulate_forward`` over ``deepfm_score_plan``'s
    slices at its tile; each CTA's partial dot of its units of the top
    layer with the last layer's weights, unit by unit; the n partials
    added in rank order, then the bias, then the FM term, x[k] q[k]
    summed over k = 0, 1, ..., fm - 1 in order."""
    D = x.shape[1]
    h0, h1 = Ws[0].shape[1], Ws[1].shape[1]
    plan = deepfm_score_plan(D, fm, h0, h1)
    top = _emulate_forward(q[:, fm:], x[:, fm:], Ws, bs, plan,
                           plan["rows"])[0][-1]
    wl, n, s = Ws[-1][:, 0], plan["n"], plan["slices"][-1]
    logit = torch.zeros(x.shape[0])
    for c in range(n):
        p = torch.zeros(x.shape[0])
        for j in range(c * s, min(h1, (c + 1) * s)):
            p = p + top[:, j] * wl[j]
        logit = logit + p
    fmt = torch.zeros(x.shape[0])
    for k in range(fm):
        fmt = fmt + x[:, k] * q[:, k]
    return 1.0 / (1.0 + torch.exp(-((logit + bs[-1][0]) + fmt)))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("net_spec", DEEPFM_NETS, ids=NET_IDS)
def test_deepfm_score_cluster_order_matches_jax(net_spec, shared):
    """The score body's order of summation over the DeepFM input keeps the
    card's 1e-5 / 1e-6 against the JAX Pallas kernel in interpret mode and
    the jnp reference, at every DEEPFM_NETS net, both query forms and an M
    that is not a multiple of the tile."""
    D, fm, h0, h1 = net_spec
    np_params = _np_deepfm_mlp(D + 2 * h0 + h1, D - fm, h0, h1)
    tp = params_from_jax(np_params, device="cpu")
    M = 2 * SCORE_TILE + 3
    rng = np.random.default_rng(D + fm + 1)
    cand = rng.normal(size=(M, D)).astype(np.float32)
    query = rng.normal(size=(D,) if shared else (M, D)).astype(np.float32)
    q_rows = np.broadcast_to(query, (M, D)).copy()
    got = _emulate_deepfm_cluster_score(
        torch.from_numpy(cand), torch.from_numpy(q_rows), tp["w"], tp["b"],
        fm)
    assert got.shape == (M,) and got.dtype == torch.float32
    for use_pallas in (True, False):
        want = j_score(jnp.asarray(cand), jnp.asarray(query),
                       _jax(np_params), fm, use_pallas=use_pallas,
                       interpret=True)
        _close(got.numpy(), want, err_msg=f"use_pallas={use_pallas}")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("net_spec", [DEEPFM_NETS[0], DEEPFM_NETS[3]],
                         ids=[NET_IDS[0], NET_IDS[3]])
def test_deepfm_score_fused_cluster_order_matches_jax(net_spec, dtype,
                                                      shared):
    """The fused score: the same body over the rows the kernel gathers and
    dequantizes (the port's ``CorpusStore.take`` of the JAX store's own
    payload, -1 ids clamped to row 0), masked rows -inf, held against the
    JAX fused jnp reference: -inf rows exactly, the rest at 1e-5 / 1e-6;
    M = 5 lanes of c_max = 16, not a multiple of the tile's clusters."""
    D, fm, h0, h1 = net_spec
    np_params = _np_deepfm_mlp(D * 5 + h0, D - fm, h0, h1)
    tp = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(D + h1)
    N, M = 300, 80
    base = rng.normal(size=(N, D)).astype(np.float32)
    js = jcorpus.make_corpus_store(jnp.asarray(base), dtype)
    ts = store_from_arrays(
        np.asarray(js.data), None if js.scales is None
        else np.asarray(js.scales), js.dtype, None, device="cpu")
    idx = rng.integers(0, N, size=M)
    idx[[2, 33, 34]] = -1
    query = rng.normal(size=(D,) if shared else (M, D)).astype(np.float32)
    q_rows = torch.from_numpy(np.broadcast_to(query, (M, D)).copy())
    mask = _prefix_mask(rng, 5, 16)
    x = ts.take(torch.from_numpy(idx).clamp_min(0))
    got = _emulate_deepfm_cluster_score(x, q_rows, tp["w"], tp["b"], fm)
    got = got.masked_fill(~torch.from_numpy(mask), float("-inf")).numpy()
    want = np.asarray(j_score_fused(
        js, jnp.asarray(idx.astype(np.int32)), jnp.asarray(query),
        _jax(np_params), fm, use_pallas=False, mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(np.isneginf(got), ~mask)
    np.testing.assert_array_equal(got[~mask], want[~mask])
    _close(got[mask], want[mask])


@pytest.mark.cuda
def test_deepfm_score_nets_match_plain_on_card():
    """On a card: both DeepFM score kernels against their plain versions
    at every DEEPFM_NETS net, M and query form, every residency masked and
    not, all-masked tiles -inf, the fused kernel bit for bit against the
    pre-gathered one at float32, and the card's plans equal to
    ``deepfm_score_plan`` (chip_smoke.py's checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke
    from repro_torch.core import make_family_measure
    dev = torch.device("cuda")
    m = make_family_measure("deepfm", torch.Generator().manual_seed(0), 40,
                            device=dev)
    for fused in (False, True):
        worst, by_net, plans = chip_smoke.check_deepfm_score_nets(
            torch, dev, m.params["mlp"], m.meta[1], fused)
        assert len(by_net) == len(plans) == len(DEEPFM_NETS)
