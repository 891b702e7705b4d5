"""The rank pair's body on the card (``csrc/neighbor_rank.cuh``: a lane's
rows in flight at once, a group of G threads per row) against the JAX
package on the CPU, and the DeepFM wrappers' refusal of the nets their
cluster plan cannot place.

The CUDA kernels run only on the card (``chip_smoke.py``,
``test_rank_kernels_match_plain_on_card``). Here:

- ``neighbor_rank_plan`` mirrors the body's launch plan: at the serving
  shape one CTA of 192 threads per lane, 4 threads per row; larger B in
  passes of up to 1024 threads, larger D in chunks of up to 1024 columns;
- a float32 emulation of the body's order of summation (each thread's
  fmaf chains over its columns gi, gi + G, ..., chunk after chunk, the G
  partials added by xor shuffles, then the key, theta and the band) keeps
  angle keys within 5e-4 and projection keys within rtol/atol 1e-5 of the
  JAX ``neighbor_rank`` through its Pallas kernel in interpret mode and
  through its jnp reference, with no mask mismatch away from the band
  edge; and of the JAX fused jnp reference over the JAX store's float32,
  bfloat16 and int8 payloads (the fused Pallas kernel cannot run on this
  jax: ``pltpu`` has no ``TPUMemorySpace``);
- ``check_deepfm_plan`` refuses, naming the generic stages, a score and a
  grad net whose cluster plan does not fit a CTA, and passes every
  ``DEEPFM_NETS`` net.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import corpus as jcorpus  # noqa: E402
from repro.kernels.neighbor_rank import neighbor_rank as j_rank  # noqa: E402
from repro.kernels.neighbor_rank_fused import (  # noqa: E402
    neighbor_rank_fused as j_rank_fused)
from repro_torch.kernels.deepfm_grad.ops import deepfm_grad_plan  # noqa: E402
from repro_torch.kernels.deepfm_score.ops import (  # noqa: E402
    check_deepfm_plan, deepfm_score_plan)
from repro_torch.kernels.mlp_grad.ops import GRAD_SMEM_CAP  # noqa: E402
from repro_torch.kernels.neighbor_rank.ops import (  # noqa: E402
    RANK_ELEMS, RANK_MAX_COLS, RANK_MAX_THREADS, neighbor_rank_plan)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (DEEPFM_GRAD_REFUSED, DEEPFM_NETS,  # noqa: E402
                        DEEPFM_SCORE_REFUSED, RANK_SHAPES)

ALPHA = 1.01
ANGLE_ATOL = 5e-4
PROJ_RTOL = PROJ_ATOL = 1e-5
# (Q, B, D): the smoke's shapes (the serving shape, a ragged B, rows that
# are not 16-byte aligned, more rows than one pass takes, a wider D, more
# columns than one chunk)
SHAPES = list(RANK_SHAPES)
SHAPE_IDS = [f"Q{q}-B{b}-D{d}" for q, b, d in SHAPES]


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def test_neighbor_rank_plan():
    """The serving shape runs one CTA of 192 threads per lane, 4 threads
    per row of 10 columns, all 48 rows in one pass (9,368 bytes); a large B
    runs in passes of 1024 threads, a large D in chunks; every plan keeps
    whole warps, a CTA's limits and the bank rule."""
    assert neighbor_rank_plan(48, 40) == {
        "threads_per_row": 4, "lanes": 1, "rows": 48, "cols": 40,
        "pitch": 44, "threads": 192,
        "smem_bytes": 4 * (48 * 44 + 2 * 40 + 3 * 48 + 6),
        "passes": 1, "chunks": 1}
    assert neighbor_rank_plan(48, 40)["smem_bytes"] == 9_368
    big_b = neighbor_rank_plan(300, 40)
    assert (big_b["rows"], big_b["threads"], big_b["passes"]) == \
        (256, 1024, 2)
    big_d = neighbor_rank_plan(48, 768)
    assert (big_d["threads_per_row"], big_d["rows"], big_d["cols"],
            big_d["chunks"]) == (32, 21, 768, 1)
    wide = neighbor_rank_plan(48, 1100)
    assert (wide["cols"], wide["chunks"]) == (RANK_MAX_COLS, 2)
    assert neighbor_rank_plan(17, 33)["pitch"] == 36    # 4 per row, 9 units
    assert neighbor_rank_plan(48, 80)["pitch"] == 88    # 8 per row, 10 units
    rng = np.random.default_rng(21)
    for _ in range(2000):
        B, D = (int(v) for v in rng.integers(1, 3000, size=2))
        p = neighbor_rank_plan(B, D)
        G = p["threads_per_row"]
        unit = max(G, 4)
        assert G & (G - 1) == 0 and 1 <= G <= 32
        assert G == 32 or RANK_ELEMS * G >= D
        assert 1 <= p["rows"] <= B
        assert p["threads"] % 32 == 0 and p["threads"] <= RANK_MAX_THREADS
        assert p["smem_bytes"] <= GRAD_SMEM_CAP
        assert p["cols"] % unit == 0 and p["pitch"] % 4 == 0
        assert p["passes"] * p["rows"] >= B and p["chunks"] * p["cols"] >= D
        if 4 <= G < 32:    # the rows a warp reads start on distinct banks
            starts = {r * p["pitch"] % 32 // G for r in range(32 // G)}
            assert len(starts) == 32 // G


# ---------------------------------------------------------------------------
# the body's order of summation
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf in float32: the product is exact in float64, the sum rounded
    to float32 from float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_rank(x, g, rows, valid, alpha, rank_by):
    """Keys and mask as csrc/neighbor_rank.cuh computes them, in float32:
    per row, thread gi of the plan's G sums d = row - x over its columns
    gi, gi + G, ... chunk by chunk (``<d, g>``, ``|d|^2``, ``|g|^2``, one
    fmaf chain each), the G partials are added by xor shuffles (offsets
    G/2, ..., 1), then the key, theta and the alpha*theta band."""
    Q, B, D = rows.shape
    plan = neighbor_rank_plan(B, D)
    G, cols = plan["threads_per_row"], plan["cols"]
    f32 = np.float32
    zero = np.zeros((Q, B, G), f32)
    dp, nn, gp = zero.copy(), zero.copy(), zero.copy()
    for d0 in range(0, D, cols):
        for gi in range(G):
            for d in range(d0 + gi, min(d0 + cols, D), G):
                df = rows[:, :, d] - x[:, None, d]
                gd = np.broadcast_to(g[:, None, d], (Q, B))
                dp[:, :, gi] = _fma(df, gd, dp[:, :, gi])
                nn[:, :, gi] = _fma(df, df, nn[:, :, gi])
                gp[:, :, gi] = _fma(gd, gd, gp[:, :, gi])
    o = G // 2
    while o:
        perm = np.arange(G) ^ o
        dp, nn, gp = dp + dp[:, :, perm], nn + nn[:, :, perm], \
            gp + gp[:, :, perm]
        o //= 2
    dp, nn, gp = dp[:, :, 0], nn[:, :, 0], gp[:, :, 0]
    eps = f32(1e-12)
    with np.errstate(invalid="ignore"):   # inf - inf on invalid lanes
        if rank_by == "angle":
            dn, gn = np.sqrt(nn) + eps, np.sqrt(gp) + eps
            c = np.clip(dp / (dn * gn), f32(-1), f32(1))
            key = np.where(valid, np.arccos(c), f32(np.inf))
            theta = key.min(1, keepdims=True)
            mask = valid & (key <= f32(alpha) * theta + eps)
        else:
            key = np.where(valid, -(dp / (np.sqrt(gp) + eps)), f32(np.inf))
            theta = (-key).max(1, keepdims=True)
            bound = np.where(theta >= 0, theta / f32(alpha),
                             theta * f32(alpha))
            mask = valid & (-key >= bound - eps)
    return key.astype(f32), mask


def _inputs(shape, seed):
    """x, g, neighbor rows near x, valid with an all-invalid lane 0, and
    row 2 of lane 1 equal to x (a zero diff)."""
    Q, B, D = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Q, D)).astype(np.float32)
    g = rng.normal(size=(Q, D)).astype(np.float32)
    rows = (x[:, None, :] + 0.5 * rng.normal(size=(Q, B, D))).astype(
        np.float32)
    rows[1, min(2, B - 1)] = x[1]
    valid = rng.random((Q, B)) < 0.7
    valid[0] = False
    return x, g, rows, valid


def _assert_rank_close(key, mask, wk, wm, valid, rank_by):
    """Keys within the tolerances (invalid keys equal), no mask mismatch
    away from the alpha*theta band edge, nothing masked in that is
    invalid."""
    wk, wm = np.asarray(wk), np.asarray(wm)
    fin = np.isfinite(wk)
    np.testing.assert_array_equal(np.isfinite(key), fin)
    np.testing.assert_array_equal(key[~fin], wk[~fin])
    with np.errstate(invalid="ignore"):
        if rank_by == "angle":
            np.testing.assert_allclose(key[fin], wk[fin], rtol=0,
                                       atol=ANGLE_ATOL)
            theta = np.where(fin, wk, np.inf).min(1, keepdims=True)
            near = np.abs(wk - ALPHA * theta) <= ANGLE_ATOL
        else:
            np.testing.assert_allclose(key[fin], wk[fin], rtol=PROJ_RTOL,
                                       atol=PROJ_ATOL)
            proj = np.where(fin, -wk, -np.inf)
            theta = proj.max(1, keepdims=True)
            bound = np.where(theta >= 0, theta / ALPHA, theta * ALPHA)
            near = np.abs(proj - bound) <= PROJ_ATOL * (1 + np.abs(bound))
    assert not ((mask != wm) & ~near).any()
    assert not mask[~valid].any()


@pytest.mark.parametrize("rank_by", ["angle", "projection"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_rank_order_matches_jax(shape, rank_by):
    """The emulated body against JAX's neighbor_rank through its Pallas
    kernel (interpret mode) and through its jnp reference."""
    x, g, rows, valid = _inputs(shape, sum(shape))
    key, mask = _emulate_rank(x, g, rows, valid, ALPHA, rank_by)
    assert np.isinf(key[0]).all() and not mask[0].any()
    args = [jnp.asarray(a) for a in (x, g, rows, valid)]
    for use_pallas in (True, False):
        wk, wm = j_rank(*args, alpha=ALPHA, rank_by=rank_by,
                        use_pallas=use_pallas, interpret=True)
        _assert_rank_close(key, mask, wk, wm, valid, rank_by)


def _dequant(js):
    """The JAX store's rows in float32, dequantized as the kernel's row
    sources do: float32 as stored, bfloat16 by widening the bits, int8 as
    float(q8) * scale rounded to float32."""
    data = np.asarray(js.data)
    if js.dtype == "bfloat16":
        return (data.astype(np.uint32) << 16).view(np.float32)
    if js.dtype == "int8":
        return data.astype(np.float32) * np.asarray(js.scales)
    return data


@pytest.mark.parametrize("rank_by", ["angle", "projection"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", SHAPES[:5], ids=SHAPE_IDS[:5])
def test_fused_rank_order_matches_jax(shape, dtype, rank_by):
    """The emulated body over rows gathered by id from the JAX store's
    payload (-1 ids clamped to row 0) against the JAX fused neighbor_rank's
    jnp reference (use_pallas=False)."""
    Q, B, D = shape
    rng = np.random.default_rng(Q * B + D)
    js = jcorpus.make_corpus_store(
        jnp.asarray(rng.normal(size=(400, D)).astype(np.float32)), dtype)
    table = _dequant(js)
    fid = rng.integers(0, 400, size=Q)
    x = table[fid]
    g = rng.normal(size=(Q, D)).astype(np.float32)
    idx = rng.integers(0, 400, size=(Q, B))
    idx[1, min(2, B - 1)] = fid[1]                   # a zero diff
    idx[-1, :3] = -1
    valid = (rng.random((Q, B)) < 0.7) & (idx >= 0)
    valid[0] = False                                 # an all-invalid lane
    rows = table[np.maximum(idx, 0)]
    np.testing.assert_array_equal(
        rows, np.asarray(js.take(jnp.asarray(np.maximum(idx, 0)))))
    key, mask = _emulate_rank(x, g, rows, valid, ALPHA, rank_by)
    wk, wm = j_rank_fused(jnp.asarray(x), jnp.asarray(g), js,
                          jnp.asarray(idx.astype(np.int32)),
                          jnp.asarray(valid), ALPHA, rank_by,
                          use_pallas=False)
    _assert_rank_close(key, mask, wk, wm, valid, rank_by)


# ---------------------------------------------------------------------------
# the DeepFM wrappers' plan check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan_of, kernel, net", [
    (deepfm_score_plan, "score", DEEPFM_SCORE_REFUSED),
    (deepfm_grad_plan, "grad", DEEPFM_GRAD_REFUSED)], ids=["score", "grad"])
def test_deepfm_plan_check_refuses_by_name(plan_of, kernel, net):
    """A net whose cluster plan does not fit a CTA is refused before any
    launch, with its widths, the bytes its plan would need and the way to
    the generic stages (not the C launcher's bare CUDA error)."""
    assert plan_of(*net) is None
    need = plan_of(*net, cap=None)["smem_bytes"]
    assert need > GRAD_SMEM_CAP
    with pytest.raises(ValueError, match="measure_impl='vmap'") as e:
        check_deepfm_plan(plan_of, kernel, *net)
    D, fm, h0, h1 = net
    assert f"D={D}, fm={fm}, hidden {h0}x{h1} need {need} bytes" in \
        str(e.value)


@pytest.mark.parametrize("plan_of, kernel", [
    (deepfm_score_plan, "score"), (deepfm_grad_plan, "grad")],
    ids=["score", "grad"])
def test_deepfm_plan_check_passes_every_net(plan_of, kernel):
    for net in DEEPFM_NETS:
        check_deepfm_plan(plan_of, kernel, *net)
        assert plan_of(*net) == plan_of(*net, cap=None)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_rank_kernels_match_plain_on_card():
    """On a card: both rank kernels against their plain versions at every
    shape of the smoke's rank phase, the card's plan against
    ``neighbor_rank_plan``, and the four DeepFM wrappers' refusals (the
    same checks as chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import chip_smoke
    from repro_torch.core import make_family_measure
    dev = torch.device("cuda")
    measure = make_family_measure("deepfm", torch.Generator().manual_seed(0),
                                  40, device=dev)
    report = chip_smoke.check_kernels(torch, dev, measure, measure.meta[1])
    assert report["neighbor_rank"]["err"] <= ANGLE_ATOL
    chip_smoke.check_deepfm_refusals(torch, dev)
