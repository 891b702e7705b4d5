"""The port's EmbeddingBag kernel wrapper and recommendation embedding ops
against the JAX package.

On the CPU the wrapper runs its plain PyTorch version (the CUDA kernel
runs only on the card: ``test_torch_attention.py::
test_library_kernels_match_plain_on_card`` there, and ``chip_smoke.py``).
Inputs come from numpy seeds and go through both sides. The JAX
Pallas-interpret path of the bag cannot run on this jax build (no
``pltpu.ANY``), so the port is held against ``embedding_bag_ref`` and
``embedding_bag(..., use_pallas=False)``.

Tolerances: float32 rtol/atol 1e-5 (the same sums in another order);
bfloat16 2e-2, the JAX test's own, because JAX rounds each product (and
its running sum) to bfloat16 while the port sums in float32 and rounds
once; the port's bfloat16 result is also held within one bfloat16 rounding
(2^-8 relative) of the float32 sum of the same values.
"""
import ml_dtypes
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag import embedding_bag as jax_bag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro_torch.kernels import embedding_bag  # noqa: E402
from repro_torch.models import layers, recsys  # noqa: E402

BF16 = ml_dtypes.bfloat16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, r, d, b, l, dtype):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(r, d)).astype(np.float32).astype(dtype)
    idx = rng.integers(-1, r, size=(b, l)).astype(np.int32)
    w = rng.uniform(size=(b, l)).astype(np.float32).astype(dtype)
    return table, idx, w


def _port(table, idx, w=None, **kw):
    t = layers.tensor_from_jax(table, device="cpu")
    ww = None if w is None else layers.tensor_from_jax(w, device="cpu")
    return embedding_bag(t, torch.from_numpy(idx), ww, **kw)


def _f32(x):
    x = x.float().numpy() if isinstance(x, torch.Tensor) else x
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("r,d,b,l,dtype", [
    (100, 16, 8, 4, "float32"), (500, 64, 33, 8, "float32"),
    (64, 128, 16, 2, "bfloat16"),
    # the card kernel's tiling edges: L below, across and twice its batch
    # of items, the scalar path (d = 12), a single bag
    (100, 16, 8, 1, "float32"), (100, 16, 8, 1, "bfloat16"),
    (300, 64, 20, 9, "float32"), (300, 64, 20, 9, "bfloat16"),
    (200, 32, 6, 17, "float32"), (200, 32, 6, 17, "bfloat16"),
    (100, 12, 10, 4, "float32"), (100, 12, 10, 4, "bfloat16"),
    (50, 64, 1, 8, "float32"), (50, 64, 1, 8, "bfloat16"),
])
def test_embedding_bag_matches_jax_sweep(r, d, b, l, dtype):
    np_dtype = np.float32 if dtype == "float32" else BF16
    table, idx, w = _inputs(r, r, d, b, l, np_dtype)
    got = _port(table, idx, w)
    assert got.shape == (b, d) and got.dtype == getattr(torch, dtype)
    for want in (embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                   jnp.asarray(w)),
                 jax_bag(jnp.asarray(table), jnp.asarray(idx),
                         jnp.asarray(w), use_pallas=False)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    if dtype == "bfloat16":
        # one rounding of the float32 sum of the same (bf16) values
        t32, w32 = table.astype(np.float32), w.astype(np.float32)
        exact = np.zeros((b, d), np.float64)
        for i in range(b):
            for j in range(l):
                if idx[i, j] >= 0:
                    exact[i] += np.float64(w32[i, j]) * t32[idx[i, j]]
        np.testing.assert_allclose(_f32(got), exact, rtol=2.0 ** -8,
                                   atol=1e-6)


def test_embedding_bag_without_weights():
    table, idx, _ = _inputs(1, 200, 32, 12, 5, np.float32)
    got = _port(table, idx)
    want = embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_embedding_bag_all_padding_bags_are_zero():
    table, idx, w = _inputs(2, 50, 8, 6, 3, np.float32)
    idx[[0, 3]] = -1
    got = _port(table, idx, w)
    assert (got[[0, 3]] == 0).all()
    want = embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                             jnp.asarray(w))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_embedding_bag_ragged_batch_and_int64_ids():
    """B = 33 is not a multiple of block_b = 8: the JAX wrapper pads, the
    port needs no padding; int64 ids give the same sums as int32."""
    table, idx, w = _inputs(3, 300, 16, 33, 4, np.float32)
    got32 = _port(table, idx, w, block_b=8)
    got64 = _port(table, idx.astype(np.int64), w, block_b=8)
    assert torch.equal(got32, got64)
    want = jax_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w),
                   block_b=8, use_pallas=False)
    np.testing.assert_allclose(_f32(got32), _f32(want), rtol=1e-5,
                               atol=1e-5)


def test_embedding_bag_out_of_range_ids_add_nothing():
    """An id outside [-1, R) is out of contract. The port (kernel and plain
    version alike) treats it as -1 and never reads outside the table; the
    jnp ref's ``jnp.take`` fills, so it returns NaN there."""
    table, idx, w = _inputs(4, 40, 8, 5, 3, np.float32)
    bad = idx.copy()
    bad[1, 0], bad[2, 2] = 40, -9
    masked = bad.copy()
    masked[1, 0], masked[2, 2] = -1, -1
    assert torch.equal(_port(table, bad, w), _port(table, masked, w))
    jax_out = np.asarray(embedding_bag_ref(jnp.asarray(table),
                                           jnp.asarray(bad), jnp.asarray(w)))
    assert np.isnan(jax_out[1]).all()


def test_embedding_bag_output_dtype_is_the_tables():
    table, idx, w = _inputs(5, 30, 8, 4, 2, BF16)
    # float32 weights are rounded to the table's dtype, as in JAX
    got = _port(table, idx, w.astype(np.float32))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _port(table, idx, w))


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 50), st.integers(1, 6), st.integers(1, 16))
def test_embedding_bag_matches_loop(rows, l, d):
    """Hypothesis: the port's bag == an explicit Python loop over ids."""
    rng = np.random.default_rng(rows * l * d)
    table = rng.normal(size=(rows, d)).astype(np.float32)
    idx = rng.integers(-1, rows, size=(3, l)).astype(np.int32)
    ref = np.zeros((3, d), np.float32)
    for i in range(3):
        for j in range(l):
            if idx[i, j] >= 0:
                ref[i] += table[idx[i, j]]
    np.testing.assert_allclose(_port(table, idx).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


def test_wrapper_refuses_bad_arguments():
    table = torch.zeros((10, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        embedding_bag(table.half(), idx)
    with pytest.raises(TypeError):
        embedding_bag(table, idx.float())
    with pytest.raises(ValueError):
        embedding_bag(table, idx, torch.ones((2, 4)))
    with pytest.raises(ValueError):
        embedding_bag(table, idx.to("meta"))
    with pytest.raises(ValueError):
        embedding_bag(table.to("meta"), idx.to("meta"))


# ---------------------------------------------------------------------------
# models/recsys.py embedding ops and the layers helpers
# ---------------------------------------------------------------------------

def test_constants_match_jax():
    assert recsys.CRITEO_CARDINALITIES == jax_recsys.CRITEO_CARDINALITIES
    assert layers.VOCAB_PAD == jax_layers.VOCAB_PAD
    for n in (1, 15, 16, 17, 33_762_577):
        assert layers.pad_vocab(n) == jax_layers.pad_vocab(n)
    np.testing.assert_array_equal(
        recsys.field_offsets(recsys.CRITEO_CARDINALITIES),
        jax_recsys.field_offsets(jax_recsys.CRITEO_CARDINALITIES))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_from_jax_keeps_the_bits(dtype):
    a = np.random.default_rng(6).normal(size=(7, 5)).astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(BF16)
    t = layers.tensor_from_jax(jnp.asarray(a), device="cpu")
    assert t.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_embedding_bag_matches_jax(mode, weighted):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(60, 8)).astype(np.float32)
    indices = rng.integers(0, 60, size=(40,)).astype(np.int32)
    segs = rng.integers(0, 9, size=(40,)).astype(np.int32)  # unsorted
    segs[segs == 4] = 5                                      # an empty bag
    w = rng.uniform(size=(40,)).astype(np.float32) if weighted else None
    got = recsys.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(indices),
        torch.from_numpy(segs), 9,
        None if w is None else torch.from_numpy(w), mode=mode)
    want = jax_recsys.embedding_bag(
        jnp.asarray(table), jnp.asarray(indices), jnp.asarray(segs), 9,
        None if w is None else jnp.asarray(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_lookups_match_jax():
    rng = np.random.default_rng(8)
    card = (50,) * 26
    table = rng.normal(size=(layers.pad_vocab(sum(card)), 8)).astype(
        np.float32)
    sparse = rng.integers(0, 50, size=(4, 26)).astype(np.int32)
    offs = recsys.field_offsets(card)
    got = recsys.multi_field_lookup(torch.from_numpy(table),
                                    torch.from_numpy(sparse),
                                    torch.from_numpy(offs))
    want = jax_recsys.multi_field_lookup(jnp.asarray(table),
                                         jnp.asarray(sparse),
                                         jnp.asarray(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = rng.integers(0, table.shape[0], size=(3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        recsys.embedding_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids)).numpy(),
        np.asarray(jax_recsys.embedding_lookup(jnp.asarray(table),
                                               jnp.asarray(ids))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_multi_field_bag_matches_jax_segment_form(dtype):
    """The slice as a whole at DLRM-RM2's smoke width (26 fields of 50
    rows, d = 8): multi-hot bags of up to 3 ids per (sample, field), -1
    padded, through the port's kernel wrapper over a table carried across
    by ``tensor_from_jax``, against JAX's segment-form ``embedding_bag``
    over the same ids."""
    rng = np.random.default_rng(9)
    card = (50,) * 26
    offs = recsys.field_offsets(card)
    np_dtype = np.float32 if dtype == "float32" else BF16
    table = (0.02 * rng.normal(size=(layers.pad_vocab(sum(card)), 8))
             ).astype(np.float32).astype(np_dtype)
    B, F, L = 4, 26, 3
    ids = rng.integers(0, 50, size=(B, F, L)) + offs[None, :, None]
    ids[rng.uniform(size=ids.shape) < 0.3] = -1
    ids = ids.reshape(B * F, L).astype(np.int32)
    got = embedding_bag(layers.tensor_from_jax(table, device="cpu"),
                        torch.from_numpy(ids))
    flat = ids.reshape(-1)
    keep = flat >= 0
    segs = np.repeat(np.arange(B * F, dtype=np.int32), L)[keep]
    want = jax_recsys.embedding_bag(jnp.asarray(table),
                                    jnp.asarray(flat[keep]),
                                    jnp.asarray(segs), B * F)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    assert got.dtype == getattr(torch, dtype)
