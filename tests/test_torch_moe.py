"""The port's MoE FFN (``models/moe.py``) against the JAX package's on the
CPU: the positions inside each expert equal as integers, the routing's
top-k ids equal and its weights at rtol 1e-5, ``moe_ffn``'s outputs and
gradients at float32 tolerance (rtol 1e-5, atol 1e-6 of the largest
entry), and the set of dropped (token, slot) pairs equal under tight
capacity. Weights from the JAX init carried by ``tree_from_jax``; inputs
made with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as j_moe  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.tree import (assert_tree_match, flatten_with_paths,  # noqa: E402
                              tree_from_jax, tree_to_numpy)

RTOL = 1e-5
ATOL_OF_MAX = 1e-6


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


def _layer(n_experts, d=16, ff=32, n_shared=0, seed=0):
    """Layer 0 of a JAX MoE init and its port carry."""
    p, _ = j_moe.init_moe(jax.random.PRNGKey(seed), 1, d, ff, n_experts,
                          dtype=jnp.float32, n_shared=n_shared,
                          shared_d_ff=ff)
    lp = jax.tree_util.tree_map(lambda a: a[0], p)
    return lp, tree_from_jax(jax.tree_util.tree_map(np.asarray, lp), "cpu")


def _x(T, d, seed=1):
    return np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)


@pytest.mark.parametrize("Tk,E,groups", [(64, 8, 1), (64, 8, 4),
                                         (66, 8, 4), (512, 48, 16)])
def test_positions_in_expert_equal(Tk, E, groups):
    """Exact int32 arrival positions, one group and several (66 does not
    divide by 4: one group, as in JAX)."""
    idx = np.random.default_rng(Tk + E).integers(0, E, Tk).astype(np.int32)
    want = np.asarray(j_moe._positions_in_expert(jnp.asarray(idx), E, groups))
    got = t_moe._positions_in_expert(torch.from_numpy(idx), E, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("router_type", ["softmax", "sigmoid"])
def test_route_matches_jax(router_type):
    r = np.random.default_rng(0)
    logits = r.normal(size=(40, 48)).astype(np.float32)
    logits = np.array(j_moe.mask_pad_experts(jnp.asarray(logits), 40))
    tl = t_moe.mask_pad_experts(torch.from_numpy(
        r.normal(size=(2, 48)).astype(np.float32)), 40)
    assert float(tl[:, 40:].max()) == float(np.float32(-1e30))
    jw, ji = j_moe.route(jnp.asarray(logits), 8, router_type)
    tw, ti = t_moe.route(torch.from_numpy(logits), 8, router_type)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=1e-7)
    assert int(ti.max()) < 40


def test_pad_experts_and_load_balance_loss_match_jax():
    for n in (1, 8, 16, 40, 256):
        assert t_moe.pad_experts(n) == j_moe.pad_experts(n)
    r = np.random.default_rng(0)
    logits = r.normal(size=(32, 8)).astype(np.float32)
    idx = r.integers(0, 8, (32, 2)).astype(np.int32)
    np.testing.assert_allclose(
        float(t_moe.load_balance_loss(torch.from_numpy(logits),
                                      torch.from_numpy(idx), 8)),
        float(j_moe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                      8)), rtol=RTOL)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_init_moe_tree_matches_jax(n_shared):
    p, axes = j_moe.init_moe(jax.random.PRNGKey(0), 3, 16, 32, 40,
                             dtype=jnp.bfloat16, n_shared=n_shared,
                             shared_d_ff=24)
    mine, maxes = t_moe.init_moe(torch.Generator().manual_seed(0), 3, 16, 32,
                                 40, dtype=torch.bfloat16, n_shared=n_shared,
                                 shared_d_ff=24, device="cpu")
    assert maxes == axes
    assert_tree_match(mine, maxes)
    got = [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in flatten_with_paths(mine)]
    want = [(k, a.shape, a.dtype.name) for k, a in _flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, p))[0]]
    assert got == want


@pytest.mark.parametrize("E,K,cf,groups,shared", [
    (8, 2, 1.25, 1, 0), (8, 2, 1.25, 4, 0), (40, 8, 1.25, 16, 0),
    (8, 2, 0.25, 2, 0), (8, 2, 50.0, 4, 1)])
def test_moe_ffn_matches_jax(E, K, cf, groups, shared):
    """Outputs, and the gradients of a loss of them with respect to the
    weights and x, at float32 tolerance; E=40 runs padded to 48."""
    jp, tp = _layer(E, n_shared=shared)
    x = _x(64, 16).reshape(2, 32, 16)
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf, n_groups=groups)
    want = j_moe.moe_ffn(jp, jnp.asarray(x), **kw)
    got = t_moe.moe_ffn(tp, torch.from_numpy(x), **kw)
    assert tuple(got.shape) == (2, 32, 16)
    _close(got, want)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(j_moe.moe_ffn(p, xx, **kw) * w),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    _, tg = value_and_grad(
        lambda pr, b: torch.sum(t_moe.moe_ffn(pr["p"], pr["x"], **kw)
                                * torch.from_numpy(w)),
        {"p": tp, "x": torch.from_numpy(x)}, None)
    _close(tg["x"], jg[1])
    got_g = flatten_with_paths(tree_to_numpy(tg["p"]))
    want_g = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                        jg[0]))[0]
    assert [k for k, _ in got_g] == [k for k, _ in want_g]
    for (k, g), (_, wv) in zip(got_g, want_g):
        np.testing.assert_allclose(
            g, wv, rtol=RTOL, atol=ATOL_OF_MAX * float(np.abs(wv).max()),
            err_msg=k)


def _jax_keep(jp, x, E, K, cf, groups):
    """JAX's kept (token, slot) pairs: its own routing and positions."""
    xt = jnp.asarray(x)
    Ew = jp["w_gate"].shape[-3]
    C = max(K, int(cf * xt.shape[0] * K / Ew))
    C = ((C + groups - 1) // groups) * groups
    logits = j_moe.mask_pad_experts(xt @ jp["router"], E)
    _, idx = j_moe.route(logits, K)
    pos = j_moe._positions_in_expert(idx.reshape(-1), Ew, groups)
    return np.asarray(pos < C)


def test_moe_scatter_no_drop_matches_dense_expert():
    """With capacity_factor huge and a single expert, MoE == plain FFN
    (the JAX test's check, on the port)."""
    _, tp = _layer(1)
    x = torch.from_numpy(_x(8, 16)).reshape(1, 8, 16)
    out = t_moe.moe_ffn(tp, x, n_experts=1, top_k=1, capacity_factor=100.0,
                        n_groups=1)
    ref = (torch.nn.functional.silu(x @ tp["w_gate"][0])
           * (x @ tp["w_up"][0])) @ tp["w_down"][0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_capacity_drops_tokens():
    """Tight capacity drops some outputs, and exactly the (token, slot)
    pairs JAX drops."""
    E, K = 16, 2
    jp, tp = _layer(E, d=8, ff=16)
    x = _x(64, 8)
    kw = dict(n_experts=E, top_k=K, n_groups=1)
    full = t_moe.moe_ffn(tp, torch.from_numpy(x), capacity_factor=50.0, **kw)
    tight = t_moe.moe_ffn(tp, torch.from_numpy(x), capacity_factor=0.25,
                          **kw)
    assert float((full - tight).abs().max()) > 1e-6
    _, _, _, keep, _ = t_moe.dispatch(tp, torch.from_numpy(x),
                                      capacity_factor=0.25, **kw)
    want = _jax_keep(jp, x, E, K, 0.25, 1)
    assert 0 < int((~keep).sum()) < keep.numel()
    np.testing.assert_array_equal(keep.numpy(), want)
    _close(tight, j_moe.moe_ffn(jp, jnp.asarray(x), capacity_factor=0.25,
                                **kw))


def test_dispatch_writes_only_kept_pairs():
    """The buffer holds each kept pair's token at its slot and zeros
    elsewhere; a dropped pair writes nowhere in it."""
    jp, tp = _layer(8)
    x = torch.from_numpy(_x(48, 16))
    buf, slot, w, keep, idx = t_moe.dispatch(
        tp, x, n_experts=8, top_k=2, capacity_factor=0.5, n_groups=2)
    E, C, d = buf.shape
    flat = buf.reshape(E * C, d)
    xk = x.repeat_interleave(2, dim=0)
    assert torch.equal(flat[slot[keep]], xk[keep])
    written = torch.zeros(E * C, dtype=torch.bool)
    written[slot[keep]] = True
    assert not flat[~written].any()
    assert int(keep.sum()) == int(written.sum())       # kept slots unique
