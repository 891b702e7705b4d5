"""The port's GIN (``models/gnn.py``), its config, the fanout sampler
(``data/sampler.py``) and the graph, molecule and token generators
(``data/synthetic.py``) against the JAX package on the CPU.

GIN's forward, both losses and their gradients at rtol 1e-5 with an atol
of 1e-6 of each array's largest entry (a sum over edges and d_hidden that
cancels keeps float32's absolute error), from the JAX init carried by
``tree_from_jax``; inputs made with numpy from a seed. The sampler and the
generators are numpy copies: equal element for element for the same
seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.data import sampler as j_sampler  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.models import gnn as j_gnn  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import sampler as t_sampler  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.models import gnn as t_gnn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.tree import (assert_tree_match, flatten_with_paths,  # noqa: E402
                              tree_from_jax, tree_to_numpy)

RTOL = 1e-5
ATOL_OF_MAX = 1e-6


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


def _tree_close(port_tree, jax_tree):
    got = flatten_with_paths(tree_to_numpy(port_tree))
    want = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                      jax_tree))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL_OF_MAX * float(np.abs(w).max()),
            err_msg=k)


def _pair(cfg_j, cfg_t):
    jp, _ = j_gnn.init_params(jax.random.PRNGKey(0), cfg_j)
    return jp, tree_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _graph(n=40, e=160, d=8, seed=1, pad=24):
    """A random graph with ``pad`` masked edges at node 0 (the sampler's
    padding), node labels and a label mask."""
    r = np.random.default_rng(seed)
    src = np.concatenate([r.integers(0, n, e), np.zeros(pad, int)])
    dst = np.concatenate([r.integers(0, n, e), np.zeros(pad, int)])
    mask = np.concatenate([np.ones(e), np.zeros(pad)]).astype(np.float32)
    return {"feats": r.normal(size=(n, d)).astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "edge_mask": mask,
            "labels": r.integers(0, 3, n).astype(np.int32),
            "label_mask": (r.random(n) < 0.5).astype(np.float32)}


def test_gin_configs_match_jax():
    a, j = get_arch("gin-tu"), j_get_arch("gin-tu")
    assert a.family == j.family == "gnn"
    assert [s.dims for s in a.shapes] == [s.dims for s in j.shapes]
    mods = __import__("repro_torch.configs.gin_tu", fromlist=["config"])
    jmods = __import__("repro.configs.gin_tu", fromlist=["config"])
    for shape in [None] + list(a.shapes):
        mine = mods.config(shape) if shape else a.make_config()
        theirs = jmods.config(j.shape(shape.name)) if shape \
            else j.make_config()
        for f in mine.__dataclass_fields__:
            m, t = getattr(mine, f), getattr(theirs, f)
            if f == "dtype":
                m, t = str(m).split(".")[-1], jnp.dtype(t).name
            assert m == t, (shape, f)
    smoke, jsmoke = a.make_smoke_config(), j.make_smoke_config()
    for f in ("name", "n_layers", "d_in", "d_hidden", "n_classes"):
        assert getattr(smoke, f) == getattr(jsmoke, f), f


def test_init_tree_matches_jax():
    jcfg = j_get_arch("gin-tu").make_smoke_config()
    tcfg = get_arch("gin-tu").make_smoke_config()
    jp, jaxes = j_gnn.init_params(jax.random.PRNGKey(0), jcfg)
    mine, axes = t_gnn.init_params(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu")
    assert axes == jaxes
    assert_tree_match(mine, axes)
    got = [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in flatten_with_paths(mine)]
    want = [(k, a.shape, a.dtype.name) for k, a in _flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jp))[0]]
    assert got == want


@pytest.mark.parametrize("masked", [False, True])
def test_gin_node_forward_loss_and_grads_match_jax(masked):
    jcfg = j_get_arch("gin-tu").make_smoke_config()
    tcfg = get_arch("gin-tu").make_smoke_config()
    jp, tp = _pair(jcfg, tcfg)
    g = _graph()
    em = g["edge_mask"] if masked else None
    j = {k: jnp.asarray(v) for k, v in g.items()}
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    want = j_gnn.forward(jp, j["feats"], j["src"], j["dst"], jcfg,
                         edge_mask=None if em is None else j["edge_mask"])
    got = t_gnn.forward(tp, t["feats"], t["src"], t["dst"], tcfg,
                        edge_mask=None if em is None else t["edge_mask"])
    _close(got, want)

    def jl(p):
        return j_gnn.node_classification_loss(
            p, j["feats"], j["src"], j["dst"], j["labels"], j["label_mask"],
            jcfg, edge_mask=None if em is None else j["edge_mask"])

    def tl(p, b):
        return t_gnn.node_classification_loss(
            p, b["feats"], b["src"], b["dst"], b["labels"], b["label_mask"],
            tcfg, edge_mask=None if em is None else b["edge_mask"])

    jloss, jgrad = jax.value_and_grad(jl)(jp)
    tloss, tgrad = value_and_grad(tl, tp, t)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    _tree_close(tgrad, jgrad)


def test_gin_graph_pool_loss_and_grads_match_jax():
    """Molecule-style graph classification: graph_pool, segment sums over
    graph ids, on ``make_batched_molecules``."""
    jcfg = dataclasses.replace(j_get_arch("gin-tu").make_smoke_config(),
                               graph_pool=True, d_in=16, n_classes=2)
    tcfg = dataclasses.replace(get_arch("gin-tu").make_smoke_config(),
                               graph_pool=True, d_in=16, n_classes=2)
    jp, tp = _pair(jcfg, tcfg)
    m = t_syn.make_batched_molecules(6, 10, 20, seed=2)
    j = {k: jnp.asarray(v) for k, v in m.items()}
    t = {k: torch.from_numpy(v) for k, v in m.items()}
    want = j_gnn.forward(jp, j["feats"], j["src"], j["dst"], jcfg,
                         graph_ids=j["graph_ids"], n_graphs=6)
    got = t_gnn.forward(tp, t["feats"], t["src"], t["dst"], tcfg,
                        graph_ids=t["graph_ids"], n_graphs=6)
    assert tuple(got.shape) == (6, 2)
    _close(got, want)
    jloss, jgrad = jax.value_and_grad(
        lambda p: j_gnn.graph_classification_loss(
            p, j["feats"], j["src"], j["dst"], j["graph_ids"], 6,
            j["labels"], jcfg))(jp)
    tloss, tgrad = value_and_grad(
        lambda p, b: t_gnn.graph_classification_loss(
            p, b["feats"], b["src"], b["dst"], b["graph_ids"], 6,
            b["labels"], tcfg), tp, t)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    _tree_close(tgrad, jgrad)


def test_gin_conv_msg_bf16_matches_jax():
    """Reduced-precision messages: the gathered rows rounded to bf16, the
    aggregation in bf16 then cast back (2e-2: bf16 rounding order)."""
    jcfg = dataclasses.replace(j_get_arch("gin-tu").make_smoke_config(),
                               msg_bf16=True)
    tcfg = dataclasses.replace(get_arch("gin-tu").make_smoke_config(),
                               msg_bf16=True)
    jp, tp = _pair(jcfg, tcfg)
    g = _graph()
    want = j_gnn.forward(jp, *(jnp.asarray(g[k]) for k in
                               ("feats", "src", "dst")), jcfg)
    got = t_gnn.forward(tp, *(torch.from_numpy(g[k]) for k in
                              ("feats", "src", "dst")), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_segment_sum_is_index_add_and_deterministic():
    r = np.random.default_rng(0)
    data = torch.from_numpy(r.normal(size=(50, 4)).astype(np.float32))
    ids = torch.from_numpy(r.integers(0, 7, 50))
    got = t_gnn.segment_sum(data, ids, 9)
    assert torch.equal(got, torch.zeros(9, 4).index_add_(0, ids, data))
    assert torch.equal(got, t_layers.segment_sum_rows(data, ids, 9))
    assert not got[7:].any()


# ---------------------------------------------------------------------------
# the sampler and the generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanouts,max_nodes,max_edges", [
    ((15, 10), 600, 900), ((5, 3), 64, 80), ((4,), 2000, 2000)])
def test_neighbor_sampler_equals_jax(fanouts, max_nodes, max_edges):
    """The same graph and seed: every array of every batch equal, element
    for element, over three batches (the samplers' streams advance
    alike); the middle case truncates nodes and edges."""
    g = j_syn.make_graph(1500, 12000, 6, n_classes=5, seed=3)
    js = j_sampler.NeighborSampler(g["src"], g["dst"], 1500, fanouts, seed=7)
    ts = t_sampler.NeighborSampler(g["src"], g["dst"], 1500, fanouts, seed=7)
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    np.testing.assert_array_equal(ts.nbr_src, js.nbr_src)
    for i in range(3):
        seeds = np.random.default_rng(i).choice(1500, 32, replace=False)
        a = js.sample(seeds, g["feats"], g["labels"], max_nodes, max_edges)
        b = ts.sample(seeds, g["feats"], g["labels"], max_nodes, max_edges)
        assert a.n_nodes == b.n_nodes
        for f in ("feats", "src", "dst", "edge_mask", "seed_local",
                  "labels"):
            x, y = getattr(b, f), getattr(a, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_generators_equal_jax():
    for kw in (dict(n_nodes=300, n_edges=2000, d_feat=5, n_classes=7,
                    seed=4),
               dict(n_nodes=100, n_edges=500, d_feat=3, seed=1,
                    power_law=False)):
        a, b = t_syn.make_graph(**kw), j_syn.make_graph(**kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a = t_syn.make_batched_molecules(5, 30, 64, d_feat=16, seed=2)
    b = j_syn.make_batched_molecules(5, 30, 64, d_feat=16, seed=2)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for args in ((4, 16, 512, 3), (1, 1, 7, 0)):
        for x, y in zip(t_syn.make_token_batch(*args),
                        j_syn.make_token_batch(*args)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
