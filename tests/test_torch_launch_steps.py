"""The port's step builders (``launch/steps.py``) against the JAX package's
on a one-device mesh (``make_test_mesh(1, 1)``), on the CPU.

- Every cell of the matrix (the 40 registry cells and the two
  ``guitar-serve`` cells) in the base variant, and ``microbatch2`` on the
  LM train cells, ``w8`` on the dense decode cells, ``bf16`` /
  ``bf16model`` on the GIN cells, the sharding-only variants: the same
  ``static_meta`` (``model_flops`` at rtol 1e-12), the same donated
  arguments, and the abstract argument trees leaf for leaf (path, shape,
  dtype): DeepSeek's bf16 moments, the caches, the padded edge and
  candidate counts.
- One cell of each kind at a small size (the archs' smoke configs at
  float32, GIN's molecule at its own), the same weights and inputs drawn
  from a seed with numpy for both (the weights carried by
  ``tree_from_jax``), the
  port's step against JAX's ``job.step_fn``: forwards, caches and scores at
  rtol 1e-5 with an atol of 1e-6 of the largest entry (1e-7 and 1e-6
  absolute for the recsys forward and candidate scores; the decode step
  over the builders' bf16 cache at rtol 2e-2 with an atol of 2e-2 of the
  largest entry, the bf16 rule), as
  ``tests/test_torch_{transformer,recsys,gnn}.py`` hold them; a train step's loss at rtol 1e-5, its first moments (0.1 x
  the gradients) at rtol 1e-5 with an atol of 1e-6 of each leaf's largest
  entry (2e-6 for the norm scales), the parameters within 2 x the step's
  learning rate (Adam's first step moves an entry whose gradient is near
  eps anywhere in +-lr; see ``tests/test_torch_lm_train.py``).
- The ``guitar`` and ``sl2g`` cells at N = 2,000 and Q = 64 (the port's
  measure bundle, JAX's ``make_sharded_search`` with ``meta=None``, as its
  builder passes): recall@10 within 0.01 of JAX's, counters sane.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.core import brute_force_topk as j_brute_force_topk  # noqa: E402
from repro.core import deepfm_measure as j_deepfm_measure  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import deepfm as j_deepfm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.graph.build import build_l2_graph  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import (flatten_with_paths, tree_from_jax,  # noqa: E402
                              tree_to_numpy, tree_unflatten)

RTOL, ATOL_OF_MAX = 1e-5, 1e-6
NORM_ATOL_OF_MAX = 2e-6
BF16_TOL = 2e-2
# the recsys forwards' and candidate scores' absolute atol
# (tests/test_torch_recsys.py)
SCORE_ATOL = {"serve": 1e-7, "retrieval": 1e-6}
RECALL_AGREE = 0.01

LM = ("yi-9b", "command-r-plus-104b", "starcoder2-3b",
      "granite-moe-3b-a800m", "deepseek-v3-671b")
DENSE = ("yi-9b", "command-r-plus-104b", "starcoder2-3b")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
VARIANTS = ([(a, "train_4k", "microbatch2") for a in LM]
            + [(a, s, "w8") for a in DENSE
               for s in ("decode_32k", "long_500k")]
            + [("gin-tu", s, v) for s in GNN_SHAPES
               for v in ("bf16", "bf16model")]
            # sharding-only variants: nothing changes on one card
            + [("yi-9b", "train_4k", "fsdp"),
               ("gin-tu", "ogb_products", "shardnodes"),
               ("dlrm-rm2", "retrieval_cand", "repltable")])


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh(1, 1)


def _leaves_port(tree):
    return [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flatten_with_paths(tree)]


def _leaves_jax(tree):
    return [(k, tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _flatten_with_paths(tree)[0]]


def _assert_same_cell(port, jaxjob):
    assert port.name == jaxjob.name
    assert port.donate == jaxjob.donate
    assert set(port.static_meta) == set(jaxjob.static_meta)
    for k, v in jaxjob.static_meta.items():
        if k == "model_flops":
            np.testing.assert_allclose(port.static_meta[k], v, rtol=1e-12)
        else:
            assert port.static_meta[k] == v, k
    assert all(t.device.type == "meta"
               for _, t in flatten_with_paths(port.args))
    assert _leaves_port(port.args) == _leaves_jax(jaxjob.args)


@pytest.mark.parametrize("cell", steps.list_cells(),
                         ids=lambda c: f"{c[0]}:{c[1]}")
def test_cell_matches_jax(mesh, cell):
    arch, shape = cell
    _assert_same_cell(steps.build_job(arch, shape),
                      j_steps.build_job(arch, shape, mesh))


@pytest.mark.parametrize("cell", VARIANTS,
                         ids=lambda c: f"{c[0]}:{c[1]}:{c[2]}")
def test_variant_matches_jax(mesh, cell):
    arch, shape, variant = cell
    port = steps.build_job(arch, shape, variant)
    _assert_same_cell(port, j_steps.build_job(arch, shape, mesh, variant))
    base = steps.build_job(arch, shape)
    if variant in ("fsdp", "shardnodes", "repltable"):
        assert port.static_meta == base.static_meta
        assert _leaves_port(port.args) == _leaves_port(base.args)
    if variant == "w8":
        assert port.args[0]["layers"]["attn"]["wq"].dtype \
            == torch.float8_e4m3fn


def test_cell_list_is_the_jax_matrix():
    cells = steps.list_cells()
    want = [(a, s.name) for a in j_list_archs()
            for s in j_get_arch(a).shapes]
    assert cells[:-2] == want and len(cells) == 42
    assert cells[-2:] == [("guitar-serve", "guitar"),
                          ("guitar-serve", "sl2g")]


# ---------------------------------------------------------------------------
# one step of each kind at a small size, against JAX's step_fn


def _draw_np(spec, shape, dtype, rng):
    """numpy counterpart of ``steps._draw`` (``materialize``'s rules)."""
    kind = spec[0] if spec else ("normal" if dtype in (
        "float32", "bfloat16") else "zeros")
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "zeros":
        return np.zeros(shape, np.float32 if dtype != "int32" else np.int32)
    if kind == "value":
        return np.full(shape, spec[1], np.int64)
    if kind == "int":
        return rng.integers(spec[1], spec[2], shape)
    if kind == "ranges":
        lo, hi = np.asarray(spec[1]), np.asarray(spec[2])
        return lo + (rng.random(shape) * (hi - lo)).astype(np.int64)
    if kind == "mask":
        return (rng.random(shape) < 0.5).astype(np.float32)
    if kind == "prefix":
        return (np.arange(shape[0]) < spec[1]).astype(np.float32)
    if kind == "edges":
        ids = rng.integers(0, spec[1], shape)
        return np.where(np.arange(shape[0]) < spec[2], ids, 0)
    if kind == "blocks":
        return np.arange(shape[0]) // spec[1]
    raise ValueError(spec)


def _inputs(job, seed):
    """Numpy leaves of every argument but the params (args[1:]), in the
    port's tree order, with their dtype names."""
    rng = np.random.default_rng(seed)
    out = []
    for i, arg in enumerate(job.args[1:]):
        leaves = []
        for p, leaf in flatten_with_paths(arg):
            path = f"{i + 1}/{p}" if p else f"{i + 1}"
            dt = str(leaf.dtype).replace("torch.", "")
            a = _draw_np(steps.input_spec(job, path), tuple(leaf.shape), dt,
                         rng)
            leaves.append((a, dt))
        out.append(leaves)
    return out


def _to_port(job, leaves):
    conv = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}
    return tuple(tree_unflatten(arg, [torch.from_numpy(np.asarray(
        a, np.float32 if dt != "int32" else np.int64)).to(conv[dt])
        for a, dt in lv]) for arg, lv in zip(job.args[1:], leaves))


def _to_jax(jaxjob, leaves):
    conv = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "int32": jnp.int32}
    outs = []
    for arg, lv in zip(jaxjob.args[1:], leaves):
        flat, tdef = jax.tree_util.tree_flatten(arg)
        assert len(flat) == len(lv)
        outs.append(jax.tree_util.tree_unflatten(
            tdef, [jnp.asarray(np.asarray(a), conv[dt]) for a, dt in lv]))
    return tuple(outs)


def _pair_archs(name):
    ja, ta = j_get_arch(name), get_arch(name)
    jsm, tsm = ja.make_smoke_config, ta.make_smoke_config

    def jmake(*a):
        cfg = jsm()
        return dataclasses.replace(cfg, dtype=jnp.float32) \
            if hasattr(cfg, "dtype") and ja.family == "lm" else cfg

    def tmake(*a):
        cfg = tsm()
        return dataclasses.replace(cfg, dtype=torch.float32) \
            if hasattr(cfg, "dtype") and ta.family == "lm" else cfg
    return (dataclasses.replace(ja, make_config=jmake),
            dataclasses.replace(ta, make_config=tmake))


def _close(got, want, atol_of_max=ATOL_OF_MAX, atol=0.0, err_msg=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=atol + atol_of_max * float(np.abs(want).max()), err_msg=err_msg)


def _tree_close(port, jtree, atol_of_max=ATOL_OF_MAX, atol=0.0):
    got = flatten_with_paths(tree_to_numpy(port))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray, jtree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        rel = NORM_ATOL_OF_MAX if "norm" in k else atol_of_max
        _close(g, w, atol_of_max=rel, atol=atol, err_msg=k)


# kind -> (arch, small shape; None: the arch's own shape): one cell of
# each kind
KINDS = {
    "train": ("yi-9b", JShapeSpec("train_s", "train",
                                  {"seq": 32, "batch": 4})),
    "train-gnn": ("gin-tu", None),
    "prefill": ("yi-9b", JShapeSpec("prefill_s", "prefill",
                                    {"seq": 32, "batch": 2})),
    "decode": ("yi-9b", JShapeSpec("decode_s", "decode",
                                   {"seq": 32, "batch": 2})),
    "serve": ("dlrm-rm2", JShapeSpec("serve_s", "serve", {"batch": 8})),
    "retrieval": ("bert4rec", JShapeSpec(
        "retrieval_s", "retrieval", {"batch": 1, "n_candidates": 1000})),
}


def _weights(jaxjob, seed):
    """Weights in the JAX job's params tree drawn with numpy: matrices
    N(0, 1/fan_in), norm scales 1, other vectors and scalars 0."""
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jaxjob.args[0])
    leaves = []
    for path, sds in flat:
        key = jax.tree_util.keystr(path)
        if len(sds.shape) >= 2:
            a = rng.standard_normal(sds.shape) / np.sqrt(sds.shape[-2])
        elif "norm" in key or "ln" in key:
            a = np.ones(sds.shape)
        else:
            a = np.zeros(sds.shape)
        leaves.append(a.astype(np.float32))
    return jax.tree_util.tree_unflatten(tdef, leaves)


def _build_pair(mesh, kind):
    name, jshape = KINDS[kind]
    if jshape is None:                      # GIN's molecule, its own size
        ja, ta = j_get_arch(name), get_arch(name)
        jjob = j_steps.build_gnn_job(ja, ja.shape("molecule"), mesh)
        tjob = steps.build_gnn_job(ta, ta.shape("molecule"))
        return jjob, tjob
    ja, ta = _pair_archs(name)
    tshape = ShapeSpec(jshape.name, jshape.kind, dict(jshape.dims))
    builder = {"lm": (j_steps.build_lm_job, steps.build_lm_job),
               "recsys": (j_steps.build_recsys_job, steps.build_recsys_job)}
    jb, tb = builder[ja.family]
    return jb(ja, jshape, mesh), tb(ta, tshape)


@pytest.mark.parametrize("kind", list(KINDS))
def test_small_step_matches_jax(mesh, kind):
    jjob, tjob = _build_pair(mesh, kind)
    assert _leaves_port(tjob.args) == _leaves_jax(jjob.args)
    np_params = _weights(jjob, seed=4)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = tree_from_jax(np_params, device="cpu")
    leaves = _inputs(tjob, seed=5)
    jargs = (jparams,) + _to_jax(jjob, leaves)
    targs = (tparams,) + _to_port(tjob, leaves)
    with mesh:
        jout = jax.jit(jjob.step_fn)(*jargs)
    tout = tjob.step_fn(*targs)
    k = tjob.static_meta["kind"]
    if k == "train":
        _close(tout[2]["loss"], jout[2]["loss"], atol_of_max=0.0)
        _tree_close(tout[1].m, jout[1].m)
        lr = float(np.asarray(jout[2]["lr"]))
        _tree_close(tout[0], jout[0], atol_of_max=0.0, atol=2 * lr)
        assert int(tout[1].step) == int(jout[1].step) == 1
    elif k == "prefill":
        _close(tout[0], jout[0])
        for c in ("k", "v"):
            _close(tout[1][c], jout[1][c])
    elif k == "decode":
        # the cache is bf16 (both builders' init_cache): JAX rounds the
        # probabilities and the attention output to it, the port's decode
        # kernel keeps them in float32 (the bf16 rule of
        # tests/test_torch_transformer.py)
        for got, want in ((tout[0], jout[0]), (tout[1]["k"], jout[1]["k"]),
                          (tout[1]["v"], jout[1]["v"])):
            w = np.asarray(jnp.asarray(want, jnp.float32))
            np.testing.assert_allclose(
                got.float().numpy(), w, rtol=BF16_TOL,
                atol=BF16_TOL * float(np.abs(w).max()))
    else:
        _close(tout, jout, atol_of_max=0.0, atol=SCORE_ATOL[k])


# ---------------------------------------------------------------------------
# the guitar-serve cells against JAX's make_sharded_search

N_ITEMS, N_Q = 2000, 64


@pytest.fixture(scope="module")
def serve_system():
    rng = np.random.default_rng(11)
    base = rng.standard_normal((N_ITEMS, 40)).astype(np.float32)
    queries = rng.standard_normal((N_Q, 40)).astype(np.float32)
    # the port's build: the JAX build's arrays (tests/test_torch_graph.py)
    g = build_l2_graph(base, m=24, k_construction=100, seed=0, device="cpu")
    nbrs = np.full((N_ITEMS, 48), -1, np.int32)
    nbrs[:, :g.neighbors.shape[1]] = g.neighbors
    from repro.configs.guitar_deepfm import measure_config
    mcfg = measure_config()
    jparams = j_deepfm.init_measure(jax.random.PRNGKey(3), mcfg)[0]
    truth, _ = j_brute_force_topk(j_deepfm_measure(jparams, mcfg),
                                  jnp.asarray(base), jnp.asarray(queries), 10)
    truth = np.asarray(truth)
    arrays = (base[None], nbrs[None], np.array([g.entry], np.int32),
              np.arange(N_ITEMS, dtype=np.int32)[None], queries)
    return dict(jparams=jparams, arrays=arrays, truth=truth)


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(i) & set(t)) / 10
                          for i, t in zip(ids, truth)]))


@pytest.mark.parametrize("mode", ["guitar", "sl2g"])
def test_guitar_serve_cell_recall_matches_jax(mesh, serve_system, mode):
    jjob = j_steps.build_guitar_serve_job(mesh, variant=mode,
                                          n_items=N_ITEMS, n_queries=N_Q)
    tjob = steps.build_guitar_serve_job(variant=mode, n_items=N_ITEMS,
                                        n_queries=N_Q)
    _assert_same_cell(tjob, jjob)
    s = serve_system
    with mesh:
        jres = jjob.step_fn(s["jparams"], *map(jnp.asarray, s["arrays"]))
    tparams = tree_from_jax(jax.tree_util.tree_map(np.asarray, s["jparams"]),
                            device="cpu")
    tres = tjob.step_fn(tparams, *map(torch.from_numpy, s["arrays"]))
    r_j, r_t = _recall(jres.ids, s["truth"]), _recall(tres.ids, s["truth"])
    assert abs(r_j - r_t) <= RECALL_AGREE, (r_j, r_t)
    assert r_t > 0.5
    n_iters = tres.n_iters.numpy()
    assert (n_iters >= 1).all() and (n_iters <= 4 * 64).all()
    if mode == "guitar":
        assert (tres.n_grad.numpy() == n_iters).all()
        assert (tres.n_eval.numpy() <= 1 + 8 * n_iters).all()
    else:
        assert (tres.n_grad.numpy() == 0).all()
        assert (tres.n_eval.numpy() <= 1 + 48 * n_iters).all()
    ids = tres.ids
    assert ((ids >= 0) & (ids < N_ITEMS)).all()
    # a second batch reuses the placed shards and the captured programs
    again = tjob.step_fn(tparams, *map(torch.from_numpy, s["arrays"]))
    assert torch.equal(again.ids, tres.ids)


def test_materialize_draws_within_range():
    """Real arguments on the CPU: ids below their tables (per Criteo
    field), padded edges at node 0 under a 0 mask, the decode position at
    the cache's last slot, moments at zero; the same seed draws the same
    arguments."""
    ta = get_arch("dlrm-rm2")
    small = dataclasses.replace(ta, make_config=ta.make_smoke_config)
    job = steps.build_recsys_job(small, ShapeSpec("t", "train",
                                                  {"batch": 64}))
    args = steps.materialize(job, "cpu", seed=3)
    cards = torch.tensor(small.make_config().cardinalities)
    sp = args[2]["sparse"]
    assert sp.dtype == torch.int32 and (sp >= 0).all() and (sp < cards).all()
    assert set(args[2]["labels"].unique().tolist()) <= {0.0, 1.0}
    assert all(float(t.abs().sum()) == 0
               for _, t in flatten_with_paths(args[1]))
    again = steps.materialize(job, "cpu", seed=3)
    for (_, a), (_, b) in zip(flatten_with_paths(args),
                              flatten_with_paths(again)):
        assert torch.equal(a, b)
    gin = get_arch("gin-tu")
    gjob = steps.build_gnn_job(gin, gin.shape("full_graph_sm"))
    g = steps.materialize(gjob, "cpu", seed=0)[2]
    n_real = gin.shape("full_graph_sm")["n_edges"]
    assert g["src"].shape[0] == steps._pad_count(n_real)
    assert (g["edge_mask"][:n_real] == 1).all() \
        and (g["edge_mask"][n_real:] == 0).all()
    assert (g["src"][n_real:] == 0).all() and (g["src"] < 2708).all()
    ya = get_arch("yi-9b")
    yjob = steps.build_lm_job(
        dataclasses.replace(ya, make_config=ya.make_smoke_config),
        ShapeSpec("d", "decode", {"seq": 16, "batch": 2}))
    _, cache, tok, pos = steps.materialize(yjob, "cpu", seed=0)
    assert int(pos) == 15 and pos.dtype == torch.int32 and pos.dim() == 0
    assert (tok < ya.make_smoke_config().vocab_size).all()
    assert cache["k"].dtype == torch.bfloat16
