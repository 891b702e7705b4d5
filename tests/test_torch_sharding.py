"""The port's sharding system (``repro_torch/sharding.py``,
``launch/mesh.py``) against the JAX package's, in one process.

- Spec trees: for every registered architecture at its published config,
  the params' logical axes (and the LM caches') equal JAX's, and
  ``specs_for_tree`` under ``mesh_rules`` of a single-pod and a multi-pod
  mesh, and under the launcher's overrides, equals JAX's entry for entry.
  The port's meshes here are one-rank gloo meshes of the production axis
  names (``mesh_rules`` reads the names alone); JAX's are
  ``AbstractMesh``es.
- ``zero1_spec_tree`` on a (2, 4) mesh equals JAX's (both read only the
  mesh's axis names and sizes).
- ``rules=None`` = ``single_device_rules()`` = ``mesh_rules`` of a (1, 1)
  gloo mesh, bit for bit, for the transformer's ``forward`` / ``prefill``
  / ``decode_step`` (dense and MoE), DeepSeek's, DLRM's and GIN's: under
  the mesh the params and inputs are DTensors and every ``constrain``
  redistributes, the attention kernels' wrappers run through their
  DTensor sharding rules.
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import sharding as j_sh  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import deepseek as j_ds  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import sharding as t_sh  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import deepseek as t_ds  # noqa: E402
from repro_torch.models import gnn as t_gnn  # noqa: E402
from repro_torch.models import recsys as t_rec  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_leaves  # noqa: E402

ARCHS = list_archs()
J_MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
            "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
NAMES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
# the launcher's overrides (JAX launch/steps.py: fsdp, the EP override,
# shardnodes, repltable, the prefill and decode caches)
OVERRIDES = {"base": {}, "fsdp": {"embed": "data"},
             "ep": {"experts": ("data", "model"), "capacity": None},
             "kv_seq": {"kv_seq": "model"},
             "decode_b1": {"act_seq": None, "kv_seq": ("data", "model"),
                           "batch": None, "queries": None},
             "shardnodes": {"nodes": ("data",)},
             "repltable": {"table_rows": None}}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group for this module (a FileStore, no port)."""
    assert not dist.is_initialized()
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _port_mesh(kind):
    from torch.distributed.device_mesh import init_device_mesh
    names = NAMES[kind]
    return init_device_mesh("cpu", (1,) * len(names), mesh_dim_names=names)


def _port_axes(name):
    """(params on meta, axes) of the arch's published config."""
    arch = get_arch(name)
    if arch.family == "lm":
        mod = t_ds if name.startswith("deepseek") else t_tf
        return mod.init_params(torch.Generator(), arch.make_config(),
                               device="meta")
    if arch.family == "gnn":
        cfg = arch.make_config(arch.shapes[0])
        return t_gnn.init_params(torch.Generator(), cfg, device="meta")
    cfg = arch.make_config()
    init = {"dlrm-rm2": (t_rec.dlrm_init, t_rec.dlrm_axes),
            "dcn-v2": (t_rec.dcn_init, t_rec.dcn_axes),
            "bst": (t_rec.bst_init, t_rec.bst_axes),
            "bert4rec": (t_rec.bert4rec_init, t_rec.bert4rec_axes)}[name]
    return init[0](torch.Generator(), cfg, device="meta"), init[1](cfg)


def _jax_axes(name):
    arch = j_get_arch(name)
    if arch.family == "lm":
        mod = j_ds if name.startswith("deepseek") else j_tf
        return j_steps._abstract_init(mod.init_params, arch.make_config())
    if arch.family == "gnn":
        from repro.models import gnn as j_gnn
        return j_steps._abstract_init(j_gnn.init_params,
                                      arch.make_config(arch.shapes[0]))
    return j_steps._abstract_init(
        j_steps._recsys_init(arch, arch.make_config()), arch.make_config())


def _caches(name):
    """(port cache axes trees, JAX's) of an LM arch."""
    if name.startswith("deepseek"):
        return [t_ds.cache_axes()], [j_ds.cache_axes()]
    return ([t_tf.cache_axes(True), t_tf.cache_axes(False)],
            [j_tf.cache_axes(True), j_tf.cache_axes(False)])


def _port_specs(tree):
    return [(k, tuple(v)) for k, v in flatten_with_paths(
        tree, is_leaf=lambda x: isinstance(x, t_sh.P))]


def _jax_specs(tree):
    items, _ = _flatten_with_paths(tree)
    return [(k, tuple(v)) for k, v in items]


def _axes_items(tree):
    return flatten_with_paths(tree, is_leaf=t_sh._is_axes_leaf)


@pytest.mark.parametrize("name", ARCHS)
def test_axes_trees_match_jax(name):
    _, t_axes = _port_axes(name)
    _, j_axes = _jax_axes(name)
    got = [(k, tuple(v) if v is not None else None)
           for k, v in _axes_items(t_axes)]
    want = [(k, tuple(v) if v is not None else None)
            for k, v in _axes_items(j_axes)]
    assert got == want


@pytest.mark.parametrize("name", ARCHS)
def test_spec_trees_match_jax(group, name):
    _, t_axes = _port_axes(name)
    _, j_axes = _jax_axes(name)
    trees = [(t_axes, j_axes)]
    if get_arch(name).family == "lm":
        trees += list(zip(*_caches(name)))
    n = 0
    for kind in ("single", "multi"):
        t_rules = t_sh.mesh_rules(_port_mesh(kind))
        j_rules = j_sh.mesh_rules(J_MESHES[kind])
        assert dict(t_rules.table) == dict(j_rules.table)
        for over in OVERRIDES.values():
            tr, jr = (t_rules.with_overrides(**over),
                      j_rules.with_overrides(**over))
            for ta, ja in trees:
                got = _port_specs(t_sh.specs_for_tree(ta, tr))
                want = _jax_specs(j_sh.specs_for_tree(ja, jr))
                assert got == want, (kind, over)
                n += len(got)
    assert n > 0
    # one rule's spec, entry for entry
    assert tuple(t_sh.single_device_rules().spec(("batch", None))) == \
        tuple(j_sh.single_device_rules().spec(("batch", None)))


@pytest.mark.parametrize("name", ARCHS)
def test_zero1_spec_tree_matches_jax(name):
    """ZeRO-1 moment specs on a (2, 4) mesh: the param's spec plus the
    largest replicated dim divisible by |data| sharded on data."""
    t_params, t_axes = _port_axes(name)
    j_params, j_axes = _jax_axes(name)
    jm = AbstractMesh((2, 4), ("data", "model"))
    tm = types.SimpleNamespace(shape={"data": 2, "model": 4},
                               axis_names=("data", "model"))
    rules = t_sh.ShardingRules(dict(j_sh.mesh_rules(jm).table))
    got = _port_specs(t_sh.zero1_spec_tree(t_params, t_axes, tm, rules))
    want = _jax_specs(j_sh.zero1_spec_tree(j_params, j_axes, jm,
                                           j_sh.mesh_rules(jm)))
    assert got == want
    assert any("data" in str(s) for _, s in got)


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in ((("data",), None), ((), "model"),
                    (("pod", "data"), None, "model"), ()):
        assert tuple(t_sh.P(*entries)) == tuple(JP(*entries))


def test_placements_and_shard_shape(group):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh("multi")
    spec = t_sh.P(("pod", "data"), None, "model")
    assert t_sh.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert t_sh.placements(t_sh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        t_sh.placements(t_sh.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="used twice"):
        t_sh.placements(t_sh.P("data", "data"), mesh)
    assert t_sh.NamedSharding(mesh, spec).shard_shape((6, 3, 5)) == (6, 3, 5)


def test_meshes_refuse_the_wrong_world(group):
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        t_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        t_mesh.make_production_mesh(multi_pod=True, device="cpu")
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert t_mesh.batch_axis_size(mesh) == 1
    assert t_mesh.batch_axis_size(_port_mesh("multi")) == 1


# ---------------------------------------------------------------------------
# rules=None = single_device_rules() = mesh_rules(1 x 1), bit for bit
# ---------------------------------------------------------------------------

def _mesh_args(mesh, params, axes, inputs):
    """Params placed by their shardings, inputs (tensor, logical axes)
    distributed by the mesh rules."""
    rules = t_sh.mesh_rules(mesh)
    dp = t_sh.distribute_tree(params, t_sh.shardings_for_tree(axes, mesh,
                                                              rules))
    di = [t_sh.distribute(x, t_sh.NamedSharding(mesh, rules.spec(ax)))
          if ax is not None else x for x, ax in inputs]
    return rules, dp, di


def _whole(x):
    return x.full_tensor() if t_sh.is_dtensor(x) else x


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _whole(x), _whole(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _three_ways(run, params, axes, inputs, mesh):
    """run(params, inputs, rules) under rules=None, single_device_rules()
    and the (1, 1) mesh's rules: the three results, equal bit for bit."""
    plain = [x for x, _ in inputs]
    want = run(params, plain, None)
    _equal(want, run(params, plain, t_sh.single_device_rules()))
    rules, dp, di = _mesh_args(mesh, params, axes, inputs)
    got = run(dp, di, rules)
    assert any(t_sh.is_dtensor(t) for t in tree_leaves(got))
    _equal(want, got)
    return want


@pytest.mark.parametrize("name", ["yi-9b", "granite-moe-3b-a800m"])
def test_transformer_mesh_rules_bit_for_bit(group, name):
    cfg = dataclasses.replace(get_arch(name).make_smoke_config(),
                              dtype=torch.float32, capacity_factor=8.0)
    params, axes = t_tf.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    _three_ways(lambda p, i, r: t_tf.forward(p, i[0], cfg, r), params, axes,
                [(toks, ("batch", None))], mesh)
    logits, cache = _three_ways(
        lambda p, i, r: t_tf.prefill(p, i[0], cfg, r), params, axes,
        [(toks, ("batch", None))], mesh)
    dec_rules_axes = t_tf.cache_axes()
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2,)))

    def decode(p, i, r):
        c = {k: (v.clone() if not t_sh.is_dtensor(v) else v)
             for k, v in i[0].items()}
        out = None
        for step in range(3):
            out, c = t_tf.decode_step(p, c, i[1], torch.tensor(5 + step), cfg,
                                      r)
        return out, c

    full = {k: torch.cat([v, torch.zeros_like(v)], dim=2)
            for k, v in cache.items()}
    rules = t_sh.mesh_rules(mesh).with_overrides(act_seq=None,
                                                 kv_seq="model")
    want = decode(params, [{k: v.clone() for k, v in full.items()}, nxt],
                  None)
    dp = t_sh.distribute_tree(params, t_sh.shardings_for_tree(axes, mesh,
                                                              rules))
    dc = t_sh.distribute_tree(
        {k: v.clone() for k, v in full.items()},
        t_sh.shardings_for_tree(dec_rules_axes, mesh, rules))
    dn = t_sh.distribute(nxt, t_sh.NamedSharding(mesh, rules.spec(
        ("batch",))))
    got = decode(dp, [dc, dn], rules)
    _equal(want, got)


def test_deepseek_mesh_rules_bit_for_bit(group):
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b")
                              .make_smoke_config(), dtype=torch.float32,
                              capacity_factor=8.0)
    params, axes = t_ds.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    _three_ways(lambda p, i, r: t_ds.forward(p, i[0], cfg, r), params, axes,
                [(toks, ("batch", None))], mesh)
    _, cache = _three_ways(lambda p, i, r: t_ds.prefill(p, i[0], cfg, r),
                           params, axes, [(toks, ("batch", None))], mesh)
    full = {k: torch.cat([v, torch.zeros_like(v)], dim=2)
            for k, v in cache.items()}
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2,)))

    def decode(p, i, r):
        out, c = None, i[0]
        for step in range(2):
            out, c = t_ds.decode_step(p, c, i[1], torch.tensor(8 + step), cfg,
                                      r)
        return out, c

    want = decode(params, [{k: v.clone() for k, v in full.items()}, nxt],
                  None)
    rules = t_sh.mesh_rules(mesh).with_overrides(act_seq=None,
                                                 kv_seq="model")
    dp = t_sh.distribute_tree(params, t_sh.shardings_for_tree(axes, mesh,
                                                              rules))
    dc = t_sh.distribute_tree({k: v.clone() for k, v in full.items()},
                              t_sh.shardings_for_tree(t_ds.cache_axes(),
                                                      mesh, rules))
    _equal(want, decode(dp, [dc, nxt], rules))


def test_dlrm_and_gin_mesh_rules_bit_for_bit(group):
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    rng = np.random.default_rng(2)
    cfg = get_arch("dlrm-rm2").make_smoke_config()
    params = t_rec.dlrm_init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    dense = torch.from_numpy(rng.standard_normal((8, cfg.n_dense))
                             .astype(np.float32))
    sparse = torch.from_numpy(rng.integers(0, 50, (8, cfg.n_sparse)))
    _three_ways(lambda p, i, r: t_rec.dlrm_forward(p, i[0], i[1], cfg, r),
                params, t_rec.dlrm_axes(cfg),
                [(dense, ("batch", None)), (sparse, ("batch", None))], mesh)

    gcfg = get_arch("gin-tu").make_smoke_config()
    gp, gaxes = t_gnn.init_params(torch.Generator().manual_seed(0), gcfg,
                                  device="cpu")
    n, e = 12, 40
    feats = torch.from_numpy(rng.standard_normal((n, gcfg.d_in))
                             .astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n, (e,)))
    dst = torch.from_numpy(rng.integers(0, n, (e,)))
    _three_ways(lambda p, i, r: t_gnn.forward(p, i[0], i[1], i[2], gcfg,
                                              rules=r),
                gp, gaxes, [(feats, None), (src, ("edges",)),
                            (dst, ("edges",))], mesh)
