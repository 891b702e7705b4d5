"""The port's mesh path on 8 gloo CPU ranks, mesh (2, 4) ("data",
"model"), against the JAX package on 8 fake host devices.

One JAX subprocess (``--xla_force_host_platform_device_count=8``) draws
the inputs and gives the oracles: JAX's ``moe_ffn_ep`` and ``moe_ffn``
(the JAX ``tests/test_distributed.py`` setup: d 16, ff 32, 8 experts
top-2, x (4, 8, 16)) and its sharded and one-device ``lm_loss``. Then 8
rank processes start once, joined through one ``FileStore`` under
``tmp_path`` (no fixed port: the suite runs under xdist), take the same
inputs (``tree_from_jax``) and write what they measured; each test below
reads one claim of it:

- ``moe_ffn_ep`` (two ``dist.all_to_all_single`` over the EP group) =
  JAX's ``moe_ffn_ep`` within 2e-4, at a capacity that drops nothing and
  at 1.25 (the same per-rank drops), and = the port's one-process
  ``moe_ffn`` within 2e-4 where nothing is dropped (JAX's own bound);
- the sharded ``lm_loss`` = JAX's sharded loss and the one-process loss
  within 2e-3 (JAX's own bound);
- DeepSeek's smoke config (float32) with ``moe_impl="ep"`` and the
  launcher's EP override (experts over ("data", "model"), capacity
  unsharded) = the one-process forward within 1e-4 of the largest logit
  (nothing dropped);
- one AdamW step of the sharded transformer with ZeRO-1 moments
  (``zero1_spec_tree``: the moments' first replicated dim divisible by
  |data| sharded on data) = the one-process step: moments within rtol
  1e-4 and 1e-6 of each leaf's largest entry, params within 1e-7 of
  each leaf's largest entry plus 1e-8 (the step's learning rate is
  3e-6: a sign flip of a moment near zero moves a param by at most that);
- ``restore_checkpoint(shardings=)`` on the mesh = the saved tree, each
  leaf a DTensor in its sharding's placements.

The errors observed are printed (``-s``) and listed in ``CHANGES.md``.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 8

JAX_SCRIPT = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import moe as moe_lib
from repro.models import transformer as tf_lib
from repro.sharding import mesh_rules, shardings_for_tree

mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = mesh_rules(mesh)
out = {}
d, ff, E, K = 16, 32, 8, 2
p, _ = moe_lib.init_moe(jax.random.PRNGKey(0), n_layers=1, d_model=d,
                        d_ff=ff, n_experts=E, dtype=jnp.float32)
lp = jax.tree_util.tree_map(lambda a: a[0], p)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, d))
out["moe_p"] = jax.tree_util.tree_map(np.asarray, lp)
out["moe_x"] = np.asarray(x)
for cf in (100.0, 1.25):
    with mesh:
        ep = jax.jit(lambda lp, x: moe_lib.moe_ffn_ep(
            lp, x, n_experts=E, top_k=K, capacity_factor=cf,
            rules=rules))(lp, x)
    out[f"moe_ep_{cf}"] = np.asarray(ep)
out["moe_local"] = np.asarray(moe_lib.moe_ffn(
    lp, x, n_experts=E, top_k=K, capacity_factor=100.0, n_groups=1))

cfg = tf_lib.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                               n_kv_heads=2, d_ff=64, vocab_size=128,
                               head_dim=8, dtype=jnp.float32, remat=False)
params, axes = tf_lib.init_params(jax.random.PRNGKey(0), cfg)
toks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 128)
out["lm_params"] = jax.tree_util.tree_map(np.asarray, params)
out["toks"] = np.asarray(toks)
out["loss_local"] = float(tf_lib.lm_loss(params, toks, toks, cfg))
with mesh:
    psh = shardings_for_tree(axes, mesh, rules)
    out["loss_sharded"] = float(jax.jit(
        lambda p, t: tf_lib.lm_loss(p, t, t, cfg, rules),
        in_shardings=(psh, NamedSharding(mesh, P("data", None))),
    )(params, toks))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

RANK_SCRIPT = r"""
import dataclasses, json, os, pickle, sys
sys.path.insert(0, "src")
import numpy as np
import torch
import torch.distributed as dist

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(work, "store"), world), rank=rank, world_size=world)

from repro_torch import sharding as sh
from repro_torch.configs import get_arch
from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import deepseek as ds
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (AdamWState, OptimizerConfig,
                                         adamw_init)
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import flatten_with_paths, tree_from_jax, tree_map

with open(os.path.join(work, "jax.pkl"), "rb") as f:
    J = pickle.load(f)
mesh = make_test_mesh(2, 4, device="cpu")
rules = sh.mesh_rules(mesh)
res = {}


def whole(t):
    return t.full_tensor() if sh.is_dtensor(t) else t


def err(a, b):
    return float((whole(a).double() - torch.as_tensor(b).double())
                 .abs().max())


# ---- moe_ffn_ep ----------------------------------------------------------
mp = tree_from_jax(J["moe_p"], device="cpu")
_, maxes = moe_lib.init_moe(torch.Generator(), 1, 16, 32, 8,
                            dtype=torch.float32, device="meta")
maxes = {k: v[1:] for k, v in maxes.items()}
dmp = sh.distribute_tree(mp, sh.shardings_for_tree(maxes, mesh, rules))
x = torch.from_numpy(J["moe_x"])
dx = sh.distribute(x, sh.NamedSharding(mesh, rules.spec(
    ("batch", "act_seq", None))))
kw = dict(n_experts=8, top_k=2)
local = moe_lib.moe_ffn(mp, x, capacity_factor=100.0, n_groups=1, **kw)
for cf in (100.0, 1.25):
    ep = moe_lib.moe_ffn_ep(dmp, dx, capacity_factor=cf, rules=rules, **kw)
    res[f"moe_ep_vs_jax_{cf}"] = err(ep, J[f"moe_ep_{cf}"])
    res[f"moe_ep_placements_{cf}"] = str(tuple(ep.placements))
    if cf == 100.0:
        res["moe_ep_vs_port_local"] = err(ep, local)
res["moe_port_local_vs_jax_local"] = err(local, J["moe_local"])

# ---- sharded lm_loss -----------------------------------------------------
cfg = tf.TransformerConfig(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                           d_ff=64, vocab_size=128, head_dim=8,
                           dtype=torch.float32, remat=False)
lm = tree_from_jax(J["lm_params"], device="cpu")
_, axes = tf.init_params(torch.Generator(), cfg, device="meta")
toks = torch.from_numpy(J["toks"]).long()
psh = sh.shardings_for_tree(axes, mesh, rules)
tsh = sh.NamedSharding(mesh, sh.P("data", None))
dlm, dt = sh.distribute_tree(lm, psh), sh.distribute(toks, tsh)
loss = float(tf.lm_loss(dlm, dt, dt, cfg, rules).full_tensor())
loss_local = float(tf.lm_loss(lm, toks, toks, cfg))
res["loss_sharded"] = loss
res["loss_vs_jax_sharded"] = abs(loss - J["loss_sharded"])
res["loss_vs_jax_local"] = abs(loss - J["loss_local"])
res["loss_vs_port_local"] = abs(loss - loss_local)

# ---- DeepSeek, moe_impl="ep" under the EP override ------------------------
dcfg = dataclasses.replace(get_arch("deepseek-v3-671b").make_smoke_config(),
                           dtype=torch.float32, capacity_factor=100.0,
                           remat=False)
dp, daxes = ds.init_params(torch.Generator().manual_seed(0), dcfg,
                           device="cpu")
ep_rules = rules.with_overrides(experts=("data", "model"), capacity=None)
dtoks = torch.from_numpy(np.random.default_rng(0).integers(
    0, dcfg.vocab_size, (4, 8)))
want = ds.forward(dp, dtoks, dcfg)
ddp = sh.distribute_tree(dp, sh.shardings_for_tree(daxes, mesh, ep_rules))
ddt = sh.distribute(dtoks, tsh)
got = ds.forward(ddp, ddt, dataclasses.replace(dcfg, moe_impl="ep"),
                 ep_rules)
res["deepseek_ep_err"] = err(got, want)
res["deepseek_ep_max"] = float(want.abs().max())

# ---- one AdamW step with ZeRO-1 moments ------------------------------------
ocfg = OptimizerConfig(lr=3e-4)


def loss_fn(p, b):
    return tf.lm_loss(p, b, b, cfg, rules if sh.is_dtensor(b) else None)


plain = tree_map(lambda t: t.clone(), lm)
st = adamw_init(plain, ocfg)
make_train_step(loss_fn, ocfg)(plain, st, toks)
dps = sh.distribute_tree(tree_map(lambda t: t.clone(), lm), psh)
z1 = sh.zero1_spec_tree(lm, axes, mesh, rules)
zsh = tree_map(lambda s: sh.NamedSharding(mesh, s), z1,
               is_leaf=lambda s: isinstance(s, sh.P))
zeros = tree_map(torch.zeros_like, lm)
dst = AdamWState(step=torch.zeros((), dtype=torch.int32),
                 m=sh.distribute_tree(zeros, zsh),
                 v=sh.distribute_tree(tree_map(torch.zeros_like, lm), zsh))
make_train_step(loss_fn, ocfg)(dps, dst, dt)
worst = {"m": 0.0, "v": 0.0, "p": 0.0}
seen = {"m": 0.0, "v": 0.0, "p": 0.0}
sharded_moments = 0
for (k, a), (_, b), (_, ma), (_, mb), (_, va), (_, vb) in zip(
        flatten_with_paths(dps), flatten_with_paths(plain),
        flatten_with_paths(dst.m), flatten_with_paths(st.m),
        flatten_with_paths(dst.v), flatten_with_paths(st.v)):
    if tuple(ma.placements) != tuple(a.placements):
        sharded_moments += 1
    for name, x_, y_ in (("m", ma, mb), ("v", va, vb), ("p", a, b)):
        y_ = y_.double()
        scale = float(y_.abs().max()) or 1.0
        seen[name] = max(seen[name], float(
            (whole(x_).double() - y_).abs().max()) / scale)
        if name == "p":
            bad = float(((whole(x_).double() - y_).abs()
                         - (1e-7 * scale + 1e-8)).max())
        else:
            bad = float(((whole(x_).double() - y_).abs()
                         - (1e-4 * y_.abs() + 1e-6 * scale)).max())
        worst[name] = max(worst[name], bad)
res["zero1_excess"] = worst
res["zero1_err_of_max"] = seen
res["zero1_sharded_moments"] = sharded_moments
res["zero1_moment_placements"] = {
    k: str(tuple(v.placements)) for k, v in flatten_with_paths(dst.m)}

# ---- restore_checkpoint(shardings=) ----------------------------------------
ck = os.path.join(work, "ckpt")
if rank == 0:
    save_checkpoint(ck, 7, lm)
dist.barrier()
back = restore_checkpoint(ck, lm, device="cpu", shardings=psh)
ok, placed = True, True
for (k, a), (_, b), (_, s) in zip(
        flatten_with_paths(back), flatten_with_paths(lm),
        flatten_with_paths(psh, is_leaf=lambda x: hasattr(x, "spec"))):
    ok = ok and torch.equal(a.full_tensor(), b)
    placed = placed and tuple(a.placements) == s.placements(b.ndim)
res["restore_equal"] = bool(ok)
res["restore_placed"] = bool(placed)

dist.barrier()
if rank == 0:
    with open(os.path.join(work, "out.json"), "w") as f:
        json.dump(res, f, indent=1)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dist"))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    j = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                        os.path.join(work, "jax.pkl")], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert j.returncode == 0, j.stderr[-3000:]
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(textwrap.dedent(RANK_SCRIPT))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD),
                               work], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    with open(os.path.join(work, "out.json")) as f:
        res = json.load(f)
    with open(os.path.join(work, "jax.pkl"), "rb") as f:
        res["jax"] = {k: v for k, v in pickle.load(f).items()
                      if k.startswith("loss")}
    print("\n[distributed] " + json.dumps(
        {k: v for k, v in res.items() if k != "zero1_moment_placements"}))
    return res


@pytest.mark.parametrize("cf", ["100.0", "1.25"])
def test_moe_ffn_ep_matches_jax(measured, cf):
    assert measured[f"moe_ep_vs_jax_{cf}"] < 2e-4
    # x's layout: batch over data, seq over model
    assert measured[f"moe_ep_placements_{cf}"] == "(Shard(dim=0), " \
        "Shard(dim=1))"


def test_moe_ffn_ep_matches_port_moe_ffn(measured):
    assert measured["moe_ep_vs_port_local"] < 2e-4
    assert measured["moe_port_local_vs_jax_local"] < 2e-4


def test_sharded_lm_loss_matches_jax_and_one_process(measured):
    assert measured["loss_vs_jax_sharded"] < 2e-3
    assert measured["loss_vs_jax_local"] < 2e-3
    assert measured["loss_vs_port_local"] < 2e-3
    assert abs(measured["jax"]["loss_sharded"]
               - measured["jax"]["loss_local"]) < 2e-3


def test_deepseek_ep_forward_matches_one_process(measured):
    assert measured["deepseek_ep_err"] <= 1e-4 * measured["deepseek_ep_max"]


def test_zero1_adamw_step_matches_one_process(measured):
    ex = measured["zero1_excess"]
    assert ex["m"] <= 0 and ex["v"] <= 0 and ex["p"] <= 0, ex
    # the moments are sharded over data where the params are not
    assert measured["zero1_sharded_moments"] > 0


def test_restore_with_shardings_returns_the_saved_tree(measured):
    assert measured["restore_equal"]
    assert measured["restore_placed"]
