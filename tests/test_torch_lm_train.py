"""Training the LM and GNN families on the port (``launch/train.py``'s
``lm_setup`` / ``gnn_setup``), gradient compression
(``train/compress.py``) and elastic remesh plans (``ft/elastic.py``)
against the JAX package on the CPU.

One AdamW step of each arch's smoke config at float32, from the JAX
launcher's own initial weights carried by ``tree_from_jax``, on the JAX
launcher's first batch: the loss at rtol 1e-5, the parameters after the
step at rtol 1e-5 with atol 1e-6 (a thousandth of the step: warmup off,
lr 1e-3, as ``tests/test_torch_recsys.py`` holds its step), the first
moments at rtol 1e-5 with an atol of 1e-6 of each leaf's largest entry
(2e-6 for the norm scales, see ``tests/test_torch_transformer.py``).
Entries whose JAX gradient is at most 1,000 x Adam's eps (1e-5) are held
at 2 x lr instead: Adam's first step is lr x g / (|g| + eps), whose slope
in g is lr x eps / (|g| + eps)^2, so a gradient held to 1e-6 of its
leaf's largest entry moves a step near eps anywhere below lr (measured:
one entry of Yi-9B's 16,384-entry table 1e-5 apart, one of its wo
entries 2.1e-6 apart). DeepSeek-V3's first moments go through
``tests/test_torch_deepseek.py``'s ``assert_grads_close`` with the
moments of the step from the port's float64 gradient as the referee: in
JAX's own run its float32 gradient lies further than 1e-6 of a leaf's
largest entry from that one (the numbers are in that file's docstring).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.ft import elastic as j_elastic  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro.train import compress as j_comp  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import trainer as j_trainer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.ft import elastic as t_elastic  # noqa: E402
from repro_torch.ft import remesh_plan  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.train import compress as t_comp  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainer as t_trainer  # noqa: E402
from repro_torch.tree import (flatten_with_paths, tree_from_jax,  # noqa: E402
                              tree_map, tree_to_numpy)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
GRAD_ATOL_OF_MAX, NORM_GRAD_ATOL_OF_MAX = 1e-6, 2e-6
STEP_LR, STEP_ATOL = 1e-3, 1e-6
NEAR_EPS = 1e-5             # |g| at or below: the step is anywhere in lr
ARCHS = ("yi-9b", "command-r-plus-104b", "starcoder2-3b",
         "granite-moe-3b-a800m", "deepseek-v3-671b", "gin-tu")


def _assert_tree_close(port_tree, jax_tree, atol=0.0, atol_of_max=0.0):
    got = flatten_with_paths(tree_to_numpy(port_tree))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                         jax_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        rel = NORM_GRAD_ATOL_OF_MAX if atol_of_max and "norm" in k \
            else atol_of_max
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=atol + rel * float(np.abs(w).max()),
            err_msg=k)


def _setups(name):
    """(jax params, loss, batch_fn; port loss, batch_fn) at float32."""
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg, tcfg = jarch.make_smoke_config(), tarch.make_smoke_config()
    if jarch.family == "lm":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
        jp, jl, jb = j_launch._lm_setup(jarch, jcfg, 4, 16)
        _, tl, tb = t_launch.lm_setup(tarch, tcfg, 4, 16, device="cpu")
    else:
        jp, jl, jb = j_launch._gnn_setup(jarch, jcfg)
        _, tl, tb = t_launch.gnn_setup(tarch, tcfg, device="cpu")
    return jp, jl, jb, tl, tb


@pytest.mark.parametrize("name", ARCHS)
def test_one_train_step_matches_jax(name):
    jp, jl, jb, tl, tb = _setups(name)
    tp = tree_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jbatch, tbatch = jb(0), tb(0)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(),
                                      np.asarray(jbatch[k]))
    kw = dict(lr=STEP_LR, warmup_steps=0, total_steps=10)
    jcfg_opt, tcfg_opt = j_opt.OptimizerConfig(**kw), t_opt.OptimizerConfig(
        **kw)
    jstep = j_trainer.make_train_step(jl, jcfg_opt, donate=False)
    tstep = t_trainer.make_train_step(tl, tcfg_opt)
    jnew, js, jm = jstep(jp, j_opt.adamw_init(jp, jcfg_opt), jbatch)
    tnew, ts, tm = tstep(tp, t_opt.adamw_init(tp, tcfg_opt), tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=RTOL)
    jgrads = jax.grad(jl)(jp, jbatch)
    got = flatten_with_paths(tree_to_numpy(tnew))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray, jnew))
    grads, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b), (_, g) in zip(got, want, grads):
        a, b, g = (np.reshape(x, -1) for x in (a, b, g))
        near = np.abs(g) <= NEAR_EPS
        np.testing.assert_allclose(a[~near], b[~near], rtol=RTOL,
                                   atol=STEP_ATOL, err_msg=k)
        np.testing.assert_allclose(a[near], b[near], rtol=0,
                                   atol=2 * STEP_LR, err_msg=k)
    if name != "deepseek-v3-671b":
        _assert_tree_close(ts.m, js.m, atol_of_max=GRAD_ATOL_OF_MAX)
        return
    from test_torch_deepseek import assert_grads_close, float64_grads
    arch = get_arch(name)
    cfg64 = dataclasses.replace(arch.make_smoke_config(), dtype=torch.float64)
    _, tl64, _ = t_launch.lm_setup(arch, cfg64, 4, 16, device="cpu")
    p64 = tree_map(lambda a: torch.tensor(a, dtype=torch.float64),
                   jax.tree_util.tree_map(np.asarray, jp))
    s64 = t_opt.adamw_init(p64, tcfg_opt)
    t_opt.adamw_update(p64, float64_grads(tl64, p64, tbatch), s64, tcfg_opt)
    assert_grads_close(ts.m, js.m, s64.m)


def test_bf16_clip_rounds_like_jax():
    """bf16 parameters (the LM smoke configs' dtype): the clipped gradient
    is rounded to bf16 before the update, as JAX's clip writes it."""
    r = np.random.default_rng(0)
    p = r.normal(size=(8, 8)).astype(np.float32)
    g = (30 * r.normal(size=(8, 8))).astype(np.float32)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    jg = {"w": jnp.asarray(g, jnp.bfloat16)}
    cfg_kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jnew, _, _ = j_opt.adamw_update(
        jp, jg, j_opt.adamw_init(jp, j_opt.OptimizerConfig(**cfg_kw)),
        j_opt.OptimizerConfig(**cfg_kw))
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    tg = {"w": torch.from_numpy(g).to(torch.bfloat16)}
    tcfg = t_opt.OptimizerConfig(**cfg_kw)
    t_opt.adamw_update(tp, tg, t_opt.adamw_init(tp, tcfg), tcfg)
    np.testing.assert_array_equal(
        tp["w"].to(torch.float32).numpy(),
        np.asarray(jnew["w"].astype(jnp.float32)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_trains_each_lm_and_gnn_arch(name):
    """``python -m repro_torch.launch.train --arch A`` at the smoke config
    as the JAX launcher runs it (the LM archs in bf16): the loss finite
    at the first and the last step."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", name,
         "--steps", "3", "--batch", "4", "--seq", "16", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [s for s in out.stdout.splitlines() if s.startswith("[train]")][-1]
    first, last = (float(w) for w in line.split("loss ")[1].split(" in ")[0]
                   .split(" -> "))
    assert np.isfinite(first) and np.isfinite(last), line


def test_launcher_trains_deepseek_in_process():
    """``main`` trains DeepSeek-V3's smoke config (MTP on) on the CPU, the
    last arch of the JAX launcher: the losses are finite and the MTP
    head's weights move."""
    tr = t_launch.main(["--arch", "deepseek-v3-671b", "--steps", "2",
                        "--batch", "2", "--seq", "8", "--device", "cpu"])
    assert len(tr.history) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    arch = get_arch("deepseek-v3-671b")
    init, _, _ = t_launch.lm_setup(arch, arch.make_smoke_config(), 2, 8,
                                   device="cpu")
    assert not torch.equal(tr.params["mtp"]["proj"], init["mtp"]["proj"])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _grads(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(6, 5)).astype(np.float32),
            "b": [r.normal(size=(7,)).astype(np.float32) * 3,
                  r.normal(size=(2, 3, 4)).astype(np.float32) * 1e-3]}


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return tree_from_jax(tree, "cpu")


def test_int8_quantize_dequantize_match_jax():
    for g in jax.tree_util.tree_leaves(_grads()):
        jq, js = j_comp.quantize_int8(jnp.asarray(g))
        tq, tscale = t_comp.quantize_int8(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(tscale), float(js), rtol=1e-7)
        np.testing.assert_allclose(
            t_comp.dequantize_int8(tq, tscale).numpy(),
            np.asarray(j_comp.dequantize_int8(jq, js)), rtol=1e-6)


def test_int8_error_feedback_matches_jax_and_sums():
    """Two steps of error feedback: the compressed trees and the errors
    equal JAX's, and decompressed + error = gradient + previous error (the
    sum identity of tests/test_train.py)."""
    g1, g2 = _grads(0), _grads(1)
    je = j_comp.init_error_state(_jt(g1))
    te = t_comp.init_error_state(_tt(g1))
    for g in (g1, g2):
        jc, je_new = j_comp.compress_int8_ef(_jt(g), je)
        tc, te_new = t_comp.compress_int8_ef(_tt(g), te)
        tdec = t_comp.decompress_int8(tc)
        jdec = j_comp.decompress_int8(jc)
        for (k, x), (_, y) in zip(flatten_with_paths(tree_to_numpy(tdec)),
                                  _flatten_with_paths(
                                      jax.tree_util.tree_map(np.asarray,
                                                             jdec))[0]):
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=k)
        _assert_tree_close(te_new, je_new, atol=1e-7)
        for d, e_new, gg, e in zip(*(flatten_with_paths(t) for t in (
                tdec, te_new, _tt(g), te))):
            np.testing.assert_allclose(
                (d[1] + e_new[1]).numpy(), (gg[1] + e[1]).numpy(),
                rtol=1e-6, atol=1e-7, err_msg=d[0])
        je, te = je_new, te_new


def test_topk_round_trip_and_error_feedback_match_jax():
    """Distinct |values|: top-k keeps the same entries as JAX (largest
    first); densify puts them back; the error-feedback trees equal
    JAX's."""
    g = _grads(2)
    for x in jax.tree_util.tree_leaves(g):
        jv, ji = j_comp.topk_sparsify(jnp.asarray(x), 0.3)
        tv, ti = t_comp.topk_sparsify(torch.from_numpy(x), 0.3)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        dense = t_comp.topk_densify(tv, ti, x.shape)
        np.testing.assert_array_equal(
            dense.numpy(), np.asarray(j_comp.topk_densify(jv, ji, x.shape)))
        kept = dense.numpy() != 0
        np.testing.assert_array_equal(dense.numpy()[kept], x[kept])
    jc, je = j_comp.topk_compress_ef(_jt(g), j_comp.init_error_state(_jt(g)),
                                     0.25)
    tc, te = t_comp.topk_compress_ef(_tt(g), t_comp.init_error_state(_tt(g)),
                                     0.25)
    _assert_tree_close(te, je)
    assert isinstance(tc["a"], tuple) and tc["a"][1].dtype == torch.int32


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def test_remesh_plan_and_transfer_bytes_equal_jax():
    assert remesh_plan is t_elastic.remesh_plan
    for n, old in ((256, (16, 16)), (240, (16, 16)), (96, (4, 8)),
                   (7, (2, 4)), (1, (1, 1)), (12, (3, 16)), (0, (4, 4))):
        a = t_elastic.remesh_plan(n, old)
        b = j_elastic.remesh_plan(n, old)
        assert (a is None) == (b is None), (n, old)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for pb, old, new in ((10**9, (16, 16), (8, 16)), (12345, (2, 2), (3, 1))):
        assert t_elastic.shard_transfer_bytes(pb, old, new) == \
            j_elastic.shard_transfer_bytes(pb, old, new)
