"""The port's training substrate against the JAX package on the CPU: AdamW,
its schedule and clip, microbatching, the trainer's convergence and
restart, checkpoints read and written by either package, the parameter
tree paths, and the synthetic data and batching pipeline.

Tolerances: the optimizer, schedule and clip at rtol 1e-6 (float32 on
both sides, the same operations in the same order). Only the global
norm's summation order differs: it moves the clip scale by an ulp, and so
every update by about lr * 1e-7 a step, which on a parameter near zero is
no relative error at all; parameters and moments are also given atol
1e-7 (two ulps of a unit value). Checkpoints bit for bit; data byte for
byte.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.ft import checkpoint as j_ckpt  # noqa: E402
from repro.models import deepfm as j_deepfm  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import trainer as j_trainer  # noqa: E402
from repro_torch.data import pipeline as t_pipeline  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.ft import checkpoint as t_ckpt  # noqa: E402
from repro_torch.models import deepfm as t_deepfm  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainer as t_trainer  # noqa: E402
from repro_torch.tree import (flatten_with_paths, tree_from_jax,  # noqa: E402
                              tree_to_numpy)

RTOL, ATOL = 1e-6, 1e-7


def _np_tree(seed, scale=1.0):
    """Matrices, vectors and a table (ndim >= 2 decays, vectors do not)."""
    r = np.random.default_rng(seed)

    def a(*s):
        return (scale * r.normal(size=s)).astype(np.float32)

    return {"table": a(50, 8), "scale": a(8),
            "mlp": {"w": [a(8, 16), a(16, 1)], "b": [a(16), a(1)]}}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(port_tree, jax_tree, rtol=RTOL, atol=ATOL):
    got = flatten_with_paths(tree_to_numpy(port_tree))
    want, _ = j_ckpt._flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jax_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 130])
def test_schedule_matches_jax(step):
    """Steps 0, inside the warmup, its end, mid-cosine, total and past it."""
    cfg = t_opt.OptimizerConfig(lr=0.3, warmup_steps=10, total_steps=100)
    jcfg = j_opt.OptimizerConfig(lr=0.3, warmup_steps=10, total_steps=100)
    got = float(t_opt.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                      cfg))
    want = float(j_opt.cosine_schedule(jnp.int32(step), jcfg))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_clip_matches_jax():
    g = _np_tree(1, scale=3.0)
    got, gnorm = t_opt.clip_by_global_norm(tree_from_jax(g, "cpu"), 1.0)
    want, jnorm = j_opt.clip_by_global_norm(_j(g), 1.0)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=RTOL)
    _close(got, want)
    # below the threshold nothing changes
    got, _ = t_opt.clip_by_global_norm(tree_from_jax(g, "cpu"), 1e6)
    _close(got, _j(g), rtol=0, atol=0)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.1), (1.0, 0.0)])
def test_adamw_matches_jax(clip, wd):
    """Five steps on a tree of matrices, vectors and a table whose rows
    mostly get no gradient (the dense update still decays them): params,
    both moments, the step and the metrics at rtol 1e-6."""
    kw = dict(lr=0.05, betas=(0.9, 0.95), weight_decay=wd, grad_clip=clip,
              warmup_steps=2, total_steps=8)
    cfg, jcfg = t_opt.OptimizerConfig(**kw), j_opt.OptimizerConfig(**kw)
    p0 = _np_tree(0)
    tp = tree_from_jax(p0, "cpu")
    jp = _j(p0)
    ts, js = t_opt.adamw_init(tp, cfg), j_opt.adamw_init(jp, jcfg)
    for s in range(5):
        g = _np_tree(10 + s, scale=2.0)
        g["table"][5:] = 0.0                  # rows with no gradient
        tp, ts, tm = t_opt.adamw_update(tp, tree_from_jax(g, "cpu"), ts, cfg)
        jp, js, jm = j_opt.adamw_update(jp, _j(g), js, jcfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    assert int(ts.step) == int(js.step) == 5
    _close(tp, jp)
    _close(ts.m, js.m)
    _close(ts.v, js.v)
    if wd > 0:   # the untouched table rows decayed, the vectors' did not
        assert not np.allclose(tp["table"][5:].detach().numpy(),
                               p0["table"][5:])


def test_adamw_chunked_update_equals_whole(monkeypatch):
    """A leaf larger than CHUNK is updated chunk by chunk to the same bits."""
    cfg = t_opt.OptimizerConfig(lr=0.05, warmup_steps=0, total_steps=10,
                                grad_clip=0.0)
    p0, g = _np_tree(0), _np_tree(1)
    whole = tree_from_jax(p0, "cpu")
    t_opt.adamw_update(whole, tree_from_jax(g, "cpu"),
                       t_opt.adamw_init(whole, cfg), cfg)
    monkeypatch.setattr(t_opt, "CHUNK", 7)
    chunked = tree_from_jax(p0, "cpu")
    t_opt.adamw_update(chunked, tree_from_jax(g, "cpu"),
                       t_opt.adamw_init(chunked, cfg), cfg)
    for (k, a), (_, b) in zip(flatten_with_paths(tree_to_numpy(whole)),
                              flatten_with_paths(tree_to_numpy(chunked))):
        np.testing.assert_array_equal(a, b, err_msg=k)


def _mse(p, b):
    return torch.mean((p["w"][None, :] - b["target"]) ** 2)


def test_microbatch_equivalence():
    """n_microbatches=4 gives n=1's step (as the JAX test), and the JAX
    step with 4 microbatches."""
    cfg = t_opt.OptimizerConfig(lr=0.05, grad_clip=0.0)
    tgt = np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)
    out = {}
    for n in (1, 4):
        p = {"w": torch.arange(8.0)}
        step = t_trainer.make_train_step(_mse, cfg, n)
        p, _, m = step(p, t_opt.adamw_init(p, cfg),
                       {"target": torch.from_numpy(tgt)})
        out[n] = (p["w"].detach().numpy().copy(), float(m["loss"]))
    np.testing.assert_allclose(out[1][0], out[4][0], rtol=1e-6)
    assert abs(out[1][1] - out[4][1]) < 1e-6
    jcfg = j_opt.OptimizerConfig(lr=0.05, grad_clip=0.0)
    jstep = j_trainer.make_train_step(
        lambda p, b: jnp.mean((p["w"][None, :] - b["target"]) ** 2), jcfg, 4,
        donate=False)
    jparams = {"w": jnp.arange(8.0)}
    jp, _, jm = jstep(jparams, j_opt.adamw_init(jparams, jcfg),
                      {"target": jnp.asarray(tgt)})
    np.testing.assert_allclose(out[4][0], np.asarray(jp["w"]), rtol=RTOL)
    np.testing.assert_allclose(out[4][1], float(jm["loss"]), rtol=RTOL)


def _quad(p, b):
    return torch.sum((p["w"] - b["target"]) ** 2)


def test_trainer_converges_and_restarts(tmp_path):
    """The JAX test's quadratic: converges, checkpoints every 20 steps,
    and a second trainer resumes at 60 with the state intact."""
    target = torch.tensor([1.0, 2.0, -1.0, 0.5])
    d = str(tmp_path)

    def fresh():
        return {"w": torch.zeros(4)}

    tr = t_trainer.Trainer(_quad, fresh(),
                           t_opt.OptimizerConfig(lr=0.1, total_steps=200),
                           t_trainer.TrainerConfig(total_steps=60,
                                                   ckpt_every=20, ckpt_dir=d))
    tr.run(lambda s: {"target": target})
    assert float((tr.params["w"].detach() - target).abs().max()) < 0.2
    assert t_ckpt.latest_step(d) == 60
    tr2 = t_trainer.Trainer(_quad, fresh(),
                            t_opt.OptimizerConfig(lr=0.1, total_steps=200),
                            t_trainer.TrainerConfig(total_steps=80,
                                                    ckpt_every=20,
                                                    ckpt_dir=d))
    assert tr2.maybe_restore() == 60
    np.testing.assert_array_equal(tr2.params["w"].detach().numpy(),
                                  tr.params["w"].detach().numpy())
    tr2.run(lambda s: {"target": target})
    assert int(tr2.opt_state.step) == 80
    assert len(tr2.history) == 20 and tr2.history[0]["step"] == 60


def test_restart_equals_uninterrupted_run(tmp_path):
    """A run that crashes at step 47 and resumes from its step-40
    checkpoint ends with the uninterrupted run's parameters and optimizer
    state, bit for bit."""
    cfg = t_deepfm.DeepFMConfig(n_users=40, n_items=60, mlp_hidden=(8, 8))
    data = t_synth.make_interactions(40, 60, 2000, seed=3)

    def batch_fn(step):
        idx = np.random.default_rng(step).integers(0, 2000, 64)
        return {k: torch.from_numpy(data[v][idx]) for k, v in
                (("u", "user_ids"), ("i", "item_ids"), ("y", "labels"))}

    def loss_fn(p, b):
        return t_deepfm.interaction_loss(p, b["u"], b["i"], b["y"], cfg)

    def trainer(ckpt_dir):
        params = t_deepfm.init_model(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
        return t_trainer.Trainer(
            loss_fn, params, t_opt.OptimizerConfig(lr=3e-3, total_steps=120),
            t_trainer.TrainerConfig(total_steps=60, ckpt_every=20,
                                    ckpt_dir=ckpt_dir))

    whole = trainer(None)
    whole.run(batch_fn)

    def crashing(step):
        if step == 47:
            raise RuntimeError("crash")
        return batch_fn(step)

    d = str(tmp_path)
    with pytest.raises(RuntimeError):
        trainer(d).run(crashing)
    resumed = trainer(d)
    assert resumed.maybe_restore() == 40
    resumed.run(batch_fn)
    a = flatten_with_paths(tree_to_numpy({"p": whole.params,
                                          "o": whole.opt_state}))
    b = flatten_with_paths(tree_to_numpy({"p": resumed.params,
                                          "o": resumed.opt_state}))
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints: the layout, and either package reading the other's
# ---------------------------------------------------------------------------

def _deepfm_pair(n_users=20, n_items=30):
    """A small DeepFM recommender in both packages from the JAX initial
    parameters, with its loss and a batch function."""
    jcfg = j_deepfm.DeepFMConfig(n_users=n_users, n_items=n_items,
                                 mlp_hidden=(8, 8))
    tcfg = t_deepfm.DeepFMConfig(n_users=n_users, n_items=n_items,
                                 mlp_hidden=(8, 8))
    jparams, _ = j_deepfm.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    data = j_synth.make_interactions(n_users, n_items, 1000, seed=1)

    def np_batch(step):
        idx = np.random.default_rng(step).integers(0, 1000, 32)
        return {"u": data["user_ids"][idx], "i": data["item_ids"][idx],
                "y": data["labels"][idx]}

    def jloss(p, b):
        return j_deepfm.interaction_loss(p, b["u"], b["i"], b["y"], jcfg)

    def tloss(p, b):
        return t_deepfm.interaction_loss(p, b["u"], b["i"], b["y"], tcfg)

    return dict(np_params=np_params, np_batch=np_batch, jloss=jloss,
                tloss=tloss)


def _jax_trainer(pair, total, d):
    return j_trainer.Trainer(
        pair["jloss"], _j(pair["np_params"]),
        j_opt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=20),
        j_trainer.TrainerConfig(total_steps=total, ckpt_every=3, ckpt_dir=d))


def _port_trainer(pair, total, d):
    return t_trainer.Trainer(
        pair["tloss"], tree_from_jax(pair["np_params"], "cpu"),
        t_opt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=20),
        t_trainer.TrainerConfig(total_steps=total, ckpt_every=3, ckpt_dir=d))


def test_checkpoint_keys_are_the_jax_tree_paths():
    pair = _deepfm_pair()
    jtr = _jax_trainer(pair, 1, None)
    ttr = _port_trainer(pair, 1, None)
    jkeys = [k for k, _ in j_ckpt._flatten_with_paths(
        {"params": jtr.params, "opt": jtr.opt_state})[0]]
    tkeys = [k for k, _ in flatten_with_paths(
        {"params": ttr.params, "opt": ttr.opt_state})]
    assert tkeys == jkeys
    assert {"params/mlp/w/0", "params/users", "opt/.step", "opt/.m/users",
            "opt/.v/mlp/b/0"} <= set(tkeys)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A JAX Trainer's checkpoint at step 6 restores into the port's
    Trainer, which continues to step 10 with the parameters and state of
    JAX's own resume (rtol 1e-6)."""
    pair = _deepfm_pair()
    src = str(tmp_path / "jax")
    jb = lambda s: _j(pair["np_batch"](s))           # noqa: E731
    tb = lambda s: {k: torch.from_numpy(v)           # noqa: E731
                    for k, v in pair["np_batch"](s).items()}
    _jax_trainer(pair, 6, src).run(jb)
    assert j_ckpt.latest_step(src) == 6
    port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
    shutil.copytree(src, port_dir)
    shutil.copytree(src, jax_dir)
    ttr = _port_trainer(pair, 10, port_dir)
    assert ttr.maybe_restore() == 6
    ttr.run(tb)
    jtr = _jax_trainer(pair, 10, jax_dir)
    assert jtr.maybe_restore() == 6
    jtr.run(jb)
    _close(ttr.params, jtr.params)
    _close(ttr.opt_state.m, jtr.opt_state.m)
    _close(ttr.opt_state.v, jtr.opt_state.v)
    assert int(ttr.opt_state.step) == int(jtr.opt_state.step) == 10


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port checkpoint restores through JAX's restore_checkpoint with the
    identical arrays, and its manifest is the JAX layout's."""
    pair = _deepfm_pair()
    d = str(tmp_path)
    ttr = _port_trainer(pair, 4, d)
    ttr.run(lambda s: {k: torch.from_numpy(v)
                       for k, v in pair["np_batch"](s).items()})
    assert j_ckpt.latest_step(d) == 4        # 3, then the end at 4
    jtr = _jax_trainer(pair, 4, None)
    back = j_ckpt.restore_checkpoint(d, {"params": jtr.params,
                                         "opt": jtr.opt_state})
    got, _ = j_ckpt._flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, back))
    want = flatten_with_paths(tree_to_numpy({"params": ttr.params,
                                             "opt": ttr.opt_state}))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        man = json.load(f)
    assert man["dtypes"]["opt/.step"] == "int32"
    assert man["shapes"]["params/users"] == [20, 40]
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003",
                                     "step_00000004"]


def test_wrong_shape_template_fails_on_both_sides(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tree = {"a": np.ones((3, 4), np.float32),
            "b": {"c": np.zeros((2,), np.float32)}}
    t_ckpt.save_checkpoint(a, 5, tree_from_jax(tree, "cpu"))
    j_ckpt.save_checkpoint(b, 5, _j(tree))
    bad = {"a": np.ones((9, 9), np.float32),
           "b": {"c": np.zeros((2,), np.float32)}}
    for d in (a, b):
        back = t_ckpt.restore_checkpoint(d, tree_from_jax(tree, "cpu"),
                                         device="cpu")
        np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
        with pytest.raises(ValueError, match="template mismatch"):
            t_ckpt.restore_checkpoint(d, tree_from_jax(bad, "cpu"),
                                      device="cpu")
        with pytest.raises(ValueError, match="template mismatch"):
            j_ckpt.restore_checkpoint(d, _j(bad))


def test_crash_between_shard_and_manifest_keeps_latest(tmp_path,
                                                       monkeypatch):
    """A save that dies after its shard and before its manifest leaves
    LATEST (for both packages) on the previous step, which restores."""
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0)}
    t_ckpt.save_checkpoint(d, 1, tree)

    def die(path, text):
        raise OSError("killed before the manifest")

    monkeypatch.setattr(t_ckpt, "_write_atomic", die)
    with pytest.raises(OSError):
        t_ckpt.save_checkpoint(d, 2, {"w": torch.arange(6.0) + 1})
    assert os.path.exists(os.path.join(d, "step_00000002", "host0000.npz"))
    assert t_ckpt.latest_step(d) == 1 and j_ckpt.latest_step(d) == 1
    back = t_ckpt.restore_checkpoint(d, tree, device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), np.arange(6.0))


def test_restore_defaults_to_the_card(tmp_path):
    """restore_checkpoint's default device is the card: without one it
    raises instead of restoring onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    t_ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)})


def test_prune_old_checkpoints(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        t_ckpt.save_checkpoint(d, s, {"w": torch.zeros(1)})
    t_ckpt.prune_old_checkpoints(d, keep=2)
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000004",
                                     "step_00000005"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(50, 80, 1000, 16, 40, 0),
                                  (7, 300, 999, 4, 12, 5)])
def test_make_interactions_byte_for_byte(args):
    got = t_synth.make_interactions(*args)
    want = j_synth.make_interactions(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_make_recsys_batch_byte_for_byte():
    card = (1460, 3, 50, 10131227)
    for seed in (0, 7):
        got = t_synth.make_recsys_batch(64, 13, card, seed=seed)
        want = j_synth.make_recsys_batch(64, 13, card, seed=seed)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_pipeline_matches_jax():
    for g, n in ((64, 4), (65, 3), (8, 1)):
        assert [t_pipeline.host_shard(g, i, n) for i in range(n)] == \
            [j_pipeline.host_shard(g, i, n) for i in range(n)]

    def make(step):
        return t_synth.make_recsys_batch(4, 2, (5, 9), seed=step)

    it = t_pipeline.BatchIterator(make, start_step=3)
    try:
        got = [next(it) for _ in range(4)]
    finally:
        it.close()
    assert not it._thread.is_alive()
    assert [s for s, _ in got] == [3, 4, 5, 6] and it.step == 7
    for s, b in got:
        for k, v in j_synth.make_recsys_batch(4, 2, (5, 9), seed=s).items():
            assert b[k].tobytes() == v.tobytes()
