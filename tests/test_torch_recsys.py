"""The port's recommendation nets (DLRM-RM2, DCN-v2, BST, BERT4Rec), their
layers, configs and the training launcher against the JAX package on the
CPU, at each arch's smoke configuration, from the JAX package's own
initial parameters carried across by ``tree_from_jax``.

Forwards, candidate scores and losses at rtol 1e-5. The loss's gradients
at rtol 1e-5 with an atol of 1e-6 of each leaf's largest entry: an entry
that sums terms cancelling to near zero keeps float32's absolute error,
not its relative one. One AdamW step each at rtol 1e-5 with atol 1e-6,
a thousandth of the step (warmup off, so the step moves every parameter
by about the learning rate, 1e-3; a parameter that starts near zero has
no relative error to hold, and Adam's g / (|g| + eps) turns a gradient
of about eps, whose sign float32 does not fix, into a step of any size
below lr). These mirror ``tests/test_models_smoke.py``'s recsys cases.
"""
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
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import recsys as j_rec  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import trainer as j_trainer  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import recsys as t_rec  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainer as t_trainer  # noqa: E402
from repro_torch.tree import (flatten_with_paths, tree_from_jax,  # noqa: E402
                              tree_to_numpy)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
GRAD_ATOL_OF_MAX = 1e-6     # gradients: atol as a share of the leaf's max
STEP_LR, STEP_ATOL = 1e-3, 1e-6
RECSYS = ("dlrm-rm2", "dcn-v2", "bst", "bert4rec")
INIT = {"dlrm-rm2": "dlrm_init", "dcn-v2": "dcn_init", "bst": "bst_init",
        "bert4rec": "bert4rec_init"}


def _pair(name):
    """(jax cfg, port cfg, jax params, port params) at the smoke config."""
    jcfg = j_get_arch(name).make_smoke_config()
    tcfg = get_arch(name).make_smoke_config()
    jparams, _ = getattr(j_rec, INIT[name])(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            "cpu")
    return jcfg, tcfg, jparams, tparams


def _inputs(name, cfg, tcfg):
    """The numpy batch of each arch's loss (seeded) and the loss functions
    of both packages over it (JAX at ``cfg``, the port at ``tcfg``)."""
    r = np.random.default_rng(1)
    if name in ("dlrm-rm2", "dcn-v2"):
        b = {"dense": r.normal(size=(8, 13)).astype(np.float32),
             "sparse": r.integers(0, 50, (8, 26)).astype(np.int32),
             "labels": (r.random(8) < 0.5).astype(np.float32)}
        jf = j_rec.dlrm_forward if name == "dlrm-rm2" else j_rec.dcn_forward
        tf = t_rec.dlrm_forward if name == "dlrm-rm2" else t_rec.dcn_forward
        jl = lambda p, b: j_rec.bce_loss(                      # noqa: E731
            jf(p, b["dense"], b["sparse"], cfg), b["labels"])
        tl = lambda p, b: t_rec.bce_loss(                      # noqa: E731
            tf(p, b["dense"], b["sparse"], tcfg), b["labels"])
    elif name == "bst":
        b = {"hist": r.integers(0, 100, (4, cfg.seq_len)).astype(np.int32),
             "target": r.integers(0, 100, 4).astype(np.int32),
             "labels": (r.random(4) < 0.5).astype(np.float32)}
        jl = lambda p, b: j_rec.bce_loss(                      # noqa: E731
            j_rec.bst_forward(p, b["hist"], b["target"], cfg), b["labels"])
        tl = lambda p, b: t_rec.bce_loss(                      # noqa: E731
            t_rec.bst_forward(p, b["hist"], b["target"], tcfg), b["labels"])
    else:
        items = r.integers(1, 400, (3, cfg.seq_len)).astype(np.int32)
        items[1, :4] = 0                           # padded keys are masked
        b = {"items": items,
             "masked_pos": r.integers(0, cfg.seq_len, (3, 2)).astype(np.int32),
             "labels": r.integers(1, 400, (3, 2)).astype(np.int32),
             "negatives": r.integers(1, 400, 16).astype(np.int32)}
        jl = lambda p, b: j_rec.bert4rec_sampled_loss(         # noqa: E731
            p, b["items"], b["masked_pos"], b["labels"], b["negatives"], cfg)
        tl = lambda p, b: t_rec.bert4rec_sampled_loss(         # noqa: E731
            p, b["items"], b["masked_pos"], b["labels"], b["negatives"], tcfg)
    return b, jl, tl


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_tree_close(port_tree, jax_tree, rtol=RTOL, atol=0.0,
                       atol_of_max=0.0):
    got = flatten_with_paths(tree_to_numpy(port_tree))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                         jax_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        tol = atol + atol_of_max * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", RECSYS)
def test_init_tree_matches_jax(name):
    """The port's own initialiser gives the JAX tree: the same paths, shapes
    and dtypes (its values come from its own generator)."""
    jcfg, tcfg, jparams, _ = _pair(name)
    mine = getattr(t_rec, INIT[name])(torch.Generator().manual_seed(0), tcfg,
                                      device="cpu")
    got = [(k, v.shape, v.dtype) for k, v in
           flatten_with_paths(tree_to_numpy(mine))]
    want = [(k, a.shape, a.dtype) for k, a in _flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jparams))[0]]
    assert got == want


@pytest.mark.parametrize("name", RECSYS)
def test_loss_and_grads_match_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name)
    b, jl, tl = _inputs(name, jcfg, tcfg)
    jloss, jgrads = jax.value_and_grad(jl)(jparams, _jb(b))
    tloss, tgrads = t_trainer.value_and_grad(tl, tparams, _tb(b))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    assert np.isfinite(float(tloss))
    _assert_tree_close(tgrads, jgrads, atol_of_max=GRAD_ATOL_OF_MAX)


@pytest.mark.parametrize("name", RECSYS)
def test_one_train_step_matches_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name)
    b, jl, tl = _inputs(name, jcfg, tcfg)
    kw = dict(lr=STEP_LR, warmup_steps=0, total_steps=10)
    jstep = j_trainer.make_train_step(jl, j_opt.OptimizerConfig(**kw),
                                      donate=False)
    tcfg_opt = t_opt.OptimizerConfig(**kw)
    tstep = t_trainer.make_train_step(tl, tcfg_opt)
    jp, js, jm = jstep(jparams, j_opt.adamw_init(jparams,
                                                 j_opt.OptimizerConfig(**kw)),
                       _jb(b))
    tp, ts, tm = tstep(tparams, t_opt.adamw_init(tparams, tcfg_opt), _tb(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    _assert_tree_close(tp, jp, atol=STEP_ATOL)
    _assert_tree_close(ts.m, js.m, atol_of_max=GRAD_ATOL_OF_MAX)


@pytest.mark.parametrize("name", ["dlrm-rm2", "dcn-v2"])
def test_criteo_forward_and_candidates_match_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name)
    b, _, _ = _inputs(name, jcfg, tcfg)
    jf = j_rec.dlrm_forward if name == "dlrm-rm2" else j_rec.dcn_forward
    tf = t_rec.dlrm_forward if name == "dlrm-rm2" else t_rec.dcn_forward
    want = np.asarray(jf(jparams, jnp.asarray(b["dense"]),
                         jnp.asarray(b["sparse"]), jcfg))
    got = tf(tparams, torch.from_numpy(b["dense"]),
             torch.from_numpy(b["sparse"]), tcfg).detach().numpy()
    assert got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    js = (j_rec.dlrm_score_candidates if name == "dlrm-rm2"
          else j_rec.dcn_score_candidates)
    ts = (t_rec.dlrm_score_candidates if name == "dlrm-rm2"
          else t_rec.dcn_score_candidates)
    cand = np.random.default_rng(3).normal(
        size=(12, jcfg.n_item_fields, jcfg.embed_dim)).astype(np.float32)
    want = np.asarray(js(jparams, jnp.asarray(b["dense"][0]),
                         jnp.arange(13), jnp.asarray(cand), jcfg))
    got = ts(tparams, torch.from_numpy(b["dense"][0]), torch.arange(13),
             torch.from_numpy(cand), tcfg).detach().numpy()
    assert got.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_bst_forward_and_candidates_match_jax():
    jcfg, tcfg, jparams, tparams = _pair("bst")
    b, _, _ = _inputs("bst", jcfg, tcfg)
    want = np.asarray(j_rec.bst_forward(jparams, jnp.asarray(b["hist"]),
                                        jnp.asarray(b["target"]), jcfg))
    got = t_rec.bst_forward(tparams, torch.from_numpy(b["hist"]),
                            torch.from_numpy(b["target"]), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-7)
    want = np.asarray(j_rec.bst_score_candidates(
        jparams, jnp.asarray(b["hist"][0]), jnp.arange(32), jcfg))
    got = t_rec.bst_score_candidates(tparams, torch.from_numpy(b["hist"][0]),
                                     torch.arange(32), tcfg)
    assert got.shape == (32,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-7)


def test_bert4rec_losses_and_candidates_match_jax():
    jcfg, tcfg, jparams, tparams = _pair("bert4rec")
    b, _, _ = _inputs("bert4rec", jcfg, tcfg)
    items = b["items"]
    ji, ti = jnp.asarray(items), torch.from_numpy(items)
    np.testing.assert_allclose(
        t_rec.bert4rec_logits(tparams, ti, tcfg).detach().numpy(),
        np.asarray(j_rec.bert4rec_logits(jparams, ji, jcfg)), rtol=RTOL,
        atol=1e-6)
    want = float(j_rec.bert4rec_mlm_loss(jparams, ji, ji, ji > 0, jcfg))
    got = float(t_rec.bert4rec_mlm_loss(tparams, ti, ti, ti > 0, tcfg))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    want = np.asarray(j_rec.bert4rec_score_candidates(
        jparams, ji[:1], jnp.arange(32), jcfg))
    got = t_rec.bert4rec_score_candidates(tparams, ti[:1], torch.arange(32),
                                          tcfg)
    assert got.shape == (32,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_dot_interaction_pair_order_is_jax_triu():
    vecs = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    got = t_rec._dot_interaction(torch.from_numpy(vecs)).numpy()
    want = np.asarray(j_rec._dot_interaction(jnp.asarray(vecs)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    iu, ju = torch.triu_indices(5, 5, 1)
    ju_, iu_ = np.triu_indices(5, k=1)[1], np.triu_indices(5, k=1)[0]
    assert iu.tolist() == iu_.tolist() and ju.tolist() == ju_.tolist()


def test_layer_norm_and_vocab_mask_match_jax():
    r = np.random.default_rng(0)
    x = (3 * r.normal(size=(4, 6, 16)) + 1).astype(np.float32)
    s, b = r.normal(size=16).astype(np.float32), r.normal(size=16).astype(
        np.float32)
    np.testing.assert_allclose(
        t_layers.layer_norm(*map(torch.from_numpy, (x, s, b))).numpy(),
        np.asarray(j_layers.layer_norm(*map(jnp.asarray, (x, s, b)))),
        rtol=RTOL, atol=1e-6)
    logits = r.normal(size=(2, 20)).astype(np.float32)
    for vocab in (20, 17):
        np.testing.assert_array_equal(
            t_layers.mask_pad_vocab(torch.from_numpy(logits), vocab).numpy(),
            np.asarray(j_layers.mask_pad_vocab(jnp.asarray(logits), vocab)))


def test_gather_rows_backward_is_the_segment_sum():
    """Duplicate ids: the gradient of a gather is each id's rows summed in
    their order (= index_add_ on the CPU, and = JAX's gradient of take)."""
    r = np.random.default_rng(0)
    table = r.normal(size=(30, 4)).astype(np.float32)
    ids = r.integers(0, 6, (5, 7))
    w = r.normal(size=(5, 7, 4)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    (t_layers.gather_rows(t, torch.from_numpy(ids)) *
     torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda tb: jnp.sum(
        jnp.take(tb, jnp.asarray(ids), axis=0) * w))(jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
    ref = torch.zeros(30, 4).index_add_(0, torch.from_numpy(ids.reshape(-1)),
                                        torch.from_numpy(w.reshape(-1, 4)))
    assert torch.equal(t.grad, ref)


def test_embed_init_draws_on_the_generator():
    a = t_layers.embed_init(torch.Generator().manual_seed(3), 1000, 8,
                            scale=0.3, device="cpu")
    b = t_layers.embed_init(torch.Generator().manual_seed(3), 1000, 8,
                            scale=0.3, device="cpu")
    assert a.shape == (1000, 8) and torch.equal(a, b)
    assert abs(float(a.std()) - 0.3) < 0.02


# ---------------------------------------------------------------------------
# the registry and the launcher
# ---------------------------------------------------------------------------

def test_registry_covers_the_jax_archs():
    """Every JAX arch is either ported (recsys, the same configs) or named
    by the launcher as not ported."""
    assert sorted(list_archs() + list(t_launch.JAX_ONLY_ARCHS)) == \
        j_list_archs()
    for name in RECSYS:
        a, j = get_arch(name), j_get_arch(name)
        assert a.family == j.family == "recsys"
        assert [s.dims for s in a.shapes] == [s.dims for s in j.shapes]
        for make in ("make_config", "make_smoke_config"):
            mine, theirs = getattr(a, make)(), getattr(j, make)()
            for f in mine.__dataclass_fields__:
                assert getattr(mine, f) == getattr(theirs, f), (name, f)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


@pytest.mark.parametrize("name", RECSYS)
def test_launcher_trains_each_recsys_arch(name):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", name,
         "--steps", "3", "--device", "cpu"], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [s for s in out.stdout.splitlines() if s.startswith("[train]")][-1]
    first, last = (float(w) for w in line.split("loss ")[1].split(" in ")[0]
                   .split(" -> "))
    assert np.isfinite(first) and np.isfinite(last), line


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    d = str(tmp_path)
    t_launch.main(["--arch", "dcn-v2", "--steps", "10", "--device", "cpu",
                   "--ckpt-dir", d])
    tr = t_launch.main(["--arch", "dcn-v2", "--steps", "14", "--device",
                        "cpu", "--ckpt-dir", d])
    assert tr.start_step == 10 and len(tr.history) == 4
    assert int(tr.opt_state.step) == 14


def test_launcher_names_what_is_not_ported():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-v3-671b", "--device", "cpu"], capture_output=True,
        text=True, env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "deepseek-v3-671b is not ported yet" in out.stderr
    assert "python -m repro.launch.train" in out.stderr
