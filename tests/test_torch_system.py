"""The paper's system through the port on the CPU, against the JAX package:
the DeepFM training loss and its gradients, 40 trainer steps on
``tests/test_system.py``'s fixture from the JAX package's initial weights,
then the port's search over the port-trained measure (recall within 0.01
of the JAX search's on the same graph, and ``test_system``'s claims), and
the end-to-end example's steps (train with resume, index, serve, label).

Tolerances: the loss and its gradients at rtol 1e-5 (gradients with an
atol of 1e-6 of each leaf's largest entry, for entries that cancel); 40
steps at rtol 1e-4 / atol 1e-5 (each step's float32 differences feed the
next); recall within 0.01 (trajectories part once the backends round an
ulp apart).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (SearchConfig as JConfig,  # noqa: E402
                        brute_force_topk as j_brute_force_topk,
                        deepfm_measure as j_deepfm_measure,
                        recall as j_recall, search_measure as j_search)
from repro.data import make_interactions as j_make_interactions  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.graph import build_l2_graph as j_build_l2_graph  # noqa: E402
from repro.models import deepfm as JF  # noqa: E402
from repro.train.optimizer import OptimizerConfig as JOpt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.core import (SearchConfig, brute_force_topk,  # noqa: E402
                              deepfm_measure, recall, search_measure)
from repro_torch.models import deepfm as TF  # noqa: E402
from repro_torch.train import (OptimizerConfig, Trainer,  # noqa: E402
                               TrainerConfig)
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.tree import (flatten_with_paths, tree_from_jax,  # noqa: E402
                              tree_to_numpy)

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS, N_USERS, N_QUERIES, N_INTER = 3000, 256, 24, 30_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many small ops: spinning BLAS threads under several xdist workers
    # slow them down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_ranking_torch", ROOT / "examples" / "serve_ranking_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_interaction_loss_and_grads_match_jax():
    jcfg = JF.DeepFMConfig(n_users=50, n_items=70)
    tcfg = TF.DeepFMConfig(n_users=50, n_items=70)
    jparams, _ = JF.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            "cpu")
    data = j_make_interactions(50, 70, 500, seed=2)
    u, i, y = data["user_ids"], data["item_ids"], data["labels"]
    jl, jg = jax.value_and_grad(JF.interaction_loss)(
        jparams, jnp.asarray(u), jnp.asarray(i), jnp.asarray(y), jcfg)
    tl, tg = value_and_grad(
        lambda p, b: TF.interaction_loss(p, *b, tcfg), tparams,
        tuple(torch.from_numpy(a) for a in (u, i, y)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = flatten_with_paths(tree_to_numpy(tg))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray, jg))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()),
                                   err_msg=k)


def _batches(data):
    def np_batch(step):
        idx = np.random.default_rng(step).integers(0, N_INTER, 256)
        return (data["user_ids"][idx], data["item_ids"][idx],
                data["labels"][idx])
    return np_batch


@pytest.fixture(scope="module")
def systems():
    """test_system's fixture in both packages: the JAX Trainer's 40 steps
    from PRNGKey(0), and the port's Trainer from the same initial
    parameters on the same batches; the graph over the JAX-learned items
    (the JAX builder), each package's exact top-10 under its own measure."""
    jcfg = JF.DeepFMConfig(n_users=N_USERS, n_items=N_ITEMS)
    tcfg = TF.DeepFMConfig(n_users=N_USERS, n_items=N_ITEMS)
    jparams, _ = JF.init_model(jax.random.PRNGKey(0), jcfg)
    init = jax.tree_util.tree_map(np.asarray, jparams)
    data = j_make_interactions(N_USERS, N_ITEMS, N_INTER, seed=1)
    np_batch = _batches(data)
    jtr = JTrainer(
        lambda p, b: JF.interaction_loss(p, b["u"], b["i"], b["y"], jcfg),
        jparams, JOpt(lr=5e-3, total_steps=80),
        JTrainerConfig(total_steps=40, ckpt_every=1000))
    jtr.run(lambda s: dict(zip("uiy", map(jnp.asarray, np_batch(s)))))
    ttr = Trainer(
        lambda p, b: TF.interaction_loss(p, b["u"], b["i"], b["y"], tcfg),
        tree_from_jax(init, "cpu"), OptimizerConfig(lr=5e-3, total_steps=80),
        TrainerConfig(total_steps=40, ckpt_every=1000))
    ttr.run(lambda s: dict(zip("uiy", map(torch.from_numpy, np_batch(s)))))

    jbase = np.asarray(jtr.params["items"], np.float32)
    jq = np.asarray(jtr.params["users"], np.float32)[:N_QUERIES]
    jm = j_deepfm_measure(jtr.params, jcfg)
    graph = j_build_l2_graph(jbase, m=12, k_construction=32)
    jtrue, _ = j_brute_force_topk(jm, jnp.asarray(jbase), jnp.asarray(jq), 10)

    tp = ttr.params
    tbase = tp["items"].detach().numpy().astype(np.float32)
    tq = tp["users"][:N_QUERIES].detach().numpy().astype(np.float32)
    tm = deepfm_measure({"mlp": {k: [t.detach() for t in v]
                                 for k, v in tp["mlp"].items()}}, tcfg)
    ttrue, _ = brute_force_topk(tm, torch.from_numpy(tbase),
                                torch.from_numpy(tq), 10)
    return dict(jtr=jtr, ttr=ttr, graph=graph, jbase=jbase, jq=jq, jm=jm,
                jtrue=np.asarray(jtrue), tbase=tbase, tq=tq, tm=tm,
                ttrue=ttrue.numpy())


def test_forty_steps_match_jax(systems):
    jtr, ttr = systems["jtr"], systems["ttr"]
    got = flatten_with_paths(tree_to_numpy(ttr.params))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                         jtr.params))
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=k)
    jl = [h["loss"] for h in jtr.history]
    tl = [h["loss"] for h in ttr.history]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def _port_run(systems, mode, ef=64, alpha=1.01, budget=8, rank_by="angle"):
    g = systems["graph"]
    cfg = SearchConfig(k=10, ef=ef, budget=budget, alpha=alpha, mode=mode,
                       rank_by=rank_by)
    res = search_measure(systems["tm"], torch.from_numpy(systems["tbase"]),
                         torch.from_numpy(g.neighbors),
                         torch.from_numpy(systems["tq"]),
                         torch.full((N_QUERIES,), g.entry), cfg)
    r = recall(res.ids, systems["ttrue"])
    total = float(res.n_eval.float().mean() + 2 * res.n_grad.float().mean())
    return r, total, res


@pytest.mark.parametrize("mode,ef", [("sl2g", 96), ("sl2g", 64),
                                     ("guitar", 96), ("guitar", 64)])
def test_port_search_recall_matches_jax(systems, mode, ef):
    g = systems["graph"]
    r_t, _, _ = _port_run(systems, mode, ef=ef)
    cfg = JConfig(k=10, ef=ef, budget=8, alpha=1.01, mode=mode)
    res = j_search(systems["jm"], jnp.asarray(systems["jbase"]),
                   jnp.asarray(g.neighbors), jnp.asarray(systems["jq"]),
                   jnp.full((N_QUERIES,), g.entry, jnp.int32), cfg)
    r_j = j_recall(res.ids, systems["jtrue"])
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)


def test_port_sl2g_reaches_high_recall(systems):
    r, _, _ = _port_run(systems, "sl2g", ef=96)
    assert r >= 0.85, f"SL2G recall too low: {r}"


def test_port_guitar_cuts_total_evaluations(systems):
    r_s, total_s, _ = _port_run(systems, "sl2g", ef=64)
    r_g, total_g, _ = _port_run(systems, "guitar", ef=96)
    assert r_g >= r_s - 0.05, f"GUITAR recall {r_g} << SL2G {r_s}"
    assert total_g < 0.6 * total_s, \
        f"GUITAR total {total_g} not <60% of SL2G {total_s}"


def test_port_alpha_monotonicity(systems):
    evals = []
    for alpha in (1.0, 1.1, 1.5):
        _, _, res = _port_run(systems, "guitar", alpha=alpha, budget=12)
        evals.append(float(res.n_eval.float().mean()))
    assert evals[0] <= evals[1] <= evals[2] * 1.05, evals


def test_port_results_sorted_and_unique(systems):
    _, _, res = _port_run(systems, "guitar")
    ids, scores = res.ids.numpy(), res.scores.numpy()
    for q in range(ids.shape[0]):
        s = scores[q][np.isfinite(scores[q])]
        assert (np.diff(s) <= 1e-6).all(), "scores not sorted desc"
        vid = ids[q][ids[q] >= 0]
        assert len(set(vid.tolist())) == len(vid), "duplicate results"


def test_example_steps_train_resume_index_serve(tmp_path):
    """The example's steps at a small size: the measure learned from
    make_interactions' rows (loss falls), a longer run resumes from a
    shorter one's checkpoint, and the served
    GUITAR search over the learned items is sorted, unique and close to
    the exact top-10."""
    ex = _example()
    whole, cfg, data, _ = ex.train_measure(200, 1500, 30, device="cpu")
    assert whole.history[-1]["loss"] < whole.history[0]["loss"]
    np.testing.assert_array_equal(data["item_init"][:, :40].shape, (1500, 40))
    d = str(tmp_path)
    ex.train_measure(200, 1500, 30, device="cpu", ckpt_dir=d, ckpt_every=10,
                     data=data)
    resumed, _, _, _ = ex.train_measure(200, 1500, 40, device="cpu",
                                        ckpt_dir=d, ckpt_every=10, data=data)
    assert resumed.start_step == 30
    measure, base, queries = ex.learned_system(whole, cfg, 32)
    graph = ex.build_index(base, m=12, k_construction=32, device="cpu")
    out = ex.serve(measure, graph, queries,
                   SearchConfig(k=10, ef=96, mode="guitar", budget=8,
                                alpha=1.01), batch=16, device="cpu")
    true_ids = ex.label(measure, base, queries, 10, device="cpu")
    assert out["ids"].shape == (32, 10)
    assert recall(out["ids"], true_ids) >= 0.8
    assert out["total"] == out["n_eval"] + 2 * out["n_grad"] > 0
