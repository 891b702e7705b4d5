"""The port's transformer family (``models/transformer.py``: Yi-9B,
Command-R+, StarCoder2, Granite-MoE at their smoke configs), its LM layers
and configs against the JAX package on the CPU, from the JAX package's own
initial parameters carried across by ``tree_from_jax``. Inputs are made
with numpy from a seed.

Tolerances. float32 (``dataclasses.replace(cfg, dtype=float32)``):
logits, losses, caches and gradients at rtol 1e-5 with an atol of 1e-6
of the array's (each leaf's) largest entry, as
``tests/test_torch_recsys.py`` holds gradients: a logit or a gradient
entry is a sum that cancels to near zero for some entries, and there
float32 keeps its absolute error, not its relative one (measured:
0.41-0.65 of that tolerance for the logits, 0.55-0.91 for the
gradients). The one exception: the gradients of the norm scales
(``norm``, ``final_norm``, ``q_norm``, ``k_norm``) at 2e-6 of their
largest entry. Each is a sum over all B x S tokens of products that
cancel, and Yi-9B's ``ln1`` read 1.06 of the 1e-6 tolerance (8.8e-8
against 8.1e-8). bfloat16: at rtol 2e-2 and an atol of 2e-2 of the
float32 model's largest logit (the bound of
``tests/test_models_smoke.py:61``, scaled to the logits' size). The
frameworks round to bf16 at other places, and the port's attention
kernels take bf16 inputs and compute in float32: against the float32
model (the same bf16 weights in float32) the port's bf16 logits are off
by as much as JAX's own (Yi-9B 0.045 / 0.040 of a largest logit of 3.8).
Granite's bf16 prefill and decode are held against that float32 model
instead of JAX's bf16 run: there the port's float32 attention and JAX's
bf16 attention feed the router inputs that differ in their last bf16
bit, a token's top-8 experts change (measured: the last-position logits
0.060 apart, 9% of the largest), and each model is only as close to the
float32 one as its own routing allows. The port must be no further from
it than 2e-2 of its largest logit or than JAX's bf16 run is, whichever
is larger. The MoE config runs at capacity_factor 50 where a check needs
no token dropped, as the JAX smoke test does; the prefill on the CPU
runs the flash kernel's plain version and ``decode_step`` the decode
kernel's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro import utils as j_utils  # noqa: E402
from repro_torch import utils as t_utils  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.tree import (assert_tree_match, flatten_with_paths,  # noqa: E402
                              tree_bytes, tree_cast, tree_from_jax,
                              tree_size, tree_to_numpy)

LM = ("yi-9b", "command-r-plus-104b", "starcoder2-3b", "granite-moe-3b-a800m")
RTOL = 1e-5
ATOL_OF_MAX = 1e-6          # logits, caches: atol / the largest entry
GRAD_ATOL_OF_MAX = 1e-6     # gradients: atol / the leaf's largest entry
NORM_GRAD_ATOL_OF_MAX = 2e-6  # the norm scales' gradients (see above)
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name, dtype="float32", **kw):
    """(jax cfg, port cfg) of ``name``'s smoke config at ``dtype``."""
    jd, td = DTYPES[dtype]
    jcfg = j_get_arch(name).make_smoke_config()
    tcfg = get_arch(name).make_smoke_config()
    if jcfg.is_moe:
        kw = {"capacity_factor": 50.0, **kw}
    return (dataclasses.replace(jcfg, dtype=jd, **kw),
            dataclasses.replace(tcfg, dtype=td, **kw))


def _pair(name, dtype="float32", **kw):
    jcfg, tcfg = _cfgs(name, dtype, **kw)
    jparams, _ = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol_of_max=ATOL_OF_MAX, ref_max=None):
    """float32: rtol 1e-5, atol ``atol_of_max`` of ``ref_max`` (default:
    the largest |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    ref_max = float(np.abs(want).max()) if ref_max is None else ref_max
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=atol_of_max * ref_max)


def _close_bf16(got, want, f32_ref, jax_bf16=None):
    """bf16: ``got`` within rtol 2e-2, atol 2e-2 x max|f32_ref| of
    ``want``; with ``jax_bf16`` (the MoE case) ``got`` is held against
    ``f32_ref`` instead, no further than max(that atol, JAX's bf16 run's
    distance)."""
    got, want, ref = _np(got), _np(want), _np(f32_ref)
    assert got.shape == want.shape == ref.shape
    atol = BF16_TOL * float(np.abs(ref).max())
    if jax_bf16 is None:
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=atol)
        return
    err = float(np.abs(got - ref).max())
    assert err <= max(atol, float(np.abs(_np(jax_bf16) - ref).max())), err


def _f32_twin(jcfg, jparams):
    """The float32 JAX model of a bf16 pair: the same weights, cast."""
    return (dataclasses.replace(jcfg, dtype=jnp.float32),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams))


def _assert_tree_close(port_tree, jax_tree, atol_of_max):
    got = flatten_with_paths(tree_to_numpy(port_tree))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                         jax_tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        a = NORM_GRAD_ATOL_OF_MAX if "norm" in k else atol_of_max
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=a * float(np.abs(w).max()), err_msg=k)


def _dtype_name(d):
    if d is None:
        return None
    if isinstance(d, torch.dtype):
        return str(d).split(".")[-1]
    return jnp.dtype(d).name


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LM)
def test_configs_match_jax(name):
    a, j = get_arch(name), j_get_arch(name)
    assert a.family == j.family == "lm"
    assert [s.dims for s in a.shapes] == [s.dims for s in j.shapes]
    for make in ("make_config", "make_smoke_config"):
        mine, theirs = getattr(a, make)(), getattr(j, make)()
        for f in mine.__dataclass_fields__:
            m, t = getattr(mine, f), getattr(theirs, f)
            if f in ("dtype", "param_dtype"):
                m, t = _dtype_name(m), _dtype_name(t)
            assert m == t, (name, make, f)
        assert mine.is_moe == theirs.is_moe


@pytest.mark.parametrize("name", LM)
def test_init_tree_and_axes_match_jax(name):
    """The port's own initialiser gives the JAX tree (paths, shapes,
    dtypes) and the JAX axes; its values come from its own generator."""
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jparams, jaxes = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    mine, axes = t_tf.init_params(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
    assert_tree_match(mine, axes)
    got = [(k, tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in
           flatten_with_paths(mine)]
    want = [(k, a.shape, a.dtype.name) for k, a in _flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jparams))[0]]
    assert got == want
    assert axes == jaxes
    assert tree_size(mine) == j_utils.tree_size(jparams)
    assert tree_bytes(mine) == j_utils.tree_bytes(jparams)
    # the draws' scales: N(0, 1/d) for wq, N(0, 0.02^2) for the table
    wq = mine["layers"]["attn"]["wq"].float()
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(mine["embed"].float().std()) - 0.02) < 0.002


def test_init_cache_and_axes_match_jax():
    jcfg, tcfg = _cfgs("yi-9b")
    c = t_tf.init_cache(tcfg, 3, 20, device="cpu")
    jc = j_tf.init_cache(jcfg, 3, 20)
    for k in ("k", "v"):
        assert tuple(c[k].shape) == jc[k].shape
        assert c[k].dtype == torch.bfloat16 and not c[k].any()
    assert t_tf.cache_axes() == j_tf.cache_axes()
    assert t_tf.cache_axes(False) == j_tf.cache_axes(False)


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LM)
def test_forward_loss_and_grads_match_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name)
    toks = _tokens(jcfg)
    tgts = _tokens(jcfg, seed=2)
    want = j_tf.forward(jparams, jnp.asarray(toks), jcfg)
    got = t_tf.forward(tparams, torch.from_numpy(toks), tcfg)
    assert tuple(got.shape) == (2, 16, j_layers.pad_vocab(jcfg.vocab_size))
    _close(got, want)
    jl, jg = jax.value_and_grad(lambda p: j_tf.lm_loss(
        p, jnp.asarray(toks), jnp.asarray(tgts), jcfg))(jparams)
    from repro_torch.train.trainer import value_and_grad
    tl, tg = value_and_grad(lambda p, b: t_tf.lm_loss(p, *b, tcfg), tparams,
                            (torch.from_numpy(toks), torch.from_numpy(tgts)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _assert_tree_close(tg, jg, GRAD_ATOL_OF_MAX)


@pytest.mark.parametrize("name", LM)
def test_bf16_forward_matches_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name, "bfloat16")
    toks = _tokens(jcfg)
    got = t_tf.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    fcfg, fparams = _f32_twin(jcfg, jparams)
    _close_bf16(got, j_tf.forward(jparams, jnp.asarray(toks), jcfg),
                j_tf.forward(fparams, jnp.asarray(toks), fcfg))


def test_remat_changes_no_number():
    """cfg.remat (torch.utils.checkpoint per layer) gives the loss and the
    gradients of the run without it, bit for bit."""
    from repro_torch.train.trainer import value_and_grad
    _, tcfg, _, tparams = _pair("granite-moe-3b-a800m")
    toks = torch.from_numpy(_tokens(tcfg))
    runs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs.append(value_and_grad(lambda p, b: t_tf.lm_loss(p, b, b, cfg),
                                   tparams, toks))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(flatten_with_paths(runs[0][1]),
                    flatten_with_paths(runs[1][1])):
        assert torch.equal(a[1], b[1]), a[0]


def test_attn_chunk_runs_chunked_causal_mha():
    """attn_chunk > 0 and S > chunk: the forward and the gradients through
    ``chunked_causal_mha`` match JAX's chunked path, and the full
    attention's logits."""
    jcfg, tcfg, jparams, tparams = _pair("yi-9b", attn_chunk=4)
    toks = _tokens(jcfg)
    got = t_tf.forward(tparams, torch.from_numpy(toks), tcfg)
    _close(got, j_tf.forward(jparams, jnp.asarray(toks), jcfg))
    full = t_tf.forward(tparams, torch.from_numpy(toks),
                        dataclasses.replace(tcfg, attn_chunk=0))
    _close(got, full)
    jl, jg = jax.value_and_grad(lambda p: j_tf.lm_loss(
        p, jnp.asarray(toks), jnp.asarray(toks), jcfg))(jparams)
    from repro_torch.train.trainer import value_and_grad
    tl, tg = value_and_grad(lambda p, b: t_tf.lm_loss(p, b, b, tcfg),
                            tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _assert_tree_close(tg, jg, GRAD_ATOL_OF_MAX)


def test_logit_softcap_matches_jax():
    """A cap of 2 bends logits of up to 3.8: the atol is 1e-6 of the
    uncapped logits' largest entry (tanh's slope is at most 1)."""
    jcfg, tcfg, jparams, tparams = _pair("yi-9b", logit_softcap=2.0)
    toks = _tokens(jcfg)
    got = t_tf.forward(tparams, torch.from_numpy(toks), tcfg)
    assert float(got[..., :jcfg.vocab_size].abs().max()) <= 2.0
    uncapped = np.abs(_np(j_tf.forward(
        jparams, jnp.asarray(toks),
        dataclasses.replace(jcfg, logit_softcap=0.0)))).max()
    _close(got, j_tf.forward(jparams, jnp.asarray(toks), jcfg),
           ref_max=uncapped)
    lg, _ = t_tf.prefill(tparams, torch.from_numpy(toks), tcfg)
    jlg, _ = j_tf.prefill(jparams, jnp.asarray(toks), jcfg)
    _close(lg, jlg, ref_max=uncapped)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM)
def test_prefill_matches_jax(name, dtype):
    jcfg, tcfg, jparams, tparams = _pair(name, dtype)
    toks = _tokens(jcfg)
    jlg, jcache = j_tf.prefill(jparams, jnp.asarray(toks), jcfg)
    lg, cache = t_tf.prefill(tparams, torch.from_numpy(toks), tcfg)
    assert tuple(lg.shape) == jlg.shape and lg.dtype == DTYPES[dtype][1]
    for k in ("k", "v"):
        assert cache[k].dtype == DTYPES[dtype][1]
    if dtype == "float32":
        _close(lg, jlg)
        for k in ("k", "v"):
            _close(cache[k], jcache[k])
        return
    fcfg, fparams = _f32_twin(jcfg, jparams)
    flg, fcache = j_tf.prefill(fparams, jnp.asarray(toks), fcfg)
    moe = jcfg.is_moe
    _close_bf16(lg, jlg, flg, jlg if moe else None)
    for k in ("k", "v"):
        _close_bf16(cache[k], jcache[k], fcache[k],
                    jcache[k] if moe else None)


def _pad_port(tcache, extra):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
            for k, v in tcache.items()}


def _pad_cache(jcache, tcache, extra=16):
    jc = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))),
        jcache)
    return jc, _pad_port(tcache, extra)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM)
def test_decode_step_matches_jax_and_forward(name, dtype):
    """Prefill 16 tokens, pad the cache by 16, decode the last token again
    at pos 15: the logits equal JAX's decode, and the port's forward's
    logits at position 15 (the JAX smoke test's own check, at bf16 by the
    bf16 rule: the decode kernel's float32 attention against the forward's
    bf16 one); the cache written in place
    equals the cache JAX returns. Then three more steps from pos 16 with a
    device tensor as pos."""
    jcfg, tcfg, jparams, tparams = _pair(name, dtype)
    toks = _tokens(jcfg)
    runs = [(jcfg, jparams)]
    if dtype == "bfloat16":
        runs.append(_f32_twin(jcfg, jparams))
    nxt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (3, 2))
    jax_logits, jax_caches = [], []
    for cfg, params in runs:               # JAX bf16 (and its f32 twin)
        _, c = j_tf.prefill(params, jnp.asarray(toks), cfg)
        c = _pad_cache(c, {}, 16)[0]
        steps = []
        for i, (tok, pos) in enumerate([(toks[:, -1], 15)] + [
                (nxt[i], 16 + i) for i in range(3)]):
            lg, c = j_tf.decode_step(params, c, jnp.asarray(tok),
                                     jnp.int32(pos), cfg)
            steps.append(lg)
        jax_logits.append(steps)
        jax_caches.append(c)
    _, tcache = t_tf.prefill(tparams, torch.from_numpy(toks), tcfg)
    tcache = _pad_port(tcache, 16)
    lg, out = t_tf.decode_step(tparams, tcache, torch.from_numpy(toks[:, -1]),
                               15, tcfg)
    assert out is tcache                       # written in place
    got = [lg]
    full = t_tf.forward(tparams, torch.from_numpy(toks), tcfg)[:, 15, :]
    if dtype == "float32":
        np.testing.assert_allclose(_np(lg), _np(full), rtol=2e-2, atol=2e-2)
    else:
        fcfg, fparams = runs[1]
        _close_bf16(lg, full, j_tf.forward(fparams, jnp.asarray(toks),
                                           fcfg)[:, 15, :],
                    jax_logits[0][0] if jcfg.is_moe else None)
    pos = torch.tensor([16], dtype=torch.int32)
    for i in range(3):
        lg, tcache = t_tf.decode_step(tparams, tcache,
                                      torch.from_numpy(nxt[i]), pos, tcfg)
        pos += 1
        got.append(lg)
    if dtype == "float32":
        for g, w in zip(got, jax_logits[0]):
            _close(g, w)
        for k in ("k", "v"):
            _close(tcache[k], jax_caches[0][k])
        return
    moe = jcfg.is_moe
    for g, w, f in zip(got, *jax_logits):
        _close_bf16(g, w, f, w if moe else None)
    for k in ("k", "v"):
        _close_bf16(tcache[k], jax_caches[0][k], jax_caches[1][k],
                    jax_caches[0][k] if moe else None)


def test_decode_cache_branch_takes_one_position():
    _, tcfg, _, tparams = _pair("yi-9b")
    lp = t_tf.layer_params(tparams, 0)
    cache = t_tf.init_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    x = torch.zeros(2, 2, tcfg.d_model)
    rope = t_layers.rope_angles(torch.zeros(2, 2), tcfg.head_dim)
    with pytest.raises(ValueError, match="one position"):
        t_tf._attn_block(tcfg, lp["attn"], x, rope, "decode",
                         cache_kv=(cache["k"][0], cache["v"][0]),
                         slot=torch.tensor([0]), length=torch.tensor([1]))


def test_prefill_and_decode_go_through_the_kernels(monkeypatch):
    """prefill calls ``flash_attention`` once per layer and decode_step
    ``decode_attention`` once per layer (their plain versions on the CPU);
    the training forward calls neither."""
    calls = {"flash": 0, "decode": 0}
    real_f, real_d = t_tf.flash_attention, t_tf.decode_attention

    def flash(*a, **k):
        calls["flash"] += 1
        return real_f(*a, **k)

    def decode(*a, **k):
        calls["decode"] += 1
        return real_d(*a, **k)

    monkeypatch.setattr(t_tf, "flash_attention", flash)
    monkeypatch.setattr(t_tf, "decode_attention", decode)
    _, tcfg, _, tparams = _pair("granite-moe-3b-a800m")
    toks = torch.from_numpy(_tokens(tcfg))
    t_tf.forward(tparams, toks, tcfg)
    assert calls == {"flash": 0, "decode": 0}
    _, cache = t_tf.prefill(tparams, toks, tcfg)
    assert calls == {"flash": tcfg.n_layers, "decode": 0}
    t_tf.decode_step(tparams, _pad_port(cache, 16), toks[:, -1], 15, tcfg)
    assert calls == {"flash": tcfg.n_layers, "decode": tcfg.n_layers}


# ---------------------------------------------------------------------------
# fp8 weight serving
# ---------------------------------------------------------------------------

def _fp8_pair():
    jcfg, tcfg, jparams, _ = _pair("yi-9b")
    jcfg8 = dataclasses.replace(jcfg, param_dtype=jnp.float8_e4m3fn)
    tcfg8 = dataclasses.replace(tcfg, param_dtype=torch.float8_e4m3fn)
    jp8 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float8_e4m3fn)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, jparams)
    return jcfg, jcfg8, tcfg8, jparams, jp8


def test_fp8_tree_round_trips_bit_for_bit():
    """A JAX float8_e4m3fn tree carried by ``tree_from_jax``: the same
    dtype and the same bits in every leaf."""
    *_, jp8 = _fp8_pair()
    want = _flatten_with_paths(jax.tree_util.tree_map(np.asarray, jp8))[0]
    got = flatten_with_paths(tree_from_jax(
        jax.tree_util.tree_map(np.asarray, jp8), "cpu"))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == torch.float8_e4m3fn, k
        np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                      w.view(np.uint8), err_msg=k)


def test_fp8_weight_serving_close_to_bf16():
    """The counterpart of the JAX smoke test: fp8 weights, cast to the
    compute dtype at use, give the fp8 JAX model's logits (rtol 1e-5: the
    same fp8 values in float32) and stay close to the full-precision
    model's (correlation > 0.98, the JAX test's bound); prefill and one
    decode step serve from the fp8 tree."""
    jcfg, jcfg8, tcfg8, jparams, jp8 = _fp8_pair()
    tp8 = tree_from_jax(jax.tree_util.tree_map(np.asarray, jp8), "cpu")
    toks = _tokens(jcfg, S=8)
    full = _np(j_tf.forward(jparams, jnp.asarray(toks), jcfg))
    want = j_tf.forward(jp8, jnp.asarray(toks), jcfg8)
    q8 = t_tf.forward(tp8, torch.from_numpy(toks), tcfg8)
    _close(q8, want)
    q8 = _np(q8)
    assert np.isfinite(q8).all()
    corr = np.corrcoef(full[:, -1].reshape(-1), q8[:, -1].reshape(-1))[0, 1]
    assert corr > 0.98, f"fp8 logits corr {corr}"
    lg, cache = t_tf.prefill(tp8, torch.from_numpy(toks), tcfg8)
    _close(lg, j_tf.prefill(jp8, jnp.asarray(toks), jcfg8)[0])
    lg, _ = t_tf.decode_step(tp8, _pad_port(cache, 4),
                             torch.from_numpy(toks[:, -1]), 7,
                             tcfg8)
    _close(lg, _np(want)[:, 7])


# ---------------------------------------------------------------------------
# LM layers and helpers
# ---------------------------------------------------------------------------

def test_lm_layers_match_jax():
    r = np.random.default_rng(0)
    x = (2 * r.normal(size=(2, 5, 3, 16)) + 0.5).astype(np.float32)
    s = r.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=RTOL, atol=1e-6)
    for theta in (10000.0, 5e6, 7.5e7):
        np.testing.assert_allclose(
            t_layers.rope_freqs(16, theta, device="cpu").numpy(),
            np.asarray(j_layers.rope_freqs(16, theta)), rtol=1e-6)
        # positions up to the 32k shapes, where the angle's rounding shows
        pos = np.array([[0, 1, 2, 4096, 32767]], np.int32)
        np.testing.assert_allclose(
            t_layers.apply_rope(torch.from_numpy(x[:1]), torch.from_numpy(pos),
                                theta).numpy(),
            np.asarray(j_layers.apply_rope(jnp.asarray(x[:1]),
                                           jnp.asarray(pos), theta)),
            rtol=1e-4, atol=1e-4)
    w = [r.normal(size=sh).astype(np.float32) / 4
         for sh in ((16, 8), (16, 8), (8, 16))]
    np.testing.assert_allclose(
        t_layers.swiglu(torch.from_numpy(x),
                        *map(torch.from_numpy, w)).numpy(),
        np.asarray(j_layers.swiglu(jnp.asarray(x), *map(jnp.asarray, w))),
        rtol=RTOL, atol=1e-6)


def test_apply_rope_is_rope_angles_then_rotate():
    x = torch.randn(2, 7, 4, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(7)[None].expand(2, 7)
    cos, sin = t_layers.rope_angles(pos, 8, 5e6)
    out = t_layers.rotate(x, cos, sin)
    assert torch.equal(out, t_layers.apply_rope(x, pos, 5e6))
    assert out.is_contiguous() and out.dtype == x.dtype


def test_utils_match_jax():
    for a, b in ((7, 3), (9, 3), (0, 4), (1, 16)):
        assert t_utils.ceil_div(a, b) == j_utils.ceil_div(a, b)
        assert t_utils.round_up(a, b) == j_utils.round_up(a, b)
    x = np.arange(6).reshape(2, 3)
    for size, axis in ((5, 0), (2, 0), (4, 1)):
        np.testing.assert_array_equal(t_utils.pad_to(x, size, axis, fill=-1),
                                      j_utils.pad_to(x, size, axis, fill=-1))
    jcfg, tcfg, jparams, tparams = _pair("starcoder2-3b")
    assert tree_size(tparams) == j_utils.tree_size(jparams)
    assert tree_bytes(tparams) == j_utils.tree_bytes(jparams)
    half = tree_cast(tparams, torch.bfloat16)
    assert tree_bytes(half) == j_utils.tree_bytes(
        j_utils.tree_cast(jparams, jnp.bfloat16))
    _, axes = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    assert_tree_match(tparams, axes)
    bad = dict(axes, final_norm=("embed", None))
    with pytest.raises(ValueError, match="rank"):
        assert_tree_match(tparams, bad)
    with pytest.raises(ValueError, match="structure"):
        assert_tree_match(tparams, {k: v for k, v in axes.items()
                                    if k != "embed"})
