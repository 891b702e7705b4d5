"""The port's DeepSeek-V3 (``models/deepseek.py``, ``configs/
deepseek_v3_671b.py``) against the JAX package on the CPU, at the smoke
config (4 layers, the first dense, 8 experts top-2, MTP on), from the JAX
package's own initial parameters carried across by ``tree_from_jax``.
Inputs are made with numpy from a seed.

float32 (``dataclasses.replace(cfg, dtype=float32)``, the config's
capacity_factor 1.25): logits, losses and latent caches at rtol 1e-5
with an atol of 1e-6 of the array's largest entry, as
``tests/test_torch_transformer.py`` holds them. Gradients at rtol 1e-5
with an atol of 1e-6 of each leaf's largest entry (2e-6 for the norm
scales), as there, widened per leaf to twice JAX's own float32 error
where that is larger (``assert_grads_close``). JAX's own float32
gradient misses a more precise one by more than that bound here: held
against the port's model run in float64 (same weights and batch; its
norms, rope, router and softmax keep the float32 steps that JAX's have),
JAX's reads up to 1.50e-6 of the leaf's largest entry (the dense
``w_gate``) and the port's float32 one up to 1.34e-6 (the dense
``wkv_b``), so two float32 runs lie up to twice that apart (measured
port against JAX: 1.75e-6, the MoE layers' ``wq_b``, whose entries sum
over the attention and cancel). JAX's distance from the float64 run is
itself held under 1e-5 of the leaf's largest entry: a fault of the port
shows there far above float32's noise.

bfloat16: rtol 2e-2 with an atol of 2e-2 of the float32 model's largest
entry (the same bf16 weights in float32), the MoE at capacity_factor 8.0
(E / K = 4 is the least that drops no pair). At the config's 1.25 a near
tie of the router that bf16 rounding decides apart on each side (3
tokens of the third MoE layer, measured) moves which later pairs
overflow an expert, and each model then lies only as close to the
float32 one as its own drops allow (JAX's bf16 logits 0.18 of the
largest float32 logit away from it, the port's 0.08). The absorbed
decode's bf16 logits lie further from the float32 model than 2e-2 of
its largest logit in JAX's own run (up to 2.8e-2, measured: the two
logit products are rounded to bf16 before the softmax, an order both
keep), so a bf16 step's logits are held to JAX's within twice JAX's own
distance from the float32 model where that exceeds the bf16 atol.

Decode at position S - 1 against ``forward`` at S - 1 at rtol 1e-3 /
atol 1e-3, the JAX smoke test's own check (``tests/test_models_smoke.py``),
at its capacity_factor 8.0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.ft.checkpoint import _flatten_with_paths  # noqa: E402
from repro.models import deepseek as j_ds  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro import utils as j_utils  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import deepseek as t_ds  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402
from repro_torch.tree import (assert_tree_match, flatten_with_paths,  # noqa: E402
                              tree_bytes, tree_from_jax, tree_map, tree_size,
                              tree_to_numpy)

NAME = "deepseek-v3-671b"
RTOL = 1e-5
ATOL_OF_MAX = 1e-6
GRAD_ATOL_OF_MAX, NORM_GRAD_ATOL_OF_MAX = 1e-6, 2e-6
EXACT_ATOL_OF_MAX = 1e-5    # JAX float32 against the port's float64
BF16_TOL = 2e-2
NO_DROP = 8.0
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    """(jax cfg, port cfg) of the smoke config at ``dtype`` (bf16: no
    pair dropped)."""
    jd, td = DTYPES[dtype]
    if dtype == "bfloat16":
        kw = {"capacity_factor": NO_DROP, **kw}
    return (dataclasses.replace(j_get_arch(NAME).make_smoke_config(),
                                dtype=jd, **kw),
            dataclasses.replace(get_arch(NAME).make_smoke_config(),
                                dtype=td, **kw))


def _pair(dtype="float32", **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    jparams, _ = j_ds.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tree_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            "cpu")
    return jcfg, tcfg, jparams, tparams


def _f32_twin(jcfg, jparams):
    """The float32 JAX model of a bf16 pair: the same weights, cast."""
    return (dataclasses.replace(jcfg, dtype=jnp.float32),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams))


def _tokens(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol_of_max=ATOL_OF_MAX):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=atol_of_max * float(np.abs(want).max()))


def _close_bf16(got, want, f32_ref, own_error=False):
    """bf16: ``got`` within rtol 2e-2, atol 2e-2 x max|f32_ref| of
    ``want``; with ``own_error`` the atol is at least twice JAX's own
    distance from the float32 model (two bf16 runs, each that far from
    it, lie within twice that of each other)."""
    got, want, ref = _np(got), _np(want), _np(f32_ref)
    assert got.shape == want.shape == ref.shape
    atol = BF16_TOL * float(np.abs(ref).max())
    if own_error:
        atol = max(atol, 2 * float(np.abs(want - ref).max()))
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=atol)


def float64_grads(loss_fn, params, batch):
    """The port's gradient in float64 (``loss_fn`` built at float64) over
    ``params`` cast to float64: a more precise gradient than either
    float32 run's (its float32 steps are JAX's too)."""
    return value_and_grad(loss_fn, tree_map(lambda t: t.detach().double(),
                                            params), batch)[1]


def assert_grads_close(port_tree, jax_tree, exact_tree):
    """Each leaf of the port's float32 gradient (or of a tree linear in it,
    an AdamW moment) against JAX's: rtol 1e-5, an atol of 1e-6 (the norm
    scales 2e-6) of the leaf's largest |entry|, widened to twice JAX's own
    distance from ``exact_tree`` where that is larger; that distance must
    be under 1e-5 of the largest |entry|."""
    got = flatten_with_paths(tree_to_numpy(port_tree))
    want, _ = _flatten_with_paths(jax.tree_util.tree_map(np.asarray,
                                                         jax_tree))
    exact = flatten_with_paths(tree_to_numpy(exact_tree))
    assert [k for k, _ in got] == [k for k, _ in want] == [k for k, _ in
                                                           exact]
    for (k, g), (_, w), (_, e) in zip(got, want, exact):
        top = float(np.abs(w).max())
        own = float(np.abs(w - e).max())
        assert own <= EXACT_ATOL_OF_MAX * top, (k, own / top)
        base = NORM_GRAD_ATOL_OF_MAX if "norm" in k else GRAD_ATOL_OF_MAX
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=max(base * top, 2 * own), err_msg=k)


def _dtype_name(d):
    if isinstance(d, torch.dtype):
        return str(d).split(".")[-1]
    return jnp.dtype(d).name


def _pad(cache, extra):
    """A latent cache, the port's or JAX's, grown by ``extra`` zero
    positions."""
    if isinstance(cache["c"], torch.Tensor):
        return {k: torch.nn.functional.pad(v, (0, 0, 0, extra))
                for k, v in cache.items()}
    return jax.tree_util.tree_map(
        lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, extra), (0, 0))), cache)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_configs_match_jax(make):
    a, j = get_arch(NAME), j_get_arch(NAME)
    assert a.family == j.family == "lm"
    assert [s.dims for s in a.shapes] == [s.dims for s in j.shapes]
    mine, theirs = getattr(a, make)(), getattr(j, make)()
    assert list(mine.__dataclass_fields__) == list(
        theirs.__dataclass_fields__)
    for f in mine.__dataclass_fields__:
        m, t = getattr(mine, f), getattr(theirs, f)
        if f == "dtype":
            m, t = _dtype_name(m), _dtype_name(t)
        assert m == t, (make, f)
    assert mine.qk_head_dim == theirs.qk_head_dim


@pytest.mark.parametrize("use_mtp", [True, False])
def test_init_tree_and_axes_match_jax(use_mtp):
    """The port's own initialiser gives the JAX tree (paths, shapes,
    dtypes) and the JAX axes; its values come from its own generator."""
    jcfg, tcfg = _cfgs("bfloat16", use_mtp=use_mtp)
    jparams, jaxes = j_ds.init_params(jax.random.PRNGKey(0), jcfg)
    mine, axes = t_ds.init_params(torch.Generator().manual_seed(0), tcfg,
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
    # the draws' scales: N(0, 1/fan_in) for wkv_b, N(0, 0.02^2) the table
    w = mine["moe_layers"]["attn"]["wkv_b"].float()
    assert abs(float(w.std()) * tcfg.kv_lora_rank ** 0.5 - 1) < 0.1
    assert abs(float(mine["embed"].float().std()) - 0.02) < 0.002


def test_init_cache_and_axes_match_jax():
    jcfg, tcfg = _cfgs()
    c = t_ds.init_cache(tcfg, 3, 20, device="cpu")
    jc = j_ds.init_cache(jcfg, 3, 20)
    for k in ("c", "kr"):
        assert tuple(c[k].shape) == jc[k].shape
        assert c[k].dtype == torch.bfloat16 and not c[k].any()
    assert t_ds.cache_axes() == j_ds.cache_axes()


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(jcfg, tcfg, jparams, tparams, toks, tgts):
    """JAX's (loss, gradient), the port's, and the port's float64
    gradient."""
    jl, jg = jax.value_and_grad(lambda p: j_ds.lm_loss(
        p, jnp.asarray(toks), jnp.asarray(tgts), jcfg))(jparams)
    batch = (torch.from_numpy(toks), torch.from_numpy(tgts))
    tl, tg = value_and_grad(lambda p, b: t_ds.lm_loss(p, *b, tcfg), tparams,
                            batch)
    c64 = dataclasses.replace(tcfg, dtype=torch.float64)
    g64 = float64_grads(lambda p, b: t_ds.lm_loss(p, *b, c64), tparams,
                        batch)
    return (jl, jg), (tl, tg), g64


@pytest.mark.parametrize("use_mtp", [True, False])
def test_forward_loss_and_grads_match_jax(use_mtp):
    """float32: the logits, ``lm_loss`` (with the MTP term, and without)
    and every leaf of its gradient, the MTP head's among them."""
    jcfg, tcfg, jparams, tparams = _pair(use_mtp=use_mtp)
    toks, tgts = _tokens(jcfg), _tokens(jcfg, seed=2)
    got = t_ds.forward(tparams, torch.from_numpy(toks), tcfg)
    assert tuple(got.shape) == (2, 16, j_layers.pad_vocab(jcfg.vocab_size))
    _close(got, j_ds.forward(jparams, jnp.asarray(toks), jcfg))
    (jl, jg), (tl, tg), g64 = _loss_and_grads(jcfg, tcfg, jparams, tparams,
                                              toks, tgts)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert_grads_close(tg, jg, g64)
    if use_mtp:                  # the MTP term is in the loss it reports
        with torch.no_grad():
            plain = t_ds.lm_loss(tparams, torch.from_numpy(toks),
                                 torch.from_numpy(tgts),
                                 dataclasses.replace(tcfg, use_mtp=False))
        assert float(tl) != float(plain)
        assert float(tg["mtp"]["proj"].abs().max()) > 0


def test_bf16_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair("bfloat16")
    toks = _tokens(jcfg)
    got = t_ds.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    fcfg, fparams = _f32_twin(jcfg, jparams)
    _close_bf16(got, j_ds.forward(jparams, jnp.asarray(toks), jcfg),
                j_ds.forward(fparams, jnp.asarray(toks), fcfg))


def test_mtp_logits_match_jax():
    """The MTP head alone, on the model's final hidden states and the next
    tokens: (B, S, V_pad) logits of token t + 2."""
    jcfg, tcfg, jparams, tparams = _pair()
    toks, nxt = _tokens(jcfg), _tokens(jcfg, seed=2)
    _, jh = j_ds.forward(jparams, jnp.asarray(toks), jcfg,
                         return_hidden=True)
    _, th = t_ds.forward(tparams, torch.from_numpy(toks), tcfg,
                         return_hidden=True)
    _close(th, jh)
    want = j_ds.mtp_logits(jparams, jh, jnp.asarray(nxt), jcfg,
                           j_ds.single_device_rules())
    got = t_ds.mtp_logits(tparams, th, torch.from_numpy(nxt), tcfg)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_remat_changes_no_number():
    """cfg.remat (torch.utils.checkpoint per layer and around the MTP
    head) gives the loss and the gradients of the run without it, bit for
    bit."""
    _, tcfg, _, tparams = _pair()
    toks = torch.from_numpy(_tokens(tcfg))
    runs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        runs.append(value_and_grad(lambda p, b: t_ds.lm_loss(p, b, b, cfg),
                                   tparams, toks))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(flatten_with_paths(runs[0][1]),
                    flatten_with_paths(runs[1][1])):
        assert torch.equal(a[1], b[1]), a[0]


def test_attn_chunk_matches_unchunked_and_jax():
    """attn_chunk = 4 < S = 16: ``chunked_causal_mha`` with MLA's widths
    (q.k 24, v 16 at the smoke config) gives the unchunked forward up to
    float32 summation order, and JAX's chunked forward, loss and
    gradients."""
    jcfg, tcfg, jparams, tparams = _pair(attn_chunk=4)
    toks = _tokens(jcfg)
    got = t_ds.forward(tparams, torch.from_numpy(toks), tcfg)
    _close(got, j_ds.forward(jparams, jnp.asarray(toks), jcfg))
    _close(got, t_ds.forward(tparams, torch.from_numpy(toks),
                             dataclasses.replace(tcfg, attn_chunk=0)))
    (jl, jg), (tl, tg), g64 = _loss_and_grads(jcfg, tcfg, jparams, tparams,
                                              toks, toks)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert_grads_close(tg, jg, g64)
    lg, cache = t_ds.prefill(tparams, torch.from_numpy(toks), tcfg)
    jlg, jcache = j_ds.prefill(jparams, jnp.asarray(toks), jcfg)
    _close(lg, jlg)
    for k in ("c", "kr"):
        _close(cache[k], jcache[k])


def test_moe_impl_ep_is_scatter_on_one_device():
    """``moe_impl="ep"`` takes ``moe_ffn`` on one device, as JAX's
    ``_block`` does without a mesh: the same logits as ``"scatter"``, bit
    for bit, and as JAX's ``"ep"``."""
    jcfg, tcfg, jparams, tparams = _pair(moe_impl="ep")
    toks = _tokens(jcfg)
    got = t_ds.forward(tparams, torch.from_numpy(toks), tcfg)
    scatter = t_ds.forward(tparams, torch.from_numpy(toks),
                           dataclasses.replace(tcfg, moe_impl="scatter"))
    assert torch.equal(got, scatter)
    _close(got, j_ds.forward(jparams, jnp.asarray(toks), jcfg))


# ---------------------------------------------------------------------------
# prefill and absorbed decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    """The last position's logits and the latent cache (c from the
    normalised block input, kr rotated), dense layers first."""
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    toks = _tokens(jcfg)
    jlg, jcache = j_ds.prefill(jparams, jnp.asarray(toks), jcfg)
    lg, cache = t_ds.prefill(tparams, torch.from_numpy(toks), tcfg)
    assert tuple(lg.shape) == jlg.shape and lg.dtype == DTYPES[dtype][1]
    for k in ("c", "kr"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert cache[k].dtype == DTYPES[dtype][1]
    if dtype == "float32":
        _close(lg, jlg)
        for k in ("c", "kr"):
            _close(cache[k], jcache[k])
        return
    fcfg, fparams = _f32_twin(jcfg, jparams)
    flg, fcache = j_ds.prefill(fparams, jnp.asarray(toks), fcfg)
    _close_bf16(lg, jlg, flg)
    for k in ("c", "kr"):
        _close_bf16(cache[k], jcache[k], fcache[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """Prefill 16 tokens, grow the cache by 8, then four absorbed decode
    steps from pos 16 (pos a device tensor advanced in place, as a decode
    loop passes it): each step's logits equal JAX's, and the cache the
    port wrote in place equals the cache JAX returned."""
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    toks = _tokens(jcfg)
    nxt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (4, 2))
    runs = [(jcfg, jparams)]
    if dtype == "bfloat16":
        runs.append(_f32_twin(jcfg, jparams))
    jax_logits, jax_caches = [], []
    for cfg, params in runs:               # JAX (and its f32 twin)
        _, c = j_ds.prefill(params, jnp.asarray(toks), cfg)
        c = _pad(c, 8)
        steps = []
        for i in range(4):
            lg, c = j_ds.decode_step(params, c, jnp.asarray(nxt[i]),
                                     jnp.int32(16 + i), cfg)
            steps.append(lg)
        jax_logits.append(steps)
        jax_caches.append(c)
    _, cache = t_ds.prefill(tparams, torch.from_numpy(toks), tcfg)
    cache = _pad(cache, 8)
    pos = torch.tensor([16], dtype=torch.int32)
    got = []
    for i in range(4):
        lg, out = t_ds.decode_step(tparams, cache, torch.from_numpy(nxt[i]),
                                   pos, tcfg)
        assert out is cache                    # written in place
        assert lg.dtype == DTYPES[dtype][1]
        pos += 1
        got.append(lg)
    assert not cache["c"][:, :, 20:].any()     # nothing past the last pos
    if dtype == "float32":
        for g, w in zip(got, jax_logits[0]):
            _close(g, w)
        for k in ("c", "kr"):
            _close(cache[k], jax_caches[0][k])
        return
    for g, w, f in zip(got, *jax_logits):
        _close_bf16(g, w, f, own_error=True)
    for k in ("c", "kr"):
        _close_bf16(cache[k], jax_caches[0][k], jax_caches[1][k])


def test_decode_at_last_position_matches_forward():
    """The JAX smoke test's own check: prefill S = 16 tokens, grow the
    cache, decode the last token again at pos 15 (int pos): the absorbed
    step's logits equal ``forward``'s at position 15 at rtol 1e-3 / atol
    1e-3 (no pair dropped: capacity_factor 8.0), and equal JAX's step."""
    jcfg, tcfg, jparams, tparams = _pair(capacity_factor=NO_DROP)
    toks = _tokens(jcfg)
    _, cache = t_ds.prefill(tparams, torch.from_numpy(toks), tcfg)
    lg, _ = t_ds.decode_step(tparams, _pad(cache, 16),
                             torch.from_numpy(toks[:, -1]), 15, tcfg)
    full = t_ds.forward(tparams, torch.from_numpy(toks), tcfg)[:, 15, :]
    np.testing.assert_allclose(_np(lg), _np(full), rtol=1e-3, atol=1e-3)
    _, jc = j_ds.prefill(jparams, jnp.asarray(toks), jcfg)
    jlg, _ = j_ds.decode_step(jparams, _pad(jc, 16),
                              jnp.asarray(toks[:, -1]), jnp.int32(15), jcfg)
    _close(lg, jlg)


def test_decode_into_a_bf16_cache_matches_jax():
    """A float32 model decoding into ``init_cache``'s bf16 cache: the
    logit products in the promoted dtype (float32), the probabilities and
    the latent output in the cache's bf16, as JAX promotes them. Three
    steps from an empty cache; the bf16 rule, against the same steps into
    a float32 cache."""
    jcfg, tcfg, jparams, tparams = _pair()
    nxt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (3, 2))
    cache = t_ds.init_cache(tcfg, 2, 8, device="cpu")
    jc = j_ds.init_cache(jcfg, 2, 8)
    fc = j_ds.init_cache(jcfg, 2, 8, dtype=jnp.float32)
    for i in range(3):
        lg, cache = t_ds.decode_step(tparams, cache,
                                     torch.from_numpy(nxt[i]), i, tcfg)
        jlg, jc = j_ds.decode_step(jparams, jc, jnp.asarray(nxt[i]),
                                   jnp.int32(i), jcfg)
        flg, fc = j_ds.decode_step(jparams, fc, jnp.asarray(nxt[i]),
                                   jnp.int32(i), jcfg)
        assert lg.dtype == torch.float32
        _close_bf16(lg, jlg, flg)
    for k in ("c", "kr"):
        assert cache[k].dtype == torch.bfloat16
        _close_bf16(cache[k], jc[k], fc[k])


def test_decode_attention_takes_one_position():
    _, tcfg, _, tparams = _pair()
    lp, _ = next(t_ds.layers(tparams, tcfg))
    cache = t_ds.init_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    rope = t_layers.rope_angles(torch.zeros(2, 2), tcfg.qk_rope_head_dim)
    with pytest.raises(ValueError, match="one position"):
        t_ds._mla_decode(tcfg, lp["attn"], torch.zeros(2, 2, tcfg.d_model),
                         cache["c"][0], cache["kr"][0], torch.tensor([0]),
                         rope, torch.ones(1, 8, dtype=torch.bool))


def test_layers_walk_dense_then_moe():
    _, tcfg, _, tparams = _pair()
    kinds = [is_moe for _, is_moe in t_ds.layers(tparams, tcfg)]
    assert kinds == [False] * tcfg.n_dense_layers + [True] * (
        tcfg.n_layers - tcfg.n_dense_layers)
    lp, _ = next(t_ds.layers(tparams, tcfg))
    assert lp["attn"]["wq_a"].data_ptr() == \
        tparams["dense_layers"]["attn"]["wq_a"].data_ptr()    # views
