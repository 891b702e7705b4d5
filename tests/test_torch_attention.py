"""The port's decode and flash attention kernel wrappers, and its attention
layers, against the JAX package.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
run only on the card: ``test_library_kernels_match_plain_on_card`` there,
and ``chip_smoke.py``). Inputs come from numpy seeds and go through both
sides; the JAX kernels run as the JAX package's own tests run them here
(Pallas in interpret mode), beside their jnp refs.

Tolerances:
- float32: rtol/atol 2e-4, the JAX kernel tests' own (an online softmax
  against a one-pass one, sums in another order).
- bfloat16 q/k/v against the jnp refs: 2e-4 as well, since both sides
  widen the same bf16 values and compute in float32.
- bfloat16 against the Pallas kernels: 2e-2, the JAX bf16 test tolerance,
  because the Pallas kernels round P to bf16 before P @ V (a relative
  2^-8 per weight); the port keeps P in float32.
- The model layers: 1e-5 in float32; 2e-2 in bfloat16 (both sides cast
  the probabilities to bf16 and multiply in bf16).
- The emulations of the tensor-core kernels' arithmetic (bf16 inputs, a
  tile-wise online softmax, P and a float32 q split into bf16 hi + lo,
  float32 sums): 2e-4 against the jnp refs and the Pallas kernels, fed the
  same bf16 values as float32 (so the Pallas kernels do not round P).
- The emulation of the float32 kernel's 3xTF32 arithmetic (every operand
  split into TF32 big + small, three products per GEMM, float32 sums):
  2e-4 against the jnp ref and the Pallas kernel, as the float32 sweep;
  against the card's own 1e-4/1e-5 check in the split test.
"""
import math
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import (  # noqa: E402
    decode_attention as jax_decode)
from repro.kernels.decode_attn.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attn import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    flash_attention_ref as port_flash_ref)
from repro_torch.models import layers  # noqa: E402

BF16 = ml_dtypes.bfloat16
RTOL = ATOL = 2e-4
BF16_PALLAS_TOL = 2e-2


def _normal(seed, *shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32).astype(dtype)


def _t(a):
    return layers.tensor_from_jax(a, device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

DECODE_SWEEP = [(2, 8, 2, 32, 128, 100, 64), (1, 4, 4, 64, 300, 300, 128),
                (3, 8, 4, 16, 1024, 77, 256), (2, 16, 8, 64, 512, 512, 512)]


def _cache(seed, b, h, kv, hd, t, dtype=np.float32):
    return (_normal(seed, b, h, hd, dtype=dtype),
            _normal(seed + 1, b, t, kv, hd, dtype=dtype),
            _normal(seed + 2, b, t, kv, hd, dtype=dtype))


@pytest.mark.parametrize("b,h,kv,hd,t,ln,bt", DECODE_SWEEP)
def test_decode_matches_jax_sweep(b, h, kv, hd, t, ln, bt):
    q, k, v = _cache(b * t, b, h, kv, hd, t)
    got = decode_attention(_t(q), _t(k), _t(v), ln, block_t=bt)
    assert got.shape == (b, h, hd) and got.dtype == torch.float32
    pallas = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ln,
                        block_t=bt)
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.int32(ln))
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


def test_decode_empty_prefix_gives_zeros_as_pallas():
    """length = 0: the Pallas kernel's guards give zeros; the jnp ref's
    softmax over an all -inf row gives NaN. The port follows the kernel."""
    q, k, v = _cache(1, 2, 8, 2, 32, 128)
    got = decode_attention(_t(q), _t(k), _t(v), 0)
    assert (got == 0).all()
    pallas = _np(jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            0, block_t=64))
    np.testing.assert_array_equal(got.numpy(), pallas)
    ref = _np(decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(0)))
    assert np.isnan(ref).all()


def test_decode_length_beyond_cache_acts_as_full_cache():
    q, k, v = _cache(2, 1, 4, 4, 16, 96)
    got = decode_attention(_t(q), _t(k), _t(v), 500)
    np.testing.assert_array_equal(got.numpy(), decode_attention(
        _t(q), _t(k), _t(v), 96).numpy())
    pallas = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 500,
                        block_t=32)
    np.testing.assert_allclose(got.numpy(), _np(pallas), rtol=RTOL,
                               atol=ATOL)


def test_decode_length_as_device_tensor():
    """A one-element int32 tensor (how a decode loop keeps the prefix on
    the device) gives what the int gives."""
    q, k, v = _cache(3, 2, 8, 2, 16, 200)
    length = torch.tensor([123], dtype=torch.int32)
    assert torch.equal(decode_attention(_t(q), _t(k), _t(v), length),
                       decode_attention(_t(q), _t(k), _t(v), 123))


def test_decode_bf16_cache():
    q, k, v = _cache(4, 2, 8, 2, 32, 256, dtype=BF16)
    got = decode_attention(_t(q), _t(k), _t(v), 200)
    assert got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got.numpy(), _np(decode_attention_ref(jq, jk, jv, jnp.int32(200))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), _np(jax_decode(jq, jk, jv, 200, block_t=64)),
        rtol=BF16_PALLAS_TOL, atol=BF16_PALLAS_TOL)
    # a float32 query over the bf16 cache: the same products
    got32 = decode_attention(_t(q.astype(np.float32)), _t(k), _t(v), 200)
    np.testing.assert_allclose(got32.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_decode_matches_gqa_layer():
    """Kernel wrapper == the JAX model's grouped attention on a cache
    prefix (and the port's own ``gqa_attention``)."""
    B, H, KV, hd, T, ln = 2, 8, 4, 32, 256, 199
    q, k, v = (_normal(0, B, 1, H, hd), _normal(1, B, T, KV, hd),
               _normal(2, B, T, KV, hd))
    mask = np.arange(T)[None, :] < ln
    want = _np(jax_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        mask=jnp.asarray(mask))[:, 0])
    got = decode_attention(_t(q[:, 0]), _t(k), _t(v), ln)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    port = layers.gqa_attention(_t(q), _t(k), _t(v),
                                mask=torch.from_numpy(mask))[:, 0]
    np.testing.assert_allclose(port.numpy(), want, rtol=1e-5, atol=1e-5)


def test_decode_wrapper_refuses_bad_arguments():
    q, k, v = (torch.zeros((2, 8, 16)), torch.zeros((2, 32, 2, 16)),
               torch.zeros((2, 32, 2, 16)))
    with pytest.raises(TypeError):
        decode_attention(q, k.half(), v.half(), 4)
    with pytest.raises(TypeError):
        decode_attention(q.bfloat16(), k, v, 4)
    with pytest.raises(ValueError):
        decode_attention(q, k, v[:, :16], 4)
    with pytest.raises(ValueError):
        decode_attention(torch.zeros((2, 6, 16)), k, torch.zeros(
            (2, 32, 4, 16)), 4)
    # on meta (shapes only) the op's fake implementation answers
    out = decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 4)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_SWEEP = [(2, 128, 4, 32, 32, 32), (1, 100, 2, 16, 32, 32),
               (2, 256, 2, 64, 64, 128), (1, 64, 8, 8, 64, 16)]


def _qkv(seed, b, s, h, hd, dtype=np.float32):
    return tuple(_normal(seed + i, b, s, h, hd, dtype=dtype)
                 for i in range(3))


@pytest.mark.parametrize("b,s,h,hd,bq,bk", FLASH_SWEEP)
def test_flash_matches_jax_sweep(b, s, h, hd, bq, bk):
    q, k, v = _qkv(s, b, s, h, hd)
    got = flash_attention(_t(q), _t(k), _t(v), block_q=bq, block_k=bk)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (jax_flash(jq, jk, jv, block_q=bq, block_k=bk),
                 flash_attention_ref(jq, jk, jv)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


def test_flash_ragged_length_with_unequal_blocks():
    """S = 100 with block_q = 32 and block_k = 64: the JAX wrapper pads S
    to 128; the port masks the ragged edge instead."""
    q, k, v = _qkv(5, 2, 100, 2, 16)
    got = flash_attention(_t(q), _t(k), _t(v), block_q=32, block_k=64)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=32, block_k=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def test_flash_bf16():
    q, k, v = _qkv(6, 1, 96, 2, 32, dtype=BF16)
    got = flash_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(got.numpy(),
                               _np(flash_attention_ref(jq, jk, jv)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               _np(jax_flash(jq, jk, jv, block_q=32,
                                             block_k=32)),
                               rtol=BF16_PALLAS_TOL, atol=BF16_PALLAS_TOL)


def test_flash_reads_strided_layouts():
    """A (B, H, S, hd) tensor viewed as (B, S, H, hd) gives what its
    contiguous copy gives (the kernel reads through strides)."""
    q, k, v = (_t(x) for x in _qkv(7, 2, 40, 3, 8))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qs.is_contiguous()
    assert torch.equal(flash_attention(qs, k, v), flash_attention(q, k, v))


def test_flash_wrapper_refuses_bad_arguments():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :4], q)
    with pytest.raises(ValueError):
        flash_attention(q, q, q.bfloat16())
    # on meta (shapes only) the op's fake implementation answers
    out = flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# the tensor-core kernels' arithmetic (csrc/flash_attn_tc.cu and the bf16
# chunk kernel of csrc/decode_attn.cu), emulated in plain PyTorch
# ---------------------------------------------------------------------------

# the card's kernel-vs-plain check (chip_smoke.ATTN_RTOL, ATTN_ATOL)
CARD_RTOL, CARD_ATOL = 1e-4, 1e-5


def _split(x):
    """float32 -> (hi, lo) bf16: hi = bf16(x), lo = bf16(x - hi), as the
    kernels split P (and decode a float32 q) for two bf16 products."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_matmul(a, b):
    """a (float32) @ b (bf16) as the tensor cores do it: a split hi + lo,
    two bf16 products, float32 sums."""
    hi, lo = _split(a)
    return hi.float() @ b.float() + lo.float() @ b.float()


def flash_tc_emulation(q, k, v, tile=128, split_p=True):
    """The tensor-core flash kernel's arithmetic on bf16 (B, S, H, hd):
    key tiles of ``tile`` up to the diagonal, the online softmax in
    float32 (a masked logit gives 0, m = -inf keeps exponent base 0), and
    O += P V with P split hi + lo (or, with ``split_p`` False, rounded once
    to bf16 as the Pallas kernel does). Returns (B, S, H, hd) float32."""
    B, S, H, hd = q.shape
    qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, S, hd)
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = (qf.float() @ kt.float().transpose(-1, -2)) / math.sqrt(hd)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        s = s.masked_fill(kpos > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        corr, p = torch.exp(m - base), torch.exp(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = _split_matmul(p, vt) if split_p else \
            p.to(torch.bfloat16).float() @ vt.float()
        acc, m = acc * corr + pv, m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


def decode_tc_emulation(q, k, v, length, tile=64):
    """The tensor-core decode kernel's arithmetic: q (B, H, hd) bf16 or
    float32 (split hi + lo, two products), a bf16 (B, T, KV, hd) cache
    walked in tiles of ``tile`` positions below ``length``, the online
    softmax in float32, P split hi + lo. Returns (B, H, hd) float32;
    length <= 0 gives zeros."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    n = max(0, min(int(length), T))
    qg = q.reshape(B, KV, G, 1, hd)
    parts = _split(qg.float()) if q.dtype == torch.float32 else (qg,)
    kf = k.permute(0, 2, 1, 3)[:, :, None]    # (B, KV, 1, T, hd)
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, KV, G, 1, 1), -math.inf)
    l = torch.zeros((B, KV, G, 1, 1))
    acc = torch.zeros((B, KV, G, 1, hd))
    for t0 in range(0, n, tile):
        t1 = min(t0 + tile, n)
        kt, vt = kf[:, :, :, t0:t1], vf[:, :, :, t0:t1]
        s = sum(part.float() @ kt.float().transpose(-1, -2)
                for part in parts) / math.sqrt(hd)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc, m = acc * corr + _split_matmul(p, vt), m_new
    return (acc / l.clamp_min(1e-30)).reshape(B, H, hd)


def _bf16_values(seed, *shape):
    """N(0, 1) values rounded to bf16: as a bf16 tensor for the emulation
    and as float32 numpy for the JAX side (the same numbers)."""
    t = torch.from_numpy(_normal(seed, *shape)).to(torch.bfloat16)
    return t, t.float().numpy()


@pytest.mark.parametrize("dist", ["normal", "probabilities", "wide"])
def test_bf16_split_reconstructs_float32(dist):
    """hi + lo is within 2^-16 of x, relative, for float32 x (N(0, 1),
    softmax weights in (0, 1], and magnitudes across 2^-60..2^60)."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=100_000).astype(np.float32)
    if dist == "probabilities":
        x = np.exp(-np.abs(x) * 8).astype(np.float32)
    elif dist == "wide":
        x = (x * np.exp2(rng.integers(-60, 60, size=x.size))).astype(
            np.float32)
    xt = torch.from_numpy(x)
    hi, lo = _split(xt)
    err = (hi.double() + lo.double() - xt.double()).abs()
    assert (err <= 2.0 ** -16 * xt.double().abs()).all()
    assert (err / xt.double().abs()).max() < 2.0 ** -16


FLASH_TC_SWEEP = [c[:4] for c in FLASH_SWEEP if c[3] in
                  flash_ops.TC_HEAD_DIMS] + [(2, 77, 8, 16), (1, 300, 2, 128)]


@pytest.mark.parametrize("b,s,h,hd", FLASH_TC_SWEEP)
def test_flash_tc_emulation_matches_jax(b, s, h, hd):
    (q, qn), (k, kn), (v, vn) = (_bf16_values(s + i, b, s, h, hd)
                                 for i in range(3))
    got = flash_tc_emulation(q, k, v)
    jq, jk, jv = jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn)
    bq = 32 if s % 32 == 0 else 16
    for want in (flash_attention_ref(jq, jk, jv),
                 jax_flash(jq, jk, jv, block_q=bq, block_k=bq)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


def test_flash_tc_split_holds_the_card_tolerance():
    """At hd = 128 over 512 keys: P split hi + lo stays inside the card's
    check against the exact plain version; P rounded once to bf16 (the
    Pallas way) misses it many times over. This is why the kernel splits."""
    q, k, v = (_bf16_values(50 + i, 1, 512, 2, 128)[0] for i in range(3))
    want = port_flash_ref(q, k, v).double()
    lim = CARD_ATOL + CARD_RTOL * want.abs()
    split = ((flash_tc_emulation(q, k, v).double() - want).abs() / lim).max()
    once = ((flash_tc_emulation(q, k, v, split_p=False).double() - want)
            .abs() / lim).max()
    assert split < 0.5 and once > 20


def _tf32(x):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to the nearest value
    with 10 mantissa bits, ties away from zero (add half of the 13 dropped
    bits to the magnitude, then clear them), kept in a float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_toward_zero(x):
    """float32 -> TF32 as the MMA reads a float32 register: the low 13
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """float32 -> (big, small) as the float32 kernel splits an operand and
    the MMA reads it: big = TF32(x) by ``cvt.rna``'s rule, small = x - big
    (exact), read as TF32 toward zero."""
    big = _tf32(x)
    return big, _tf32_toward_zero(x - big)


def _tf32_matmul(a, b, form="3x"):
    """a @ b (float32) as the float32 kernel's tensor cores take it:
    ``"3x"`` big*big + big*small + small*big (the kernel), ``"1x"`` one
    TF32 product (TF32 mode), ``"a_split"`` only a split (big*big +
    small*big: b rounded once to TF32). Sums in float32, the cross terms
    first."""
    ab, am = _split_tf32(a)
    bb, bm = _split_tf32(b)
    if form == "1x":
        return ab @ bb
    if form == "a_split":
        return am @ bb + ab @ bb
    return (am @ bb + ab @ bm) + ab @ bb


def flash_tf32x3_emulation(q, k, v, tile=64, pv_form="3x", s_form="3x"):
    """The float32 tensor-core flash kernel's arithmetic on float32 (B, S,
    H, hd): key tiles of ``tile`` up to the diagonal, S = Q K^T and O +=
    P V each through ``_tf32_matmul`` (``s_form``, ``pv_form``), the
    online softmax in float32 per tile (a masked logit gives 0, m = -inf
    keeps exponent base 0). Returns (B, S, H, hd) float32."""
    B, S, H, hd = q.shape
    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = _tf32_matmul(qf, kt.transpose(-1, -2), s_form) / math.sqrt(hd)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        s = s.masked_fill(kpos > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        corr, p = torch.exp(m - base), torch.exp(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        acc, m = acc * corr + _tf32_matmul(p, vt, pv_form), m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("dist", ["normal", "probabilities", "wide"])
def test_tf32_split_reconstructs_float32(dist):
    """big + small, as the MMA reads them, is within 2^-21 of x, relative
    (N(0, 1), softmax weights in (0, 1], magnitudes across 2^-60..2^60);
    big alone, as TF32 mode keeps it, only within 2^-11; big's ties round
    away from zero."""
    rng = np.random.default_rng(41)
    x = rng.normal(size=100_000).astype(np.float32)
    if dist == "probabilities":
        x = np.exp(-np.abs(x) * 8).astype(np.float32)
    elif dist == "wide":
        x = (x * np.exp2(rng.integers(-60, 60, size=x.size))).astype(
            np.float32)
    xt = torch.from_numpy(x)
    big, small = _split_tf32(xt)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    rel = ((big.double() + small.double() - xt.double()).abs()
           / xt.double().abs())
    assert rel.max() < 2.0 ** -21
    assert (big.double() - xt.double()).abs().div(xt.double().abs()).max() \
        < 2.0 ** -11
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -9)]


FLASH_TF32_SWEEP = [c[:4] for c in FLASH_SWEEP] + [(2, 77, 8, 16),
                                                   (1, 300, 2, 128)]


@pytest.mark.parametrize("b,s,h,hd", FLASH_TF32_SWEEP)
def test_flash_tf32x3_emulation_matches_jax(b, s, h, hd):
    """At every width of the float32 kernel, hd = 8 included."""
    q, k, v = _qkv(s + 1, b, s, h, hd)
    got = flash_tf32x3_emulation(_t(q), _t(k), _t(v))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    bq = 32 if s % 32 == 0 else 16
    for want in (flash_attention_ref(jq, jk, jv),
                 jax_flash(jq, jk, jv, block_q=bq, block_k=bq)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


def test_flash_tf32_split_holds_the_card_tolerance():
    """At hd = 128 over 512 keys, float32 inputs: 3xTF32 on both products
    stays well inside the card's check against the exact plain version;
    one TF32 product each (TF32 mode), and 3xTF32 with V left unsplit in
    P V, miss it more than 10x. This is why the kernel splits every
    operand."""
    q, k, v = (_t(x) for x in _qkv(70, 1, 512, 2, 128))
    want = port_flash_ref(q, k, v).double()
    lim = CARD_ATOL + CARD_RTOL * want.abs()

    def ratio(**form):
        got = flash_tf32x3_emulation(q, k, v, **form).double()
        return float(((got - want).abs() / lim).max())
    assert ratio() < 0.25
    assert ratio(s_form="1x", pv_form="1x") > 10
    assert ratio(pv_form="a_split") > 10


DECODE_TC_SWEEP = [c[:6] for c in DECODE_SWEEP]


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,kv,hd,t,ln", DECODE_TC_SWEEP)
def test_decode_tc_emulation_matches_jax(b, h, kv, hd, t, ln, q_dtype):
    (q, qn), (k, kn), (v, vn) = (_bf16_values(b * t, b, h, hd),
                                 _bf16_values(b * t + 1, b, t, kv, hd),
                                 _bf16_values(b * t + 2, b, t, kv, hd))
    if q_dtype == "float32":   # a float32 q over the bf16 cache
        qn = _normal(b * t + 3, b, h, hd)
        q = torch.from_numpy(qn)
    got = decode_tc_emulation(q, k, v, ln)
    jq, jk, jv = jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn)
    for want in (decode_attention_ref(jq, jk, jv, jnp.int32(ln)),
                 jax_decode(jq, jk, jv, ln, block_t=64)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("length", [0, -3, 700])
def test_decode_tc_emulation_edges_match_pallas(length):
    """length 0 (or below) gives zeros, length > T acts as T, as in the
    Pallas kernel (the jnp ref gives NaN at 0)."""
    (q, qn), (k, kn), (v, vn) = (_bf16_values(60, 2, 8, 32),
                                 _bf16_values(61, 2, 256, 2, 32),
                                 _bf16_values(62, 2, 256, 2, 32))
    got = decode_tc_emulation(q, k, v, length)
    want = jax_decode(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                      max(length, 0), block_t=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    if length <= 0:
        assert (got == 0).all()


def test_decode_split_fills_one_wave_for_the_tensor_cores():
    """The split aims at BLOCKS_PER_SM blocks per SM in chunks of whole
    tiles; for the tensor-core kernel with fewer (batch, kv head) rows
    than one wave of resident blocks, at exactly one wave."""
    for B, T in ((128, 32768), (1, 524288), (1, 4096), (4, 300)):
        for resident in (0, 2, 4):
            chunk, n = decode_ops.split(B, 4, T, 132, resident)
            assert chunk % decode_ops.TILE == 0
            assert (n - 1) * chunk < T <= n * chunk
            if resident:
                assert B * 4 * n <= max(resident * 132, B * 4 * 5)
    assert decode_ops.split(128, 4, 32768, 132) == (6656, 5)
    assert decode_ops.split(128, 4, 32768, 132, 2) == (6656, 5)
    assert decode_ops.split(1, 4, 524288, 132, 2) == (8064, 66)
    assert decode_ops.split(1, 4, 524288, 132) == (1024, 512)


@pytest.mark.parametrize("module", [flash_ops, decode_ops])
def test_kernel_path_by_dtype_and_head_width(module):
    """bf16 at hd >= 16 goes to the tensor cores, bf16 at hd = 8 (under
    the MMA's k16 depth) stays on the CUDA cores; float32 flash goes to the
    3xTF32 tensor-core kernel, float32 decode stays on the CUDA cores."""
    f32_path = "tensor_core_tf32" if module is flash_ops else "cuda_core"
    for hd in module.HEAD_DIMS:
        assert module.kernel_path(torch.float32, hd) == f32_path
        assert module.kernel_path(torch.bfloat16, hd) == (
            "cuda_core" if hd == 8 else "tensor_core")


def test_flash_float32_path_is_the_tf32_split_at_every_width():
    """Float32 flash takes the 3xTF32 kernel at every compiled width (the
    k8 step fits hd = 8); its launches are counted under its own path, and
    it reads through TMA like the bf16 tensor-core kernel."""
    assert {flash_ops.kernel_path(torch.float32, hd)
            for hd in flash_ops.HEAD_DIMS} == {"tensor_core_tf32"}
    assert set(flash_attention.path_launches) == {
        "tensor_core_tf32", "tensor_core", "cuda_core"}
    assert flash_ops.ENTRY["tensor_core_tf32"] == "flash_attention_tf32"
    q = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="float32 q is read by TMA"):
        flash_ops._check_tma(q[:, :, :, :6].contiguous()[..., :5], q, q)
    flash_ops._check_tma(q, q, q)


# ---------------------------------------------------------------------------
# the attention layers
# ---------------------------------------------------------------------------

def test_causal_mask_matches_jax():
    for S, T in ((5, 5), (3, 8), (1, 6)):
        np.testing.assert_array_equal(
            layers.causal_mask(S, T, device="cpu").numpy(),
            np.asarray(jax_layers.causal_mask(S, T)))


def test_expand_kv_matches_jax():
    k = _normal(8, 2, 5, 2, 4)
    np.testing.assert_array_equal(layers.expand_kv(_t(k), 8).numpy(),
                                  np.asarray(jax_layers.expand_kv(
                                      jnp.asarray(k), 8)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_and_gqa_match_jax(dtype):
    np_dtype = np.float32 if dtype == "float32" else BF16
    tol = 1e-5 if dtype == "float32" else 2e-2
    B, S, T, H, KV, hd = 2, 6, 10, 4, 2, 8
    q = _normal(9, B, S, H, hd, dtype=np_dtype)
    k = _normal(10, B, T, KV, hd, dtype=np_dtype)
    v = _normal(11, B, T, KV, hd, dtype=np_dtype)
    mask = np.asarray(jax_layers.causal_mask(S, T))
    got = layers.gqa_attention(_t(q), _t(k), _t(v),
                               mask=torch.tensor(mask))
    want = jax_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask=jnp.asarray(mask))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol,
                               atol=tol)
    ke, ve = layers.expand_kv(_t(k), H), layers.expand_kv(_t(v), H)
    got = layers.mha_attention(_t(q), ke, ve, mask=torch.tensor(mask))
    want = jax_layers.mha_attention(
        jnp.asarray(q), jax_layers.expand_kv(jnp.asarray(k), H),
        jax_layers.expand_kv(jnp.asarray(v), H), mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol,
                               atol=tol)


def test_chunked_causal_mha_matches_jax():
    B, S, H, hd = 2, 64, 4, 16
    q, k, v = _qkv(12, B, S, H, hd)
    full = layers.mha_attention(_t(q), _t(k), _t(v),
                                mask=layers.causal_mask(S, device="cpu"))
    for chunk in (16, 32):
        got = layers.chunked_causal_mha(_t(q), _t(k), _t(v), chunk)
        want = jax_layers.chunked_causal_mha(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), chunk)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError):
        layers.chunked_causal_mha(_t(q), _t(k), _t(v), 24)


# ---------------------------------------------------------------------------
# the slice as a whole, at Yi-9B's smoke width (H = 8, KV = 2, hd = 16)
# ---------------------------------------------------------------------------

def test_slice_decode_over_cache_prefix_matches_jax_layer():
    B, H, KV, hd, T = 3, 8, 2, 16, 160
    for ln in (1, 97, T):
        q, k, v = (_normal(13, B, 1, H, hd), _normal(14, B, T, KV, hd),
                   _normal(15, B, T, KV, hd))
        mask = np.broadcast_to(np.arange(T) < ln, (1, T))
        want = jax_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        mask=jnp.asarray(mask))[:, 0]
        got = decode_attention(_t(q[:, 0]), _t(k), _t(v),
                               torch.tensor([ln], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


def test_slice_causal_prefill_matches_jax_layer():
    B, S, H, KV, hd = 2, 72, 8, 2, 16
    q = _normal(16, B, S, H, hd)
    k, v = _normal(17, B, S, KV, hd), _normal(18, B, S, KV, hd)
    want = jax_layers.mha_attention(
        jnp.asarray(q), jax_layers.expand_kv(jnp.asarray(k), H),
        jax_layers.expand_kv(jnp.asarray(v), H),
        mask=jax_layers.causal_mask(S))
    got = flash_attention(_t(q), layers.expand_kv(_t(k), H),
                          layers.expand_kv(_t(v), H))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_library_kernels_match_plain_on_card():
    """On a card: embedding_bag, decode_attention and flash_attention
    against their plain versions at the JAX test shapes and at DLRM-RM2
    and Yi-9B widths (the checks of chip_smoke.py's library phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    report = chip_smoke.check_library_kernels(torch, torch.device("cuda"))
    assert set(report) == {"embedding_bag", "decode_attention",
                           "flash_attention"}
