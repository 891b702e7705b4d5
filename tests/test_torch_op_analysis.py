"""The op counter (``launch/op_analysis.py``) drives the dry run's numbers:
the four checks of ``tests/test_hlo_analysis.py`` restated for it (one
product, a loop of L products, no collectives, an elementwise op's bytes),
the attention custom ops counted alike on meta and on the CPU, the counted
dot FLOPs of two cells at their smoke configs equal to JAX's
``analyze_hlo`` of the same cell compiled, and a meta init of the full
DeepSeek-V3 config in seconds."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402
from repro_torch.kernels.decode_attn.ops import decode_flops  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_flops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.op_analysis import analyze_ops, nbytes  # noqa: E402
from repro_torch.models import deepseek  # noqa: E402
from repro_torch.tree import tree_bytes, tree_leaves  # noqa: E402


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_dot_flops(device):
    a = torch.randn(64, 128, device=device)
    b = torch.randn(128, 32, device=device)
    rep = analyze_ops(lambda x, y: x @ y, a, b)
    assert rep.flops == 2 * 64 * 128 * 32
    assert tuple(rep.output.shape) == (64, 32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_vector_products_count_as_dots(device):
    """A matrix-vector and a vector product: 2 x M x K and 2 x K, as HLO's
    dot counts them (BERT4Rec's candidate scores are one)."""
    a = torch.randn(100, 64, device=device)
    x = torch.randn(64, device=device)
    assert analyze_ops(lambda m, v: m @ v, a, x).flops == 2 * 100 * 64
    assert analyze_ops(torch.dot, x, x).flops == 2 * 64
    assert analyze_ops(lambda m, v: torch.addmv(v[:1].expand(100), m, v),
                       a, x).flops == 2 * 100 * 64


@pytest.mark.parametrize("L", [3, 9])
def test_loop_of_products_counts_every_trip(L):
    """A Python loop over L layers (the port's counterpart of a scan):
    every trip dispatches, so the count is L times one layer's."""
    def fn(params, x):
        h = x
        for i in range(params.shape[0]):
            h = torch.tanh(h @ params[i])
        return h.sum()

    params = torch.randn(L, 32, 32, device="meta")
    x = torch.randn(8, 32, device="meta")
    rep = analyze_ops(fn, params, x)
    assert rep.flops == L * 2 * 8 * 32 * 32
    assert rep.trip_counts == {}


def test_no_collectives_single_device():
    a = torch.randn(16, 16)
    rep = analyze_ops(lambda x: x @ x, a)
    assert rep.total_collective_bytes == 0 and rep.collective_bytes == {}
    assert set(rep.to_dict()) == {"flops", "bytes_accessed", "bytes_bf16eq",
                                  "collective_bytes",
                                  "total_collective_bytes", "trip_counts"}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_elementwise_bytes_are_inputs_plus_output(device):
    x = torch.randn(1024, 1024, device=device)
    y = torch.randn(1024, 1024, device=device)
    n = 1024 * 1024 * 4
    rep = analyze_ops(lambda a: a * 2, x)
    assert rep.bytes_accessed == 2 * n
    assert rep.bytes_bf16eq == n            # float32 counted at 2 bytes
    assert analyze_ops(lambda a, b: a + b, x, y).bytes_accessed == 3 * n
    # a view moves nothing; the copy it feeds reads and writes its size
    rep = analyze_ops(lambda a: a.t().contiguous(), x)
    assert rep.bytes_accessed == 2 * n
    xb = x.to(torch.bfloat16)
    assert nbytes(xb) == nbytes(xb, cap_float=2) == n // 2


def test_attention_ops_count_alike_on_meta_and_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, 16, generator=g)
    qd = torch.randn(2, 8, 16, generator=g)
    kc = torch.randn(2, 40, 2, 16, generator=g)
    counts = {}
    for dev in ("cpu", "meta"):
        qq, dq, kk = q.to(dev), qd.to(dev), kc.to(dev)
        length = torch.tensor([9], dtype=torch.int32, device=dev)
        counts[dev] = (
            analyze_ops(flash_attention, qq, qq, qq).flops,
            analyze_ops(decode_attention, dq, kk, kk, 9).flops,
            analyze_ops(decode_attention, dq, kk, kk, length).flops)
    assert counts["cpu"] == counts["meta"]
    # causal flash work; a host-int prefix counts its keys, a prefix held
    # in a tensor (no value on meta, a host sync on the card) all T keys
    assert counts["cpu"] == (flash_flops(2, 24, 4, 16),
                             decode_flops(2, 8, 16, 9),
                             decode_flops(2, 8, 16, 40))
    assert flash_flops(1, 4, 1, 1) == 4 * 10


def _smoke_pair(name, dims):
    ja, ta = j_get_arch(name), get_arch(name)
    ja = dataclasses.replace(ja, make_config=ja.make_smoke_config)
    ta = dataclasses.replace(ta, make_config=ta.make_smoke_config)
    return ja, ta, JShapeSpec(*dims), ShapeSpec(*dims)


@pytest.mark.parametrize("name,dims", [
    ("dlrm-rm2", ("serve_p99", "serve", {"batch": 512})),
    ("deepseek-v3-671b", ("decode_32k", "decode", {"seq": 64, "batch": 4})),
])
def test_counted_flops_equal_jax_hlo(name, dims):
    """The products the port's step dispatches on meta are the dots of
    JAX's compiled step, FLOP for FLOP (``analyze_hlo`` weights the layer
    scan by its trip count; eager PyTorch dispatches each layer)."""
    ja, ta, jshape, tshape = _smoke_pair(name, dims)
    mesh = make_test_mesh(1, 1)
    jb, tb = ((j_steps.build_recsys_job, steps.build_recsys_job)
              if ja.family == "recsys" else
              (j_steps.build_lm_job, steps.build_lm_job))
    jjob, tjob = jb(ja, jshape, mesh), tb(ta, tshape)
    with mesh:
        compiled = jax.jit(jjob.step_fn).lower(*jjob.args).compile()
    want = analyze_hlo(compiled.as_text()).flops
    got = analyze_ops(tjob.step_fn, *tjob.args).flops
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_meta_init_of_deepseek_v3_takes_seconds():
    """The full 671B config on meta draws nothing: seconds, not the ~100 s
    a CPU generator took to draw 671e9 numbers."""
    cfg = get_arch("deepseek-v3-671b").make_config()
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    t0 = time.perf_counter()
    params, _ = deepseek.init_params(gen, cfg, device="meta")
    assert time.perf_counter() - t0 < 10.0
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    n = sum(t.numel() for t in tree_leaves(params))
    assert 6.7e11 < n < 6.9e11
    assert tree_bytes(params) == 2 * n          # bf16
    assert torch.equal(gen.get_state(), state)  # nothing drawn


def test_cpu_draws_unchanged_by_the_meta_path():
    """On the CPU the init draws what it drew before the meta branch:
    ``dense_init`` is N(0, 1) x 1/sqrt(d_in) from the generator."""
    from repro_torch.models import layers as L
    w = L.dense_init(torch.Generator().manual_seed(3), 5, 7, device="cpu")
    want = torch.randn((5, 7), generator=torch.Generator().manual_seed(3),
                       dtype=torch.float32) * (1.0 / np.sqrt(5))
    assert torch.equal(w, want)
    s = L.stacked_normal(torch.Generator().manual_seed(4), 2, (3, 4), 0.5,
                         torch.float32, "cpu")
    g = torch.Generator().manual_seed(4)
    want = torch.stack([torch.randn((3, 4), generator=g) * 0.5
                        for _ in range(2)])
    assert torch.equal(s, want)
    ids = torch.tensor([3, 1, 3, 0])
    rows = torch.randn(4, 2)
    got = L.segment_sum_rows(rows, ids, 5)
    want = torch.zeros(5, 2).index_add_(0, ids, rows)
    assert torch.equal(got, want)
    meta = L.segment_sum_rows(rows.to("meta"), ids.to("meta"), 5)
    assert meta.shape == (5, 2) and meta.device.type == "meta"
