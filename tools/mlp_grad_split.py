#!/usr/bin/env python3
"""Where a grad kernel's time goes: device µs per call of cut-down copies
of it, timed in turns in one process at the serving shape (Q = 32 frontier
rows, per-row queries; ``--measure mlp``: Dx = Dq = 40, MLP 80 -> 64 -> 64
-> 1; ``--measure deepfm``: D = 40, fm = 8, deep input 64 -> 64 -> 64 ->
1), each under CUDA-graph replay as ``chip_smoke.time_ms`` times the
kernels.

Variants of the one-warp-per-row layout (``mlp_stage`` and
``mlp_forward_warp`` of ``csrc/mlp.cuh``, the score path's, at its grid of
Q / 8 blocks of 256 threads and its shared memory):

- ``warp_empty``: the launch alone, nothing done;
- ``warp_stage``: the whole network staged into shared memory;
- ``warp_forward``: staging and the forward pass of every row;

(for DeepFM the same over ``deepfm_stage`` and ``deepfm_forward_warp`` of
``csrc/deepfm.cuh``, the one-warp-per-row grad kernel's pieces), or, where
the sources run the measure's grad on the cluster kernel of
``mlp_grad.cuh``, its ``Stop`` phases at its own cluster launch:
``cluster_empty``, ``cluster_stage``, ``cluster_forward`` (through the
value); then ``kernel``: the sources' own ``mlp_grad_f32`` (or
``deepfm_grad_f32``) entry, whatever body it launches; and ``floor``, an
in-place add on a one-element tensor.

Splits this checkout's kernel, or each kernel source directory given with
``--csrc`` (another commit's ``src/repro_torch/kernels/csrc`` unpacked
with ``git archive`` into a directory that ``.gitignore`` lists, or an
edited copy), all timed in turns in one process (each copy is its own
library with plain C entry points). Prints one JSON line: per variant the
median over the rounds and each round's time, each copy's largest error
against the plain version, its ptxas lines and its SASS opcode counts,
and for a copy instrumented with clock64 stamps (one that defines
``extern "C" int mlp_grad_stamps(unsigned long long*)``, 32 counters) the
stamps of one run (MLP only). The parents' splits in PERF.md are this
tool on the parent's sources (``--csrc
build/parent/src/repro_torch/kernels/csrc``).

    python3 tools/mlp_grad_split.py [--measure mlp|deepfm] [--rounds 5]
                                    [--csrc DIR ...] [--sass-dir DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

Q, DX, DQ, HIDDEN = 32, 40, 40, (64, 64)
D, FM = 40, 8          # the DeepFM measure (configs/guitar_deepfm.py)

# cut-down copies of the grad kernel, over the score path's pieces; each
# entry takes the arguments of mlp_grad_f32 and launches one variant
VARIANTS_CU = r"""
#include "mlp.cuh"
#include "mlp_grad.cu"
using namespace repro;

// keep a variant's shared-memory work alive without writing anything
__device__ inline void sink(const float* sm, float* out, int M) {
  if (threadIdx.x == 0 && sm[M & 7] == 1234.5f) out[0] = sm[1];
}

__global__ void __launch_bounds__(kMLPThreads)
warp_empty(float* vals, int M) {
  if (M < 0) vals[0] = 0.f;
}

__global__ void __launch_bounds__(kMLPThreads)
warp_stage(MLPNet net, float* vals, int M) {
  extern __shared__ float sm[];
  mlp_stage(sm, net);
  __syncthreads();
  sink(sm, vals, M);
}

__global__ void __launch_bounds__(kMLPThreads)
warp_forward(GatheredRows rows, const float* __restrict__ query,
             int q_shared, MLPNet net, float* __restrict__ vals, int M) {
  extern __shared__ float sm[];
  mlp_stage(sm, net);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* scr = sm + net.weight_floats + warp * net.scratch_floats;
  float* slice = scr + net.scratch_floats - net.dx;
  const int row0 = blockIdx.x * kMLPRowsPerBlock;
  const int row1 = min(row0 + kMLPRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += blockDim.x / kWarp) {
    __syncwarp();
    const float* x = rows.load(r, net.dx, slice, lane);
    const float* q =
        q_shared ? query : query + static_cast<size_t>(r) * net.dq;
    const float val = mlp_forward_warp(sm, net, x, q, scr, lane);
    if (lane == 0) vals[r] = val;
  }
}

extern "C" int split_run(int variant, const void* cand, const void* query,
                         int q_shared, const void* const* ws,
                         const void* const* bs, const int* dims, int layers,
                         void* vals, void* grads, int M, int Dx, int Dq,
                         void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mlp_smem_bytes(net);
  const int grid = (M + kMLPRowsPerBlock - 1) / kMLPRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  switch (variant) {
    case 0:
      allow_smem(warp_empty, smem);
      warp_empty<<<grid, kMLPThreads, smem, s>>>(v, M);
      break;
    case 1:
      allow_smem(warp_stage, smem);
      warp_stage<<<grid, kMLPThreads, smem, s>>>(net, v, M);
      break;
    case 2:
      allow_smem(warp_forward, smem);
      warp_forward<<<grid, kMLPThreads, smem, s>>>(
          GatheredRows{static_cast<const float*>(cand)},
          static_cast<const float*>(query), q_shared, net, v, M);
      break;
    default:
      return mlp_grad_f32(cand, query, q_shared, ws, bs, dims, layers, vals,
                          grads, M, Dx, Dq, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# the same for the DeepFM grad kernel, over the pieces of its one-warp-per-
# row body that the score path keeps (csrc/deepfm.cuh)
DEEPFM_CU = r"""
#include "deepfm_grad.cu"

__global__ void __launch_bounds__(kDeepFMThreads)
dfm_stage(DeepFMWeights w, float* vals, int M, int K0, int H0, int H1) {
  extern __shared__ float sm[];
  deepfm_stage(deepfm_layout(sm, K0, H0, H1), w, K0, H0, H1);
  __syncthreads();
  sink(sm, vals, M);
}

__global__ void __launch_bounds__(kDeepFMThreads)
dfm_forward(GatheredRows rows, const float* __restrict__ query, int q_shared,
            DeepFMWeights w, float* __restrict__ vals, int M, int D, int fm,
            int H0, int H1) {
  extern __shared__ float sm[];
  const int dd = D - fm, K0 = 2 * dd;
  const DeepFMSmem s = deepfm_layout(sm, K0, H0, H1);
  deepfm_stage(s, w, K0, H0, H1);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const DeepFMScratch c = deepfm_scratch(sm, warp, K0, H0, H1, D);
  const int row0 = blockIdx.x * kDeepFMRowsPerBlock;
  const int row1 = min(row0 + kDeepFMRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += blockDim.x / kWarp) {
    __syncwarp();
    const float* x = rows.load(r, D, c.x, lane);
    const float* q = q_shared ? query : query + static_cast<size_t>(r) * D;
    const float val =
        deepfm_forward_warp(s, x, q, c.in, c.z0, c.z1, fm, dd, H0, H1, lane);
    if (lane == 0) vals[r] = val;
  }
}

extern "C" int split_deepfm(int variant, const void* cand, const void* query,
                            int q_shared, const void* w0, const void* b0,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* vals, void* grads, int M,
                            int D, int fm, int H0, int H1, void* stream) {
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
  const size_t smem = deepfm_smem_bytes(D, fm, H0, H1);
  const int grid = (M + kDeepFMRowsPerBlock - 1) / kDeepFMRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  switch (variant) {
    case 0:
      allow_smem(warp_empty, smem);
      warp_empty<<<grid, kDeepFMThreads, smem, s>>>(v, M);
      break;
    case 1:
      allow_smem(dfm_stage, smem);
      dfm_stage<<<grid, kDeepFMThreads, smem, s>>>(w, v, M, 2 * (D - fm), H0,
                                                   H1);
      break;
    case 2:
      allow_smem(dfm_forward, smem);
      dfm_forward<<<grid, kDeepFMThreads, smem, s>>>(
          GatheredRows{static_cast<const float*>(cand)},
          static_cast<const float*>(query), q_shared, w, v, M, D, fm, H0, H1);
      break;
    default:
      return deepfm_grad_f32(cand, query, q_shared, w0, b0, w1, b1, w2, b2,
                             vals, grads, M, D, fm, H0, H1, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# the cluster kernel's phases, where the checkout has it
CLUSTER_CU = r"""
extern "C" int split_cluster(int stop, const void* cand, const void* query,
                             int q_shared, const void* const* ws,
                             const void* const* bs, const int* dims,
                             int layers, void* vals, void* grads, int M,
                             int Dx, int Dq, void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 0>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
    case 1:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 1>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
    default:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 2>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
  }
}
"""


# the DeepFM grad on the cluster kernel's phases, where the checkout has it
DEEPFM_CLUSTER_CU = r"""
extern "C" int split_deepfm_cluster(int stop, const void* cand,
                                    const void* query, int q_shared,
                                    const void* w0, const void* b0,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2,
                                    void* vals, void* grads, int M, int D,
                                    int fm, int H0, int H1, void* stream) {
  const DeepFMWeights w = deepfm_weights(w0, b0, w1, b1, w2, b2);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_deepfm_grad_cluster<GatheredRows, 0>(
          rows, query, q_shared, w, vals, grads, nullptr, M, D, fm, H0, H1,
          stream));
    case 1:
      return static_cast<int>(launch_deepfm_grad_cluster<GatheredRows, 1>(
          rows, query, q_shared, w, vals, grads, nullptr, M, D, fm, H0, H1,
          stream));
    default:
      return static_cast<int>(launch_deepfm_grad_cluster<GatheredRows, 2>(
          rows, query, q_shared, w, vals, grads, nullptr, M, D, fm, H0, H1,
          stream));
  }
}
"""


def build(csrc, out_dir, measure):
    """Compile the variants of ``measure``'s grad kernel against the kernel
    sources in ``csrc`` into one library with the port's nvcc flags;
    returns (library, whether the grad runs on the cluster kernel, nvcc's
    output, the library's SASS)."""
    from repro_torch.kernels import _lib
    os.makedirs(out_dir, exist_ok=True)
    cuh = os.path.join(csrc, "mlp_grad.cuh")
    has_cluster = os.path.exists(cuh)
    if measure == "deepfm":
        with open(cuh if has_cluster else os.devnull) as f:
            has_cluster = "launch_deepfm_grad_cluster" in f.read()
        cu = VARIANTS_CU + DEEPFM_CU + (DEEPFM_CLUSTER_CU if has_cluster
                                        else "")
    else:
        cu = VARIANTS_CU + (CLUSTER_CU if has_cluster else "")
    src = os.path.join(out_dir, "mlp_grad_split.cu")
    with open(src, "w") as f:
        f.write(cu)
    so = os.path.join(out_dir, "libmlp_grad_split.so")
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", csrc, "-shared", "-o", so,
           src]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump"), "-sass",
         so], capture_output=True, text=True).stdout
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    if measure == "deepfm":
        names = ["split_deepfm"] + (["split_deepfm_cluster"] if has_cluster
                                    else [])
        argtypes = [I, P, P, I, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    else:
        names = ["split_run"] + (["split_cluster"] if has_cluster else [])
        argtypes = [I, P, P, I, P, P, P, I, P, P, I, I, I, P]
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    return lib, has_cluster, out.stdout + out.stderr, sass


def is_grad_kernel(fn: str, measure: str) -> bool:
    """Whether SASS function ``fn`` is a grad kernel of ``measure``: the
    cluster kernel's instantiations for that measure's input, or the
    one-warp-per-row kernel."""
    if measure == "deepfm":
        return "deepfm_grad_kernel" in fn or (
            "mlp_grad_cluster_kernel" in fn and "DeepFMInput" in fn)
    return "mlp_grad" in fn and "DeepFMInput" not in fn


def sass_opcodes(sass: str, measure: str) -> dict:
    """Opcode counts of each grad kernel of ``measure``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if is_grad_kernel(fn, measure) else None
        elif fn and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op:
                name = op[0].rstrip(";")
                counts.setdefault(fn, {})
                counts[fn][name] = counts[fn].get(name, 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--measure", choices=("mlp", "deepfm"), default="mlp")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--csrc", nargs="*", default=None,
                    help="kernel source directories to split, each timed "
                         "in turns with the others (default: this "
                         "checkout's)")
    ap.add_argument("--sass-dir", default=None,
                    help="also write each copy's SASS of the grad kernels "
                         "to this directory")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlp_grad_split: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _lib
    from repro_torch.kernels.deepfm_grad.ref import deepfm_value_and_grad_ref
    from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
    from repro_torch.kernels.mlp_score.ops import net_args

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(456)
    deepfm = opts.measure == "deepfm"
    if deepfm:
        dd = D - FM
        net = chip_smoke.random_mlp(torch, dev, 2 * dd, HIDDEN, gen)
        c = torch.randn((Q, D), generator=gen).to(dev)
        q = torch.randn((Q, D), generator=gen).to(dev)
        wb = [t for pair in zip(net["w"], net["b"]) for t in pair]
        args = [t.data_ptr() for t in wb]
        widths = (Q, D, FM, *HIDDEN)
        grads = torch.empty((Q, D), device=dev)
        pv, pg = deepfm_value_and_grad_ref(c, q, *wb, FM)
        shape = f"Q={Q} D={D} fm={FM} hidden={HIDDEN}"
    else:
        net = chip_smoke.random_mlp(torch, dev, DX + DQ, HIDDEN, gen)
        c = torch.randn((Q, DX), generator=gen).to(dev)
        q = torch.randn((Q, DQ), generator=gen).to(dev)
        args = net_args(net["w"], net["b"], DX, dev)
        widths = (Q, DX, DQ)
        grads = torch.empty((Q, DX), device=dev)
        pv, pg = mlp_value_and_grad_ref(c, q, net["w"], net["b"])
        shape = f"Q={Q} Dx={DX} Dq={DQ} hidden={HIDDEN}"
    vals = torch.empty((Q,), device=dev)

    def call(fn, variant):
        def run():       # on the current stream: time_ms captures a graph
            rc = fn(variant, c.data_ptr(), q.data_ptr(), 0, *args,
                    vals.data_ptr(), grads.data_ptr(), *widths,
                    _lib.stream_of(dev))
            _lib.check(rc, f"variant {variant}")
        return run

    out = {"device": chip_smoke.nvidia_smi_line(), "unit": "us",
           "measure": opts.measure, "shape": shape, "err": {},
           "ptxas": {}, "sass_opcodes": {}}
    calls = {}
    for i, csrc in enumerate(opts.csrc or [str(_lib.CSRC)]):
        label = os.path.basename(os.path.normpath(csrc)) + (
            f"#{i}" if opts.csrc else "")
        lib, has_cluster, log, sass = build(
            csrc, os.path.join(ROOT, "build", "mlp_grad_split", str(i)),
            opts.measure)
        whole = lib.split_deepfm if deepfm else lib.split_run
        if has_cluster:
            names = ("cluster_empty", "cluster_stage", "cluster_forward")
            fn = lib.split_deepfm_cluster if deepfm else lib.split_cluster
        else:
            names = ("warp_empty", "warp_stage", "warp_forward")
            fn = whole
        for v, name in enumerate(names):
            calls[f"{label}:{name}"] = call(fn, v)
        calls[f"{label}:kernel"] = call(whole, 3)
        calls[f"{label}:kernel"]()
        torch.cuda.synchronize()
        out["err"][label] = max(float((vals - pv).abs().max()),
                                float((grads - pg).abs().max()))
        out["ptxas"][label] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        out["sass_opcodes"][label] = sass_opcodes(sass, opts.measure)
        if opts.sass_dir:
            os.makedirs(opts.sass_dir, exist_ok=True)
            with open(os.path.join(opts.sass_dir, f"{label}.sass"), "w") as f:
                f.write(sass)
        try:            # a copy instrumented with clock64 stamps
            stamps = lib.mlp_grad_stamps
        except AttributeError:
            continue
        buf = (ctypes.c_ulonglong * 32)()
        calls[f"{label}:kernel"]()
        torch.cuda.synchronize()
        _lib.check(stamps(buf), "mlp_grad_stamps")
        out.setdefault("stamps", {})[label] = list(buf)
    one = torch.zeros(1, device=dev)
    calls["floor"] = lambda: one.add_(1.0)
    times = {k: [] for k in calls}
    for _ in range(opts.rounds):
        for k, fn in calls.items():
            times[k].append(chip_smoke.time_ms(fn) * 1e3)
    out["median_us"] = {k: statistics.median(v) for k, v in times.items()}
    out["rounds_us"] = times
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
